"""Train → serve bridge: the serving bundle.

The port of ``odigos_tpu/training/checkpoint.py``. A bundle is a directory
holding

    <dir>/model.json     {"model": "transformer" | "autoencoder",
                          "config": {<config fields, dtype by name>}}
    <dir>/variables.pt   the port's state dict (``torch.save`` of CPU
                         tensors; loads with ``weights_only=True``)

``model.json`` has the reference's schema, so serving rebuilds the model's
geometry (vocabularies, ``d_model``, ``max_len``) from the artifact and a
pipeline config only names the path. The reference keeps its variables as
an Orbax tree under ``<dir>/variables/``;
``tools/torch_import_bundle.py`` turns such a bundle into this one
(outside the port: reading Orbax needs JAX).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping, Optional

import torch

MODEL_META_FILE = "model.json"
VARIABLES_FILE = "variables.pt"

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16, "float64": torch.float64}


def _dtype_name(dtype: Any) -> str:
    for name, t in _DTYPES.items():
        if dtype == t:
            return name
    raise ValueError(f"unsupported checkpoint dtype {dtype!r} "
                     f"(known: {sorted(_DTYPES)})")


def _resolve_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported checkpoint dtype {name!r} "
                         f"(known: {sorted(_DTYPES)})") from None


def config_to_dict(model_config: Any) -> dict[str, Any]:
    """JSON-safe dict of a TransformerConfig/AutoencoderConfig."""
    d = dataclasses.asdict(model_config)
    if "dtype" in d:
        d["dtype"] = _dtype_name(d["dtype"])
    return d


def make_model_config(model: str, fields: Optional[dict[str, Any]] = None):
    """Build the frozen config dataclass for ``model`` from plain-dict
    fields (a bundle's model.json, or a pipeline config's
    ``model_config``). Unknown keys and dtypes are refused, so a typo fails
    loudly."""
    fields = dict(fields or {})
    if "dtype" in fields and isinstance(fields["dtype"], str):
        fields["dtype"] = _resolve_dtype(fields["dtype"])
    if model == "transformer":
        from ..models.transformer import TransformerConfig

        return TransformerConfig(**fields)
    if model == "autoencoder":
        from ..models.autoencoder import AutoencoderConfig

        return AutoencoderConfig(**fields)
    raise ValueError(f"model {model!r} has no config class "
                     "(known: transformer, autoencoder)")


def save_bundle(path: str, variables: Mapping[str, Any], *, model: str,
                model_config: Any) -> str:
    """Write a serving bundle; returns the absolute bundle path. The
    variables are stored as contiguous CPU tensors, so a bundle trained on
    the card loads in a CPU-only process and the other way round."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    state = {k: torch.as_tensor(v).detach().cpu().contiguous()
             for k, v in variables.items()}
    torch.save(state, os.path.join(path, VARIABLES_FILE))
    meta = {"model": model, "config": config_to_dict(model_config)}
    with open(os.path.join(path, MODEL_META_FILE), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    return path


@dataclasses.dataclass(frozen=True)
class ServingBundle:
    model: str                       # "transformer" | "autoencoder"
    model_config: Any                # TransformerConfig | AutoencoderConfig
    variables: dict[str, torch.Tensor]  # the port's state dict (CPU)


def load_bundle(path: str) -> ServingBundle:
    """Load a serving bundle written by :func:`save_bundle`."""
    path = os.path.abspath(path)
    meta_path = os.path.join(path, MODEL_META_FILE)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(
            f"{path} is not a serving bundle (missing {MODEL_META_FILE}); "
            "export one with Trainer.export() / save_bundle()")
    with open(meta_path) as f:
        meta = json.load(f)
    cfg = make_model_config(meta["model"], meta.get("config"))
    return ServingBundle(model=meta["model"], model_config=cfg,
                         variables=restore_variables(path))


def restore_variables(path: str) -> dict[str, torch.Tensor]:
    """The state dict of a bundle directory (or of a ``variables.pt``
    file given directly), on the CPU."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        path = os.path.join(path, VARIABLES_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} missing: a bundle of the JAX package (an Orbax tree "
            f"under variables/) converts with tools/torch_import_bundle.py")
    return torch.load(path, map_location="cpu", weights_only=True)
