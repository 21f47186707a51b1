#!/usr/bin/env python3
"""Convert a serving bundle of the JAX package into one of the port.

    python tools/torch_import_bundle.py <jax bundle dir> <port bundle dir>

A bundle of ``odigos_tpu`` (``Trainer.export`` / ``save_bundle`` there) is
``model.json`` plus an Orbax tree under ``variables/``; the port's
(``odigos_tpu_torch/training/checkpoint.py``) is the same ``model.json``
plus ``variables.pt``, its state dict. This tool reads the Orbax tree with
the JAX package (so it needs ``jax`` and ``orbax``, and lives outside the
port, which never imports it), carries the Flax variables across with
``flax_to_torch`` (the transformer) or ``flax_autoencoder_to_torch`` (the
autoencoder), and writes the port's bundle with the same geometry. The
engine then serves it: ``EngineConfig(model=..., checkpoint_path=<port
bundle dir>)``, or the sidecar's ``--checkpoint``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def import_bundle(src: str, dst: str) -> str:
    """Convert the JAX bundle at ``src`` into a port bundle at ``dst``;
    returns ``dst``'s absolute path."""
    sys.path.insert(0, ROOT)
    import jax
    import numpy as np

    from odigos_tpu.training.checkpoint import load_bundle as load_jax
    from odigos_tpu_torch.models import (flax_autoencoder_to_torch,
                                         flax_to_torch)
    from odigos_tpu_torch.training.checkpoint import (MODEL_META_FILE,
                                                      make_model_config,
                                                      save_bundle)

    jb = load_jax(src)
    with open(os.path.join(os.path.abspath(src), MODEL_META_FILE)) as f:
        meta = json.load(f)
    cfg = make_model_config(meta["model"], meta.get("config"))
    params = jax.tree.map(np.asarray, jb.variables)
    convert = flax_to_torch if jb.model == "transformer" \
        else flax_autoencoder_to_torch
    return save_bundle(dst, convert(params, cfg), model=jb.model,
                       model_config=cfg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="the JAX package's bundle directory")
    ap.add_argument("dst", help="where to write the port's bundle")
    args = ap.parse_args(argv)
    print(import_bundle(args.src, args.dst))
    return 0


if __name__ == "__main__":
    sys.exit(main())
