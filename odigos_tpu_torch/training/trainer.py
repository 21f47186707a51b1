"""The training loop: AdamW under a warmup-cosine schedule, with step
checkpoints and resume.

The port of ``odigos_tpu/training/trainer.py``, for both of its models.
One step: the labelled stream's next batch (``training/data.py``,
regenerated from the seed, so a resumed run sees the same remaining
stream; the autoencoder trains on clean traffic, ``fault_fraction`` 0, as
the reference's), the model's ``loss_fn`` forward through the kernels'
autograd Functions (``kernels/autograd.py``: K1/K16, K2/K18, K14/K17, K15
and K19 for FFN1; the autoencoder also K12/K21, K15 + K19 for
``dec_ff1``, K15 for ``dec_ff2`` and K11/K20 + K17 for its heads), the
backward pass, and one ``torch.optim.AdamW`` update (betas 0.9 /
0.999, eps 1e-8, weight decay 1e-4 on every parameter: optax's ``adamw``
with no mask) at the learning rate of ``optax.warmup_cosine_decay_schedule
(0, lr, warmup, max(schedule_steps or steps, 1))``, reproduced by
:func:`lr_schedule` through a ``LambdaLR`` (lr 0 at step 0, as optax counts
from 0). It trains in f32, as the reference does (bf16 activations lost
most of the AUC there), at the model's full width. It starts from the
weights the reference's seed gives (``models/jax_init.py``: JAX's draws,
reproduced without JAX), since the transformer recipe's outcome depends
on them: the reference reaches AUC 0.98 from seed 0 and 0.66 / 0.35 from
seeds 1 / 2.

Checkpoints: every ``checkpoint_every`` steps (and at the end) a directory
``<checkpoint_dir>/<step>/`` holding the model, optimizer and scheduler
state (``torch.save``), the newest 3 kept; ``train`` resumes from the
newest one. ``export`` writes a serving bundle (``training/checkpoint.py``)
that ``EngineConfig(checkpoint_path=...)`` loads.

``Trainer(config, device="cuda")`` raises without a card unless asked for
``"cpu"``; on the card either model's geometry must be one
``kernels/coverage.check`` takes (it holds K20's ``d`` too), with
embedding tables of at most ``embed.MAX_BWD_ROWS`` rows (K18's), and the
working type f32 (the backward kernels K16-K21 are f32; bf16 training is a
later slice): each raises there by name (:func:`card_checks`). On the CPU
every kernel is its plain version, in any geometry.
"""

from __future__ import annotations

import math
import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional

import torch

from ..utils.device import resolve_device
from .data import training_stream

MAX_TO_KEEP = 3
STATE_FILE = "state.pt"


@dataclass
class TrainConfig:
    model: str = "transformer"  # transformer | autoencoder
    steps: int = 300
    traces_per_step: int = 64
    fault_fraction: float = 0.3
    learning_rate: float = 3e-3
    warmup_steps: int = 20
    max_len: int = 32
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    # cosine-decay horizon; defaults to ``steps``. Set it explicitly when a
    # run will be resumed past its current ``steps`` so every leg of the
    # run sees the same schedule.
    schedule_steps: Optional[int] = None
    model_kwargs: dict[str, Any] = field(default_factory=dict)


@dataclass
class TrainResult:
    variables: dict[str, torch.Tensor]  # the model's state dict
    losses: list[float]
    start_step: int  # >0 when resumed from a checkpoint
    final_step: int
    # seconds a step spent in each part (the host's clock; on the card each
    # part ends in a synchronize): data, forward, backward, optimizer
    step_seconds: dict[str, list[float]] = field(default_factory=dict)


def lr_schedule(step: int, peak: float, warmup: int, decay_steps: int
                ) -> float:
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps)``
    at ``step`` (end value 0): linear from 0 over the warmup, then a cosine
    decay to 0 over ``decay_steps - warmup`` steps, held there after."""
    if decay_steps - warmup <= 0:
        raise ValueError(f"the cosine decay needs decay_steps > warmup "
                         f"steps, got {decay_steps} and {warmup}")
    if step < warmup:
        return peak * step / warmup
    t = min(step - warmup, decay_steps - warmup)
    return peak * 0.5 * (1.0 + math.cos(math.pi * t / (decay_steps - warmup)))


def card_checks(mcfg: Any) -> None:
    """Raise, naming the limit, where the card's training kernels cannot
    take a model config (a ``TransformerConfig`` or an
    ``AutoencoderConfig``): the geometry ``kernels/coverage.check`` serves
    (``d_model`` % 16 up to 1024, which K20 takes too), embedding tables
    within K18's histogram, and f32."""
    from ..kernels import coverage
    from ..kernels.embed import MAX_BWD_ROWS

    coverage.check(mcfg)
    rows = max(mcfg.service_vocab, mcfg.name_vocab, mcfg.max_len,
               mcfg.attr_vocab if mcfg.attr_slots else 0)
    if rows > MAX_BWD_ROWS:
        raise ValueError(f"training on the card takes embedding tables "
                         f"of up to {MAX_BWD_ROWS} rows (K18's "
                         f"histogram), not {rows}")
    if mcfg.dtype != torch.float32:
        raise ValueError(f"training on the card takes float32 (the "
                         f"backward kernels K16-K21 are f32); {mcfg.dtype} "
                         f"training is a later slice")


def _build_model(cfg: TrainConfig, device: torch.device):
    from ..models.autoencoder import AutoencoderConfig, SpanAutoencoder
    from ..models.transformer import TraceTransformer, TransformerConfig

    classes = {"transformer": (TransformerConfig, TraceTransformer),
               "autoencoder": (AutoencoderConfig, SpanAutoencoder)}
    if cfg.model not in classes:
        raise ValueError(f"unknown model {cfg.model!r}")
    config_cls, model_cls = classes[cfg.model]
    kwargs = dict(cfg.model_kwargs)
    kwargs.setdefault("max_len", cfg.max_len)
    kwargs.setdefault("dtype", torch.float32)  # as the reference trains
    mcfg = config_cls(**kwargs)
    if device.type == "cuda":
        card_checks(mcfg)
    return model_cls(mcfg, device=device, seed=cfg.seed)


def _sync(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class Trainer:
    def __init__(self, config: Optional[TrainConfig] = None,
                 device: str | torch.device = "cuda",
                 initial_state: Optional[Mapping[str, Any]] = None):
        """``initial_state``: the model's starting weights (a state dict),
        else the reference's for the config's seed (``jax_init``)."""
        from ..models.jax_init import autoencoder_state, transformer_state

        self.config = config or TrainConfig()
        self.device = resolve_device(device)
        self.model = _build_model(self.config, self.device)
        reference_state = (transformer_state if self.supervised
                           else autoencoder_state)
        self.model.load_state_dict(
            initial_state if initial_state is not None
            else reference_state(self.model.cfg, self.config.seed))
        self._initial = {k: v.detach().clone()
                         for k, v in self.model.state_dict().items()}

    @property
    def supervised(self) -> bool:
        """The transformer trains on labels; the autoencoder on clean
        traffic without them."""
        return self.config.model == "transformer"

    # ------------------------------------------------------- optimizer
    def _optimizer(self):
        cfg = self.config
        params = list(self.model.module.parameters())
        opt = torch.optim.AdamW(params, lr=cfg.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        decay = max(cfg.schedule_steps or cfg.steps, 1)
        lr_schedule(0, 1.0, cfg.warmup_steps, decay)  # refuse as optax does
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda step: lr_schedule(step, 1.0, cfg.warmup_steps,
                                          decay))
        return opt, sched

    # ------------------------------------------------------ checkpoints
    def _steps_saved(self) -> list[int]:
        root = self.config.checkpoint_dir
        if not root or not os.path.isdir(root):
            return []
        return sorted(int(n) for n in os.listdir(root)
                      if n.isdigit() and os.path.exists(
                          os.path.join(root, n, STATE_FILE)))

    def save(self, step: int, opt, sched) -> str:
        """Write ``<checkpoint_dir>/<step>/`` (the model, optimizer and
        scheduler state) and keep the newest ``MAX_TO_KEEP``."""
        root = os.path.abspath(self.config.checkpoint_dir)
        os.makedirs(root, exist_ok=True)
        state = {"step": step, "variables": {
            k: v.detach().cpu() for k, v in self.model.state_dict().items()},
            "optimizer": opt.state_dict(), "scheduler": sched.state_dict()}
        tmp = os.path.join(root, f".{step}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_FILE))
        final = os.path.join(root, str(step))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self._steps_saved()[:-MAX_TO_KEEP]:
            shutil.rmtree(os.path.join(root, str(old)), ignore_errors=True)
        return final

    def restore_latest(self) -> tuple[Optional[int], Optional[dict]]:
        """``(step, state)`` of the newest checkpoint, or ``(None, None)``;
        ``state["variables"]`` is the model's state dict (on the CPU),
        with ``"optimizer"`` and ``"scheduler"`` beside it."""
        steps = self._steps_saved()
        if not steps:
            return None, None
        path = os.path.join(os.path.abspath(self.config.checkpoint_dir),
                            str(steps[-1]), STATE_FILE)
        return steps[-1], torch.load(path, map_location="cpu",
                                     weights_only=True)

    def export(self, path: str,
               variables: Optional[Mapping[str, Any]] = None) -> str:
        """Write the trained weights (the model's own by default) as a
        serving bundle that ``EngineConfig(checkpoint_path=...)`` and the
        sidecar's ``--checkpoint`` load."""
        from .checkpoint import save_bundle

        return save_bundle(path, variables if variables is not None
                           else self.model.state_dict(),
                           model=self.config.model,
                           model_config=self.model.cfg)

    # ---------------------------------------------------------- training
    def train(self, reference: bool = False) -> TrainResult:
        """``reference=True`` runs every kernel's plain version instead,
        on the card too: a check that holds the kernels' trajectory
        against it (the CPU takes the plain versions anyway)."""
        cfg = self.config
        model, dev = self.model, self.device
        model.load_state_dict(self._initial)
        opt, sched = self._optimizer()
        start_step = 0
        if cfg.checkpoint_dir:
            step, state = self.restore_latest()
            if step is not None:
                start_step = step
                model.load_state_dict(state["variables"])
                opt.load_state_dict(state["optimizer"])
                sched.load_state_dict(state["scheduler"])
        module = model.module
        module.train()
        parts: dict[str, list[float]] = {
            "data": [], "forward": [], "backward": [], "optimizer": []}
        losses: list[float] = []
        stream = training_stream(
            cfg.traces_per_step, fault_fraction=cfg.fault_fraction
            if self.supervised else 0.0,
            max_len=cfg.max_len, seed=cfg.seed, start_step=start_step)
        try:
            t0 = _sync(dev)
            for step, data in stream:
                if step >= cfg.steps:
                    break
                t1 = _sync(dev)
                opt.zero_grad(set_to_none=True)
                labels = ((data.span_labels, data.trace_labels)
                          if self.supervised else ())
                loss = model.loss_fn(data.categorical, data.continuous,
                                     data.mask, *labels, reference=reference)
                t2 = _sync(dev)
                loss.backward()
                t3 = _sync(dev)
                opt.step()
                sched.step()
                losses.append(float(loss.detach()))
                t4 = _sync(dev)
                for key, a, b in (("data", t0, t1), ("forward", t1, t2),
                                  ("backward", t2, t3),
                                  ("optimizer", t3, t4)):
                    parts[key].append(b - a)
                if cfg.checkpoint_dir and (step + 1) % cfg.checkpoint_every \
                        == 0:
                    self.save(step + 1, opt, sched)
                t0 = _sync(dev)
        finally:
            module.eval()
        if cfg.checkpoint_dir and cfg.steps % cfg.checkpoint_every:
            self.save(cfg.steps, opt, sched)
        variables = {k: v.detach().clone()
                     for k, v in model.state_dict().items()}
        return TrainResult(variables, losses, start_step, cfg.steps, parts)

