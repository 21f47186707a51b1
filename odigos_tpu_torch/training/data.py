"""Labelled training data: synthetic traffic with injected faults as padded
trace sequences with span and trace labels.

The port's copy of ``odigos_tpu/training/data.py`` on the port's own
``synthesize_traces`` / ``inject_faults`` and ``featurize`` /
``assemble_sequences``: for the same seeds the arrays are bit-identical to
the reference's (``tests/test_torch_training.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from ..features import assemble_sequences, featurize
from ..pdata import inject_faults, synthesize_traces


@dataclass(frozen=True)
class LabeledSequences:
    categorical: np.ndarray  # (T, L, C) int32
    continuous: np.ndarray   # (T, L, D) float32
    mask: np.ndarray         # (T, L) bool
    span_labels: np.ndarray  # (T, L) float32 — 1.0 at culprit spans
    trace_labels: np.ndarray  # (T,) float32


def labeled_sequences(n_traces: int, *, fault_fraction: float = 0.3,
                      max_len: int = 32, seed: int = 0,
                      pad_traces_to: Optional[int] = None
                      ) -> LabeledSequences:
    batch = synthesize_traces(n_traces, seed=seed)
    batch, labels, _ = inject_faults(batch, fault_fraction=fault_fraction,
                                     seed=seed + 1)
    feats = featurize(batch)
    seqs = assemble_sequences(batch, feats, max_len=max_len,
                              pad_traces_to=pad_traces_to)
    # scatter span labels onto the (T, L) grid via span_index
    idx = seqs.span_index
    span_labels = np.where(idx >= 0, labels[np.clip(idx, 0, None)],
                           False).astype(np.float32)
    trace_labels = span_labels.any(axis=-1).astype(np.float32)
    return LabeledSequences(seqs.categorical, seqs.continuous, seqs.mask,
                            span_labels, trace_labels)


def training_stream(traces_per_step: int, *, fault_fraction: float = 0.3,
                    max_len: int = 32, seed: int = 0, start_step: int = 0
                    ) -> Iterator[tuple[int, LabeledSequences]]:
    """Infinite deterministic stream of (step, data); step i is reproducible
    on its own, so a resumed run regenerates the remaining stream without
    replaying the prefix. Every step is padded to ``traces_per_step``
    traces, so every step has one shape."""
    step = start_step
    while True:
        yield step, labeled_sequences(
            traces_per_step, fault_fraction=fault_fraction, max_len=max_len,
            seed=seed + 7919 * step, pad_traces_to=traces_per_step)
        step += 1
