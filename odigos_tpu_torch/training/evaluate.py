"""ROC-AUC evaluation on injected faults.

The port of ``odigos_tpu/training/evaluate.py``: generate a held-out faulty
stream, score its spans with a detector, and measure the span-level ROC-AUC
against the injected ground truth. The north star asks AUC >= 0.95.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import numpy as np

from ..features import assemble_sequences, featurize, pack_sequences
from ..pdata import inject_faults, synthesize_traces
from ..pdata.spans import SpanBatch


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-statistic AUC (Mann-Whitney U), ties handled by midranks."""
    labels = np.asarray(labels, dtype=bool)
    scores = np.asarray(scores, dtype=np.float64)
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(scores)
    ranks[order] = np.arange(1, scores.size + 1, dtype=np.float64)
    # midranks for ties
    sorted_scores = scores[order]
    i = 0
    while i < scores.size:
        j = i
        while j + 1 < scores.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j + 2) / 2.0
        i = j + 1
    u = ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


# A scorer maps a span batch to per-span anomaly scores.
Scorer = Callable[[SpanBatch], np.ndarray]


def transformer_scorer(model, variables: Optional[Mapping[str, Any]] = None,
                       *, max_len: int = 32) -> Scorer:
    """A trained ``TraceTransformer`` as a per-span scorer (one trace a
    row, ``score_spans``); ``variables``, if given, are loaded into it
    first."""
    if variables is not None:
        model.load_state_dict(variables)

    def score(batch: SpanBatch) -> np.ndarray:
        feats = featurize(batch)
        seqs = assemble_sequences(batch, feats, max_len=max_len)
        span_scores, _ = model.score_spans(seqs.categorical, seqs.continuous,
                                           seqs.mask)
        out = np.zeros(len(batch), dtype=np.float32)
        idx = seqs.span_index
        valid = idx >= 0
        out[idx[valid]] = span_scores.cpu().numpy()[valid]
        return out

    return score


def quantized_transformer_scorer(model,
                                 variables: Optional[Mapping[str, Any]] = None,
                                 *, max_len: int = 32) -> Scorer:
    """The int8 serving path (``models/quantized.py``) over a trained
    transformer's f32 weights (``variables``, else the model's own) as a
    per-span scorer, packed rows as the engine scores them: the AUC bar
    holds for quantized serving as for the float path."""
    from ..models.quantized import QuantizedTraceScorer

    scorer = QuantizedTraceScorer(model.cfg, device=model.device)
    scorer.load_state_dict(variables if variables is not None
                           else model.state_dict())

    def score(batch: SpanBatch) -> np.ndarray:
        feats = featurize(batch)
        p = pack_sequences(batch, feats, max_len=max_len)
        probs = scorer.score_packed(p.categorical, p.continuous, p.segments,
                                    p.positions).cpu().numpy()
        out = np.zeros(len(batch), dtype=np.float32)
        idx = p.span_index
        valid = idx >= 0
        out[idx[valid]] = probs[valid]
        return out

    return score


def zscore_scorer(detector, *, warmup_batch: Optional[SpanBatch] = None
                  ) -> Scorer:
    if warmup_batch is not None:
        detector.update(featurize(warmup_batch))

    def score(batch: SpanBatch) -> np.ndarray:
        return np.abs(np.asarray(detector.score(featurize(batch))))

    return score


def evaluate_detector(scorer: Scorer, *, n_traces: int = 2000,
                      fault_fraction: float = 0.1, seed: int = 1000,
                      kinds: Optional[tuple[str, ...]] = None
                      ) -> dict[str, Any]:
    """Held-out evaluation; returns {"auc", "auc_by_kind", n_spans, n_pos}."""
    clean = synthesize_traces(n_traces, seed=seed)
    kwargs = {"kinds": kinds} if kinds else {}
    batch, labels, reports = inject_faults(
        clean, fault_fraction=fault_fraction, seed=seed + 1, **kwargs)
    scores = scorer(batch)
    result = {
        "auc": roc_auc(labels, scores),
        "n_spans": int(len(batch)),
        "n_pos": int(labels.sum()),
        "auc_by_kind": {},
    }
    trace_lo = batch.col("trace_id_lo")
    faulty_traces_by_kind: dict[str, set[int]] = {}
    all_faulty = set()
    for r in reports:
        faulty_traces_by_kind.setdefault(r.kind, set()).add(r.trace_id_lo)
        all_faulty.add(r.trace_id_lo)
    for kind, traces in sorted(faulty_traces_by_kind.items()):
        # kind AUC: spans of this kind's traces vs all clean spans
        keep = np.isin(trace_lo, list(traces)) | ~np.isin(
            trace_lo, list(all_faulty))
        result["auc_by_kind"][kind] = roc_auc(labels[keep], scores[keep])
    return result
