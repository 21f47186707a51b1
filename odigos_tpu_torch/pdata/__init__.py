"""Columnar span batches (the port's copy of the pdata span layer)."""

from .attrstore import (
    AttrDictView,
    AttrStore,
    attr_store_of,
    columnar_attrs,
    columnar_enabled,
    set_columnar_attrs,
)
from .gen import (FAULT_KINDS, FaultReport, TraceShape, adversarial_traces,
                  inject_faults, join_stress_frames, synthesize_traces)
from .spans import (
    SpanBatch,
    SpanBatchBuilder,
    SpanKind,
    StatusCode,
    concat_batches,
)

__all__ = [
    "AttrDictView",
    "AttrStore",
    "attr_store_of",
    "columnar_attrs",
    "columnar_enabled",
    "set_columnar_attrs",
    "SpanBatch",
    "SpanBatchBuilder",
    "SpanKind",
    "StatusCode",
    "concat_batches",
    "FAULT_KINDS",
    "FaultReport",
    "TraceShape",
    "inject_faults",
    "synthesize_traces",
    "adversarial_traces",
    "join_stress_frames",
]
