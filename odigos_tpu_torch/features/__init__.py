"""Host featurizer, next-fit packer and one-trace-per-row assembly (the
port's copy of the host route)."""

from .featurizer import (
    CAT_FIELDS,
    CONT_FIELDS,
    FeaturizerConfig,
    PackedSequences,
    SpanColumns,
    SpanFeatures,
    TraceSequences,
    assemble_sequences,
    batch_columns,
    featurize,
    featurize_columns,
    pack_arrays,
    pack_sequences,
)

__all__ = [
    "CAT_FIELDS",
    "CONT_FIELDS",
    "FeaturizerConfig",
    "PackedSequences",
    "SpanColumns",
    "SpanFeatures",
    "TraceSequences",
    "assemble_sequences",
    "batch_columns",
    "featurize",
    "featurize_columns",
    "pack_arrays",
    "pack_sequences",
]
