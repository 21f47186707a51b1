"""The port's scoring models: the flagship trace transformer (and the
Flax→torch bridge), its int8 (W8A8) scorer, the span autoencoder and the
streaming z-score detector."""

from .autoencoder import AutoencoderConfig, SpanAutoencoder
from .convert import (flax_autoencoder_to_torch, flax_quantized_to_torch,
                      flax_to_torch, quantize_state_dict)
from .quantized import QuantizedTraceScorer, quantize_weight
from .transformer import TraceTransformer, TransformerConfig
from .zscore import ZScoreDetector, ZScoreState, state_from_numpy

__all__ = ["AutoencoderConfig", "QuantizedTraceScorer", "SpanAutoencoder",
           "TraceTransformer", "TransformerConfig", "ZScoreDetector",
           "ZScoreState", "flax_autoencoder_to_torch",
           "flax_quantized_to_torch", "flax_to_torch",
           "quantize_state_dict", "quantize_weight", "state_from_numpy"]
