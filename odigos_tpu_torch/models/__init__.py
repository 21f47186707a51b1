"""The port's scoring models: the flagship trace transformer (and the
Flax→torch bridge) and the streaming z-score detector."""

from .convert import flax_to_torch
from .transformer import TraceTransformer, TransformerConfig
from .zscore import ZScoreDetector, ZScoreState, state_from_numpy

__all__ = ["TraceTransformer", "TransformerConfig", "ZScoreDetector",
           "ZScoreState", "flax_to_torch", "state_from_numpy"]
