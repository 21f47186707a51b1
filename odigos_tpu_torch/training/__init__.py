"""Model training, checkpointing and evaluation (the port of
``odigos_tpu/training``).

The trainer runs the transformer's forward through the kernels' autograd
Functions and their hand-written backward kernels (K16-K19,
``kernels/autograd.py``), checkpoints its steps with ``torch.save`` and
exports serving bundles that the engine's ``checkpoint_path`` loads.
"""

from .data import LabeledSequences, labeled_sequences, training_stream  # noqa: F401
from .trainer import TrainConfig, Trainer, TrainResult  # noqa: F401
from .evaluate import evaluate_detector, roc_auc  # noqa: F401
from .checkpoint import (  # noqa: F401
    ServingBundle, load_bundle, make_model_config, restore_variables,
    save_bundle)
