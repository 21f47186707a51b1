"""odigos_tpu_torch — the PyTorch/CUDA port of odigos_tpu's scoring stage.

A second package beside ``odigos_tpu`` (the JAX reference). It serves the
streaming z-score detector (the default model, as in the JAX package) and
the flagship trace transformer through its own scoring sidecar, engine and
packer on an NVIDIA H100, with hand-written CUDA kernels for the packed
segment-masked attention, the span-embedding gather-sum and the z-score
detector's segmented update and score (``odigos_tpu_torch.kernels``). It
imports ``torch`` and ``numpy`` and never ``jax``, ``flax`` or anything of
``odigos_tpu``: framework-free modules it needs are kept here as its own
copies under the same relative paths.

Entry points run on ``device="cuda"`` unless the caller asks for
``"cpu"``, and raise when CUDA is asked for but absent.

Run the sidecar:  python -m odigos_tpu_torch.serving.sidecar \\
                      --socket /tmp/score.sock [--model zscore|transformer]
"""
