"""odigos_tpu_torch — the PyTorch/CUDA port of odigos_tpu's scoring stage.

A second package beside ``odigos_tpu`` (the JAX reference). It serves the
streaming z-score detector (the default model, as in the JAX package), the
flagship trace transformer (float and int8) and the span autoencoder
through its own scoring sidecar, engine and packers on an NVIDIA H100,
on the host route and the fused columns route, with hand-written CUDA
kernels (``odigos_tpu_torch.kernels``, K1-K13). It
imports ``torch`` and ``numpy`` and never ``jax``, ``flax`` or anything of
``odigos_tpu``: framework-free modules it needs are kept here as its own
copies under the same relative paths.

Entry points run on ``device="cuda"`` unless the caller asks for
``"cpu"``, and raise when CUDA is asked for but absent.

Run the sidecar:  python -m odigos_tpu_torch.serving.sidecar \\
                      --socket /tmp/score.sock
                      [--model zscore|transformer|autoencoder]
"""
