"""PyTorch/CUDA port of ``truely_tpu``'s score path for an NVIDIA H100.

The package mirrors the JAX layout (``config``, ``models/``, ``ops/``,
``pipeline/``) and imports nothing of ``truely_tpu`` and no JAX.  The four
Pallas kernels on the path are hand-written CUDA kernels in ``csrc/``,
built with nvcc on first use; every kernel wrapper runs its plain PyTorch
version on CPU tensors.
"""
