"""PyTorch/CUDA port of ``truely_tpu`` for an NVIDIA H100.

The package mirrors the JAX layout (``config``, ``cli``, ``agents/``,
``media/``, ``models/``, ``ops/``, ``pipeline/``, ``serve/``) and imports
nothing of ``truely_tpu`` and no JAX.  The five Pallas kernels are
hand-written CUDA kernels in ``csrc/``, built with nvcc on first use; every
kernel wrapper runs its plain PyTorch version on CPU tensors.  ``python -m
truely_tpu_torch analyze|stream|serve`` is the command-line entry point.
"""
