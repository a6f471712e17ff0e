"""Shared utilities: profiling (counterpart of ``truely_tpu/utils``)."""

from truely_tpu_torch.utils.profiling import StageTimer  # noqa: F401
