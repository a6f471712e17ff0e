"""Operations and bytes of the detector's work, from shapes alone: the
nets' multiply-adds per frame step (``nets``), the hand-written kernels'
bytes and operations per launch (``kernels``), and the card's peaks."""

# One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): dense bf16
# on the tensor cores, float32 outside them, and HBM3 bandwidth.
BF16_FLOPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
