"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
no sparsity), at the full 700 W power limit. Every roofline and MFU of
the benchmark is a share of these."""

BF16_FLOPS = 989e12  # tensor cores, bf16 and fp16
F32_FLOPS = 67e12  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, flops_per_s: float = BF16_FLOPS) -> float:
    """The least time the chip could take for work of `flops` operations
    moving `nbytes` bytes: the larger of the two rooflines."""
    return max(flops / flops_per_s, nbytes / HBM_BYTES_PER_S)
