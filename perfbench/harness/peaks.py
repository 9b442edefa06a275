"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W limit): the yardstick of every roofline and mfu share."""

PEAK_F32_FLOPS = 67e12        # f32 on the CUDA cores
PEAK_BF16_FLOPS = 989e12      # bf16 on the tensor cores
PEAK_BYTES_S = 3.35e12        # HBM3


def bound_s(ops: float, nbytes: float) -> float:
    """The least time f32 work of ``ops`` operations over ``nbytes``
    bytes can take: the larger of its two bounds."""
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S)
