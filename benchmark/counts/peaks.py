"""Published peaks of one NVIDIA H100 SXM at its full 700 W limit (NVIDIA's
data sheet, dense rates): float32 outside the tensor cores, and HBM3.  A
share of them is stated with the card's power limit beside it."""

PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take for the work: the larger of the
    operations over the float32 rate and the bytes over the memory rate,
    and which of the two it is."""
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")
