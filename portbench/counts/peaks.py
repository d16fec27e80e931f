"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W power limit).  The kernels counted here compute in float32 on
the CUDA cores, so their operations are held to the float32 rate outside
the tensor cores."""

PEAK_FP32 = 67e12      # float32 operations a second, CUDA cores
PEAK_BYTES = 3.35e12   # HBM3 bytes a second


def least_seconds(nbytes: float, flops: float) -> tuple[float, str]:
    """(the least time the card could take for work that moves `nbytes`
    and does `flops` float32 operations, which of the two bounds it)."""
    tb, tf = nbytes / PEAK_BYTES, flops / PEAK_FP32
    return (tb, "bytes") if tb >= tf else (tf, "operations")
