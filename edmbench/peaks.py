"""The card's peaks, and the least time a step's work needs on it,
whatever implements the step: the yardstick of every ``_roofline`` metric.
A kind's ``work`` counts the operations and bytes; this module divides."""

# the H100 SXM's published peaks (NVIDIA data sheet, 700 W): float32
# outside the tensor cores, and HBM3
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def least_seconds(work: dict) -> float:
    """The larger of the operations over the float32 peak and the bytes
    over the memory rate."""
    return max(work["flops"] / PEAK_F32, work["bytes"] / PEAK_BYTES)
