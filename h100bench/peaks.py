"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet,
dense rates without sparsity, at the full 700 W power limit.  A run prints
the card's power limit beside every share of these peaks."""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float64": 34e12, "float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
               "float16": 989e12}
#: bytes per element
ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2, "int32": 4, "int64": 8}


def least_seconds(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the card could take for the work: the larger of its
    bytes over the HBM rate and its operations over the dtype's peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S[dtype])
