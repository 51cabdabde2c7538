"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the 700 W
power limit) and the least time a piece of work can take on it."""

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}


def least_seconds(n_bytes: float, n_ops: float, dtype: str = "bfloat16") -> float:
    """The larger of the bytes over the memory bandwidth and the operations
    over the dtype's peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[dtype])
