"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the card's full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12      # HBM3 bandwidth
F32_FLOPS = 67e12              # float32 outside the tensor cores


def least_seconds(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """The least time the card could take for ``n_bytes`` moved and
    ``n_flops`` of float32 work, and which of the two bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_flops = n_flops / F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "flops")
