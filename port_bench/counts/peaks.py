"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the card's full 700 W limit; a card set lower runs slower under load, so a
share is stated with the card's `power.limit` beside it)."""

FLOPS = {
    "bf16": 989e12,   # tensor cores, fp32 accumulation
    "tf32": 495e12,   # tensor cores
    "fp32": 67e12,    # CUDA cores
}
HBM_BYTES_PER_S = 3.35e12

# the fastest arithmetic each GEMM precision of the port admits:
# 'default' takes bf16 inputs; 'high' and 'highest' keep fp32 accuracy,
# which no tensor-core type faster than TF32 gives
BY_PRECISION = {"default": "bf16", "high": "tf32", "highest": "tf32"}


def least_seconds(flops: float, nbytes: float, arithmetic: str):
    """(least seconds, which bound sets it): the larger of the operations
    at the peak of `arithmetic` and the bytes at the HBM bandwidth."""
    t_ops, t_bytes = flops / FLOPS[arithmetic], nbytes / HBM_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
