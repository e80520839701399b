"""The FFT-equivalent operation count: 2.5 n log2 n for a real transform
of n points (half the 5 n log2 n of a complex one). A roofline counted so
reads the same work whatever implements the transform (dense DFT GEMMs,
fused kernels or cuFFT)."""

import math


def real_transform_flops(n_points: int) -> float:
    return 2.5 * n_points * math.log2(n_points)
