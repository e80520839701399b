"""One IF-AB2 step of the 3D DNS on the compact matmul engine's carry.

Work: nine real 3D transforms of nx ny nz points (six inverse, of u and
omega; three forward, of u x omega), counted FFT-equivalent, and the
cross product (9 operations a point). Bytes: the carry read and written
once: u_hat and N_prev in, u_new and N out, each a complex64 spectrum of
3 x Rx x Ry x Kzc (Rx, Ry the rows with |k| < n/3, Kzc those with
0 <= k_z < nz/3).
"""

from port_bench.counts.fft import real_transform_flops

COMPLEX64 = 8


def kept(n: int, half: bool) -> int:
    """Rows the 2/3 rule keeps along an axis of n points."""
    ks = range(n // 2 + 1) if half else [k if k <= n // 2 else k - n
                                          for k in range(n)]
    return sum(1 for k in ks if abs(k) < n / 3)


def count(nx: int, ny: int, nz: int):
    """(flops, bytes) of one step."""
    points = nx * ny * nz
    flops = 9 * real_transform_flops(points) + 9 * points
    field = 3 * kept(nx, False) * kept(ny, False) * kept(nz, True) * COMPLEX64
    return flops, 4 * field
