"""K8 (`fused_lamb`): (6, nx, Ry, Kzc) complex64 (u, omega) after the
x-inverse -> (3, nx, Ry, Kzc) complex64 u x omega before the x-forward.

Its function, per x-plane: six inverse 2D real transforms of ny x nz
points (y, then z), the cross product (6 multiplies and 3 subtractions a
point), three forward 2D real transforms. Bytes: the input and the output
once each, and the four DFT tables (Fyi_t (ny, Ry), Bz (Kzc, nz), Fz_t
(Kzc, nz), Fy_t (Ry, ny), complex64) once.
"""

from port_bench.counts.fft import real_transform_flops

COMPLEX64 = 8


def count(nx: int, ny: int, nz: int, ry: int, kzc: int):
    """(flops, bytes) of one call."""
    plane = ny * nz
    flops = nx * (9 * real_transform_flops(plane) + 9 * plane)
    spectra = (6 + 3) * nx * ry * kzc * COMPLEX64
    tables = (2 * ny * ry + 2 * kzc * nz) * COMPLEX64
    return flops, spectra + tables
