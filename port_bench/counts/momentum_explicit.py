"""K3 (`momentum_explicit_fused`): AB2 advection and diffusion of (u, v)
on the interior plus the BC edges, for `members` grids of nx x ny.

Operations, per field and interior cell, as the stencil needs them: four
centred differences (a subtraction and a scaling each: 8), two 5-point
Laplacians (9 each: 18), the two advection products with their 3/2 and
1/2 weights and dt (10), the diffusion's weights and dt nu (4), and the
update (2): 42; 84 for the pair. Bytes: u, v, u_prev, v_prev read once and
u*, v* written once.
"""

FLOPS_PER_CELL = 84
FIELDS_READ, FIELDS_WRITTEN = 4, 2


def count(nx: int, ny: int, members: int = 1, itemsize: int = 4):
    """(flops, bytes) of one call."""
    flops = FLOPS_PER_CELL * (nx - 2) * (ny - 2) * members
    nbytes = (FIELDS_READ + FIELDS_WRITTEN) * nx * ny * members * itemsize
    return flops, nbytes
