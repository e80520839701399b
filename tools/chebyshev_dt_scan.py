#!/usr/bin/env python3
"""Scan the time step of the corrected Chebyshev lid cavity on the CPU.

For each dt: the port's corrected chorin_spectral cavity (the run_solver
preset's BCs, nu 0.1, the parity engine from 194^2) runs `--nt` steps in
float64 and in float32 on the CPU. Printed per run: max|u| every tenth
step (finite and bounded means the step survives), and the final state's
interior divergence D[1:-1,:] u[:,1:-1] + v[1:-1,:] D[1:-1,:]^T split
into its max and its max outside the pressure modes the solver deflates
(|lx + ly| <= 1e-8 max, the JAX package's rule): the projection removes
every other mode, so that part is rounding. With --jax the JAX package
runs the same float64 steps (`--jax-nt` of them) and the largest
difference to the port is printed relative to each field's max.

    python tools/chebyshev_dt_scan.py --n 1024 --nt 20 1e-3 1e-5 1e-6
    python tools/chebyshev_dt_scan.py --n 1024 --nt 5 --jax 1e-6

CPU only (set the threads with --threads); one JSON line per run.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ns_tpu_torch.cli.run_solver import cavity_bcs  # noqa: E402
from ns_tpu_torch.ops import cheb, parity  # noqa: E402
from ns_tpu_torch.solvers import chorin_spectral as cs  # noqa: E402


def divergence_split(u, v, n: int):
    """(max|div|, max|div outside the deflated pressure modes|, number of
    deflated modes), in float64."""
    D = torch.as_tensor(cheb.d_matrix(n, quirk_compat=False))
    M = cheb.d_matrix(n, False)[1:-1, 1:-1] @ cheb.d_matrix_pn_minus_2(n,
                                                                      False)
    pe = parity.ParityEig(M, "pressure", torch.float64, device="cpu")
    p2 = parity.ParityEig2D(pe, pe)
    den = p2.full_recip(p2.denoms(lambda lx, ly: lx + ly))
    keep = den.abs() > 1e-8 * den.abs().max()
    u, v = u.double(), v.double()
    div = D[1:-1, :] @ u[:, 1:-1] + v[1:-1, :] @ D[1:-1, :].T
    G = pe.forward(pe.forward(div, -2), -1)
    res = pe.inverse(pe.inverse(G * keep, -1), -2)
    return (float(div.abs().max()), float(res.abs().max()),
            int((~keep).sum()))


def port_run(n: int, nt: int, dt: float, dtype):
    u_bc, v_bc, _ = cavity_bcs(2.0 / (n - 1), 2.0 / (n - 1))
    z = np.zeros((n, n))
    t0 = time.perf_counter()
    sys_ = cs.NavierStokesSystem(z, z, z, u_bc, v_bc, nt=nt, nx=n, ny=n,
                                 dt=dt, nu=0.1, quirk_compat=False,
                                 dtype=dtype, device="cpu")
    setup = time.perf_counter() - t0
    u, v, p = sys_.simulate()
    return sys_, (u, v, p), setup, time.perf_counter() - t0 - setup


def jax_run(n: int, nt: int, dt: float):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from ns_tpu.cli.run_solver import cavity_bcs as j_cavity_bcs
    from ns_tpu.solvers import chorin_spectral as jcs

    u_bc, v_bc, _ = j_cavity_bcs(2.0 / (n - 1), 2.0 / (n - 1))
    z = np.zeros((n, n))
    sys_ = jcs.NavierStokesSystem(z, z, z, u_bc, v_bc, nt=nt, nx=n, ny=n,
                                  dt=dt, nu=0.1, quirk_compat=False,
                                  dtype=jnp.float64)
    return [np.asarray(a) for a in sys_.simulate()]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dts", nargs="+", type=float)
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--nt", type=int, default=20)
    p.add_argument("--jax", action="store_true")
    p.add_argument("--threads", type=int, default=4)
    args = p.parse_args(argv)
    torch.set_num_threads(args.threads)
    for dt in args.dts:
        for dtype in (torch.float64, torch.float32):
            sys_, (u, v, p_), setup, secs = port_run(args.n, args.nt, dt,
                                                     dtype)
            dmax, res, n_defl = divergence_split(u[-1], v[-1], args.n)
            row = {"n": args.n, "nt": args.nt, "dt": dt,
                   "dtype": str(dtype).split(".")[-1],
                   "parity_split": sys_._step.parity_split,
                   "setup_s": setup, "steps_s": secs,
                   "finite": bool(all(torch.isfinite(a).all()
                                      for a in (u, v, p_))),
                   "max_abs_u_every_tenth": [
                       float(u[i].abs().max())
                       for i in range(0, args.nt, max(1, args.nt // 10))],
                   "div_max": dmax, "div_outside_deflated_max": res,
                   "deflated_modes": n_defl}
            if args.jax and dtype == torch.float64:
                want = jax_run(args.n, args.nt, dt)
                row["vs_jax_max_rel"] = {
                    k: float(np.abs(a.numpy() - b).max() / np.abs(b).max())
                    for k, a, b in zip("uvp", (u, v, p_), want)}
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
