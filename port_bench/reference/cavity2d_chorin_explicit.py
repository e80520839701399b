"""Plain reference of the explicit Chorin FD cavity (float64 torch), from
the reference chorin_fd scheme the configuration names. Axis 0 carries
x; the grid is [0, 2]^2 with dx = dy = 2 / (n - 1). A step:

  1. predictor, Adams-Bashforth on advection and diffusion, interior:
       f* = f - dt (3/2 (u f_x + v f_y) - 1/2 (u1 f1_x + v1 f1_y))
              + dt nu (3/2 lap f - 1/2 lap f1),
     with the reference's quirk (`quirk_compat`): f_y takes the axis-0
     difference over 2 dy; then the velocity BC lists;
  2. rhs_c = dx rho dy^2 / dt (u*_i,j - u*_i-1,j)
             + dy rho dx^2 / dt (v*_i,j - v*_i,j-1) on the interior;
  3. red-black SOR from the last p, boundary held:
       p = beta (dy^2 (p_E + p_W) + dx^2 (p_N + p_S) - rhs_c)
           / (2 dx^2 + 2 dy^2) + (1 - beta) p,
     red ((i + j) even) cells, then black; err = max|dp| of a sweep,
     starting at err = 1, it = 1, and sweeping while err > tol and
     it < nit. The gate is read every `sor_gate_every` sweeps (the JAX
     package's packed tiled solve reads it every 8; its one-block solve
     every sweep); each member of a batch has its own gate;
  4. the p BC list; 5. u = u* - dt / (2 dx) (p_E - p_W), v likewise in y,
     on the interior.

BC lists come from the configuration file, applied in list order. With
`rounding='bf16'` (the control) every field and operation is bfloat16.
"""

from __future__ import annotations

import torch


def _apply(a: torch.Tensor, bcs, dx: float, dy: float) -> torch.Tensor:
    a = a.clone()
    for kind, value, side in bcs:
        h = dx if side in ("left", "right") else dy
        # edge, inner neighbour, sign of the Neumann offset
        edge, inner, sign = {"left": (0, 1, -1), "right": (-1, -2, 1),
                             "bottom": (0, 1, -1), "top": (-1, -2, 1)}[side]
        ix = ((Ellipsis, edge, slice(None)), (Ellipsis, inner, slice(None)))
        if side in ("bottom", "top"):
            ix = ((Ellipsis, slice(None), edge), (Ellipsis, slice(None), inner))
        a[ix[0]] = (value if kind == "dirichlet"
                    else a[ix[1]] + sign * h * value)
    return a


def _predict(f, f1, u, v, u1, v1, dt, dx, dy, nu, quirk):
    E = (Ellipsis, slice(2, None), slice(1, -1))
    W = (Ellipsis, slice(None, -2), slice(1, -1))
    N = (Ellipsis, slice(1, -1), slice(2, None))
    S = (Ellipsis, slice(1, -1), slice(None, -2))
    C = (Ellipsis, slice(1, -1), slice(1, -1))

    def grads(g):
        gx = (g[E] - g[W]) / (2.0 * dx)
        gy = (g[E] - g[W]) / (2.0 * dy) if quirk else (g[N] - g[S]) / (2.0 * dy)
        lap = ((g[E] - 2 * g[C] + g[W]) / dx ** 2
               + (g[N] - 2 * g[C] + g[S]) / dy ** 2)
        return gx, gy, lap

    fx, fy, lap = grads(f)
    f1x, f1y, lap1 = grads(f1)
    out = f.clone()
    out[C] = (f[C] - dt * (1.5 * (u[C] * fx + v[C] * fy)
                           - 0.5 * (u1[C] * f1x + v1[C] * f1y))
              + dt * nu * (1.5 * lap - 0.5 * lap1))
    return out


def _sor(p, rhs, dx, dy, beta, tol, nit, every):
    n1, n2 = p.shape[-2:]
    i = torch.arange(n1, device=p.device)[:, None]
    j = torch.arange(n2, device=p.device)[None, :]
    red = ((i + j) % 2 == 0)[1:-1, 1:-1]
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 * (dx2 + dy2)
    C = (Ellipsis, slice(1, -1), slice(1, -1))
    rc = rhs[C]

    def half(p, colour):
        new = (beta * (dy2 * (p[..., 2:, 1:-1] + p[..., :-2, 1:-1])
                       + dx2 * (p[..., 1:-1, 2:] + p[..., 1:-1, :-2]) - rc)
               / denom + (1.0 - beta) * p[C])
        q = p.clone()
        q[C] = torch.where(colour, new, p[C])
        return q

    tol = torch.tensor(tol, dtype=p.dtype).item()
    err = torch.ones(p.shape[:-2], dtype=p.dtype, device=p.device)
    it = 1
    while it < nit:
        open_ = err > tol
        if not bool(open_.any()):
            break
        q = p
        for _ in range(every):
            prev = q
            q = half(half(q, red), ~red)
        d = (q - prev).abs().amax(dim=(-2, -1))
        err = torch.where(open_, d, err)
        p = torch.where(open_[..., None, None], q, p)
        it += every
    return p


def solve(cell, inputs: dict, rounding: str | None = None) -> dict:
    """Final (u, v, p) of one job (float64; bfloat16 under the control),
    on the inputs' device."""
    c, t = cell.config, cell.traffic
    dtype = {None: torch.float64, "bf16": torch.bfloat16}[rounding]
    n = t["n"]
    dx = dy = 2.0 / (n - 1)
    dt, nu, rho, beta = t["dt"], t["nu"], c["rho"], c["beta"]
    quirk = c["quirk_compat"]
    bc = lambda a, key: _apply(a, c[key], dx, dy)
    u = bc(inputs["u0"].to(dtype), "u_bc")
    v = bc(inputs["v0"].to(dtype), "v_bc")
    p = bc(inputs["p0"].to(dtype), "p_bc")
    u1, v1 = u, v
    C = (Ellipsis, slice(1, -1), slice(1, -1))
    for _ in range(t["nt_job"]):
        us = bc(_predict(u, u1, u, v, u1, v1, dt, dx, dy, nu, quirk), "u_bc")
        vs = bc(_predict(v, v1, u, v, u1, v1, dt, dx, dy, nu, quirk), "v_bc")
        rhs = torch.zeros_like(us)
        rhs[C] = (dx * rho * dy ** 2 / dt * (us[C] - us[..., :-2, 1:-1])
                  + dy * rho * dx ** 2 / dt * (vs[C] - vs[..., 1:-1, :-2]))
        p = bc(_sor(p, rhs, dx, dy, beta, c["sor_tol"], c["nit"],
                    t["sor_gate_every"]), "p_bc")
        un, vn = us.clone(), vs.clone()
        un[C] = us[C] - dt / (2.0 * dx) * (p[..., 2:, 1:-1] - p[..., :-2, 1:-1])
        vn[C] = vs[C] - dt / (2.0 * dy) * (p[..., 1:-1, 2:] - p[..., 1:-1, :-2])
        u1, v1, u, v = u, v, un, vn
    return {"u": u, "v": v, "p": p}


def numbers(got: dict, ref: dict) -> dict:
    """max|got - ref| / max|ref| of each final field, the worst member of
    a batch."""
    out = {}
    for k in ("u", "v", "p"):
        g = got[k].to(torch.float64).to(ref[k].device)
        r = ref[k].to(torch.float64)
        if r.dim() == 2:
            g, r = g[None], r[None]
        gap = (g - r).abs().amax(dim=(-2, -1))
        scale = r.abs().amax(dim=(-2, -1))
        out[k] = float((gap / scale).max())
    return out
