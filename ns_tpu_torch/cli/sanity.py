"""Chebyshev transform sanity check: port of `ns_tpu/cli/sanity.py` (the
reference's sanity.py as an asserting CLI), on the port's copy of the
operators (`ns_tpu_torch/ops/cheb.py`).

Checks, for the requested N:
  1. quirked (reference) transform pair round-trip error on a smooth field
     (expected ~0.1 relative: documented reference behaviour)
  2. corrected transform pair is an exact inverse (to ~1e-10)
  3. corrected D differentiates polynomials to spectral accuracy

Usage: python -m ns_tpu_torch.cli.sanity [--n 51]
"""

import argparse

import numpy as np

from ns_tpu_torch.ops import cheb


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=51)
    args = p.parse_args(argv)
    N = args.n

    x = cheb.gauss_lobatto(N)
    X, Y = np.meshgrid(x, x, indexing="ij")
    U = np.exp(-(X**2 + Y**2))

    T = cheb.t_matrix(N)
    for quirk, bound in ((True, 0.25), (False, 1e-9)):
        Ti = cheb.inv_t_matrix(N, quirk_compat=quirk)
        rel = np.linalg.norm(U - T @ (Ti @ U)) / np.linalg.norm(U)
        tag = "reference(quirked)" if quirk else "corrected"
        status = "ok" if rel < bound else "FAIL"
        print(f"round-trip {tag:>18}: rel err {rel:.3e}  [{status}]")
        assert rel < bound, f"{tag} round-trip out of bound"

    D = cheb.d_matrix(N, quirk_compat=False)
    f = x**3 - 2 * x
    err = np.abs(D @ f - (3 * x**2 - 2)).max()
    print(f"corrected D on cubic   : max err {err:.3e}  "
          f"[{'ok' if err < 1e-8 else 'FAIL'}]")
    assert err < 1e-8
    print("sanity: all checks passed")


if __name__ == "__main__":
    main()
