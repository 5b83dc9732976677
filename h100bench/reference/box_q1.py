"""Plain reference of the box configurations, in NumPy and SciPy (float64).

It builds, from the configuration file alone, the assembled operator of the
3-D Poisson problem on a box of ``cells`` unit Q1 elements: trilinear
elements, so the stiffness is the tensor sum of the 1-D stiffness and mass
matrices, nodes numbered x fastest.  The x = 0 face is clamped: its rows and
columns are zeroed and given a unit diagonal, so there the answer equals the
load.

It judges an answer x of the load f by what the answer says: the relative
residual ||A x - f|| / ||f||.

Nothing here imports the program under test.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _stiffness_1d(n: int) -> sp.csr_matrix:
    """Linear elements of unit length on n nodes, both ends free."""
    d = np.full(n, 2.0)
    d[[0, -1]] = 1.0
    o = np.full(n - 1, -1.0)
    return sp.diags([o, d, o], [-1, 0, 1], format="csr")


def _mass_1d(n: int) -> sp.csr_matrix:
    d = np.full(n, 4.0 / 6.0)
    d[[0, -1]] = 2.0 / 6.0
    o = np.full(n - 1, 1.0 / 6.0)
    return sp.diags([o, d, o], [-1, 0, 1], format="csr")


def assembled_operator(cells) -> sp.csr_matrix:
    """The clamped Q1 Laplacian on (cells[0]+1) x (cells[1]+1) x (cells[2]+1)
    nodes, x fastest."""
    Mx, My, Mz = (c + 1 for c in cells)
    Kx, Ky, Kz = (_stiffness_1d(M) for M in (Mx, My, Mz))
    Mxm, Mym, Mzm = (_mass_1d(M) for M in (Mx, My, Mz))
    A = (sp.kron(Mzm, sp.kron(Mym, Kx)) + sp.kron(Mzm, sp.kron(Ky, Mxm))
         + sp.kron(Kz, sp.kron(Mym, Mxm))).tocsr()
    clamped = np.arange(A.shape[0]) % Mx == 0
    keep = sp.diags((~clamped).astype(float))
    return (keep @ A @ keep + sp.diags(clamped.astype(float))).tocsr()


class Reference:
    """The reference of one configuration: ``check(f, x)`` gives the numbers
    that are compared."""

    def __init__(self, config: dict):
        self.A = assembled_operator(tuple(config["problem"]["cells"]))

    def check(self, f: np.ndarray, x: np.ndarray) -> dict:
        x = np.asarray(x, dtype=np.float64)
        if x.shape != f.shape or not np.isfinite(x).all():
            return {"residual": float("inf")}
        return {"residual": float(np.linalg.norm(self.A @ x - f) / np.linalg.norm(f))}
