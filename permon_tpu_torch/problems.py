"""Problem generators of the large-path slice — numpy/scipy copies of
``build_sparse`` and ``assembled_system`` from ``examples/feti_large.py``
(the machine with the card has no JAX, and the example module imports the
JAX package).  The CPU tests hold both array-equal to the originals.

``build_sparse(cells, grid)`` is the 3-D Poisson ex71 configuration
(reference: src/tutorials/feti/ex71.c): Q1 elements on a box of
``cells`` elements, decomposed into ``grid`` subdomains with the DMDA
upper-corner element ownership, x = 0 Dirichlet face eliminated
symmetrically ('assembled' diagonal: each copy gets 1/multiplicity), and
rhs = 1.  The north star is ``build_sparse((100,) * 3, (4,) * 3)``:
101^3 = 1,030,301 dofs in 64 subdomains of <= 26^3 nodes.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .feti.assembly import decompose_rhs_by_multiplicity
from .feti.large import SparseFetiProblem


def _axis_split(M, m):
    base = M // m
    return [base + (1 if i < M % m else 0) for i in range(m)]


def _free_tridiag(n, d, o):
    """Free-free 1-D tridiagonal (d on the diagonal, d/2 at both ends)."""
    diag = np.full(n, float(d))
    diag[0] = diag[-1] = d / 2
    off = np.full(n - 1, float(o))
    return sp.diags([off, diag, off], [-1, 0, 1], shape=(n, n), format="csr")


def _m1d(n):
    """1-D Q1 mass on n nodes, unit elements, free-free."""
    return _free_tridiag(n, 2.0 / 3.0, 1.0 / 6.0)


def _kron3(nx, ny, nz):
    """Q1 stiffness K = Kx (x) My (x) Mz + Mx (x) Ky (x) Mz + Mx (x) My (x) Kz
    on an nx*ny*nz node box, lexicographic with x fastest."""
    Kx, Mxm = _free_tridiag(nx, 2.0, -1.0), _m1d(nx)
    Ky, Mym = _free_tridiag(ny, 2.0, -1.0), _m1d(ny)
    Kz, Mzm = _free_tridiag(nz, 2.0, -1.0), _m1d(nz)
    return (
        sp.kron(sp.kron(Mzm, Mym), Kx)
        + sp.kron(sp.kron(Mzm, Ky), Mxm)
        + sp.kron(sp.kron(Kz, Mym), Mxm)
    ).tocsr()


def _eliminate(K, fixed, diag_vals):
    """Symmetric elimination: zero rows/columns ``fixed`` and put
    ``diag_vals`` on their diagonal (vectorized form of the lil loop)."""
    n = K.shape[0]
    keep = np.ones(n)
    keep[fixed] = 0.0
    D = sp.diags(keep)
    fix = np.zeros(n)
    fix[fixed] = diag_vals
    return ((D @ K @ D) + sp.diags(fix)).tocsr()


def build_sparse(cells=(24, 24, 24), grid=(2, 2, 2)) -> SparseFetiProblem:
    """SparseFetiProblem of the 3-D Poisson ex71 configuration at scale
    (examples/feti_large.py:48-136)."""
    cx, cy, cz = cells
    m, n, p = grid
    Mx, My, Mz = cx + 1, cy + 1, cz + 1
    ox = np.concatenate([[0], np.cumsum(_axis_split(Mx, m))])
    oy = np.concatenate([[0], np.cumsum(_axis_split(My, n))])
    oz = np.concatenate([[0], np.cumsum(_axis_split(Mz, p))])

    def node_range(o, r, last, M):
        lo = o[r] - 1 if r > 0 else 0
        hi = o[r + 1] - 1 if r < last - 1 else M - 1
        return lo, hi  # inclusive node ids

    def box_gids(x0, x1, y0, y1, z0, z1):
        gx = np.arange(x0, x1 + 1)
        gy = np.arange(y0, y1 + 1)
        gz = np.arange(z0, z1 + 1)
        return ((gz[:, None, None] * My + gy[None, :, None]) * Mx
                + gx[None, None, :]).reshape(-1)

    ns = m * n * p
    boxes = [
        node_range(ox, im, m, Mx) + node_range(oy, jn, n, My) + node_range(oz, kp, p, Mz)
        for kp in range(p) for jn in range(n) for im in range(m)
    ]
    mult = np.zeros(Mx * My * Mz)
    for bx in boxes:
        np.add.at(mult, box_gids(*bx), 1.0)
    nl = max((x1 - x0 + 1) * (y1 - y0 + 1) * (z1 - z0 + 1)
             for (x0, x1, y0, y1, z0, z1) in boxes)

    l2g = np.full((ns, nl), -1, dtype=np.int64)
    b_loc = np.zeros((ns, nl))
    fixed_any = np.zeros(ns, dtype=bool)
    K_cache: dict = {}
    K_blocks = []
    for s, bx in enumerate(boxes):
        x0, x1, y0, y1, z0, z1 = bx
        nx, ny, nz = x1 - x0 + 1, y1 - y0 + 1, z1 - z0 + 1
        nn = nx * ny * nz
        if (nx, ny, nz) not in K_cache:
            K_cache[(nx, ny, nz)] = _kron3(nx, ny, nz)
        K = K_cache[(nx, ny, nz)]
        gids = box_gids(*bx)
        l2g[s, :nn] = gids
        b_loc[s, :nn] = 1.0 / mult[gids]
        if x0 == 0:  # x=0 Dirichlet face: symmetric elimination
            fixed_any[s] = True
            loc_fixed = np.flatnonzero(gids % Mx == 0)
            K = _eliminate(K, loc_fixed, 1.0 / mult[gids[loc_fixed]])
        if nn < nl:  # unit diagonal on padding
            K = sp.block_diag([K, sp.identity(nl - nn)], format="csr")
        K_blocks.append(K)

    b_loc = decompose_rhs_by_multiplicity(b_loc, l2g)
    return SparseFetiProblem(K_blocks=K_blocks, b_loc=b_loc, l2g=l2g, floating=~fixed_any)


def assembled_system(cells):
    """The assembled global Q1 system (A, b) for verification: the x = 0
    face rows/columns zeroed with a unit diagonal, b = 1 everywhere
    (examples/feti_large.py:359-380)."""
    cx, cy, cz = cells
    Mx, My, Mz = cx + 1, cy + 1, cz + 1
    A = _kron3(Mx, My, Mz)
    N = Mx * My * Mz
    b = np.ones(N)
    fixed = np.flatnonzero(np.arange(N) % Mx == 0)
    return _eliminate(A, fixed, 1.0), b
