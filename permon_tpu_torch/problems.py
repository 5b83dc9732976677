"""Problem generators — numpy/scipy copies of the ones the examples and
``bench.py`` of the JAX package keep (the machine with the card has no
JAX, and those modules import the JAX package).  The CPU tests hold each
array-equal to its original.

Large path: ``build_sparse``, ``build_obstacle`` (its contact variant) and
``assembled_system`` from ``examples/feti_large.py``; the 3-D Q1 elasticity
family ``build_sparse_elasticity``, ``build_obstacle_elasticity`` (the
north-star problem class: 3-D TFETI contact) and
``assembled_elasticity_system`` from the same file, with
``q1_elasticity_emat`` from ``examples/feti_ex71.py`` and
``assembled_residual_free`` from ``scripts/northstar_elasticity.py``;
``build_contact`` (the 1-D semicoercive obstacle problem with Dirichlet
rows) from ``examples/feti_contact.py``.  Dense path (``FetiProblem``):
``build_feti_ex1`` (examples/feti_ex1.py), ``build_ex71`` with
``q1_poisson_emat`` (examples/feti_ex71.py: Poisson and elasticity in 1-3
D, every Dirichlet diagonal convention) and ``build_feti_contact``
(examples/feti_contact.py).  General QP path: ``build_ex1`` / ``build_ex2``
(the 1-D obstacle tutorials), ``build_jbearing`` (MINPACK-2 DPJB journal
bearing), ``rcm_permuted`` (reverse Cuthill-McKee reordering of a QP, which
turns a stencil Hessian into the unstructured pattern of a real mesh) and
``laplacian_3d_rcm`` (the unstructured SpMV matrix of ``bench.py``).
SVM: ``make_blobs`` (examples/svm.py) and ``make_a9a_like`` (data of the
shape of LIBSVM's a9a, synthetic).

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

from .core.extension import SubdomainExtension
from .feti.assembly import FetiProblem, decompose_rhs_by_multiplicity
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
    boxes, (Mx, My, Mz) = _dmda_boxes(cells, grid)
    ns = len(boxes)

    mult = np.zeros(Mx * My * Mz)
    for bx in boxes:
        np.add.at(mult, _box_gids(bx, Mx, My), 1.0)
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
        gids = _box_gids(bx, Mx, My)
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


def _dmda_boxes(cells, grid):
    """The subdomain node boxes (x0, x1, y0, y1, z0, z1), inclusive, of the
    DMDA upper-corner element ownership (owned nodes plus one LOWER ghost
    layer), x fastest over the process grid; and (Mx, My, Mz)."""
    Ms = tuple(c + 1 for c in cells)
    offs = [np.concatenate([[0], np.cumsum(_axis_split(M, g))]) for M, g in zip(Ms, grid)]

    def node_range(o, r, last, M):
        lo = o[r] - 1 if r > 0 else 0
        hi = o[r + 1] - 1 if r < last - 1 else M - 1
        return lo, hi

    m, n, p = grid
    boxes = [
        node_range(offs[0], im, m, Ms[0]) + node_range(offs[1], jn, n, Ms[1])
        + node_range(offs[2], kp, p, Ms[2])
        for kp in range(p) for jn in range(n) for im in range(m)
    ]
    return boxes, Ms


def _box_gids(box, Mx, My):
    x0, x1, y0, y1, z0, z1 = box
    gx, gy, gz = np.arange(x0, x1 + 1), np.arange(y0, y1 + 1), np.arange(z0, z1 + 1)
    return ((gz[:, None, None] * My + gy[None, :, None]) * Mx + gx[None, None, :]).reshape(-1)


def q1_elasticity_emat(dim: int, lam: float = 1.0, mu: float = 1.0) -> np.ndarray:
    """Q1 isotropic elasticity element stiffness on the unit cube, nodes in
    lexicographic order (x fastest), dofs blocked per node, 2-point Gauss
    quadrature (examples/feti_ex71.py:29-82).  With lam = mu = 1 these are
    the reference's hardcoded elast_{1,2,3}D_emat tables (ex71.c:26-99)."""
    import itertools

    gp = np.array([-1.0, 1.0]) / np.sqrt(3.0) * 0.5 + 0.5
    nodes = [tuple(reversed(t)) for t in itertools.product((0, 1), repeat=dim)]
    nn = len(nodes)
    nstr = {1: 1, 2: 3, 3: 6}[dim]
    D = np.zeros((nstr, nstr))
    if dim == 1:
        D[0, 0] = lam + 2 * mu
    else:
        D[:dim, :dim] = lam
        for d in range(dim):
            D[d, d] = lam + 2 * mu
        for d in range(dim, nstr):
            D[d, d] = mu
    # strain rows: (row, displacement component, derivative direction)
    strain = {1: [(0, 0, 0)],
              2: [(0, 0, 0), (1, 1, 1), (2, 0, 1), (2, 1, 0)],
              3: [(0, 0, 0), (1, 1, 1), (2, 2, 2), (3, 0, 1), (3, 1, 0), (4, 1, 2), (4, 2, 1),
                  (5, 0, 2), (5, 2, 0)]}[dim]
    K = np.zeros((nn * dim, nn * dim))
    for q in itertools.product(range(2), repeat=dim):
        x = np.array([gp[qi] for qi in q])
        dN = np.zeros((nn, dim))
        for a, nd in enumerate(nodes):
            for d in range(dim):
                prod = 1.0
                for e in range(dim):
                    val = x[e] if nd[e] == 1 else 1.0 - x[e]
                    der = 1.0 if nd[e] == 1 else -1.0
                    prod *= der if e == d else val
                dN[a, d] = prod
        B = np.zeros((nstr, nn * dim))
        for a in range(nn):
            for row, comp, direction in strain:
                B[row, a * dim + comp] = dN[a, direction]
        K += (1.0 / 2**dim) * B.T @ D @ B
    return K


def _q1_elasticity_box(nx, ny, nz, emat):
    """Q1 elasticity stiffness of an nx*ny*nz node box, 3 dofs per node,
    node-major interleaved, all (nx-1)(ny-1)(nz-1) elements at once."""
    dof = 3
    dxyz = np.array([(a & 1, (a >> 1) & 1, (a >> 2) & 1) for a in range(8)])
    ei, ej, ek = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1),
                             indexing="ij")
    orig = (ek.ravel() * ny + ej.ravel()) * nx + ei.ravel()  # (ne,)
    corner = orig[:, None] + (dxyz[:, 2] * ny + dxyz[:, 1]) * nx + dxyz[:, 0]  # (ne, 8)
    edofs = (dof * corner[:, :, None] + np.arange(dof)[None, None, :]).reshape(-1, 24)
    rows = np.repeat(edofs, 24, axis=1).ravel()
    cols = np.tile(edofs, (1, 24)).ravel()
    vals = np.tile(emat.ravel(), edofs.shape[0])
    n = nx * ny * nz * dof
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()


def build_sparse_elasticity(cells=(16, 16, 16), grid=(2, 2, 2), lam: float = 1.0,
                            mu: float = 1.0) -> SparseFetiProblem:
    """Sparse 3-D Q1 ELASTICITY analog of :func:`build_sparse` (the ex71
    ``-pde_type Elasticity`` configuration at scale; examples/feti_large.py:
    139-243).  Same decomposition as :func:`build_sparse`; 3 dofs per node,
    node-major interleaved (dof = 3*node + c), so the subdomain bandwidth
    stays 3*(nx*ny + nx + 1) + 2 and FLAT boxes keep the band block small.
    TFETI convention: ALL subdomains are floating (6 rigid-body modes from
    the nodal coordinates) and the clamped x = 0 face is returned as
    ``dirichlet`` global dof ids for the large path to enforce, by B rows
    or by elimination in the Hessian.  The rhs is the assembled unit load
    on every dof.  Boxes of one shape share ONE stiffness matrix object."""
    dof = 3
    emat = q1_elasticity_emat(3, lam=lam, mu=mu)  # (24, 24), x-fastest nodes
    boxes, (Mx, My, Mz) = _dmda_boxes(cells, grid)
    ns = len(boxes)
    mult = np.zeros(Mx * My * Mz)
    for bx in boxes:
        np.add.at(mult, _box_gids(bx, Mx, My), 1.0)
    nn_max = max((x1 - x0 + 1) * (y1 - y0 + 1) * (z1 - z0 + 1)
                 for (x0, x1, y0, y1, z0, z1) in boxes)
    nl = nn_max * dof
    l2g = np.full((ns, nl), -1, dtype=np.int64)
    b_loc = np.zeros((ns, nl))
    coords = np.zeros((ns, nn_max, 3))
    K_cache: dict = {}
    K_blocks = []
    for s, bx in enumerate(boxes):
        x0, x1, y0, y1, z0, z1 = bx
        nx, ny, nz = x1 - x0 + 1, y1 - y0 + 1, z1 - z0 + 1
        nn = nx * ny * nz
        gids = _box_gids(bx, Mx, My)
        l2g[s, : nn * dof] = (dof * gids[:, None] + np.arange(dof)).ravel()
        coords[s, :nn, 0] = np.tile(np.arange(x0, x1 + 1), ny * nz)
        coords[s, :nn, 1] = np.tile(np.repeat(np.arange(y0, y1 + 1), nx), nz)
        coords[s, :nn, 2] = np.repeat(np.arange(z0, z1 + 1), nx * ny)
        if (nx, ny, nz) not in K_cache:
            K = _q1_elasticity_box(nx, ny, nz, emat)
            if nn * dof < nl:  # unit diagonal on padding
                K = sp.block_diag([K, sp.identity(nl - nn * dof)], format="csr")
            K_cache[(nx, ny, nz)] = K
        K_blocks.append(K_cache[(nx, ny, nz)])
        # each copy carries 1/multiplicity so the copy-sum is 1 (node
        # multiplicity == dof multiplicity in the interleaved layout)
        b_loc[s, : nn * dof] = 1.0 / np.repeat(mult[gids], dof)

    b_loc = decompose_rhs_by_multiplicity(b_loc, l2g)
    # clamped x = 0 face: all 3 components of every x = 0 node, GLOBAL dof ids
    fixed_nodes = np.arange(My * Mz) * Mx
    dirichlet = (dof * fixed_nodes[:, None] + np.arange(dof)).ravel()
    return SparseFetiProblem(
        K_blocks=K_blocks, b_loc=b_loc, l2g=l2g, floating=np.ones(ns, dtype=bool),
        dirichlet=dirichlet, dirichlet_numtype="global_undecomposed", coords=coords)


def assembled_elasticity_system(cells, lam: float = 1.0, mu: float = 1.0):
    """The globally assembled elasticity system (K, b) for verification: the
    same Q1 assembly on the undecomposed grid, the x = 0 face eliminated
    symmetrically (rows and columns zeroed, unit diagonal, rhs value 0)."""
    Mx, My, Mz = (c + 1 for c in cells)
    K = _q1_elasticity_box(Mx, My, Mz, q1_elasticity_emat(3, lam=lam, mu=mu))
    b = np.ones(K.shape[0])
    fixed = (3 * (np.arange(My * Mz) * Mx)[:, None] + np.arange(3)).ravel()
    b[fixed] = 0.0
    return _eliminate(K, fixed, 1.0), b


def build_obstacle_elasticity(cells=(16, 16, 16), grid=(2, 2, 2), gap=None,
                              lam: float = 1.0, mu: float = 1.0):
    """Elastic CONTACT variant of :func:`build_sparse_elasticity`, the
    north-star problem class (3-D TFETI contact; examples/feti_large.py:
    281-319): the body is clamped at x = 0, loaded by the unit body force,
    and its far face x = Lx meets a rigid plane at distance ``gap``:
    u_x <= gap for every far-face node (one inequality row on the first
    owning copy of each node's x-dof).  The default gap is 30% of the free
    cantilever's x-stretch scale, so that a contact set forms.

    Returns (prob, BI, cI, gap)."""
    prob = build_sparse_elasticity(cells, grid, lam=lam, mu=mu)
    Mx = cells[0] + 1
    if gap is None:
        # the bar under unit axial body force stretches ~ L^2/(2(lam+2mu))
        gap = 0.3 * (Mx - 1) ** 2 / (2.0 * (lam + 2 * mu))
    g = np.arange(prob.n_global)
    BI, _ = _first_owner_rows(prob.l2g, (g % 3 == 0) & ((g // 3) % Mx == Mx - 1), 1.0)
    return prob, BI, np.full(BI.shape[0], gap), gap


def assembled_apply(prob: SparseFetiProblem, x_global) -> np.ndarray:
    """sum_s scatter(K_s x|_s): the assembled operator applied to a global
    vector, from the decomposed blocks alone (no global assembly).  Blocks
    that are one matrix object are applied together as one
    sparse-times-dense product."""
    x = np.asarray(x_global, dtype=np.float64)
    real = prob.l2g >= 0
    xs = np.where(real, x[np.maximum(prob.l2g, 0)], 0.0)  # (ns, nl)
    ys = np.empty_like(xs)
    groups: dict = {}
    for s, K in enumerate(prob.K_blocks):
        groups.setdefault(id(K), []).append(s)
    for subs in groups.values():
        ys[subs] = (prob.K_blocks[subs[0]] @ xs[subs].T).T
    return np.bincount(prob.l2g[real], weights=ys[real], minlength=prob.n_global)


def assembled_gradient_free(prob: SparseFetiProblem, x_global):
    """(g, free, viol) for the unit load b = 1: g = A x - b on the free
    dofs (0 on the clamped ones) with x zeroed at the clamped dofs, i.e. the
    eliminated system's exact gradient; ``free`` the mask of the free dofs;
    ``viol`` the largest |x| on a clamped dof."""
    fixed = prob.dirichlet_global()
    x = np.array(x_global, dtype=np.float64, copy=True)
    viol = float(np.abs(x[fixed]).max()) if len(fixed) else 0.0
    x[fixed] = 0.0
    free = np.ones(prob.n_global, dtype=bool)
    free[fixed] = False
    return np.where(free, assembled_apply(prob, x) - 1.0, 0.0), free, viol


def assembled_residual_free(prob: SparseFetiProblem, x_global):
    """(||(A_free x - b)|_free|| / ||b|_free||, max |x| on the clamped dofs)
    for the unit load b = 1 (scripts/northstar_elasticity.py:29-52): the
    host check of an elasticity solve that needs no global assembly."""
    g, free, viol = assembled_gradient_free(prob, x_global)
    return float(np.linalg.norm(g) / np.sqrt(free.sum())), viol


def _first_owner_rows(l2g: np.ndarray, wanted: np.ndarray, value: float):
    """One constraint row per global dof g with ``wanted[g]``, on its first
    owning copy in (subdomain, local index) order, rows numbered in that
    order; returns (BI, the global dof of each row).  One stable sort finds
    the first copies (no loop over the ns * nl copies)."""
    ns, nl = l2g.shape
    flat = l2g.reshape(-1)
    cand = np.flatnonzero((flat >= 0) & wanted[np.maximum(flat, 0)])
    order = np.argsort(flat[cand], kind="stable")
    g_sorted = flat[cand][order]
    first = np.concatenate([[True], g_sorted[1:] != g_sorted[:-1]]) if len(cand) else \
        np.zeros(0, dtype=bool)
    cols = np.sort(cand[order[first]])
    mI = len(cols)
    BI = SubdomainExtension.from_coo(np.arange(mI), cols, np.full(mI, float(value)),
                                     m=mI, ns=ns, nl=nl)
    return BI, flat[cols]


def build_obstacle(cells=(24, 24, 24), grid=(2, 2, 2), cap=None):
    """Contact variant of :func:`build_sparse` (examples/feti_large.py:
    322-356): a ceiling u <= cap on the far face (x = Lx) of the Poisson
    box — the membrane pressed against a plane, creating an active contact
    set where the unconstrained solution would exceed the cap.  One
    inequality row per far-face node on its first owning copy.

    Returns (prob, BI, cI, cap)."""
    prob = build_sparse(cells, grid)
    Mx = cells[0] + 1
    if cap is None:
        # the free solution of -u'' = 1, u(0) = 0 grows like x^2/2: cap at
        # a fraction of the far-face scale so contact actually activates
        cap = 0.3 * (Mx - 1) ** 2 / 2.0
    BI, _ = _first_owner_rows(prob.l2g, np.arange(prob.n_global) % Mx == Mx - 1, 1.0)
    return prob, BI, np.full(BI.shape[0], cap), cap


def build_contact(ns: int = 4, ne: int = 25):
    """The decomposed 1-D obstacle problem of tutorial ex1 (examples/
    feti_contact.py:31-78): -u'' = -30, u(0) = u(1) = 0 as a Dirichlet set
    (enforced by rows of BE or in the Hessian), u >= sin(4 pi x - pi/6)/2 - 2
    as inequality rows -u_g <= -lb_g on the first owning copy of each
    interior node; ``ns`` floating subdomains of ``ne`` elements.

    Returns (prob, BI, cI, lb) with ``prob`` a SparseFetiProblem."""
    nl = ne + 1
    n = ns * ne + 1
    h = 1.0 / (n - 1)
    K = _free_tridiag(nl, 2.0, -1.0)
    # element loads -15 h^2 to each end, assembling to the serial ex1 rhs
    # b_i = -30 h^2 at interior nodes; the Dirichlet nodes carry no load
    load = -15.0 * h * h
    b = np.full((ns, nl), load + load)
    b[:, 0] = b[:, -1] = load
    b[0, 0] = b[-1, -1] = 0.0
    l2g = np.arange(ns)[:, None] * ne + np.arange(nl)[None, :]
    prob = SparseFetiProblem(
        K_blocks=[K.copy() for _ in range(ns)], b_loc=decompose_rhs_by_multiplicity(b, l2g),
        l2g=l2g.astype(np.int64), floating=np.ones(ns, dtype=bool),
        dirichlet=np.array([0, n - 1]))
    lb = np.sin(4 * np.pi * np.arange(n) * h - np.pi / 6.0) / 2 - 2
    interior = np.ones(n, dtype=bool)
    interior[[0, n - 1]] = False
    BI, g = _first_owner_rows(l2g, interior, -1.0)
    return prob, BI, -lb[g], lb


# ------------------------------------------------------------ dense TFETI path


def build_feti_ex1(ns: int = 4, ne: int = 7) -> FetiProblem:
    """The 1-D Poisson problem of the FETI tutorial ex1 (examples/
    feti_ex1.py:21-43): -u'' = sin(pi x) on [0, 1], ``ns`` subdomains of
    ``ne`` elements, element stiffness [[1, -1], [-1, 1]], load
    sin((g + 1/2) h pi) h^2 / 2 to both ends of element g (pi as 3.14159,
    as the reference writes it), both ends Dirichlet; the rhs re-split by
    multiplicity."""
    nl = ne + 1
    h = 1.0 / (ns * ne)
    K = np.zeros((ns, nl, nl))
    i = np.arange(ne)
    for a, c, v in ((0, 0, 1.0), (0, 1, -1.0), (1, 0, -1.0), (1, 1, 1.0)):
        K[:, i + a, i + c] += v  # element i adds to rows i, i + 1
    load = np.sin((np.arange(ns)[:, None] * ne + i[None, :] + 0.5) * h * 3.14159) * 0.5 * h * h
    b = np.zeros((ns, nl))
    b[:, :ne] += load
    b[:, 1:] += load
    l2g = (np.arange(ns)[:, None] * ne + np.arange(nl)[None, :]).astype(np.int64)
    return FetiProblem(K_blocks=K, b_loc=decompose_rhs_by_multiplicity(b, l2g), l2g=l2g,
                       dirichlet=np.array([0, ns * ne]))


def build_feti_contact(ns: int = 4, ne: int = 25):
    """The dense twin of :func:`build_contact` (examples/feti_contact.py:
    31-78): the same 1-D obstacle problem as a :class:`FetiProblem` with
    the obstacle rows BI over the (ns, nl) space.  Returns (prob, BI, cI, lb)."""
    sprob, BI, cI, lb = build_contact(ns, ne)
    K = np.stack([k.toarray() for k in sprob.K_blocks])
    prob = FetiProblem(K_blocks=K, b_loc=sprob.b_loc, l2g=sprob.l2g, dirichlet=sprob.dirichlet)
    return prob, BI, cI, lb


def q1_poisson_emat(dim: int) -> np.ndarray:
    """Q1 Poisson element stiffness on the unit cube (lexicographic nodes,
    x fastest; 2-point Gauss quadrature): K = sum_q w dN dN'
    (examples/feti_ex71.py:85-109)."""
    import itertools

    gp = np.array([-1.0, 1.0]) / np.sqrt(3.0) * 0.5 + 0.5
    nodes = [tuple(reversed(t)) for t in itertools.product((0, 1), repeat=dim)]
    nn = len(nodes)
    K = np.zeros((nn, nn))
    for q in itertools.product(range(2), repeat=dim):
        x = np.array([gp[qi] for qi in q])
        dN = np.zeros((nn, dim))
        for a, nd in enumerate(nodes):
            for d in range(dim):
                prod = 1.0
                for e in range(dim):
                    val = x[e] if nd[e] == 1 else 1.0 - x[e]
                    der = 1.0 if nd[e] == 1 else -1.0
                    prod *= der if e == d else val
                dN[a, d] = prod
        K += (1.0 / 2**dim) * dN @ dN.T
    return K


#: the reference's hardcoded Q1 Poisson element stiffness (ex71.c)
POISS_3D_EMAT = np.array([
    [1 / 3, 0, 0, -1 / 12, 0, -1 / 12, -1 / 12, -1 / 12],
    [0, 1 / 3, -1 / 12, 0, -1 / 12, 0, -1 / 12, -1 / 12],
    [0, -1 / 12, 1 / 3, 0, -1 / 12, -1 / 12, 0, -1 / 12],
    [-1 / 12, 0, 0, 1 / 3, -1 / 12, -1 / 12, -1 / 12, 0],
    [0, -1 / 12, -1 / 12, -1 / 12, 1 / 3, 0, 0, -1 / 12],
    [-1 / 12, 0, -1 / 12, -1 / 12, 0, 1 / 3, -1 / 12, 0],
    [-1 / 12, -1 / 12, 0, -1 / 12, 0, -1 / 12, 1 / 3, 0],
    [-1 / 12, -1 / 12, -1 / 12, 0, -1 / 12, 0, 0, 1 / 3],
])


def _ex71_box(ncells, active, emat, dof: int):
    """The local numbering and stiffness of one subdomain box of
    ``ncells`` (x, y, z) cells (an inactive axis has one layer and no
    second corner): nodes numbered by first appearance when the cells are
    walked z, y, x outermost to innermost and each cell's corners dz, dy,
    dx (the dict of examples/feti_ex71.py:140-160).  Returns (the local
    nodes' (x, y, z) offsets in that order, K) with K summed cell by cell
    in the walk's order (``np.add.at``: the example's ``+=`` per cell)."""
    cz, cy, cx = (np.arange(n) for n in ncells[::-1])
    cells = np.stack(np.meshgrid(cz, cy, cx, indexing="ij"), axis=-1).reshape(-1, 3)[:, ::-1]
    rng = [(0, 1) if a else (0,) for a in active]
    offs = np.array([(dx, dy, dz) for dz in rng[2] for dy in rng[1] for dx in rng[0]])
    corner = cells[:, None, :] + offs[None, :, :]  # (ncell, nc, 3), walk order
    ext = np.asarray(ncells) + np.asarray(active, dtype=np.int64)  # nodes per axis
    key = ((corner[..., 2] * ext[1] + corner[..., 1]) * ext[0] + corner[..., 0]).reshape(-1)
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    order = np.argsort(first)
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[order] = np.arange(len(uniq))
    local = rank[inv.reshape(-1)].reshape(corner.shape[:2])  # (ncell, nc)
    k = uniq[order]
    nodes = np.stack([k % ext[0], (k // ext[0]) % ext[1], k // (ext[0] * ext[1])], axis=1)
    n = len(uniq) * dof
    idx = (local[:, :, None] * dof + np.arange(dof)).reshape(len(cells), -1)  # (ncell, nc*dof)
    K = np.zeros(n * n)
    np.add.at(K, (idx[:, :, None] * n + idx[:, None, :]).reshape(-1),
              np.broadcast_to(emat, (len(cells),) + emat.shape).reshape(-1))
    return nodes, K.reshape(n, n)


def build_ex71(cells=(7, 8, 9), grid=(1, 2, 3), dirichlet_diag: str = "assembled",
               pde: str = "poisson") -> FetiProblem:
    """The FETI tutorial ex71 (examples/feti_ex71.py:125-207): Q1 Poisson or
    elasticity on a structured grid of ``cells`` (1-3 entries), decomposed
    on the DMDA process ``grid`` with the upper-corner element ownership,
    the x = 0 face zeroed symmetrically in the blocks with the diagonal by
    ``dirichlet_diag`` ('assembled': 1/multiplicity per copy; 'copy': 1;
    'owner': 1 on the first copy and 0 on the others), the unit rhs
    D-scaled onto the copies, padding dofs with a unit diagonal, and the
    node coordinates (ns, nn_max, 3).  Boxes of one shape share one local
    assembly."""
    from .feti.matis import decompose_vec, matis_ctx

    cells = tuple(cells) + (0,) * (3 - len(cells))
    grid = tuple(grid) + (1,) * (3 - len(grid))
    active = tuple(c > 0 for c in cells)
    dim = sum(active)
    Ms = tuple(c + 1 for c in cells)
    Mx, My, Mz = Ms
    offs = [np.concatenate([[0], np.cumsum(_axis_split(M, g))]) for M, g in zip(Ms, grid)]

    def cell_range(o, r, last, c, act):
        if not act:
            return 0, 1
        return (o[r] - 1 if r > 0 else 0), (o[r + 1] - 1 if r < last - 1 else c)

    m, n, p = grid
    boxes = [tuple(cell_range(offs[a], r, grid[a], cells[a], active[a])
                   for a, r in enumerate((im, jn, kp)))
             for kp in range(p) for jn in range(n) for im in range(m)]
    dof = dim if pde == "elasticity" else 1
    if pde == "elasticity":
        emat = q1_elasticity_emat(dim)
    else:
        emat = POISS_3D_EMAT if dim == 3 else q1_poisson_emat(dim)
    local = {}
    for bx in boxes:
        shape = tuple(hi - lo for lo, hi in bx)
        if shape not in local:
            local[shape] = _ex71_box(shape, active, emat, dof)
    nn_max = max(len(local[tuple(hi - lo for lo, hi in bx)][0]) for bx in boxes)
    ns, nl = len(boxes), nn_max * dof
    K = np.zeros((ns, nl, nl))
    l2g = np.full((ns, nl), -1, dtype=np.int64)
    coords = np.zeros((ns, nn_max, 3))
    for s, bx in enumerate(boxes):
        nodes, Kb = local[tuple(hi - lo for lo, hi in bx)]
        g = nodes + np.array([lo for lo, _ in bx])  # global node (x, y, z)
        gid = (g[:, 2] * My + g[:, 1]) * Mx + g[:, 0]
        nd = len(gid) * dof
        l2g[s, :nd] = (gid[:, None] * dof + np.arange(dof)).reshape(-1)
        coords[s, : len(gid)] = g
        K[s, :nd, :nd] = Kb
        K[s, np.arange(nd, nl), np.arange(nd, nl)] = 1.0  # padding: unit diagonal

    n_global = Mx * My * Mz * dof
    mult = matis_ctx(l2g, n_global).multiplicity
    # the x = 0 face: rows and columns zeroed, the diagonal by convention
    gnode = np.where(l2g >= 0, l2g // dof, -1)
    fixed = (l2g >= 0) & (gnode % Mx == 0)
    ss, ii = np.nonzero(fixed)
    K[ss, ii, :] = 0.0
    K[ss, :, ii] = 0.0
    g = l2g[ss, ii]
    if dirichlet_diag == "assembled":
        diag = 1.0 / mult[g]
    elif dirichlet_diag == "owner":  # the first copy in (s, i) order gets 1
        _, first = np.unique(g, return_index=True)
        diag = np.zeros(len(g))
        diag[first] = 1.0
    else:
        diag = np.ones(len(g))
    K[ss, ii, ii] = diag
    b_loc = decompose_vec(np.ones(n_global), l2g, mult, scale=True)
    return FetiProblem(K_blocks=K, b_loc=b_loc, l2g=l2g,
                       dirichlet=np.array([], dtype=np.int64), coords=coords)


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


# ------------------------------------------------------------ general QP path


def fobst(i, n: int):
    """The obstacle sin(4 pi x - pi/6)/2 - 2 at node i of n (x = i h,
    h = 1/(n-1)); ``i`` an int or an integer array (examples/ex2.py:25)."""
    h = 1.0 / (n - 1)
    return np.sin(4 * np.pi * i * h - np.pi / 6.0) / 2 - 2


def _obstacle_1d(n: int, constrained: np.ndarray):
    """The FD system of -u'' = -15 on [0, 1], u(0) = u(1) = 0, Dirichlet
    rows kept as identity rows with the couplings to them dropped, and the
    obstacle sin(4 pi x - pi/6)/2 - 2 on the interior nodes ``constrained``."""
    h = 1.0 / (n - 1)
    i = np.arange(n)
    inner = (i >= 1) & (i <= n - 2)
    A = np.zeros((n, n))
    A[i, i] = np.where(inner, 2.0, 1.0)
    lo = i[inner & (i != 1)]
    A[lo, lo - 1] = -1.0
    hi = i[inner & (i != n - 2)]
    A[hi, hi + 1] = -1.0
    b = np.where(inner, -15 * h * h * 2, 0.0)
    obst = fobst(i, n)
    return A, b, inner & constrained, obst


def build_ex1(n: int = 10):
    """(A, b, lb) of tutorial ex1 (examples/ex1.py:19-41): the obstacle on
    every interior node, lb = 0 on the two boundary nodes."""
    A, b, mask, obst = _obstacle_1d(n, np.ones(n, dtype=bool))
    return A, b, np.where(mask, obst, 0.0)


def build_ex2(n: int = 10):
    """(A, b, lb) of tutorial ex2 (examples/ex2.py:30-51): the obstacle on
    the interior nodes i < n // 2 only, lb = -inf elsewhere, lb[0] = 0."""
    A, b, mask, obst = _obstacle_1d(n, np.arange(n) < n // 2)
    lb = np.where(mask, obst, -np.inf)
    lb[0] = 0.0
    return A, b, lb


def build_ex3(n: int = 10):
    """(A, b, BI, cI) of tutorial ex3 (examples/ex3.py:35-39): ex1's A and
    b with the obstacle as the linear inequality BI x <= cI, BI = -I and
    cI = -lb (lb = 0 on the two boundary nodes).  A and BI are dense n x n
    arrays, as the example hands them to ``QP.create``."""
    A, b, lb = build_ex1(n)
    return A, b, -np.eye(n), -lb


def build_jbearing(nx: int = 8, ny: int = 12, ecc: float = 0.1, b: float = 10.0):
    """(A, rhs, lb, ub) of the journal bearing problem (MINPACK-2 DPJB;
    examples/jbearing2.py:21-68): pressure over [0, 2 pi] x [0, 2 b],
    5-point stencil Hessian with trapezoidal-rule coefficients of
    p(xi) = (1 + ecc cos xi)^3, bounds 0 <= x <= 1000.  The coefficients
    depend on the column i only; row = j * nx + i."""
    hx = 2 * np.pi / (nx + 1.0)
    hy = 2 * b / (ny + 1.0)
    hxhy = hx * hy
    hxhx = 1.0 / (hx * hx)
    hyhy = 1.0 / (hy * hy)

    def p(xi):
        t = 1.0 + ecc * np.cos(xi)
        return t * t * t

    xi = (np.arange(nx) + 1) * hx
    trule1 = hxhy * (p(xi) + p(xi + hx) + p(xi)) / 6.0
    trule2 = hxhy * (p(xi) + p(xi - hx) + p(xi)) / 6.0
    trule3 = hxhy * (p(xi) + p(xi + hx) + p(xi + hx)) / 6.0
    trule4 = hxhy * (p(xi) + p(xi - hx) + p(xi - hx)) / 6.0
    trule5, trule6 = trule1, trule2
    vdown = -(trule5 + trule2) * hyhy
    vleft = -hxhx * (trule2 + trule4)
    vright = -hxhx * (trule1 + trule3)
    vup = -hyhy * (trule1 + trule6)
    vmid = hxhx * (trule1 + trule2 + trule3 + trule4) + hyhy * (
        trule1 + trule2 + trule5 + trule6)

    n = nx * ny
    i = np.tile(np.arange(nx), ny)
    j = np.repeat(np.arange(ny), nx)
    row = np.arange(n)
    parts = [  # (mask, column offset, per-column coefficient)
        (j > 0, -nx, vdown), (i > 0, -1, vleft), (np.ones(n, dtype=bool), 0, vmid),
        (i + 1 < nx, 1, vright), (j + 1 < ny, nx, vup)]
    rows = np.concatenate([row[m] for m, _, _ in parts])
    cols = np.concatenate([row[m] + off for m, off, _ in parts])
    vals = np.concatenate([v[i[m]] for m, _, v in parts])
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    A.sort_indices()
    # linear term B = -ecc*hx*hy*sin((i+1)hx); QP rhs = -B
    rhs = (ecc * hxhy * np.sin(xi))[i]
    return A, rhs, np.zeros(n), np.full(n, 1000.0)


def rcm_permuted(A, b, lb=None, ub=None):
    """The QP (A, b, lb, ub) renumbered by scipy's reverse Cuthill-McKee
    ordering of A (symmetric mode): returns (A[perm][:, perm] as CSR with
    sorted columns, b[perm], lb[perm], ub[perm], perm); x_original[perm] is
    the solution of the permuted problem."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    A = sp.csr_matrix(A)
    perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True), dtype=np.int64)
    Ap = A[perm][:, perm].tocsr()
    Ap.sort_indices()

    def vec(v):
        return None if v is None else np.asarray(v)[perm]

    return Ap, vec(b), vec(lb), vec(ub), perm


def laplacian_3d_rcm(nx: int):
    """The unstructured SpMV matrix of bench.py (:25-36, :149-156): the
    7-point 3-D Laplacian on nx^3 nodes, RCM-reordered (row-varying column
    offsets defeat the DIA format) and scaled by 1/12 (= 1/lambda_max) so
    that chained products stay bounded."""
    n1 = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx), format="csr")
    i1 = sp.identity(nx, format="csr")
    a = (sp.kron(sp.kron(n1, i1), i1) + sp.kron(sp.kron(i1, n1), i1)
         + sp.kron(sp.kron(i1, i1), n1)).tocsr()
    return (rcm_permuted(a, None)[0] / 12.0).tocsr()


def make_blobs(n=200, dim=2, seed=0, margin=1.0):
    """Two Gaussian blobs at +-margin with labels +-1, shuffled
    (examples/svm.py::make_blobs)."""
    rng = np.random.default_rng(seed)
    half = n // 2
    Xp = rng.standard_normal((half, dim)) + margin
    Xn = rng.standard_normal((n - half, dim)) - margin
    X = np.vstack([Xp, Xn])
    y = np.concatenate([np.ones(half), -np.ones(n - half)])
    perm = rng.permutation(n)
    return X[perm], y[perm]


def make_a9a_like(n=32561, dim=123, groups=14, seed=0, flip=0.05):
    """Synthetic data of the shape of LIBSVM's a9a (the UCI Adult census
    set: 32,561 rows, 123 binary features, each row one-hot in 14 feature
    groups): row i sets one feature of each group; the labels are the sign
    of a random hyperplane through the data's mean, ``flip`` of them
    flipped (not separable, as a9a is not)."""
    rng = np.random.default_rng(seed)
    edges = np.linspace(0, dim, groups + 1).astype(int)
    X = np.zeros((n, dim))
    for g in range(groups):
        X[np.arange(n), rng.integers(edges[g], edges[g + 1], n)] = 1.0
    w = rng.standard_normal(dim)
    score = (X - X.mean(axis=0)) @ w
    y = np.where(score > 0, 1.0, -1.0)
    y[rng.random(n) < flip] *= -1.0
    return X, y
