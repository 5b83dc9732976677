"""Leaf-space dual iteration — the port of :mod:`permon_tpu.feti.leaf`
(the PetscSF / MATGLUING leaf storage of the reference,
src/mat/impls/gluing/gluing.c:47-159, taken to its conclusion).

A dual vector is stored as the (ns, k) array of its values at every
(subdomain, slot) leaf of the extension operator; all leaves of one dual
row hold the same value (a "consistent" array).  Then

- B' lambda is one batched product against the dense condensed blocks
  ``blk`` (ns, k, nl): no index operation at all;
- B u is a batched product followed by the root sum, which for leaves of
  degree <= deg_max is a gather over deg_max planes: the identity, then
  the partners (:attr:`LeafDualSpace.comb`, a
  :class:`~permon_tpu_torch.core.extension.GatherTable` applied by the
  CUDA gather kernel ``csrc/gather_apply.cu``);
- dot products carry the multiplicity weights: <x, y> = sum x y / deg.

``restrict`` (leaf -> row, the scatter-mean of the JAX package) is a
gather table too, one row per dual row over its leaves in ascending order
with the value 1/deg, and ``lift`` (row -> leaf) a one-plane table: no
device apply adds anything up by a scatter.

The three batched products are ``torch.bmm`` in the operator's dtype; the
JAX package runs them at ``default_matmul_precision("highest")`` because a
reduced-precision product collapsed the f32-state contact trajectory (48
to 136 outer iterations), so :class:`LeafDualOperator` raises on a CUDA
device when TF32 is allowed or the float32 matmul precision is not
'highest'.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import Struct, resolve_device
from ..core.band import _check_tf32 as check_full_precision
from ..core.convergence import ConvergedReason, Tolerances, converged_default
from ..core.extension import GatherTable, SubdomainExtension, pack_planes


def leaf_partners(rows: np.ndarray, vals: np.ndarray, m: int) -> Tuple[np.ndarray, np.ndarray]:
    """(partners (deg_max - 1, ns*k) int32, weights (ns, k)) of the batched
    extension triplets: for each leaf the flat indices of the other leaves of
    its dual row in ascending order (pad: ns*k, the zero slot), and 1/deg at
    leaves with a real row and a nonzero value (0 elsewhere) — the map of
    ``native/permon_host.cpp::permon_leaf_partners``, vectorized: one stable
    sort of the leaves by row and one pass per partner slot."""
    ns, k = rows.shape
    nleaf = ns * k
    flat_rows = np.asarray(rows).reshape(-1).astype(np.int64)
    flat_vals = np.asarray(vals).reshape(-1)
    live = np.flatnonzero((flat_rows != m) & (flat_vals != 0.0))
    leaves = live[np.argsort(flat_rows[live], kind="stable")]  # by row, ascending leaf
    r = flat_rows[leaves]
    counts = np.bincount(r, minlength=m)
    deg_max = max(int(counts.max()) if len(leaves) else 1, 1)
    start = (np.cumsum(counts) - counts)[r]
    deg = counts[r]
    pos = np.arange(len(leaves)) - start
    partners = np.full((deg_max - 1, nleaf), nleaf, dtype=np.int32)
    for q in range(deg_max):
        on = (q < deg) & (q != pos)
        slot = q - (q > pos[on])
        partners[slot, leaves[on]] = leaves[start[on] + q]
    weights = np.zeros(nleaf)
    weights[leaves] = 1.0 / deg
    return partners, weights.reshape(ns, k)


def _ext_device(B: SubdomainExtension, device) -> torch.device:
    if B.blk is not None:
        return B.blk.device
    return B.gB.idx.device if B.gB is not None else resolve_device(device)


def table_as(tab: GatherTable, dtype: torch.dtype) -> GatherTable:
    """``tab`` with its values in ``dtype`` (kept on the table, so the cast
    and the launch plan are made once): a table applied to a vector of
    another precision computes in the vector's, as the JAX package's
    ``weights.astype(x.dtype)`` does."""
    if tab.vals.dtype == dtype:
        return tab
    cache = tab.__dict__.setdefault("_as", {})
    if dtype not in cache:
        cache[dtype] = tab.cast(dtype)
    return cache[dtype]


@dataclasses.dataclass
class LeafDualSpace(Struct):
    """The static plan tying the (ns, k) leaf layout to the m-dim dual
    space (leaf.py:41-119)."""

    rows: np.ndarray  # (ns, k) int32 dual row of each leaf (m = padding), host
    partners: np.ndarray  # (deg_max - 1, ns*k) int32 (ns*k = the zero pad slot), host
    weights: torch.Tensor  # (ns, k) 1/deg at real leaves, 0 at pad slots
    m_dual: int
    #: the root sum: (deg_max, ns*k) planes, the identity then the partners
    comb: GatherTable = None
    #: leaf -> row: (deg_max, m) planes, a row's leaves ascending, value 1/deg
    restr: GatherTable = None
    #: row -> leaf: one plane, idx = rows (pad m), value 1
    lift_tab: GatherTable = None

    @classmethod
    def build(cls, B: SubdomainExtension, device=None, kernel: Optional[bool] = None
              ) -> "LeafDualSpace":
        """The plan of ``B`` on the device of its tables or blocks (else
        ``device``, None: the card); ``kernel`` False puts the three tables
        on the plain PyTorch version (default: as ``B``'s tables)."""
        if kernel is None:
            kernel = B.gB.kernel if B.gB is not None else True
        rows = np.asarray(B.rows, dtype=np.int32)
        partners, weights = leaf_partners(rows, np.asarray(B.vals), int(B.m_dual))
        out = cls.from_partners(rows, partners, weights, int(B.m_dual), _ext_device(B, device))
        return out if kernel else out.with_kernel(False)

    @classmethod
    def from_partners(cls, rows, partners, weights, m: int, device=None) -> "LeafDualSpace":
        """The plan from its host arrays (as :func:`leaf_partners` makes
        them), its tables on ``device`` (None: the card)."""
        dev = resolve_device(device)
        rows = np.asarray(rows, dtype=np.int32)
        partners = np.asarray(partners, dtype=np.int32)
        weights = np.asarray(weights, dtype=np.float64)
        ns, k = rows.shape
        nleaf = ns * k
        cidx = np.concatenate([np.arange(nleaf, dtype=np.int32)[None, :], partners])
        comb = GatherTable.from_host(cidx, (cidx < nleaf).astype(np.float64), dev, n_src=nleaf)
        flat_w = weights.reshape(-1)
        live = np.flatnonzero(flat_w > 0)
        # a row's leaves in ascending order (pack_planes keeps the input order)
        ridx, rval, _ = pack_planes(rows.reshape(-1)[live], live.astype(np.int32),
                                    flat_w[live], m, nleaf)
        restr = GatherTable.from_host(ridx, rval, dev, n_src=nleaf)
        lidx = rows.reshape(1, -1)
        lift_tab = GatherTable.from_host(lidx, (lidx < m).astype(np.float64), dev, n_src=m)
        return cls(rows=rows, partners=partners,
                   weights=torch.tensor(weights.reshape(ns, k), device=dev), m_dual=int(m),
                   comb=comb, restr=restr, lift_tab=lift_tab)

    def with_kernel(self, on: bool) -> "LeafDualSpace":
        """Route the three tables through the CUDA kernel (True) or the plain
        PyTorch version (False)."""
        return self.replace(**{f: getattr(self, f).replace(kernel=bool(on))
                               for f in ("comb", "restr", "lift_tab")})

    @property
    def leaf_shape(self) -> Tuple[int, int]:
        return tuple(self.rows.shape)

    # -- representation changes ------------------------------------------
    def lift(self, lam: torch.Tensor) -> torch.Tensor:
        """m-vector -> consistent (ns, k) leaf array (the SFBcast analog)."""
        return table_as(self.lift_tab, lam.dtype).apply(lam).reshape(self.leaf_shape)

    def lift_rows(self, G: torch.Tensor) -> torch.Tensor:
        """The rows of a (c, m) tensor lifted to (c, ns, k) (setup: plain
        indexing over a zero pad column)."""
        Gp = torch.cat([G, G.new_zeros(G.shape[0], 1)], dim=1)
        idx = torch.as_tensor(self.rows.reshape(-1).astype(np.int64), device=G.device)
        return Gp[:, idx].reshape(G.shape[0], *self.leaf_shape)

    def restrict(self, Lam: torch.Tensor) -> torch.Tensor:
        """Consistent leaf array -> m-vector, the multiplicity-weighted mean
        of each row's leaves (exact: all leaves of a row agree)."""
        return table_as(self.restr, Lam.dtype).apply(Lam.reshape(-1))

    def combine(self, contrib: torch.Tensor) -> torch.Tensor:
        """The root sum in leaf space (SFReduce + SFBcast fused): every leaf
        ends up holding the sum over its row's leaves, added in plane order
        (its own value, then its partners ascending)."""
        return table_as(self.comb, contrib.dtype).apply(
            contrib.reshape(-1)).reshape(self.leaf_shape)

    def dot(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """<x, y> of the dual vectors the leaf arrays represent."""
        return torch.sum(X * Y * self.weights.to(X.dtype))

    def norm(self, X: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.dot(X, X))


@dataclasses.dataclass
class LeafDualOperator(Struct):
    """F = B K+ B' on consistent leaf arrays: two batched products against
    ``blk``, one batched GEMV against the explicit K+ inverses, and the root
    sum (leaf.py:122-146)."""

    blk: torch.Tensor  # (ns, k, nl) dense condensed extension blocks
    invs: torch.Tensor  # (ns, nl, nl) explicit per-block K+ inverses
    space: LeafDualSpace

    @classmethod
    def create(cls, B: SubdomainExtension, kplus, device=None) -> "LeafDualOperator":
        B = B.with_dense_blocks(device)
        return cls(blk=B.blk, invs=kplus.explicitly().invs,
                   space=LeafDualSpace.build(B, device))

    def apply(self, Lam: torch.Tensor) -> torch.Tensor:
        check_full_precision(Lam.device)
        u = torch.bmm(Lam.unsqueeze(1), self.blk)  # (ns, 1, nl) = blk[s]' Lam[s]
        w = torch.bmm(self.invs, u.transpose(1, 2))  # (ns, nl, 1)
        contrib = torch.bmm(self.blk, w).squeeze(-1)  # (ns, k)
        return self.space.combine(contrib)


@dataclasses.dataclass
class LeafProjector(Struct):
    """The coarse projector P = I - G'(GG')^{-1}G lifted to leaf space: G's
    rows stored as consistent leaf arrays and contracted with the weighted
    dot (leaf.py:149-174); ``Glw`` = Gl * weights is stored once."""

    Gl: torch.Tensor  # (kc, ns, k) lifted G rows
    chol: torch.Tensor  # (kc, kc) Cholesky factor of GG'
    weights: torch.Tensor  # (ns, k)
    Glw: torch.Tensor = None  # (kc, ns, k) Gl * weights

    @classmethod
    def create(cls, space: LeafDualSpace, G, ggt_chol=None) -> "LeafProjector":
        from ..qp.projector import dense_rows

        Gd = dense_rows(G)
        Gl = space.lift_rows(Gd)
        chol = torch.linalg.cholesky(Gd @ Gd.T) if ggt_chol is None else ggt_chol
        return cls(Gl=Gl, chol=chol, weights=space.weights, Glw=Gl * space.weights)

    def __call__(self, Lam: torch.Tensor) -> torch.Tensor:
        check_full_precision(Lam.device)
        kc = self.Gl.shape[0]
        y = self.Glw.reshape(kc, -1) @ Lam.reshape(-1)
        z = torch.cholesky_solve(y[:, None], self.chol)[:, 0]
        return Lam - (self.Gl.reshape(kc, -1).T @ z).reshape(Lam.shape)


def leaf_cg(op: LeafDualOperator, B_leaf: torch.Tensor, tol: Tolerances = Tolerances(),
            project: Optional[Callable] = None):
    """(Projected) CG entirely in leaf space (leaf.py:177-223): a CGResult
    whose ``x`` is the (ns, k) leaf array.  ``project`` maps consistent
    arrays to consistent arrays (e.g. :class:`LeafProjector`).  The weighted
    dot makes every recurrence coefficient equal its row-space counterpart.
    The ``while_loop`` is a Python loop with one host read per iteration:
    ||r|| and the last step's breakdown flag."""
    from ..solvers.cg import CGResult

    sp = op.space
    P = project if project is not None else (lambda v: v)
    norm_rhs = float(sp.norm(B_leaf))
    ttol = max(tol.rtol * norm_rhs, tol.atol)
    r = P(B_leaf)
    x, p, rr = torch.zeros_like(B_leaf), r, sp.dot(r, r)
    broke = torch.zeros((), dtype=torch.bool, device=B_leaf.device)
    it, reason = 0, 0
    while True:
        rnorm, broke_h = torch.stack([torch.sqrt(rr), broke.to(rr.dtype)]).tolist()
        if broke_h:
            reason = int(ConvergedReason.CONVERGED_ATOL)
            break
        reason = converged_default(it, rnorm, ttol=ttol, atol=tol.atol, divtol=tol.divtol,
                                   norm_rhs_div=norm_rhs, max_it=tol.max_it)
        if reason != 0:
            break
        Ap = P(op.apply(p))
        pAp = sp.dot(p, Ap)
        broke = torch.logical_not(torch.isfinite(rr / pAp)) | (pAp <= 0.0)
        a = torch.where(broke, torch.zeros_like(pAp), rr / pAp)
        x = x + a * p
        r = r - a * Ap
        rr2 = sp.dot(r, r)
        beta = torch.where(broke, torch.zeros_like(rr2), rr2 / rr)
        p = r + beta * p
        rr = rr2
        it += 1
    return CGResult(x=x, reason=int(reason), iterations=it, rnorm=float(torch.sqrt(rr)),
                    nmv=it + 1)
