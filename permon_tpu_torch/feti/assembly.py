"""TFETI assembly on the host — numpy copies of the setup functions of
:mod:`permon_tpu.feti.assembly` that the large path uses (the machine with
the card has no JAX, so the port cannot import them).  Each one is
vectorized: no per-dof Python loop, since they run over ~1.1M dof copies
at the 101^3 north star.  The CPU tests hold each one array-equal to the
JAX package's original.

Gluing semantics (reference: QPFetiGetBgtSF, src/qp/impls/feti/
qpfeti.c:527-565, 786-821): for a dof shared by d subdomains, copies in
rank order,
  * nonred: d-1 rows pairing the first copy with each other copy;
  * full:   all d(d-1)/2 pairs;
each row +1 on the lower-rank copy and -1 on the higher, scaled by
1/sqrt(d) when ``scale``;
  * orth:   d-1 orthonormal rows, row k with 1/k on copies 0..k-1 and -1
    on copy k, normalized by sqrt(1/k + 1) (never scaled).

:class:`FetiProblem` is the dense path's problem container; its floating
test and the K+ regularization run batched on the problem's device
(``torch.linalg.eigvalsh``), the rest of the setup on the host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device

GLUING_TYPES = ("nonred", "full", "orth")


def floating_and_lam_max(K: torch.Tensor, tol: float = 1e-10):
    """(floating flags as a host array, the largest eigenvalue of each
    block as a device tensor) from one batched ``eigvalsh`` of the blocks
    ``K``: block s is singular when its least eigenvalue is at most ``tol *
    max(|largest|, 1)`` (the reference learns this from MUMPS null-pivot
    counts, matinv.c:55-195)."""
    w = torch.linalg.eigvalsh(K)
    floating = (w[:, 0] <= tol * torch.clamp(torch.abs(w[:, -1]), min=1.0)).cpu().numpy()
    return floating, w[:, -1].clone()


@dataclasses.dataclass
class FetiProblem:
    """Host-side description of a decomposed problem (the dense path).

    ``K_blocks[s]`` is subdomain s's local stiffness (equal padded size),
    ``b_loc[s]`` its local load vector, ``l2g[s, i]`` the global id of its
    i-th local dof (-1 marks padding).  ``dirichlet`` lists dof ids in
    ``dirichlet_numtype`` numbering ('global_undecomposed', the default;
    'global_decomposed': s*nl + i; 'local': (s, i) pairs); values default
    to zero."""

    K_blocks: np.ndarray  # (ns, nl, nl)
    b_loc: np.ndarray  # (ns, nl)
    l2g: np.ndarray  # (ns, nl) int; -1 marks padding dofs
    dirichlet: np.ndarray
    dirichlet_values: Optional[np.ndarray] = None
    dirichlet_numtype: str = "global_undecomposed"
    coords: Optional[np.ndarray] = None  # (ns, nl/dim, dim) for rigid body modes
    #: per-subdomain floating flag (block singular); None = detect
    floating: Optional[np.ndarray] = None

    def dirichlet_global(self) -> np.ndarray:
        """The Dirichlet set renumbered to global-undecomposed ids
        (qpfeti.c:153-200)."""
        return dirichlet_global_ids(self.l2g, self.dirichlet, self.dirichlet_numtype)

    def floating_mask(self, tol: float = 1e-10, device=None) -> np.ndarray:
        """``floating`` when given, else :func:`floating_and_lam_max` of the
        blocks on ``device`` (None: the card)."""
        if self.floating is not None:
            return np.asarray(self.floating, dtype=bool)
        K = torch.as_tensor(np.asarray(self.K_blocks), device=resolve_device(device))
        return floating_and_lam_max(K, tol)[0]

    @property
    def ns(self) -> int:
        return self.K_blocks.shape[0]

    @property
    def nl(self) -> int:
        return self.K_blocks.shape[1]

    @property
    def n_decomposed(self) -> int:
        return self.ns * self.nl

    @property
    def n_global(self) -> int:
        return int(self.l2g.max()) + 1


def dirichlet_global_ids(l2g: np.ndarray, dirichlet, numtype: str) -> np.ndarray:
    """Renumber a Dirichlet set to global-undecomposed ids
    (qpfeti.c:153-200)."""
    d = np.asarray(dirichlet)
    if len(d) == 0:
        return d.astype(np.int64).reshape(-1)
    if numtype == "global_undecomposed":
        return d.astype(np.int64)
    if numtype == "global_decomposed":
        return l2g.reshape(-1)[d.astype(np.int64)]
    if numtype == "local":
        d = d.reshape(-1, 2)
        return l2g[d[:, 0], d[:, 1]]
    raise ValueError(f"unknown dirichlet numtype {numtype!r}")


def _copy_groups(l2g: np.ndarray, exclude=None):
    """Flat positions of all real copies grouped by global dof (ascending),
    each group in rank (= flat) order; returns (pos, start, d, g) with
    group i = pos[start[i]:start[i]+d[i]] of dof g[i], only dofs with
    d >= 2 copies (and not excluded)."""
    flat = np.asarray(l2g, dtype=np.int64).reshape(-1)
    real = np.flatnonzero(flat >= 0)
    order = real[np.argsort(flat[real], kind="stable")]
    gs = flat[order]
    g, start, d = np.unique(gs, return_index=True, return_counts=True)
    keep = d >= 2
    if exclude is not None and len(exclude):
        keep &= ~np.isin(g, np.asarray(exclude, dtype=np.int64))
    return order, start[keep], d[keep], g[keep]


def build_gluing(l2g: np.ndarray, gluing: str = "nonred", scale: bool = True,
                 exclude: Optional[Sequence[int]] = None):
    """COO (rows, cols, vals, n_rows) of Bg over the decomposed space;
    rows ordered by global dof, then by copy pair; within a row the
    lower-rank (+) entry comes first."""
    if gluing not in GLUING_TYPES:
        raise ValueError(f"unknown gluing {gluing!r}")
    pos, start, d, _ = _copy_groups(l2g, exclude)
    if gluing == "orth":
        return _orth_gluing(pos, start, d)
    mscale = 1.0 / np.sqrt(d) if scale else np.ones(len(d))
    if gluing == "nonred":
        npairs = d - 1
    else:
        npairs = d * (d - 1) // 2
    nrows = int(npairs.sum())
    row_off = np.concatenate([[0], np.cumsum(npairs)[:-1]]).astype(np.int64)
    plus = np.empty(nrows, dtype=np.int64)
    minus = np.empty(nrows, dtype=np.int64)
    val = np.empty(nrows, dtype=np.float64)
    for dd in np.unique(d):
        grp = np.flatnonzero(d == dd)
        if gluing == "nonred":
            a_idx = np.zeros(dd - 1, dtype=np.int64)
            b_idx = np.arange(1, dd, dtype=np.int64)
        else:
            a_idx, b_idx = np.triu_indices(dd, k=1)
        rows = row_off[grp][:, None] + np.arange(len(a_idx))[None, :]
        plus[rows] = pos[start[grp][:, None] + a_idx[None, :]]
        minus[rows] = pos[start[grp][:, None] + b_idx[None, :]]
        val[rows] = mscale[grp][:, None]
    rows = np.repeat(np.arange(nrows, dtype=np.int64), 2)
    cols = np.stack([plus, minus], axis=1).reshape(-1)
    vals = np.stack([val, -val], axis=1).reshape(-1)
    return rows, cols, vals, nrows


def _orth_gluing(pos, start, d):
    """The orth rows of every copy group, in the order of the JAX package
    (dof, then row k = 1..d-1, then copies 0..k): row k holds
    nrm/k on copies 0..k-1 and -nrm on copy k, nrm = 1/sqrt(1/k + 1)."""
    nrows = int((d - 1).sum())
    nent = (d - 1) * (d + 2) // 2  # row k has k + 1 entries
    row_off = np.cumsum(d - 1) - (d - 1)
    ent_off = np.cumsum(nent) - nent
    total = int(nent.sum())
    rows = np.empty(total, dtype=np.int64)
    cols = np.empty(total, dtype=np.int64)
    vals = np.empty(total, dtype=np.float64)
    for dd in np.unique(d):
        grp = np.flatnonzero(d == dd)
        k = np.repeat(np.arange(1, dd), np.arange(2, dd + 1))  # row k of each entry
        first = np.repeat(np.cumsum(np.arange(2, dd + 1)) - np.arange(2, dd + 1),
                          np.arange(2, dd + 1))
        a = np.arange(len(k)) - first  # copy index within the row: 0..k
        nrm = 1.0 / np.sqrt(1.0 / k + 1.0)
        v = np.where(a < k, nrm / k, -nrm)
        at = ent_off[grp][:, None] + np.arange(len(k))[None, :]
        rows[at] = row_off[grp][:, None] + (k - 1)[None, :]
        cols[at] = pos[start[grp][:, None] + a[None, :]]
        vals[at] = v[None, :]
    return rows, cols, vals, nrows


def _dirichlet_copies_sorted(dg: np.ndarray, flat: np.ndarray):
    """(dirichlet index, flat position) pairs by one stable sort of the
    flattened l2g and two sorted searches — O(n log n); the pairs come in
    dg order, each dof's copies in ascending flat (= rank) order."""
    order = np.argsort(flat, kind="stable")
    sf = flat[order]
    lo = np.searchsorted(sf, dg, side="left")
    counts = np.searchsorted(sf, dg, side="right") - lo
    pos_d = np.repeat(np.arange(len(dg)), counts)
    first = np.cumsum(counts) - counts  # where each dof's run starts in the output
    take = np.repeat(lo - first, counts) + np.arange(int(counts.sum()))
    return pos_d, order[take]


def build_dirichlet_rows(prob):
    """Identity rows on every decomposed copy of each Dirichlet dof (the
    enforce_by_B path, qpfeti.c:153-312).  Returns (rows, cols, vals, n_rows,
    c) with c the prescribed values.  The sorted search serves every size
    (the JAX package also keeps an O(nd * n) broadcast for small problems;
    both give the same arrays)."""
    dg = prob.dirichlet_global()
    dvals = (np.asarray(prob.dirichlet_values, dtype=np.float64)
             if prob.dirichlet_values is not None else np.zeros(len(prob.dirichlet)))
    pos_d, pos_flat = _dirichlet_copies_sorted(dg, prob.l2g.reshape(-1))
    r = len(pos_flat)
    return np.arange(r), pos_flat.astype(np.int64), np.ones(r), r, dvals[pos_d]


def eliminate_dirichlet_in_blocks(prob: FetiProblem):
    """Symmetric elimination in the Hessian (the dir_in_hess path): for each
    copy (s, i) of a Dirichlet dof, in the order of the Dirichlet list and
    then of the copies, the rhs is lifted by -K_s[:, i] * value, row and
    column i are zeroed and alpha = max|diag| (with alpha * value on the
    rhs) put on the diagonal (qpfeti.c:153-312).  Returns (K_blocks, b_loc,
    masks), masks (ns, nl) marking the Dirichlet copies.

    One pass over the copies' rank within their block, vectorized over the
    blocks: a row that is no Dirichlet copy takes its lifts one rounded
    subtraction at a time in the JAX package's order, so the arrays are
    equal to its loop's.  A dof listed twice lifts with its first value and
    keeps its last on the diagonal, as that loop does."""
    K = np.array(prob.K_blocks, dtype=np.float64, copy=True)
    b = np.array(prob.b_loc, dtype=np.float64, copy=True)
    dg = prob.dirichlet_global()
    dvals = (np.asarray(prob.dirichlet_values, dtype=np.float64)
             if prob.dirichlet_values is not None else np.zeros(len(dg)))
    masks = np.zeros((prob.ns, prob.nl), dtype=bool)
    alpha = max(np.abs(np.diagonal(K, axis1=1, axis2=2)).max(), 1.0)
    pos_d, pos_flat = _dirichlet_copies_sorted(dg, prob.l2g.reshape(-1))
    if not len(pos_flat):
        return K, b, masks
    v = dvals[pos_d]
    _, first = np.unique(pos_flat, return_index=True)
    _, last_rev = np.unique(pos_flat[::-1], return_index=True)
    first = np.sort(first)  # lifts: each copy once, in processing order
    s_f, i_f, v_f = pos_flat[first] // prob.nl, pos_flat[first] % prob.nl, v[first]
    counts = np.bincount(s_f, minlength=prob.ns)
    order = np.argsort(s_f, kind="stable")
    rank = np.empty(len(first), dtype=np.int64)
    rank[order] = np.arange(len(first)) - (np.cumsum(counts) - counts)[s_f[order]]
    K0 = np.asarray(prob.K_blocks, dtype=np.float64)
    for p in range(int(rank.max()) + 1):
        sel = rank == p
        b[s_f[sel]] -= K0[s_f[sel], :, i_f[sel]] * v_f[sel][:, None]
    K[s_f, i_f, :] = 0.0
    K[s_f, :, i_f] = 0.0
    K[s_f, i_f, i_f] = alpha
    last = len(pos_flat) - 1 - last_rev  # the final value of each copy
    b[pos_flat[last] // prob.nl, pos_flat[last] % prob.nl] = alpha * v[last]
    masks[s_f, i_f] = True
    return K, b, masks


def numeric_nullspace_blocks(K_blocks: np.ndarray, l2g: np.ndarray,
                             tol: float = 1e-8) -> List[np.ndarray]:
    """Per-block numeric nullspace bases by eigendecomposition (the MUMPS
    null-pivot detection + ICNTL(25) analog, matinv.c:55-195): the
    eigenvectors of the eigenvalues within ``tol`` of 0 relative to
    max(|w|, 1); a list of (nl, k_s) orthonormal bases, k_s may be 0.  One
    batched host ``eigh`` (the same LAPACK call per block as the JAX
    package's loop)."""
    w, v = np.linalg.eigh(np.asarray(K_blocks))
    scale = np.maximum(np.maximum(np.abs(w[:, -1]), np.abs(w[:, 0])), 1.0)
    k = np.sum(np.abs(w) <= tol * scale[:, None], axis=1)
    return [v[s][:, : k[s]] if k[s] else np.zeros((v.shape[1], 0)) for s in range(len(k))]


def constant_nullspace_columns(prob, fixed_mask: Optional[np.ndarray] = None):
    """One normalized constant column per floating subdomain (Poisson);
    ``fixed_mask[s]`` True blocks get no column (qpfeti.c:281-301)."""
    l2g = np.asarray(prob.l2g)
    ns, nl = l2g.shape
    keep = np.ones(ns, dtype=bool) if fixed_mask is None else ~np.asarray(fixed_mask, bool)
    subs = np.flatnonzero(keep)
    real = l2g[subs] >= 0
    counts = real.sum(axis=1)
    ss, ii = np.nonzero(real)
    rows = subs[ss] * nl + ii
    cols = ss.astype(np.int64)
    vals = 1.0 / np.sqrt(counts[ss])
    return rows, cols, vals, len(subs)


def nullspace_columns_from_blocks(bases):
    """Stack per-block bases (each (nl, k_s), k_s may be 0) into global COO
    columns of the block-diagonal R (MatCreateBlockDiag(R_loc),
    matinv.c:180-187).  Entries come column by column (the coarse column
    numbering: subdomain by subdomain, basis column by basis column), rows
    ascending within a column: ``Ell.from_scipy`` and the coarse numbering
    follow this order.  One ``np.nonzero`` over the stacked bases."""
    if not len(bases):
        return np.array([]), np.array([]), np.array([], dtype=np.float64), 0
    nl = bases[0].shape[0]
    Mt = np.concatenate([np.asarray(B).T for B in bases], axis=0)  # (k, nl): row = column j
    sub = np.repeat(np.arange(len(bases)), [B.shape[1] for B in bases])
    cols, ri = np.nonzero(Mt)
    return sub[cols] * nl + ri, cols, Mt[cols, ri].astype(np.float64), Mt.shape[0]


def rigid_body_modes(coords: np.ndarray) -> np.ndarray:
    """Orthonormalized rigid body modes of one subdomain from nodal
    coordinates (nn, dim): 3 modes in 2-D, 6 in 3-D, dofs node-major
    interleaved (MatNullSpaceCreateRigidBody as used in feti/ex71.c:331-339)."""
    nn, dim = coords.shape
    n = nn * dim
    if dim == 2:
        modes = np.zeros((n, 3))
        modes[0::2, 0] = 1.0
        modes[1::2, 1] = 1.0
        modes[0::2, 2] = -coords[:, 1]
        modes[1::2, 2] = coords[:, 0]
    elif dim == 3:
        modes = np.zeros((n, 6))
        for d in range(3):
            modes[d::3, d] = 1.0
        # rotations about z, x, y
        modes[0::3, 3] = -coords[:, 1]
        modes[1::3, 3] = coords[:, 0]
        modes[1::3, 4] = -coords[:, 2]
        modes[2::3, 4] = coords[:, 1]
        modes[0::3, 5] = coords[:, 2]
        modes[2::3, 5] = -coords[:, 0]
    else:
        raise ValueError(f"unsupported dim {dim}")
    q, _ = np.linalg.qr(modes)
    return q


def decompose_rhs_by_multiplicity(b_loc: np.ndarray, l2g: np.ndarray) -> np.ndarray:
    """Sum the copies into the global rhs and re-split it with
    D = 1/multiplicity (QPTMatISToBlockDiag, qptransform.c:2097-2115)."""
    ng = int(l2g.max()) + 1
    flat = l2g.reshape(-1)
    real = flat >= 0
    ids = flat[real]
    b_glob = np.bincount(ids, weights=b_loc.reshape(-1)[real], minlength=ng)
    mult = np.bincount(ids, minlength=ng)
    out = np.zeros_like(b_loc).reshape(-1)
    out[real] = b_glob[ids] / mult[ids]
    return out.reshape(b_loc.shape)
