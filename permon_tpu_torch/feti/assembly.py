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
1/sqrt(d) when ``scale``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .. import not_ported

GLUING_TYPES = ("nonred", "full", "orth")


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
    if gluing == "orth":
        raise not_ported("gluing='orth'")
    pos, start, d, _ = _copy_groups(l2g, exclude)
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
