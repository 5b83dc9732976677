"""Subdomain extension operator — the port of
:class:`permon_tpu.core.extension.SubdomainExtension` (the MATEXTENSION
of the reference, src/mat/impls/extension/extension.c:476-540).

The batched triplet (rows, cols, vals) of shape (ns, k) — subdomain s
contributes ``vals[s, t] * u[s, cols[s, t]]`` to dual entry ``rows[s, t]``
— stays on the host: it is setup data (``to_coo`` for the coarse build).
The device applies run through two plane-major gather tables, one per
direction, built once on the host (:meth:`SubdomainExtension.
with_gather_apply`) and applied by the gather kernel
(:func:`~permon_tpu_torch.core.sell.gather_apply`):

- ``mv``  (B u):  out[r] = sum_j gB_vals[j, r] * u[gB_cols[j, r]];
- ``rmv`` (B'l):  the same over primal dofs, the table width capped at 2
  slots per dof plus an OVERFLOW table for the few dofs with more rows
  (subdomain corner/edge owner copies under nonredundant gluing), added
  per target in entry order — no scatter-add anywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import Struct, resolve_device
from .linop import LinearOperator
from .sell import MARK_GROUP, gather_apply, plane_stride


def pack_planes(keys, payload, pv, nrows: int, pad_key: int,
                cap: Optional[int] = None):
    """Host pack of COO (keys -> payload, value pv) into a plane-major
    gather table: entries grouped by key (stable, so each key keeps its
    entries in input order), slot j of key k at [j, k].  Returns
    ``(idx (w, nrows) int32, val (w, nrows), overflow)``; past ``cap``
    slots the tail entries go to ``overflow = (keys, payload, pv)`` in
    (key, input) order — the pack of core/extension.py:185-204."""
    keys = np.asarray(keys, dtype=np.int64)
    order = np.argsort(keys, kind="stable")
    k_s, p_s, v_s = keys[order], np.asarray(payload)[order], np.asarray(pv)[order]
    counts = np.bincount(k_s, minlength=nrows)
    w = max(int(counts.max()) if len(counts) else 0, 1)
    slot = np.arange(len(k_s)) - np.concatenate([[0], np.cumsum(counts)[:-1]])[k_s]
    ov = None
    if cap is not None and w > cap:
        over = slot >= cap
        ov = (k_s[over], p_s[over], v_s[over])
        k_s, p_s, v_s, slot = k_s[~over], p_s[~over], v_s[~over], slot[~over]
        w = cap
    idx = np.full((w, nrows), pad_key, dtype=np.int32)
    val = np.zeros((w, nrows), dtype=v_s.dtype if len(v_s) else np.float64)
    idx[slot, k_s] = p_s
    val[slot, k_s] = v_s
    return idx, val, ov


#: planes of a device table are padded to a multiple of this many entries,
#: so that every plane starts on a 16-byte boundary (csrc/gather_apply.cu
#: reads 2 or 4 neighbouring rows with one load)
PLANE_ALIGN = 4


def overflow_marker(targets, nrows: int) -> np.ndarray:
    """The (ceil(nrows / 256), 9) int32 table that tells the kernel which
    rows have overflow.  Record g covers rows 256 g .. 256 g + 255: column 0
    holds the number of ``targets`` (ascending, unique) before the group,
    columns 1..8 bitmasks of 32 rows each, bit r % 32 of mask (r % 256) // 32
    set for a target r.  So a marked row owns overflow column
    ``count + popcount(the group's masks below its bit)``."""
    targets = np.asarray(targets, dtype=np.int64)
    ngroups = (nrows + MARK_GROUP - 1) // MARK_GROUP
    masks = np.zeros(ngroups * 8, dtype=np.uint32)
    np.bitwise_or.at(masks, targets // 32, np.uint32(1) << (targets % 32).astype(np.uint32))
    per_group = np.bincount(targets // MARK_GROUP, minlength=ngroups)
    before = (np.cumsum(per_group) - per_group).astype(np.int32)
    return np.concatenate([before[:, None], masks.view(np.int32).reshape(ngroups, 8)], axis=1)


def _padded_planes(a: np.ndarray, fill, device) -> torch.Tensor:
    """Upload a (w, nrows) host table with its planes padded to PLANE_ALIGN
    entries; returns the (w, nrows) view of the padded device tensor."""
    w, n = a.shape
    full = np.full((w, -(-n // PLANE_ALIGN) * PLANE_ALIGN), fill, dtype=a.dtype)
    full[:, :n] = a
    return torch.tensor(full, device=device)[:, :n]


@dataclasses.dataclass
class GatherTable(Struct):
    """A plane-major gather table plus its optional overflow planes:
    ``apply(x)[r] = sum_j vals[j, r] * xhat[idx[j, r]]``, then for each
    overflow target t (unique, ascending): ``out[ov_tgt[t]] +=`` its
    overflow planes in entry order.  On a CUDA device one kernel launch
    does both (:func:`~permon_tpu_torch.core.sell.gather_apply`)."""

    idx: torch.Tensor  # (w, nrows) int32, pad = n_src; planes may be padded
    vals: torch.Tensor  # (w, nrows), the stride of idx
    n_src: int  # length of the vectors the table gathers from
    ov_tgt: torch.Tensor = None  # (nt,) int32 unique ascending targets
    ov_idx: torch.Tensor = None  # (wov, nt) int32, pad = n_src
    ov_vals: torch.Tensor = None  # (wov, nt)
    ov_mark: torch.Tensor = None  # overflow_marker(ov_tgt, nrows), for the kernel
    #: False selects the plain PyTorch version even on CUDA
    kernel: bool = True

    @classmethod
    def from_host(cls, idx, vals, device, n_src: int, overflow=None):
        """Upload host tables gathering from vectors of length ``n_src``,
        their planes padded to PLANE_ALIGN entries (``idx`` and ``vals`` are
        the (w, nrows) views); ``overflow`` = (targets, src ids, values) COO
        in any order is sorted by target (stable) and packed into planes
        here, with the marker that names its targets.  Every index is
        checked to lie in [0, n_src] (n_src = the zero pad slot) before the
        kernel ever sees the table."""
        dev = resolve_device(device)
        idx = np.asarray(idx, dtype=np.int32)
        ov_src = () if overflow is None else np.asarray(overflow[1])
        for name, a in (("idx", idx), ("overflow ids", ov_src)):
            if len(a) and not (0 <= np.min(a) and np.max(a) <= n_src):
                raise ValueError(f"gather table {name} outside [0, {n_src}]")
        out = cls(idx=_padded_planes(idx, n_src, dev),
                  vals=_padded_planes(np.asarray(vals), 0, dev), n_src=int(n_src))
        if overflow is not None and len(overflow[0]):
            tgt_all, src, v = (np.asarray(a) for a in overflow)
            tgt, inv = np.unique(tgt_all, return_inverse=True)
            oi, ov, _ = pack_planes(inv, src.astype(np.int32), v, len(tgt), n_src)
            out = out.replace(
                ov_tgt=torch.as_tensor(tgt.astype(np.int32), device=dev),
                ov_idx=torch.as_tensor(oi, device=dev),
                ov_vals=torch.as_tensor(ov.astype(np.asarray(vals).dtype), device=dev),
                ov_mark=torch.as_tensor(overflow_marker(tgt, idx.shape[1]), device=dev),
            )
        return out

    def cast(self, dtype: torch.dtype) -> "GatherTable":
        """The table with its values in ``dtype``, the padded planes kept."""
        w, n = self.vals.shape
        s = plane_stride(self.vals)
        full = self.vals.as_strided((w, s), (s, 1)).to(dtype)
        return self.replace(vals=full[:, :n], ov_vals=None if self.ov_vals is None
                            else self.ov_vals.to(dtype))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return gather_apply(self, x)


def copy_sum_table(l2g: np.ndarray, n_global: int, device) -> GatherTable:
    """The gather table out[g] = the sum of the flat copies of dof g of a
    local-to-global map (padding, l2g = -1, skipped), each dof's copies
    added in ascending flat order, two slots per dof and the rest in
    overflow planes; on ``device``.  The fixed-order stand-in for the
    scatter-add of a reassembly."""
    flat = np.asarray(l2g, dtype=np.int64).reshape(-1)
    pos = np.flatnonzero(flat >= 0)
    idx, vals, ov = pack_planes(flat[pos], pos.astype(np.int32), np.ones(len(pos)),
                                int(n_global), len(flat), cap=2)
    return GatherTable.from_host(idx, vals, device, n_src=len(flat), overflow=ov)


@dataclasses.dataclass
class SubdomainExtension(LinearOperator):
    rows: np.ndarray  # (ns, k) int32 dual (link) indices, m = padding
    cols: np.ndarray  # (ns, k) int32 local dof indices within the subdomain
    vals: np.ndarray  # (ns, k) float64
    m_dual: int
    ns: int
    nl: int
    gB: GatherTable = None  # mv table over decomposed cols, pad = ns*nl
    gBt: GatherTable = None  # rmv table over dual rows, pad = m_dual
    #: (ns, k, nl) dense condensed blocks of the leaf path (with_dense_blocks)
    blk: torch.Tensor = None

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.m_dual, self.ns * self.nl)

    @classmethod
    def from_coo(cls, rows, cols, vals, m: int, ns: int, nl: int) -> "SubdomainExtension":
        """Build from global COO over the decomposed space (cols in
        [0, ns*nl), entry t belongs to subdomain cols[t] // nl); each
        subdomain's slots keep the entries' input order."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        sub = cols // nl
        idx, _, _ = pack_planes(sub, np.arange(len(rows)), np.zeros(len(rows)), ns, -1)
        live = idx >= 0
        t = idx[live]
        k = idx.shape[0]
        r = np.full((k, ns), m, dtype=np.int32)
        c = np.zeros((k, ns), dtype=np.int32)
        v = np.zeros((k, ns), dtype=np.float64)
        r[live] = rows[t]
        c[live] = cols[t] % nl
        v[live] = vals[t]
        return cls(rows=np.ascontiguousarray(r.T), cols=np.ascontiguousarray(c.T),
                   vals=np.ascontiguousarray(v.T), m_dual=int(m), ns=int(ns), nl=int(nl))

    @classmethod
    def vstack(cls, ops) -> "SubdomainExtension":
        """B = [B1; B2; ...] as ONE extension operator (same ns / nl; the
        slots concatenate along k, each operator's rows shifted by the rows
        before it, pad slots pointing at the combined pad row)
        (core/extension.py:123-149).  When the first operator has gather
        tables, the stack gets its own on their device."""
        ns, nl = ops[0].ns, ops[0].nl
        if any(o.ns != ns or o.nl != nl for o in ops):
            raise ValueError("vstack needs extensions of one (ns, nl)")
        m_total = int(sum(o.m_dual for o in ops))
        offs = np.cumsum([0] + [o.m_dual for o in ops])
        rows = [np.where(o.rows == o.m_dual, m_total, o.rows.astype(np.int64) + off)
                for o, off in zip(ops, offs)]
        out = cls(rows=np.concatenate(rows, axis=1).astype(np.int32),
                  cols=np.concatenate([o.cols for o in ops], axis=1),
                  vals=np.concatenate([o.vals for o in ops], axis=1),
                  m_dual=m_total, ns=ns, nl=nl)
        if ops[0].gB is None:
            return out
        return out.with_gather_apply(ops[0].gB.idx.device).with_kernel(ops[0].gB.kernel)

    def todense(self):
        """The (m, ns*nl) dense matrix, on the tables' device (the CPU
        without tables); entries of one (row, column) add up."""
        out = np.zeros((self.m_dual + 1, self.ns * self.nl))
        gcols = np.arange(self.ns)[:, None] * self.nl + self.cols
        np.add.at(out, (self.rows.reshape(-1), gcols.reshape(-1)), self.vals.reshape(-1))
        dev = self.gB.idx.device if self.gB is not None else "cpu"
        return torch.as_tensor(out[: self.m_dual], device=dev)

    def with_gather_apply(self, device=None, base_width: int = 2) -> "SubdomainExtension":
        """Attach the plane-major gather tables for both apply directions
        (host setup, O(nnz)); the primal-major table is capped at
        ``base_width`` slots per dof, the tail goes to its overflow planes
        (core/extension.py:162-224)."""
        if self.gB is not None:
            return self
        rows = self.rows.reshape(-1).astype(np.int64)
        vals = self.vals.reshape(-1)
        sub = np.repeat(np.arange(self.ns), self.cols.shape[1])
        gcols = sub * self.nl + self.cols.reshape(-1).astype(np.int64)
        real = (rows < self.m_dual) & (vals != 0.0)
        rows, gcols, vals = rows[real], gcols[real], vals[real]
        N = self.ns * self.nl
        gi, gv, _ = pack_planes(rows, gcols.astype(np.int32), vals, self.m_dual, N)
        ti, tv, ov = pack_planes(gcols, rows.astype(np.int32), vals, N, self.m_dual,
                                 cap=int(base_width))
        return self.replace(
            gB=GatherTable.from_host(gi, gv, device, n_src=N),
            gBt=GatherTable.from_host(ti, tv, device, n_src=self.m_dual, overflow=ov),
        )

    def with_dense_blocks(self, device=None) -> "SubdomainExtension":
        """Materialize the condensed per-subdomain blocks blk[s, t, :] = the
        row of slot t of subdomain s over the nl local dofs, for the batched
        products of the leaf path (core/extension.py:150-161; ~k*nl*8 bytes
        per subdomain), on the tables' device (``device`` without tables).
        Each (s, t) slot holds one column, so one indexed assignment builds
        it: nothing adds up."""
        if self.blk is not None:
            return self
        dev = self.gB.idx.device if self.gB is not None else resolve_device(device)
        ns, k = self.vals.shape
        blk = torch.zeros((ns, k, self.nl), dtype=torch.float64, device=dev)
        s_idx = torch.arange(ns, device=dev)[:, None].expand(ns, k)
        t_idx = torch.arange(k, device=dev)[None, :].expand(ns, k)
        cols = torch.as_tensor(self.cols.astype(np.int64), device=dev)
        blk[s_idx, t_idx, cols] = torch.as_tensor(self.vals, dtype=torch.float64, device=dev)
        return self.replace(blk=blk)

    def with_kernel(self, on: bool) -> "SubdomainExtension":
        """Route both tables through the CUDA kernel (True) or the plain
        PyTorch version (False)."""
        return self.replace(gB=self.gB.replace(kernel=bool(on)),
                            gBt=self.gBt.replace(kernel=bool(on)))

    def _need_tables(self):
        if self.gB is None:
            raise ValueError("SubdomainExtension applies need with_gather_apply() first")

    def mv(self, u):
        """B u through the decomposed-column gather table."""
        self._need_tables()
        return self.gB.apply(u)

    def rmv(self, lam):
        """B' lambda through the dual-row gather table and its overflow."""
        self._need_tables()
        return self.gBt.apply(lam)
