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
from .sell import gather_apply


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


@dataclasses.dataclass
class GatherTable(Struct):
    """A plane-major gather table plus its optional overflow planes:
    ``apply(x)[r] = sum_j vals[j, r] * xhat[idx[j, r]]``, then for each
    overflow target t (unique, ascending): ``out[ov_tgt[t]] +=`` its
    overflow planes in entry order."""

    idx: torch.Tensor  # (w, nrows) int32, pad = n_src
    vals: torch.Tensor  # (w, nrows)
    n_src: int  # length of the vectors the table gathers from
    ov_tgt: torch.Tensor = None  # (nt,) int32 unique targets
    ov_idx: torch.Tensor = None  # (wov, nt) int32, pad = n_src
    ov_vals: torch.Tensor = None  # (wov, nt)
    #: False selects the plain PyTorch version even on CUDA
    kernel: bool = True

    @classmethod
    def from_host(cls, idx, vals, device, n_src: int, overflow=None):
        """Upload host tables gathering from vectors of length ``n_src``;
        ``overflow`` = (targets, src ids, values) COO in any order is sorted
        by target (stable) and packed into planes here.  Every index is
        checked to lie in [0, n_src] (n_src = the zero pad slot) before the
        kernel ever sees the table."""
        dev = resolve_device(device)
        idx = np.asarray(idx, dtype=np.int32)
        ov_src = () if overflow is None else np.asarray(overflow[1])
        for name, a in (("idx", idx), ("overflow ids", ov_src)):
            if len(a) and not (0 <= np.min(a) and np.max(a) <= n_src):
                raise ValueError(f"gather table {name} outside [0, {n_src}]")
        out = cls(idx=torch.tensor(idx, device=dev),
                  vals=torch.tensor(np.asarray(vals), device=dev), n_src=int(n_src))
        if overflow is not None and len(overflow[0]):
            tgt_all, src, v = (np.asarray(a) for a in overflow)
            tgt, inv = np.unique(tgt_all, return_inverse=True)
            oi, ov, _ = pack_planes(inv, src.astype(np.int32), v, len(tgt), n_src)
            out = out.replace(
                ov_tgt=torch.as_tensor(tgt.astype(np.int32), device=dev),
                ov_idx=torch.as_tensor(oi, device=dev),
                ov_vals=torch.as_tensor(ov, device=dev),
            )
        return out

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape != (self.n_src,):
            raise ValueError(f"gather table over {self.n_src} entries got x of "
                             f"shape {tuple(x.shape)}")
        out = gather_apply(self.idx, self.vals, x, kernel=self.kernel)
        if self.ov_tgt is not None:
            gather_apply(self.ov_idx, self.ov_vals, x, out=out, tgt=self.ov_tgt,
                         kernel=self.kernel)
        return out


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
