"""Communication / compute overlap of the sharded leaf-space dual apply,
and the two-level ('host', 'sd') mesh — the port of
:mod:`permon_tpu.parallel.overlap`.

The reference overlaps the lambda exchange with local work through the
Begin/End halves of PetscSF (src/mat/impls/gluing/gluing.c:47-159).  The
JAX package makes the boundary exchange and the interior compute
independent ops of one XLA graph; here they are explicit steps of the
rank's apply:

1. the leaves of the redundant dual representation (feti/leaf.py) are
   split at plan time into LOCAL partner edges (both leaves on the rank)
   and REMOTE edges grouped by rank offset (:class:`LeafOverlapPlan`);
2. each F application solves the rank's *boundary* subdomains (those
   owning a leaf of a remote edge) first, packs their contributions into
   one send buffer per offset and starts one point-to-point permutation
   per offset (:func:`~permon_tpu_torch.parallel.dist.ppermute`);
3. while those are in flight, the *interior* subdomain solves and the
   in-shard partner combine run;
4. then it waits and adds the received buffers.

The send pack, the in-shard combine and the received combine are gather
tables on the gather kernel (``csrc/gather_apply.cu``), their planes in
the JAX package's order: the rank's own contribution, its in-shard
partners, then the received partners offset by offset.  The sums are
reorderings of the flat combine's, so the result matches the flat apply to
round-off.

The leaf iterate stays replicated on every rank, as dual vectors do on the
row path: :class:`OverlappedLeafOperator` all-gathers the ranks' blocks of
the result (one collective beside the neighbour exchange), so the leaf
solvers run unchanged and read bitwise equal dots on every rank.

On the two-level mesh the subdomains shard over the flattened rank order,
the permutations address the flattened mesh, and
:func:`feti_dual_apply_hier` reduces first over 'sd' (within a host
group), then over 'host'.  ``shard_map_compat`` (a shim across JAX
versions) has no counterpart (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import Struct
from ..core.extension import GatherTable
from ..feti.leaf import LeafDualOperator, LeafDualSpace, check_full_precision, table_as
from .dist import Mesh, _make, all_gather, all_reduce_sum, ppermute, shard_qp


def make_mesh2(shape: Tuple[int, int], axis_names=("host", "sd"), device=None) -> Mesh:
    """A two-level mesh (overlap.py:58-66): first axis the host groups,
    second the ranks within a group, laid out host-major over the ranks of
    the process group (see :func:`~permon_tpu_torch.parallel.dist.make_mesh`)."""
    return _make(tuple(shape), tuple(axis_names), device)


def _rank_in_group(keys: np.ndarray) -> np.ndarray:
    """For each element, how many earlier elements carry the same key."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    start = np.concatenate([[0], np.flatnonzero(sk[1:] != sk[:-1]) + 1]) if len(sk) else sk
    first = np.zeros(len(sk), dtype=np.int64)
    first[start] = start
    first = np.maximum.accumulate(first) if len(sk) else first
    out = np.empty(len(keys), dtype=np.int64)
    out[order] = np.arange(len(keys)) - first
    return out


@dataclasses.dataclass
class LeafOverlapPlan(Struct):
    """Static exchange plan for one (leaf layout, rank count) pair
    (overlap.py:69-179): host arrays with a leading rank axis, equal to the
    JAX package's plan.  Pads: the local-partner and receive tables point at
    a trailing zero slot; the send tables at nb*k."""

    perm: np.ndarray  # (ndev, ns_loc) boundary-first subdomain order
    partners_local: np.ndarray  # (ndev, degm1, nloc) in-shard partner gathers
    send_idx: Tuple[np.ndarray, ...]  # per offset (ndev, n_send) into (nb*k) + pad
    recv_partner: Tuple[np.ndarray, ...]  # per offset (ndev, deg_o, nloc) into recv + pad
    offsets: Tuple[int, ...]
    ndev: int
    ns_loc: int
    nb: int  # boundary subdomains per rank (the largest count)

    @classmethod
    def build(cls, space: LeafDualSpace, ndev: int) -> "LeafOverlapPlan":
        """The plan of ``space`` over ``ndev`` ranks, vectorized: one pass
        over each partner plane, no loop over the edges."""
        rows = np.asarray(space.rows)
        ns, k = rows.shape
        if ns % ndev:
            raise ValueError(f"ns={ns} not divisible by ndev={ndev}")
        ns_loc = ns // ndev
        nloc = ns_loc * k
        partners = np.asarray(space.partners)  # (degm1, ns*k), pad = ns*k
        degm1, nleaf = partners.shape
        flat = np.arange(nleaf)
        fdev = (flat // k) // ns_loc
        floc = flat - fdev * nloc

        partners_local = np.full((ndev, max(degm1, 1), nloc), nloc, np.int32)
        ei, ej = [], []  # remote edges in (plane, leaf) order: i receives j
        for d in range(degm1):
            js = partners[d]
            real = js < nleaf
            ii, jj = flat[real], js[real].astype(np.int64)
            same = fdev[ii] == fdev[jj]
            partners_local[fdev[ii[same]], d, floc[ii[same]]] = floc[jj[same]]
            ei.append(ii[~same])
            ej.append(jj[~same])
        ei = np.concatenate(ei) if ei else np.zeros(0, np.int64)
        ej = np.concatenate(ej) if ej else np.zeros(0, np.int64)
        rd, li, sd, lj = fdev[ei], floc[ei], fdev[ej], floc[ej]
        off = (rd - sd) % ndev

        # boundary subdomains: own a leaf that sends or receives
        bmask = np.zeros((ndev, ns_loc), dtype=bool)
        bmask[rd, li // k] = True
        bmask[sd, lj // k] = True
        nb = int(bmask.sum(axis=1).max()) if ndev else 0
        perm = np.argsort(~bmask, axis=1, kind="stable").astype(np.int32)
        inv_perm = np.empty_like(perm)
        np.put_along_axis(inv_perm, perm.astype(np.int64),
                          np.broadcast_to(np.arange(ns_loc, dtype=np.int32), perm.shape), axis=1)

        offsets = tuple(int(o) for o in np.unique(off))
        send_idx, recv_partner = [], []
        for o in offsets:
            e = np.flatnonzero(off == o)
            # sender side: each rank's leaves to ship, in order of first use
            skey = sd[e] * nloc + lj[e]
            uk, first = np.unique(skey, return_index=True)
            uk = uk[np.argsort(first, kind="stable")]
            u_dev, u_leaf = uk // nloc, uk % nloc
            u_pos = _rank_in_group(u_dev)
            n_send = int(np.bincount(u_dev, minlength=ndev).max())
            sidx = np.full((ndev, n_send), nb * k, np.int32)
            sidx[u_dev, u_pos] = inv_perm[u_dev, u_leaf // k] * k + u_leaf % k
            pos = np.full(ndev * nloc, -1, np.int64)
            pos[uk] = u_pos
            # receiver side: per local leaf, the slots of the recv buffer to add
            rkey = rd[e] * nloc + li[e]
            slot = _rank_in_group(rkey)
            deg_o = int(slot.max()) + 1 if len(slot) else 1
            rp = np.full((ndev, max(deg_o, 1), nloc), n_send, np.int32)
            rp[rd[e], slot, li[e]] = pos[skey]
            send_idx.append(sidx)
            recv_partner.append(rp)
        return cls(perm=perm, partners_local=partners_local, send_idx=tuple(send_idx),
                   recv_partner=tuple(recv_partner), offsets=offsets, ndev=int(ndev),
                   ns_loc=int(ns_loc), nb=nb)


@dataclasses.dataclass
class OverlappedLeafOperator(Struct):
    """Drop-in for :class:`~permon_tpu_torch.feti.leaf.LeafDualOperator`
    in the leaf solvers (overlap.py:270-291): ``apply`` runs the
    overlapped exchange on this rank's subdomains and all-gathers the
    result; ``space`` (the whole leaf space) gives the weighted dots.  Holds
    this rank's blocks of ``blk`` / ``invs`` and its tables: the send packs,
    the in-shard combine and the received combine."""

    op: LeafDualOperator  # this rank's blk / invs, the whole space
    plan: LeafOverlapPlan
    mesh: Mesh
    idxb: torch.Tensor  # (nb,) boundary subdomains (local numbering)
    idxi: torch.Tensor  # (ns_loc - nb,) interior subdomains
    send: Tuple[GatherTable, ...]  # per offset: cb (nb*k) -> send buffer
    local: GatherTable  # contrib (nloc) -> own + in-shard partners
    recv: Optional[GatherTable]  # [out1; recv buffers] -> + received partners

    @classmethod
    def create(cls, op: LeafDualOperator, plan: LeafOverlapPlan, mesh: Mesh
               ) -> "OverlappedLeafOperator":
        """This rank's operator of a whole-space leaf operator ``op``."""
        if plan.ndev != mesh.size:
            raise ValueError(f"the plan is for {plan.ndev} ranks, the mesh has {mesh.size}")
        r, nsl, nb = mesh.rank, plan.ns_loc, plan.nb
        lo, hi = r * nsl, (r + 1) * nsl
        k = op.blk.shape[1]
        nloc = nsl * k
        dev = op.blk.device
        kernel = op.space.comb.kernel

        def table(idx, n_src):
            idx = np.asarray(idx, dtype=np.int32)
            return GatherTable.from_host(idx, (idx < n_src).astype(np.float64), dev,
                                         n_src=n_src).replace(kernel=kernel)

        send = tuple(table(s[r][None, :], nb * k) for s in plan.send_idx)
        local = table(np.concatenate([np.arange(nloc, dtype=np.int32)[None, :],
                                      plan.partners_local[r]]), nloc)
        recv = None
        if plan.offsets:
            n_src = nloc + sum(s.shape[1] for s in plan.send_idx)
            planes, base = [np.arange(nloc, dtype=np.int64)[None, :]], nloc
            for s, rp in zip(plan.send_idx, plan.recv_partner):
                n_send = s.shape[1]
                planes.append(np.where(rp[r] < n_send, rp[r].astype(np.int64) + base, n_src))
                base += n_send
            recv = table(np.concatenate(planes), n_src)
        perm = torch.as_tensor(plan.perm[r].astype(np.int64), device=dev)
        mine = op.replace(blk=op.blk[lo:hi], invs=op.invs[lo:hi])
        return cls(op=mine, plan=plan, mesh=mesh, idxb=perm[:nb], idxi=perm[nb:],
                   send=send, local=local, recv=recv)

    @property
    def space(self) -> LeafDualSpace:
        return self.op.space

    def _solve(self, u: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """The condensed contributions blk (K+ blk' Lam) of subdomains idx."""
        w = torch.bmm(self.op.invs[idx], u[idx].transpose(1, 2))
        return torch.bmm(self.op.blk[idx], w).squeeze(-1)

    def apply_local(self, Lam: torch.Tensor) -> torch.Tensor:
        """This rank's (ns_loc, k) block of F Lam for the whole (ns, k)
        leaf array ``Lam`` (overlap.py:182-250)."""
        check_full_precision(Lam.device)
        plan, dt = self.plan, Lam.dtype
        r, nsl = self.mesh.rank, plan.ns_loc
        L = Lam[r * nsl:(r + 1) * nsl]
        u = torch.bmm(L.unsqueeze(1), self.op.blk)  # (ns_loc, 1, nl)
        # boundary subdomains: solve, condense and ship first
        cb = self._solve(u, self.idxb)
        cbf = cb.reshape(-1)
        pending = ppermute([table_as(t, dt).apply(cbf) for t in self.send], plan.offsets,
                           self.mesh)
        # interior solves and the in-shard combine while the buffers travel
        ci = self._solve(u, self.idxi)
        contrib = torch.empty_like(L)
        contrib[self.idxb] = cb
        contrib[self.idxi] = ci
        out = table_as(self.local, dt).apply(contrib.reshape(-1))
        recvs = pending.wait()
        if self.recv is not None:
            out = table_as(self.recv, dt).apply(torch.cat([out] + recvs))
        return out.reshape(L.shape)

    def apply(self, Lam: torch.Tensor) -> torch.Tensor:
        return all_gather(self.apply_local(Lam), self.mesh)


def leaf_apply_overlapped(op: LeafDualOperator, plan: LeafOverlapPlan, mesh: Mesh):
    """``apply(Lam)`` -> this rank's (ns_loc, k) block of F Lam, with the
    boundary exchange overlapped with the interior solves (the body of the
    JAX package's shard_map; the module docstring)."""
    return OverlappedLeafOperator.create(op, plan, mesh).apply_local


def feti_dual_apply_hier(B, kplus, mesh: Mesh):
    """Row-space F = B K+ B' on a two-level mesh with the reduction
    written out (overlap.py:294-332): the rank's partial B u summed over
    'sd' (within the host group) first, then over 'host'.  ``B`` and
    ``kplus`` are this rank's blocks (:func:`shard_qp2`)."""
    if len(mesh.axis_names) != 2:
        raise ValueError("feti_dual_apply_hier expects a two-axis mesh")
    host_ax, chip_ax = mesh.axis_names

    def apply(lam):
        part = all_reduce_sum(B.mv_partial(kplus.mv(B.rmv(lam))), mesh, chip_ax)
        return all_reduce_sum(part, mesh, host_ax)

    return apply


def shard_qp2(qp, kplus, mesh: Mesh):
    """The two-level placement of a dense-path QP (overlap.py:335-371):
    subdomains over the flattened ('host', 'sd') rank order, the coarse
    side replicated — :func:`~permon_tpu_torch.parallel.dist.shard_qp`."""
    return shard_qp(qp, kplus, mesh)

