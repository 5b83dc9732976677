"""Multi-device layout of TFETI problems on ``torch.distributed`` — the port
of :mod:`permon_tpu.parallel.dist`.

The layout is the JAX package's, after the reference's MPI decomposition
(SURVEY 2.10):

- the subdomain axis is sharded: a rank owns ``ns / world`` contiguous
  subdomains and holds only their K blocks (or stencil data), their band
  factors and regularization, the primal vectors, the rows of R and its
  own slice of the extension's gather tables, on its own device;
- dual vectors are replicated: every rank runs the dual solver (CG,
  MPRGP, SMALXE) on the whole lambda, so the solvers do not change, and
  every dot and stop test reads a value that is bitwise equal on every
  rank (a rank that stopped alone would hang the others);
- each F = B K+ B' costs one collective: B'lambda is a local gather from
  the replicated lambda (the rank's rows of the primal-major table), K+ is
  local, and B u gives each rank a length-m partial, summed by one
  ``all_reduce``.  The JAX package drops the dual-major table under a mesh
  and scatter-adds the triplets; the port keeps its no-atomics rule: each
  rank has a DUAL-MAJOR table over its own primal dofs, in the slot order
  of the one-device table, whose slots owned by other ranks point at the
  zero pad.  With at most two entries per dual row (nonredundant and full
  gluing, Dirichlet rows) each partial is ``a + 0``, so the all-reduced F
  is bitwise equal to the one-device F for any world size;
- the coarse problem is replicated (every rank builds the same host G and
  GG' and factors its own copy; :func:`replicate_projector`), or lives on
  redundancy groups (:mod:`permon_tpu_torch.parallel.coarse`).

JAX places arrays with a ``NamedSharding`` and GSPMD infers every
collective inside solvers that never mention a mesh.  PyTorch has no
GSPMD, so the port is SPMD with explicit collectives: one process per rank
(``torchrun``), every rank running the same Python code, and every
operator that maps the sharded primal space into the replicated dual or
coarse space ends in one ``all_reduce``: :meth:`ShardedExtension.mv`,
:meth:`ShardedEll.rmv` (R'u) and ``BlockCoarse.mv``.  The reassembly of
the global solution (feti/large.py) gathers the ranks' blocks instead
(one ``all_gather``) and sums each dof's copies in the one-device order.

The collectives choose by the group's backend, never by catching a
failure: NCCL takes CUDA tensors; gloo takes CPU tensors, and CUDA tensors
for ``all_reduce`` and ``broadcast`` (PyTorch's backend table), while its
``all_gather`` and point-to-point copies of a CUDA tensor go through
pinned host memory (``Mesh.staged`` names them).  A mesh made without a
process group (one process, nothing to talk to) has size 1 and every
collective over it is the identity.

Not ported: the ``jax.ShapeDtypeStruct`` branch of ``_put``, which served
the AOT memory audits of ``scripts/memaudit.py`` (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..core.extension import GatherTable, SubdomainExtension, pack_planes
from ..core.linop import Ell

#: the collectives that gloo does not take CUDA tensors for: a CUDA tensor
#: crosses pinned host memory for these
GLOO_HOST_STAGED = ("all_gather", "ppermute")


class Mesh:
    """A device mesh of ranks: the attributes the JAX package's callers read
    of a ``jax.sharding.Mesh`` (``axis_names``, ``shape``, ``size``), this
    rank's coordinates and compute device, the process group of each axis,
    and how the collectives run (``backend``, ``staged``).  Ranks are laid
    out row-major over ``shape``: the flattened order is the rank order,
    which is the subdomain order."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], rank: int,
                 device: torch.device, device_mesh=None):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in shape)
        self.rank = int(rank)
        self.device = device
        self.device_mesh = device_mesh
        if device_mesh is None:
            self.backend, self.staged = "none", ()
        else:
            self.backend = _backend_for(None, device)
            self.staged = GLOO_HOST_STAGED if (self.backend == "gloo"
                                               and device.type == "cuda") else ()

    def __repr__(self):
        return (f"Mesh(axis_names={self.axis_names}, shape={self.shape}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend!r}, staged={self.staged})")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def coords(self) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(self.rank, self.shape))

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: Optional[str] = None):
        """The process group of ``axis`` (None: the whole mesh)."""
        if axis is None or len(self.axis_names) == 1:
            return None  # the default group: a mesh spans every rank
        return self.device_mesh.get_group(axis)

    def subdomains(self, ns: int) -> Tuple[int, int]:
        """[lo, hi): the contiguous subdomains this rank owns."""
        if ns % self.size:
            raise ValueError(f"ns={ns} not divisible by {self.size} ranks")
        per = ns // self.size
        return self.rank * per, (self.rank + 1) * per


def check_mesh(mesh) -> None:
    """``TypeError`` for a ``mesh`` option that is neither None nor a
    :class:`Mesh`."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a permon_tpu_torch.parallel Mesh (make_mesh / "
                        f"make_mesh2), got {type(mesh).__name__}")


def _backend_for(group, device: torch.device) -> str:
    """The backend that runs collectives on ``device``'s tensors in
    ``group``: from the group's backend configuration ('gloo', 'nccl', or
    per device type as in 'cuda:gloo,cpu:gloo')."""
    cfg = dist.get_backend_config(group)
    for part in cfg.split(","):
        if ":" not in part:
            return part.strip()
        dev_type, backend = part.split(":", 1)
        if dev_type.strip() == device.type:
            return backend.strip()
    raise ValueError(f"the process group ({cfg!r}) has no backend for {device.type} tensors")


def _rank_device(device) -> torch.device:
    """This process's compute device: ``device`` as given, or for a CUDA
    device without an index the card ``LOCAL_RANK % device_count`` (ranks
    share the cards of a host; several ranks may share one card)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           % torch.cuda.device_count())
    return dev


def _make(shape: Tuple[int, ...], axis_names: Tuple[str, ...], device) -> Mesh:
    dev = _rank_device(device)
    if dev.type == "cuda":
        # the device first: DeviceMesh would otherwise pick LOCAL_RANK,
        # which does not exist when several ranks share one card
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group("gloo" if dev.type == "cpu" else "cpu:gloo,cuda:nccl")
    world = dist.get_world_size() if dist.is_initialized() else 1
    want = int(np.prod(shape)) if all(s is not None for s in shape) else world
    if want != world:
        raise ValueError(f"a mesh spans every rank: shape {shape} but the world has "
                         f"{world} ranks")
    shape = tuple(world if s is None else int(s) for s in shape)
    if not dist.is_initialized():
        return Mesh(axis_names, shape, 0, dev)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, shape, mesh_dim_names=axis_names)
    return Mesh(axis_names, shape, dist.get_rank(), dev, device_mesh=dm)


def make_mesh(n_devices: Optional[int] = None, axis: str = "sd", device=None) -> Mesh:
    """A one-axis mesh over every rank of the process group (dist.py:39).
    Needs an initialized process group or torchrun's environment (then the
    group is made here: gloo for the CPU, NCCL for CUDA tensors); without
    either it is the one-process mesh of size 1.  ``n_devices``, when given,
    must equal the world size.  ``device``: this rank's compute device
    (None: the card ``LOCAL_RANK % device_count``)."""
    return _make((n_devices,), (axis,), device)


# -- collectives -----------------------------------------------------------


def _staged(mesh: Mesh, op: str, t: torch.Tensor) -> bool:
    return t.is_cuda and op in mesh.staged


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, axis: Optional[str] = None) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``axis`` (None: the whole mesh),
    as a new tensor on ``t``'s device (``t`` itself on a mesh without a
    process group)."""
    if mesh.device_mesh is None:
        return t
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=mesh.group(axis))
    return out


def broadcast(t: torch.Tensor, mesh: Mesh, src: int = 0, axis: Optional[str] = None
              ) -> torch.Tensor:
    """``t`` of the rank with index ``src`` along ``axis`` (None: the rank
    ``src`` of the whole mesh) on every rank, as a new tensor."""
    if mesh.device_mesh is None:
        return t
    group = mesh.group(axis)
    root = src if group is None else dist.get_global_rank(group, src)
    out = t.clone(memory_format=torch.contiguous_format)
    dist.broadcast(out, root, group=group)
    return out


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0 in rank
    order, on every rank."""
    if mesh.device_mesh is None:
        return t
    src = _pinned_copy(t) if _staged(mesh, "all_gather", t) else t.contiguous()
    out = src.new_empty((mesh.size * t.shape[0],) + tuple(t.shape[1:]))
    if src.is_cuda:
        dist.all_gather_into_tensor(out, src)
    else:  # gloo: into the rank-order chunks of ``out``
        dist.all_gather(list(out.chunk(mesh.size)), src)
    return out.to(t.device)


def all_gather_object(obj, mesh: Mesh) -> list:
    """Every rank's picklable ``obj``, in rank order (setup data only)."""
    if mesh.device_mesh is None:
        return [obj]
    out: list = [None] * mesh.size
    dist.all_gather_object(out, obj)
    return out


class Pending:
    """The receives of a :func:`ppermute` in flight: :meth:`wait` returns
    them, one tensor per offset, on the device of the sends.  Holds the
    send and receive buffers until then."""

    def __init__(self, works, sends: List[torch.Tensor], recvs: List[torch.Tensor],
                 device: torch.device):
        self.works, self.sends, self.recvs, self.device = works, sends, recvs, device

    def wait(self) -> List[torch.Tensor]:
        for w in self.works:
            w.wait()
        return [r.to(self.device) for r in self.recvs]


def ppermute(bufs: Sequence[torch.Tensor], offsets: Sequence[int], mesh: Mesh) -> Pending:
    """``lax.ppermute`` over the flattened mesh, one permutation per offset:
    rank s sends ``bufs[i]`` to rank (s + offsets[i]) % size and receives a
    buffer of the same shape from (s - offsets[i]) % size.  Returns at once
    (``batch_isend_irecv``); :meth:`Pending.wait` waits for the receives."""
    dev = bufs[0].device if bufs else mesh.device
    if mesh.device_mesh is None:
        return Pending([], [], list(bufs), dev)
    n, r = mesh.size, mesh.rank
    stage = bool(bufs) and _staged(mesh, "ppermute", bufs[0])
    ops, sends, recvs = [], [], []
    for buf, o in zip(bufs, offsets):
        send = _pinned_copy(buf) if stage else buf.contiguous()
        recv = torch.empty_like(send)
        ops += [dist.P2POp(dist.isend, send, (r + o) % n),
                dist.P2POp(dist.irecv, recv, (r - o) % n)]
        sends.append(send)
        recvs.append(recv)
    works = dist.batch_isend_irecv(ops) if ops else []
    return Pending(works, sends, recvs, dev)


# -- sharded operators -------------------------------------------------------


@dataclasses.dataclass
class ShardedExtension(SubdomainExtension):
    """This rank's block of an extension operator B (m, ns*nl): the host
    triplet of its own subdomains, the rows of the primal-major table
    (``gBt``, B'lambda local) and the dual-major table over its own dofs
    (``gB``, the slot order of the one-device table, other ranks' slots at
    the zero pad).  ``mv`` is the partial B u of the rank plus one
    ``all_reduce``; ``shape`` is (m, ns_loc*nl), the local primal space."""

    mesh: Any = None
    #: the first subdomain of this rank (global numbering)
    sd0: int = 0

    def mv_partial(self, u):
        """This rank's share of B u (before the all_reduce)."""
        self._need_tables()
        return self.gB.apply(u)

    def mv(self, u):
        return all_reduce_sum(self.mv_partial(u), self.mesh)


def shard_extension(B: SubdomainExtension, mesh: Mesh, axis: str = "sd",
                    device=None) -> ShardedExtension:
    """This rank's :class:`ShardedExtension` of ``B`` (a one-device
    extension with its global host triplet), its tables on ``device``
    (default: those of B's tables, else the mesh's device) and on the plain
    version when B's are (dist.py:57-64).  ``axis`` is kept for the JAX
    signature: subdomains shard over the flattened mesh."""
    del axis
    if isinstance(B, ShardedExtension):
        return B
    lo, hi = mesh.subdomains(B.ns)
    nl, m = B.nl, B.m_dual
    N, n0, n1 = B.ns * nl, lo * nl, hi * nl
    dev = B.gB.idx.device if B.gB is not None and device is None else (
        resolve_device(device) if device is not None else mesh.device)
    rows = B.rows.reshape(-1).astype(np.int64)
    vals = B.vals.reshape(-1)
    sub = np.repeat(np.arange(B.ns), B.cols.shape[1])
    gcols = sub * nl + B.cols.reshape(-1).astype(np.int64)
    real = (rows < m) & (vals != 0.0)
    rows, gcols, vals = rows[real], gcols[real], vals[real]
    # dual-major: the one-device table, slots of other ranks' dofs -> pad
    gi, gv, _ = pack_planes(rows, gcols.astype(np.int32), vals, m, N)
    own = (gi >= n0) & (gi < n1)
    gB = GatherTable.from_host(np.where(own, gi - n0, n1 - n0), np.where(own, gv, 0.0), dev,
                               n_src=n1 - n0)
    # primal-major: this rank's rows (each dof's entries in input order)
    mine = (gcols >= n0) & (gcols < n1)
    ti, tv, ov = pack_planes(gcols[mine] - n0, rows[mine].astype(np.int32), vals[mine],
                             n1 - n0, m, cap=2)
    gBt = GatherTable.from_host(ti, tv, dev, n_src=m, overflow=ov)
    kernel = B.gB.kernel if B.gB is not None else True
    return ShardedExtension(
        rows=np.ascontiguousarray(B.rows[lo:hi]), cols=np.ascontiguousarray(B.cols[lo:hi]),
        vals=np.ascontiguousarray(B.vals[lo:hi]), m_dual=m, ns=hi - lo, nl=nl,
        gB=gB.replace(kernel=kernel), gBt=gBt.replace(kernel=kernel), mesh=mesh, sd0=lo)


#: the large-path name (dist.py:96): the same per-rank tables
shard_extension_sparse = shard_extension


@dataclasses.dataclass
class ShardedEll(Ell):
    """This rank's rows of an :class:`~permon_tpu_torch.core.linop.Ell`
    (the nullspace R over the sharded primal space): ``mv`` is local,
    ``rmv`` (R'u, a primal reduction) the rank's column sums plus one
    ``all_reduce``.  The column table keeps the one-device width and slot
    order, so a column owned by one rank sums as on one device."""

    mesh: Any = None

    def rmv(self, x):
        return all_reduce_sum(super().rmv(x), self.mesh)


def shard_ell(R: Ell, mesh: Mesh, lo: int, hi: int, device=None) -> ShardedEll:
    """Rows [lo, hi) of ``R`` as a :class:`ShardedEll` on ``device``
    (default: R's)."""
    dev = R.vals.device if device is None else resolve_device(device)
    kk = R.cols.shape[1]
    t = R.t_slots
    pad = (hi - lo) * kk
    t_loc = torch.where((t >= lo * kk) & (t < hi * kk), t - lo * kk, torch.full_like(t, pad))
    return ShardedEll(cols=R.cols[lo:hi].to(dev), vals=R.vals[lo:hi].to(dev),
                      shape=(hi - lo, R.shape[1]), t_slots=t_loc.to(dev), mesh=mesh)


def shard_qp(qp, kplus, mesh: Mesh, axis: str = "sd"):
    """This rank's block of a TFETI decomposed QP of the dense path
    (dist.py:66-94): its K blocks, b, rows of R, extension tables and
    Cholesky factors; cE / cI replicated.  Returns (qp_sharded,
    kplus_sharded)."""
    from ..core.blockdiag import BlockDiagDense
    from ..core.factor import BlockDiagCholInv

    if not isinstance(qp.A, BlockDiagDense):
        raise TypeError("shard_qp expects a block-diagonal Hessian (BlockDiagDense)")
    if not isinstance(qp.BE, SubdomainExtension):
        raise TypeError("shard_qp expects an extension BE")
    if not isinstance(kplus, BlockDiagCholInv):
        raise TypeError("shard_qp expects a BlockDiagCholInv K+")
    ns, nl, _ = qp.A.blocks.shape
    lo, hi = mesh.subdomains(ns)
    r0, r1 = lo * nl, hi * nl
    BI = (shard_extension(qp.BI, mesh, axis) if isinstance(qp.BI, SubdomainExtension)
          else qp.BI)
    qp_sh = qp.replace(
        A=qp.A.replace(blocks=qp.A.blocks[lo:hi]), BE=shard_extension(qp.BE, mesh, axis),
        BI=BI, b=qp.b[r0:r1],
        x0=None if qp.x0 is None else qp.x0[r0:r1],
        R=None if qp.R is None else shard_ell(qp.R, mesh, r0, r1))
    kplus_sh = kplus.replace(chols=kplus.chols[lo:hi], shape=(r1 - r0, r1 - r0),
                             invs=None if kplus.invs is None else kplus.invs[lo:hi])
    return qp_sh, kplus_sh


def shard_blockdia(op, lo: int, hi: int, device=None, base=None):
    """Subdomains [lo, hi) of a BlockDia or RegularizedBlockDia stencil on
    ``device`` (default: the stencil's).  ``base``: a RegularizedBlockDia's
    base, sliced already (the QP's A, which the regularization shares)."""
    from ..core.dia import RegularizedBlockDia

    if isinstance(op, RegularizedBlockDia):
        base = shard_blockdia(op.base, lo, hi, device) if base is None else base
        dev = base.data.device
        return op.replace(base=base, idx=op.idx[lo:hi].to(dev), q=op.q[lo:hi].to(dev),
                          bi=op.bi[lo:hi].to(dev))
    n = (hi - lo) * op.nlp
    dev = op.data.device if device is None else resolve_device(device)
    return op.replace(data=op.data[lo:hi].to(dev), shape=(n, n))


def shard_band(kp, lo: int, hi: int):
    """Subdomains [lo, hi) of a BandCholInv: its scan-major factors sliced
    along dim 1 and its refinement operator."""
    from ..core.band import BlockTridiag

    if kp is None:
        return None
    nb, _, NB, _ = kp.Dinv.shape
    n = (hi - lo) * nb * NB
    op = kp.op
    if isinstance(op, BlockTridiag):
        op = op.replace(Ad=op.Ad[lo:hi], Asub=op.Asub[lo:hi], shape=(n, n))
    elif op is not None:
        op = shard_blockdia(op, lo, hi)
    return kp.replace(Dinv=kp.Dinv[:, lo:hi].contiguous(), F=kp.F[:, lo:hi].contiguous(),
                      shape=(n, n), op=op)


def shard_qp_sparse(qp, kplus, mesh: Mesh, kplus_post=None, device=None):
    """This rank's block of a LARGE-PATH TFETI QP (BlockDia stencil, band
    K+, gather-table extensions; dist.py:133-194): the stencil, the
    scan-major band factors (dim 1), the regularization, b, the rows of R
    and the per-rank tables of BE and BI; cE / cI and the coarse side
    replicated.  Works on one- and two-axis meshes (subdomains shard over
    the flattened rank order).  ``device``: where the block goes (default:
    where ``qp`` lies; the extensions' tables, made here when ``qp``'s have
    none, go to the mesh's device).  ``kplus`` may be None.  Returns
    ``(qp_sharded, kplus_sharded, kplus_post_sharded)``.
    :func:`~permon_tpu_torch.feti.large.assemble_qp_sparse` with
    ``FetiOptions(mesh=...)`` places its host-built QP through this."""
    from ..core.dia import BlockDia

    if not isinstance(qp.A, BlockDia):
        raise TypeError("shard_qp_sparse expects a BlockDia Hessian")
    lo, hi = mesh.subdomains(qp.A.ns)
    nlp = qp.A.nlp
    r0, r1 = lo * nlp, hi * nlp
    dev = qp.b.device if device is None else resolve_device(device)
    qp_sh = qp.replace(
        A=shard_blockdia(qp.A, lo, hi, dev), BE=shard_extension(qp.BE, mesh, device=device),
        BI=None if qp.BI is None else shard_extension(qp.BI, mesh, device=device),
        b=qp.b[r0:r1].to(dev), x0=None if qp.x0 is None else qp.x0[r0:r1].to(dev),
        R=None if qp.R is None else shard_ell(qp.R, mesh, r0, r1, device=dev))
    return qp_sh, shard_band(kplus, lo, hi), shard_band(kplus_post, lo, hi)


def replicate_projector(pf, mesh: Mesh):
    """The replicated coarse projector (dist.py:196-210).  Every rank builds
    the same host G and GG' and factors its own copy on its own device, so
    the projector is replicated as it is made: this checks that it lies on
    the rank's device and returns it."""
    from ..core.linop import operator_device

    dev = operator_device(pf.replace(cp_dist=None))
    if dev != mesh.device:
        raise ValueError(f"the projector is on {dev}, the rank's device is {mesh.device}")
    return pf


def feti_dual_apply_shard_map(B: ShardedExtension, kplus, mesh: Mesh, axis: str = "sd"):
    """The explicit dual apply F = B K+ B' on a rank (dist.py:212-270): the
    local gather of the replicated lambda into the rank's subdomains, the
    local K+ solves, the rank's partial B u and the ONE all_reduce — the
    single collective per F application.  Returns ``apply(lam) -> F lam``
    (the name of the JAX package's shard_map version, so that the
    counterpart is easy to find)."""
    del axis

    def apply(lam):
        return all_reduce_sum(B.mv_partial(kplus.mv(B.rmv(lam))), mesh)

    return apply


def global_rows(op) -> int:
    """The rows of an operator over the primal space: a sharded one's
    local rows times the ranks (each holds an equal block)."""
    mesh = operator_mesh(op)
    return op.shape[0] * (1 if mesh is None else mesh.size)


def operator_mesh(op) -> Optional[Mesh]:
    """The mesh of a sharded operator (looking through VStack, Transpose
    and Product), or None."""
    mesh = getattr(op, "mesh", None)
    if isinstance(mesh, Mesh):
        return mesh
    for name in ("ops", "inner"):
        sub = getattr(op, name, None)
        for o in (sub if isinstance(sub, tuple) else (sub,)):
            if o is not None:
                found = operator_mesh(o)
                if found is not None:
                    return found
    return None
