"""Scale-capable K+ — batched blocked band Cholesky, the port of
:mod:`permon_tpu.core.band` (the large-subdomain MATINV path, reference:
src/mat/impls/inv/matinv.c:481-590).

A matrix of bandwidth bw < NB is block tridiagonal with (NB, NB) blocks;
its Cholesky factor follows the recurrence

    F_i = A_{i,i-1} D_{i-1}^{-T},   D_i = chol(A_ii - F_i F_i'),

run as a loop over the nb block rows with every step a batched (over
subdomains) dense op.  Applies are two loops (forward/backward
substitution) of batched GEMVs against the stored D^{-1} and F blocks;
on a card one apply is the replay of a CUDA graph of those loops,
captured once per operator and input shape (:meth:`BandCholInv._replay`).
Floating subdomains get FIXING-DOF regularization (reference:
src/mat/interface/permonmatregularize.c:117-287): Kreg = K + rho R_I
(R_I'R_I)^{-1} R_I', an exact generalized inverse of K.

Factors are stored SCAN-MAJOR, (nb, ns, NB, NB), block-row index leading,
so each step of the loops reads one contiguous (ns, NB, NB) slab.

Two ways in: :meth:`BandCholInv.from_blockdia` factorizes from a stencil
(the large path: the block rows are expanded inside the loop),
:meth:`BandCholInv.from_block_tridiag` from explicit (NB, NB) blocks
(:func:`make_band_kplus` for a list of sparse blocks, and
:func:`band_chol_single`, the RCM-ordered band factorization of ONE sparse
SPD matrix that serves the coarse problem GG' past 2048 rows,
qp/projector.py).  Both run the same factor loop.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .. import as_torch_dtype, resolve_device
from ..sys.tracing import trace
from .linop import LinearOperator


# ---------------------------------------------------------------------------
# host-side setup (numpy / scipy copies of the JAX package's helpers)
# ---------------------------------------------------------------------------


def rcm_order(a) -> np.ndarray:
    """Bandwidth-reducing (reverse Cuthill-McKee) ordering of a sparse
    symmetric matrix."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(reverse_cuthill_mckee(sp.csr_matrix(a), symmetric_mode=True))


def bandwidth(a) -> int:
    coo = a.tocoo()
    if coo.nnz == 0:
        return 0
    return int(np.abs(coo.row.astype(np.int64) - coo.col).max())


def csr_to_block_tridiag(a, NB: int) -> Tuple[np.ndarray, np.ndarray]:
    """(nl, nl) sparse with bandwidth < NB -> block-tridiagonal numpy blocks
    Ad (nb, NB, NB), Asub (nb, NB, NB) with Asub[0] = 0.  Padding rows get a
    unit diagonal.  The superdiagonal entries are the transposes of the
    stored subdiagonal ones and are dropped."""
    import scipy.sparse as sp

    a = sp.coo_matrix(a)
    nl = a.shape[0]
    nb = max((nl + NB - 1) // NB, 1)
    bw = bandwidth(a)
    if bw >= NB:
        raise ValueError(f"bandwidth {bw} >= block size {NB}; raise NB or reorder")
    Ad = np.zeros((nb, NB, NB))
    Asub = np.zeros((nb, NB, NB))
    bi, ri = np.divmod(a.row.astype(np.int64), NB)
    bj, rj = np.divmod(a.col.astype(np.int64), NB)
    diag = bi == bj
    np.add.at(Ad, (bi[diag], ri[diag], rj[diag]), a.data[diag])
    sub = bi == bj + 1
    np.add.at(Asub, (bi[sub], ri[sub], rj[sub]), a.data[sub])
    pad = np.arange(nl, nb * NB)
    Ad[pad // NB, pad % NB, pad % NB] = 1.0
    return Ad, Asub


def fixing_dofs(R_block: np.ndarray, lo: int = 0, hi: Optional[int] = None) -> np.ndarray:
    """k = R.shape[1] fixing dofs with a well-conditioned restriction R_I
    (column-pivoted QR on R'), restricted to rows [lo, hi)."""
    from scipy.linalg import qr

    k = R_block.shape[1]
    if k == 0:
        return np.zeros(0, dtype=np.int64)
    hi = R_block.shape[0] if hi is None else hi
    _, _, piv = qr(R_block[lo:hi].T, pivoting=True)
    return np.sort(piv[:k] + lo)


def _fixing_window(R_block: np.ndarray, NB: int, nl: int) -> Tuple[int, int]:
    """The [lo, hi) row window the fixing dofs are picked from: inside ONE
    diagonal band block near the end of the ordering, restricted to rows
    where R is supported (core/band.py:119-135)."""
    k = R_block.shape[1]
    rnz = np.flatnonzero(np.abs(R_block[:nl]).sum(axis=1) != 0.0)
    if len(rnz) == 0:
        raise ValueError("nullspace basis has no nonzero rows")
    n_real = int(rnz[-1]) + 1
    last = (n_real - 1) // NB
    in_last = int(np.count_nonzero(rnz >= last * NB))
    if in_last >= max(4 * k, 16) or last == 0:
        return last * NB, n_real
    return (last - 1) * NB, last * NB


def _fixing_projector(R_block: np.ndarray, NB: int, nl: Optional[int]):
    """(I, Q): the fixing dofs of one block and Q = R_I (R_I'R_I)^{-1} R_I'."""
    nl = R_block.shape[0] if nl is None else nl
    lo, hi = _fixing_window(R_block, NB, nl)
    I = fixing_dofs(R_block, lo=lo, hi=hi)
    RI = R_block[I]
    return I, RI @ np.linalg.solve(RI.T @ RI, RI.T)


def regularize_block_tridiag(Ad: np.ndarray, Asub: np.ndarray, R_block: np.ndarray,
                             rho: float, NB: int, nl: Optional[int] = None):
    """Add rho * R_I (R_I'R_I)^{-1} R_I' at fixing dofs I (on copies), the
    fixing dofs inside ONE diagonal block near the end of the ordering, so
    the dense k x k coupling never widens the band."""
    if R_block.shape[1] == 0:
        return Ad, Asub
    I, Q = _fixing_projector(R_block, NB, nl)
    Ad = Ad.copy()
    bi = I // NB
    if not (bi == bi[0]).all():
        raise ValueError("fixing dofs span two band blocks")
    Ad[bi[0]][np.ix_(I % NB, I % NB)] += rho * Q
    return Ad, Asub


def regularize_csr(Ksp, R_block: np.ndarray, rho: float, NB: int,
                   nl: Optional[int] = None):
    """Sparse-matrix form of :func:`regularize_block_tridiag`: Kreg = K +
    rho * R_I (R_I'R_I)^{-1} R_I' as scipy CSR."""
    import scipy.sparse as sp

    if R_block.shape[1] == 0:
        return sp.csr_matrix(Ksp)
    I, Q = _fixing_projector(R_block, NB, nl)
    upd = sp.coo_matrix((rho * Q.reshape(-1), (np.repeat(I, len(I)), np.tile(I, len(I)))),
                        shape=Ksp.shape)
    return (sp.csr_matrix(Ksp) + upd.tocsr()).tocsr()


def gershgorin_max_eig_csr(Ksp) -> float:
    """max_i sum_j |K_ij| from sparse storage."""
    import scipy.sparse as sp

    return float(np.abs(sp.csr_matrix(Ksp)).sum(axis=1).max())


def gershgorin_max_eig(Ad: np.ndarray, Asub: np.ndarray) -> float:
    """max_i sum_j |K_ij| from block-tridiagonal storage: a cheap upper
    bound on lambda_max for the regularization rho."""
    rowsum = np.abs(Ad).sum(axis=2)
    rowsum[1:] += np.abs(Asub[1:]).sum(axis=2)
    rowsum[:-1] += np.abs(Asub[1:]).sum(axis=1)  # the A_{i,i-1}' contributions
    return float(rowsum.max())


# ---------------------------------------------------------------------------
# device-side operators and factorization
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BlockTridiag(LinearOperator):
    """Batched per-subdomain block-tridiagonal symmetric operator; only the
    diagonal and subdiagonal blocks are stored.  ``mv`` computes in the
    operator's storage dtype and casts back to the input's."""

    Ad: torch.Tensor  # (ns, nb, NB, NB)
    Asub: torch.Tensor  # (ns, nb, NB, NB), [:, 0] = 0
    shape: Tuple[int, int]

    @classmethod
    def from_blocks(cls, Ad, Asub, device=None) -> "BlockTridiag":
        Ad, Asub = _blocks_on_device(Ad, Asub, device)
        ns, nb, NB, _ = Ad.shape
        n = int(ns * nb * NB)
        return cls(Ad=Ad, Asub=Asub, shape=(n, n))

    def mv(self, x):
        ns, nb, NB, _ = self.Ad.shape
        _check_tf32(x.device)
        xb = x.reshape(ns, nb, NB, 1).to(self.Ad.dtype)
        y = torch.matmul(self.Ad, xb)
        # A_{i,i-1} x_{i-1}, then A_{i,i+1} x_{i+1} = Asub_{i+1}' x_{i+1}
        y[:, 1:] += torch.matmul(self.Asub[:, 1:], xb[:, :-1])
        y[:, :-1] += torch.matmul(self.Asub[:, 1:].transpose(2, 3), xb[:, 1:])
        return y.reshape(-1).to(x.dtype)

    rmv = mv  # symmetric

    def diagonal(self):
        return torch.diagonal(self.Ad, dim1=2, dim2=3).reshape(-1)


def _blocks_on_device(Ad, Asub, device):
    """The two block arrays as tensors on one device: tensors stay where
    they are (``device`` must agree), numpy arrays go to ``device``."""
    if isinstance(Ad, torch.Tensor):
        if device is not None and torch.device(device).type != Ad.device.type:
            raise ValueError(f"blocks live on {Ad.device}, device={device!r} was asked for")
        return Ad, torch.as_tensor(Asub, device=Ad.device)
    dev = resolve_device(device)
    return torch.as_tensor(Ad, device=dev), torch.as_tensor(Asub, device=dev)


def _expand_row(Dd: torch.Tensor, offsets, NB: int, Ad: torch.Tensor,
                Asub: torch.Tensor) -> None:
    """Write block row i of the block-tridiagonal factor input from its
    stencil diagonals ``Dd`` (ns, ndiag, NB) into the zeroed ``Ad`` /
    ``Asub`` (ns, NB, NB), or every block row at once with one more
    leading axis on all three: diagonal ``off`` puts Dd[:, d, r] at
    Ad[:, r, r + off] and, for off < 0, the rows r < -off at
    Asub[:, r, r + off + NB].  The same values the JAX package's masked eye
    products produce (core/band.py:361-371), written as diagonal views."""
    for d, off in enumerate(offsets):
        if -NB < off < NB:
            lo, hi = max(0, -off), min(NB, NB - off)
            torch.diagonal(Ad, offset=off, dim1=-2, dim2=-1).copy_(Dd[..., d, lo:hi])
        if -NB < off < 0:
            torch.diagonal(Asub, offset=off + NB, dim1=-2, dim2=-1).copy_(Dd[..., d, : -off])


def _check_tf32(dev: torch.device) -> None:
    """The band factors and their applies, the block K+ GEMVs and the leaf
    path's batched products need full-f32 products: under TF32 the f32
    Schur recurrence loses positive definiteness (the JAX package forces
    "highest" precision for the same reason, core/band.py:302-305), TF32
    GEMVs cap the refinement, and the f32-state leaf contact trajectory
    collapses (feti/leaf.py:138-141)."""
    if dev.type == "cuda" and (torch.backends.cuda.matmul.allow_tf32
                               or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True (or the float32 matmul precision "
            "is not 'highest'); the K+ factors and the leaf operator need full-precision "
            "products")


def expand_block_tridiag_dia(data: torch.Tensor, offsets, NB: int, dtype=None):
    """Expansion of per-subdomain DIA stencil data (ns, ndiag, nlp) to the
    scan-major block-tridiagonal factor input (Ad_sm, Asub_sm) of shape
    (nb, ns, NB, NB), on the stencil's device; the same values as the host
    :func:`csr_to_block_tridiag` followed by a cast to ``dtype``."""
    ns, ndiag, nlp = data.shape
    nb = nlp // NB
    dt = as_torch_dtype(dtype) or data.dtype
    D = data.to(dt).reshape(ns, ndiag, nb, NB).permute(2, 0, 1, 3)  # (nb, ns, ndiag, NB)
    Ad = torch.zeros((nb, ns, NB, NB), dtype=dt, device=data.device)
    Asub = torch.zeros_like(Ad)
    _expand_row(D, offsets, NB, Ad, Asub)
    return Ad, Asub


def _factor_loop(block_row, nb: int, ns: int, NB: int, dt, cdt, dev):
    """The block-tridiagonal Cholesky recurrence over ``nb`` block rows:
    ``block_row(i)`` gives (A_ii, A_{i,i-1}) as (ns, NB, NB) tensors of the
    compute dtype ``cdt``; returns scan-major (Dinv, F) of dtype ``dt`` with
    Dinv_i = D_i^{-1}, D_i = chol(A_ii - F_i F_i'), F_i = A_{i,i-1}
    D_{i-1}^{-T}, F_0 = 0.

    The recurrence runs in ``cdt`` and only the STORED factors are rounded
    to ``dt``.  They are written IN PLACE into preallocated tensors, one
    block row per step (a functional scan would hold a second copy of the
    multi-GB factor arrays at the end).  Raises if any pivot block is not
    positive definite (checked once, after the loop, from ``cholesky_ex``'s
    info)."""
    _check_tf32(dev)
    eye = torch.eye(NB, dtype=cdt, device=dev).expand(ns, NB, NB)
    Dinv = torch.empty((nb, ns, NB, NB), dtype=dt, device=dev)
    F = torch.empty((nb, ns, NB, NB), dtype=dt, device=dev)
    info = torch.zeros((nb, ns), dtype=torch.int32, device=dev)
    Dinv_prev = torch.zeros((ns, NB, NB), dtype=cdt, device=dev)
    for i in range(nb):
        Aii, Ai = block_row(i)
        Fi = torch.bmm(Ai, Dinv_prev.transpose(1, 2))  # A_{i,i-1} D^{-T}
        L, info[i] = torch.linalg.cholesky_ex(Aii - torch.bmm(Fi, Fi.transpose(1, 2)))
        Dinv_prev = torch.linalg.solve_triangular(L, eye, upper=False)
        F[i] = Fi
        Dinv[i] = Dinv_prev
    bad = torch.nonzero(info).tolist()
    if bad:
        raise ValueError(
            f"band Cholesky: {len(bad)} pivot blocks not positive definite "
            f"(first at block row {bad[0][0]}, subdomain {bad[0][1]})"
        )
    return Dinv, F


def factor_block_tridiag_sm(Ad_sm: torch.Tensor, Asub_sm: torch.Tensor, dtype=None):
    """Block-tridiagonal Cholesky on SCAN-MAJOR (nb, ns, NB, NB) blocks;
    returns scan-major (Dinv, F) of ``dtype`` (default: the blocks' dtype).
    The recurrence runs in the wider of the blocks' dtype and ``dtype``
    (:func:`_factor_loop`)."""
    nb, ns, NB, _ = Ad_sm.shape
    dt = as_torch_dtype(dtype) or Ad_sm.dtype
    cdt = torch.promote_types(Ad_sm.dtype, dt)
    return _factor_loop(lambda i: (Ad_sm[i].to(cdt), Asub_sm[i].to(cdt)),
                        nb, ns, NB, dt, cdt, Ad_sm.device)


def factor_block_tridiag(Ad, Asub, dtype=None, device=None):
    """Batch-major (ns, nb, NB, NB) wrapper around
    :func:`factor_block_tridiag_sm`; returns batch-major factors."""
    Ad, Asub = _blocks_on_device(Ad, Asub, device)
    Dinv, F = factor_block_tridiag_sm(Ad.transpose(0, 1), Asub.transpose(0, 1), dtype=dtype)
    return Dinv.transpose(0, 1), F.transpose(0, 1)


def factor_from_dia_sm(data: torch.Tensor, offsets, NB: int, dtype=None,
                       upd_bi=None, upd_idx=None, upd_q=None):
    """Fused expand-and-factor over SCAN-MAJOR blocks: block row i of the
    block-tridiagonal input is expanded from the (ns, ndiag, nlp) stencil
    diagonals inside the loop (the (nb, ns, NB, NB) inputs never exist),
    the rank-k fixing-dof correction ``upd_q`` is injected into each
    subdomain's diagonal block ``upd_bi[s]`` as the loop passes it, and the
    factors are written into preallocated (nb, ns, NB, NB) tensors of
    ``dtype`` (default: the stencil's dtype).

    The recurrence runs in the wider of the stencil's dtype and ``dtype``
    (f64 for the f64 stencil of the large path) and only the STORED factors
    are rounded to ``dtype``: f32 storage keeps half the memory, while an
    f32 recurrence measured on an H100 left the unrefined K+ 3x and the
    refined K+ four orders less accurate, and the 101^3 north-star residual
    after one primal defect pass at 1.7e-6 instead of 2.0e-8 (PERF.md).

    Returns (Dinv, F) as :func:`_factor_loop` gives them
    (core/band.py:336-389)."""
    ns, ndiag, nlp = data.shape
    nb = nlp // NB
    dt = dtype if dtype is not None else data.dtype
    cdt = torch.promote_types(data.dtype, dt)
    dev = data.device
    D = data.to(cdt).reshape(ns, ndiag, nb, NB)
    Ad = torch.empty((ns, NB, NB), dtype=cdt, device=dev)
    Asub = torch.empty((ns, NB, NB), dtype=cdt, device=dev)
    if upd_q is not None:
        kf = upd_idx.shape[1]
        sidx = torch.arange(ns, device=dev)[:, None, None].expand(ns, kf, kf)
        ridx = upd_idx[:, :, None].expand(ns, kf, kf)
        cidx = upd_idx[:, None, :].expand(ns, kf, kf)
        q = upd_q.to(cdt)

    def block_row(i):
        Ad.zero_()
        Asub.zero_()
        _expand_row(D[:, :, i, :], offsets, NB, Ad, Asub)
        if upd_q is not None:
            mask = (upd_bi == i).to(cdt)  # the blocks whose window is this row
            Ad.index_put_((sidx, ridx, cidx), q * mask[:, None, None], accumulate=True)
        return Ad, Asub

    return _factor_loop(block_row, nb, ns, NB, dt, cdt, dev)


#: device -> the side stream on which K+ passes are captured
_capture_streams: dict = {}


@dataclasses.dataclass
class _Replay:
    """One captured K+ pass: the graph, its static input and output, and
    the factors it reads."""

    graph: Any
    x: torch.Tensor
    y: torch.Tensor
    Dinv: torch.Tensor
    F: torch.Tensor


@dataclasses.dataclass
class BandCholInv(LinearOperator):
    """y = Kreg^{-1} x via the stored block-tridiagonal Cholesky factors.
    With ``refine`` > 0 and ``op`` set, each apply runs that many
    iterative-refinement steps against ``op`` (kept in its own precision),
    recovering direct accuracy from an f32 factorization."""

    Dinv: torch.Tensor  # (nb, ns, NB, NB), scan-major
    F: torch.Tensor  # (nb, ns, NB, NB), scan-major; F[0] = 0
    shape: Tuple[int, int]
    op: Any = None
    refine: int = 0

    @classmethod
    def from_block_tridiag(cls, Ad, Asub, dtype=None, refine: int = 0,
                           keep_operator: bool = False, op_dtype=None, op=None,
                           scan_major: bool = False, device=None) -> "BandCholInv":
        """Factorize explicit blocks, batch-major (ns, nb, NB, NB) or, with
        ``scan_major=True``, (nb, ns, NB, NB); numpy arrays go to ``device``,
        tensors stay on theirs.  ``dtype`` is the factors' storage dtype
        (default: the blocks'); the recurrence runs in the wider of the two
        (:func:`_factor_loop`).  With ``refine`` or ``keep_operator`` the
        refinement operator is ``op`` when given (e.g. a cheap stencil
        SpMV), else a :class:`BlockTridiag` of the blocks in ``op_dtype``
        (default: the INPUT precision, else an f32 factor could never
        refine past f32)."""
        Ad, Asub = _blocks_on_device(Ad, Asub, device)
        if scan_major:
            Ad_sm, Asub_sm = Ad, Asub
        else:
            Ad_sm, Asub_sm = Ad.transpose(0, 1), Asub.transpose(0, 1)
        nb, ns, NB, _ = Ad_sm.shape
        n = int(ns * nb * NB)
        if op is None and (keep_operator or refine):
            odt = as_torch_dtype(op_dtype) or Ad.dtype
            op = BlockTridiag.from_blocks(Ad_sm.transpose(0, 1).to(odt),
                                          Asub_sm.transpose(0, 1).to(odt))
        Dinv, F = factor_block_tridiag_sm(Ad_sm, Asub_sm, dtype=as_torch_dtype(dtype))
        return cls(Dinv=Dinv, F=F, shape=(n, n), op=op, refine=refine)

    @classmethod
    def from_blockdia(cls, op, NB: int, dtype=None, refine: int = 0) -> "BandCholInv":
        """Factorize from a (regularized) BlockDia stencil; ``op`` doubles
        as the refinement operator when ``refine`` > 0."""
        from .dia import RegularizedBlockDia

        n = int(op.shape[0])
        if isinstance(op, RegularizedBlockDia):
            Dinv, F = factor_from_dia_sm(op.base.data, op.base.offsets, NB, dtype=dtype,
                                         upd_bi=op.bi, upd_idx=op.idx, upd_q=op.q)
        else:
            Dinv, F = factor_from_dia_sm(op.data, op.offsets, NB, dtype=dtype)
        return cls(Dinv=Dinv, F=F, shape=(n, n), op=op if refine else None,
                   refine=refine)

    def _fwd(self, xb: torch.Tensor) -> torch.Tensor:
        """y = L^{-1} x on scan-major (nb, ns, NB) blocks (L_ii = D_i,
        L_{i,i-1} = F_i): y_i = Dinv_i (b_i - F_i y_{i-1})."""
        nb, ns, NB, _ = self.Dinv.shape
        Y = torch.empty_like(xb)
        y = torch.zeros((ns, NB, 1), dtype=xb.dtype, device=xb.device)
        for i in range(nb):
            y = torch.bmm(self.Dinv[i], xb[i, :, :, None] - torch.bmm(self.F[i], y))
            Y[i] = y[..., 0]
        return Y

    def _bwd(self, Y: torch.Tensor) -> torch.Tensor:
        """x = L^{-T} y: x_i = Dinv_i' (y_i - z_{i+1}) with the carried
        cross term z_i = F_i' x_i."""
        nb, ns, NB, _ = self.Dinv.shape
        X = torch.empty_like(Y)
        z = torch.zeros((ns, NB, 1), dtype=Y.dtype, device=Y.device)
        for i in range(nb - 1, -1, -1):
            xi = torch.bmm(self.Dinv[i].transpose(1, 2), Y[i, :, :, None] - z)
            z = torch.bmm(self.F[i].transpose(1, 2), xi)
            X[i] = xi[..., 0]
        return X

    def _to_blocks(self, x):
        nb, ns, NB, _ = self.Dinv.shape
        return x.reshape(ns, nb, NB).to(self.Dinv.dtype).transpose(0, 1).contiguous()

    @staticmethod
    def _from_blocks(Xb):
        return Xb.transpose(0, 1).reshape(-1)

    def half_solve_lower(self, x):
        """L^{-1} x: one forward loop."""
        _check_tf32(x.device)
        return self._from_blocks(self._fwd(self._to_blocks(x))).to(x.dtype)

    def half_solve_upper(self, x):
        """L^{-T} x: one backward loop."""
        _check_tf32(x.device)
        return self._from_blocks(self._bwd(self._to_blocks(x))).to(x.dtype)

    def _solve(self, x):
        """One forward and one backward pass: the span ``kplus.solve``. On a
        card, outside a stream capture, the pass is a CUDA graph's replay
        (:meth:`_replay`); on the CPU, and inside a capture, it is launched
        op by op (:meth:`_eager`)."""
        with trace("kplus.solve"):
            _check_tf32(x.device)
            if x.device.type != "cuda" or torch.cuda.is_current_stream_capturing():
                return self._eager(x)
            return self._replay(x)

    def _eager(self, x):
        """One forward and one backward pass, op by op, in the factors' dtype."""
        return self._from_blocks(self._bwd(self._fwd(self._to_blocks(x))))

    def _replay(self, x):
        """:meth:`_eager` cast to x's dtype, as one replay of the graph that
        this operator captured at its first call for x's shape, dtype and
        device (captured again when ``Dinv`` or ``F`` is another tensor than
        it was captured on). The graph reads its static input and writes its
        static output; the result is a copy, so two results never alias.
        The span ``kplus.replay`` opens around the replay alone."""
        graphs = self.__dict__.setdefault("_graphs", {})
        key = (tuple(x.shape), x.dtype, x.device)
        g = graphs.get(key)
        if g is None or g.Dinv is not self.Dinv or g.F is not self.F:
            g = graphs[key] = self._capture(x)
        g.x.copy_(x)
        with trace("kplus.replay"):
            if torch.autograd._profiler_enabled():
                # the profiler ties a kernel to the operator open at its
                # launch, and a span's range is a user range, not an
                # operator: the launch gets an operator's range of its own
                with torch._C._profiler._RecordFunctionFast("kplus.graph_launch"):
                    g.graph.replay()
            else:
                g.graph.replay()
        return g.y.clone()

    def _capture(self, x) -> "_Replay":
        """Capture one pass on a side stream, after an eager pass there (so
        that cuBLAS holds its workspace on that stream), as
        ``torch.cuda.graphs`` asks."""
        sx = x.clone(memory_format=torch.contiguous_format)
        s = _capture_streams.get(x.device)
        if s is None:
            s = _capture_streams[x.device] = torch.cuda.Stream(x.device)
        s.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(s):
            self._eager(sx)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=s):
            sy = self._eager(sx).to(x.dtype)
        return _Replay(graph=graph, x=sx, y=sy, Dinv=self.Dinv, F=self.F)

    def mv(self, x):
        y = self._solve(x).to(x.dtype)
        if self.refine and self.op is not None:
            for _ in range(self.refine):
                r = x - self.op.mv(y)
                y = y + self._solve(r).to(x.dtype)
        return y

    rmv = mv  # symmetric


def _default_nb(bw: int) -> int:
    """The band block size for bandwidth ``bw``: bw + 1 rounded up to a
    multiple of 128, at least 128."""
    return max(((bw + 1 + 127) // 128) * 128, 128)


def band_chol_single(S, dtype=None, NB: Optional[int] = None, reorder: bool = True,
                     device=None):
    """Band Cholesky of ONE sparse SPD matrix (RCM-reordered, padded to a
    block-tridiagonal ns = 1 batch): the sparse coarse-problem factorization
    (the GG' factor of qppf.c:282-333).

    Returns ``(inv, perm)``: ``inv`` solves the PERMUTED system (padded to a
    multiple of NB; callers pad and slice), ``perm`` is the RCM ordering
    used (the identity when ``reorder=False``)."""
    import scipy.sparse as sp

    S = sp.csr_matrix(S)
    perm = rcm_order(S) if reorder else np.arange(S.shape[0])
    Sp = S[perm][:, perm]
    if NB is None:
        NB = _default_nb(bandwidth(Sp))
    Ad, Asub = csr_to_block_tridiag(Sp, NB)
    inv = BandCholInv.from_block_tridiag(Ad[None], Asub[None], dtype=dtype, device=device)
    return inv, perm


def make_band_kplus(K_blocks: List, R_bases: Optional[List[np.ndarray]] = None,
                    NB: Optional[int] = None, dtype=None, refine: int = 0,
                    keep_operator: bool = False, device=None):
    """Factorized generalized inverse for a list of per-subdomain SPARSE
    stiffness blocks (scipy matrices, equal size).  ``R_bases[s]`` is
    subdomain s's nullspace basis (fixing-dof regularization per singular
    block); the blocks are taken as ordered for bandwidth already.

    Returns (BandCholInv, NB)."""
    import scipy.sparse as sp

    nl = K_blocks[0].shape[0]
    if NB is None:
        NB = _default_nb(max(bandwidth(sp.csr_matrix(K)) for K in K_blocks))
    Ads, Asubs = [], []
    for s, K in enumerate(K_blocks):
        Ad, Asub = csr_to_block_tridiag(K, NB)
        if R_bases is not None and R_bases[s].shape[1] > 0:
            rho = gershgorin_max_eig(Ad, Asub)
            Ad, Asub = regularize_block_tridiag(Ad, Asub, R_bases[s][: K.shape[0]], rho,
                                                NB, nl=nl)
        Ads.append(Ad)
        Asubs.append(Asub)
    inv = BandCholInv.from_block_tridiag(np.stack(Ads), np.stack(Asubs), dtype=dtype,
                                         refine=refine, keep_operator=keep_operator,
                                         device=device)
    return inv, NB
