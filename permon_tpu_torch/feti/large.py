"""Large-scale TFETI — sparse per-subdomain blocks + band Cholesky K+; the
port of :mod:`permon_tpu.feti.large`: linear solves and contact.

- :class:`SparseFetiProblem` holds per-subdomain scipy sparse blocks;
- the decomposed operator A is a :class:`~permon_tpu_torch.core.dia.
  BlockDia` stencil, K+ a :class:`~permon_tpu_torch.core.band.BandCholInv`
  with fixing-dof regularization of the floating blocks, optionally f32
  factors with iterative refinement against the f64 stencil;
- the nullspace R is analytic: one constant column per floating
  subdomain (Poisson), or the rigid body modes from the nodal coordinates
  (``nullspace='rbm'``, elasticity: 6 columns per floating subdomain in
  3-D);
- Dirichlet dofs are enforced by identity rows of BE with a nonzero cE
  (TFETI, the default) or eliminated into the Hessian
  (``dirichlet_by_B=False``: :func:`eliminate_dirichlet_in_sparse_blocks`,
  the touched blocks grounded);
- linear: dualize -> homogenize -> project -> PCPG, optionally with the
  lumped dual preconditioner (``pc_dual='lumped'``), then the primal
  solution is reassembled, with optional f64 primal defect-correction
  passes;
- contact (``BI``/``cI``: inequality rows B_I u <= c_I): the dual keeps a
  box (lambda_I >= 0) and is solved by SMALXE around MPRGP — on the
  projected dual P F P (one outer iteration: the iterates stay in ker G),
  or with ``project=False`` on the unprojected dual, where the augmented
  Lagrangian enforces G lambda = e itself (SMALBE proper);
- B and B' of BE and of BI run through the plane-major gather tables and
  the CUDA gather kernel (core/sell.py);
- past 2^26 elements of the coarse G = R'B' (the 1.18M-dof elasticity
  shape: 540 x 253,000) G is a :class:`BlockCoarse`: per-subdomain
  contractions of the block-diagonal R against B'v, no (k, m) array; past
  2048 coarse rows GG' is factorized as a band (qp/projector.py);
- :func:`reorder_rcm` renumbers every subdomain's local dofs by reverse
  Cuthill-McKee, fused into the problem.

:class:`FetiSolverSparse` factorizes once and re-solves with new right-hand
sides; in the sparse-coarse regime (k*(N+m) > 2^25, e.g. the 101^3 north
star, or ``coarse='sparse'``) every solve, the first included, runs
:func:`make_fast_solve_fn`: the whole chain and the defect correction on
the device, reassembly through a fixed-order gather table (no scatter-add).

Under ``FetiOptions(mesh=...)`` (:mod:`permon_tpu_torch.parallel`, one
process per rank) every rank does the host setup of the whole problem and
puts only its own subdomains on its device: the stencil, the band factors
and their regularization, b, the rows of R and its per-rank gather tables;
the dual solve runs replicated, each F apply with one ``all_reduce``, and
the reassembly of the global solution gathers the ranks' decomposed
solutions (one ``all_gather``) and sums each dof's copies in the
one-device order, so x_global is the one-device result, bit for bit.
``qppf_redundancy`` puts the coarse factor on redundancy groups
(parallel/coarse.py).

As in the JAX package, ``FetiOptions.precision`` is not read here and any
``nullspace`` but 'rbm' is the constant one; ``orth_G``, ``project=False``
for a linear solve and ``throughput`` are rejected in its words.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from .. import as_torch_dtype, not_ported, resolve_device
from ..core.band import (BandCholInv, _default_nb, _fixing_window, bandwidth, fixing_dofs,
                         gershgorin_max_eig_csr, rcm_order)
from ..core.convergence import Tolerances
from ..core.detred import det_sum, deterministic_mode
from ..core.dia import BlockDia, RegularizedBlockDia
from ..core.extension import GatherTable, SubdomainExtension, copy_sum_table
from ..core.linop import Ell, LinearOperator, VStack
from ..parallel.dist import (all_gather, all_reduce_sum, check_mesh, global_rows, operator_mesh,
                             shard_blockdia, shard_qp_sparse)
from ..pc.dual import PCDual
from ..qp.projector import Projector
from ..qp.qp import QP
from ..qp.transforms import (
    SPARSE_COARSE_THRESHOLD,
    Solution,
    _sparse_coarse,
    compose,
    dualize,
    enforce_eq_by_projector,
    homogenize_eq,
)
from ..solvers.cg import cg
from ..solvers.smalxe import smalxe
from ..sys.tracing import trace
from .assembly import (build_dirichlet_rows, build_gluing, constant_nullspace_columns,
                       decompose_rhs_by_multiplicity, dirichlet_global_ids,
                       nullspace_columns_from_blocks, rigid_body_modes)
from .solve import FetiOptions, FetiResult, _device_extension, _sync, assemble_global_mean


@dataclasses.dataclass
class SparseFetiProblem:
    """Decomposed problem with SPARSE per-subdomain stiffness blocks (the
    JAX package's container, same fields)."""

    K_blocks: List[Any]  # ns scipy sparse (nl, nl) matrices
    b_loc: np.ndarray  # (ns, nl)
    l2g: np.ndarray  # (ns, nl) int64, -1 = padding
    floating: np.ndarray  # (ns,) bool
    dirichlet: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )
    dirichlet_values: Optional[np.ndarray] = None
    dirichlet_numtype: str = "global_undecomposed"
    #: (ns, nn, dim) nodal coordinates for rigid body modes (elasticity).
    #: Dof layout must be node-major interleaved: dof c of node n is
    #: n*dim + c; padding nodes (all dofs with l2g = -1) are ignored.
    coords: Optional[np.ndarray] = None

    def dirichlet_global(self) -> np.ndarray:
        return dirichlet_global_ids(self.l2g, self.dirichlet, self.dirichlet_numtype)

    @property
    def ns(self) -> int:
        return len(self.K_blocks)

    @property
    def nl(self) -> int:
        return int(self.l2g.shape[1])

    @property
    def n_decomposed(self) -> int:
        return self.ns * self.nl

    @property
    def n_global(self) -> int:
        return int(self.l2g.max()) + 1


def reorder_rcm(prob: SparseFetiProblem) -> SparseFetiProblem:
    """Bandwidth-reducing reorder of every subdomain's LOCAL numbering,
    fused into the problem (K blocks, b_loc, l2g, coords all permuted) so
    downstream operators are built on the permuted numbering and applies
    need no runtime gather.  Identical patterns share one RCM call (one
    call serves the thousands of equal interior boxes of a regular
    decomposition)."""
    import scipy.sparse as sp

    if prob.coords is not None and prob.coords.shape[1] != prob.nl:
        raise NotImplementedError(
            "reorder_rcm with node-blocked dofs (dof-per-node > 1) "
            "needs a node-level permutation; reorder before blocking"
        )
    cache: dict = {}
    K_new = []
    perm = np.empty((prob.ns, prob.nl), dtype=np.int64)
    for s, K in enumerate(prob.K_blocks):
        K = sp.csr_matrix(K)
        key = (K.shape, K.nnz, K.indptr.tobytes(), K.indices.tobytes())
        p = cache.get(key)
        if p is None:
            p = cache[key] = rcm_order(K)
        K_new.append(K[p][:, p].tocsr())
        perm[s] = p
    rows = np.arange(prob.ns)[:, None]
    return dataclasses.replace(
        prob, K_blocks=K_new, b_loc=prob.b_loc[rows, perm], l2g=prob.l2g[rows, perm],
        coords=None if prob.coords is None else prob.coords[rows, perm],
    )


def _check_slice(opts: FetiOptions, contact: bool) -> None:
    """Raise for an option the port does not cover (ROADMAP.md), for a
    ``mesh`` that is not a mesh (TypeError), and, in the JAX package's
    words, for the three it rejects on the large path.  As there,
    ``precision`` is not read on the large path and every ``nullspace`` but
    'rbm' takes the constant nullspace."""
    check_mesh(opts.mesh)
    if opts.coarse not in ("auto", "dense", "sparse"):
        raise not_ported(f"coarse={opts.coarse!r}")
    if opts.pc_dual not in ("none", "lumped"):
        raise ValueError(f"pc_dual {opts.pc_dual!r}: 'none' or 'lumped'")
    if opts.throughput:
        raise NotImplementedError(
            "throughput=True (the dense leaf/explicit-inverse iteration, "
            "feti/leaf.py) has no large-path analog: the band K+ keeps its "
            "factors implicit and B/B' already apply as vectorized gather "
            "tables/kernels here — drop the flag, or use feti_solve for "
            "the dense leaf path"
        )
    if not opts.project and not contact:
        raise NotImplementedError(
            "the large path runs the projected dual pipeline for LINEAR "
            "solves; project=False (SMALXE on the unprojected dual) is a "
            "tutorial-scale option there — use feti_solve.  For CONTACT "
            "(BI given) project=False selects the production SMALBE: the "
            "augmented-Lagrangian outer loop enforces G lam = e itself "
            "(smalxe.c:892-997)"
        )
    if opts.orth_G is not None:
        raise NotImplementedError(
            "orth_G on the large path: the sparse coarse build factors GG' "
            "directly (band Cholesky), which subsumes the orthonormalization "
            "shortcut — use feti_solve for the orth_G parity variants"
        )


def _check_contact_refine(BI, primal_refine: int) -> None:
    if BI is not None and primal_refine:
        raise ValueError(
            "primal_refine assumes a LINEAR solve; with contact "
            "inequalities the defect correction is invalid — use f64 "
            "factors or kplus_refine instead"
        )


@dataclasses.dataclass
class DirichletElim:
    """Rhs-side record of the Dirichlet-in-Hessian elimination: repeated
    solves with NEW right-hand sides (FetiSolverSparse.solve(b_loc=...))
    must re-apply the same affine rhs transform — lift by -K_orig[:, i] *
    value, then alpha * value on the Dirichlet rows — or the boundary
    conditions are silently violated.  Also carries the ELIMINATED blocks
    so primal defect-correction passes compute their residual against the
    operator that was actually solved (the original singular K would
    inject O(r/alpha) errors at the Dirichlet dofs every pass)."""

    K_elim: List[Any]  # ns csr blocks AFTER elimination
    touched: np.ndarray  # (ns,) bool
    alpha: float
    lift: dict  # s -> (nl,) precomputed K_orig_s @ vvec_s
    fix_idx: dict  # s -> local Dirichlet indices
    fix_val: dict  # s -> alpha * values at those indices

    def apply_b(self, b_loc: np.ndarray) -> np.ndarray:
        b = np.array(b_loc, dtype=np.float64, copy=True)
        for s, idx in self.fix_idx.items():
            b[s] -= self.lift[s]
            b[s, idx] = self.fix_val[s]
        return b

    def eliminated_prob(self, prob: "SparseFetiProblem") -> "SparseFetiProblem":
        """The problem as actually solved: eliminated blocks + transformed
        rhs, Dirichlet set cleared (it lives in the operator now)."""
        return dataclasses.replace(
            prob, K_blocks=self.K_elim, b_loc=self.apply_b(prob.b_loc),
            dirichlet=np.zeros(0, dtype=np.int64), dirichlet_values=None,
        )


def eliminate_dirichlet_in_sparse_blocks(prob: SparseFetiProblem, K_blocks):
    """Sparse-blocks Dirichlet-in-Hessian: for every copy (s, i) of a
    Dirichlet dof, lift the rhs by -K_s[:, i] * value, zero row/column i
    symmetrically, and put alpha = max|diag| (with alpha * value on the
    rhs) on the diagonal — MatZeroRowsColumnsIS semantics
    (qpfeti.c:280-306).  Returns (K_blocks', b_loc', touched, elim) with
    ``touched[s]`` true when block s holds a Dirichlet copy (those blocks
    are non-singular afterwards and are grounded out of the nullspace,
    the classical-FETI R-row zeroing) and ``elim`` a :class:`DirichletElim`
    record replaying the rhs transform on new right-hand sides."""
    import scipy.sparse as sp

    b = prob.b_loc.copy()
    dglob = prob.dirichlet_global()
    dvals = (np.asarray(prob.dirichlet_values, dtype=np.float64)
             if prob.dirichlet_values is not None else np.zeros(len(dglob)))
    # value of a global Dirichlet dof by sorted search (a dof listed twice
    # takes its last value)
    order = np.argsort(dglob, kind="stable")
    dsorted, vsorted = dglob[order], dvals[order]
    alpha = max(max(abs(K.diagonal()).max() for K in K_blocks), 1.0)
    touched = np.zeros(prob.ns, dtype=bool)
    K_out = []
    lift, fix_idx, fix_val = {}, {}, {}
    for s, K in enumerate(K_blocks):
        here = np.isin(prob.l2g[s], dglob)
        idx = np.flatnonzero(here)
        if not len(idx):
            K_out.append(K)
            continue
        touched[s] = True
        vvec = np.zeros(prob.nl)
        vvec[idx] = vsorted[np.searchsorted(dsorted, prob.l2g[s, idx], side="right") - 1]
        lift[s] = K @ vvec
        b[s] -= lift[s]
        D = sp.diags((~here).astype(K.dtype))
        K_out.append(((D @ K @ D) + sp.diags(alpha * here.astype(K.dtype))).tocsr())
        fix_idx[s] = idx
        fix_val[s] = alpha * vvec[idx]
        b[s, idx] = fix_val[s]
    elim = DirichletElim(K_elim=K_out, touched=touched, alpha=float(alpha),
                         lift=lift, fix_idx=fix_idx, fix_val=fix_val)
    return K_out, b, touched, elim


def _per_distinct(blocks, fn) -> list:
    """[fn(K) for K in blocks], computed once per distinct object."""
    cache: dict = {}
    return [cache[id(K)] if id(K) in cache else cache.setdefault(id(K), fn(K))
            for K in blocks]


def band_layout(K_blocks, nl: int, NB: Optional[int] = None):
    """(NB, nb, nlp): the band block size (the bandwidth rounded up to a
    multiple of 128 unless given), the block rows per subdomain and the
    padded local size nlp = nb * NB."""
    bw = max(_per_distinct(K_blocks, bandwidth))
    if NB is None:
        NB = _default_nb(bw)
    elif bw >= NB:
        raise ValueError(f"bandwidth {bw} >= NB {NB}")
    nb = max((nl + NB - 1) // NB, 1)
    return NB, nb, nb * NB


def padded(prob: SparseFetiProblem, nlp: int) -> SparseFetiProblem:
    """The problem with l2g / b_loc padded to nlp local dofs (l2g = -1)."""
    l2g = np.full((prob.ns, nlp), -1, dtype=np.int64)
    l2g[:, : prob.nl] = prob.l2g
    b_loc = np.zeros((prob.ns, nlp))
    b_loc[:, : prob.nl] = prob.b_loc
    return dataclasses.replace(prob, l2g=l2g, b_loc=b_loc)


def gluing_extension(l2g: np.ndarray, opts: FetiOptions, device) -> SubdomainExtension:
    """The gluing operator over a padded l2g (no Dirichlet rows), with its
    gather tables on ``device``."""
    ns, nlp = l2g.shape
    gr, gc, gv, ng = build_gluing(l2g, opts.gluing, opts.scale)
    return _device_extension(
        SubdomainExtension.from_coo(gr, gc, gv, m=ng, ns=ns, nl=nlp), opts, device)


def assemble_qp_sparse(prob: SparseFetiProblem, opts: FetiOptions = FetiOptions(),
                       NB: Optional[int] = None, kplus_dtype=None,
                       kplus_refine: int = 0, op_dtype=None, BI=None, cI=None,
                       device=None, timings: Optional[dict] = None):
    """Build the decomposed QP (A = BlockDia stencil, BE = [Dirichlet rows;]
    gluing as gather tables, R analytic: constant columns or, with
    ``nullspace='rbm'``, rigid body modes) and the band K+ on ``device``.
    Local sizes are padded to a multiple of the band block size NB (padding
    dofs get unit diagonals and l2g = -1).

    ``BI``/``cI`` attach contact inequalities B_I u <= c_I given as a
    :class:`~permon_tpu_torch.core.extension.SubdomainExtension` over the
    UNPADDED (ns, nl) decomposed space; the operator is re-padded to nlp
    here and gets its gather tables.  ``timings`` (optional dict) gets
    ``host_setup_s`` and ``factor_s``: the seconds of the synchronised
    spans ``feti.host_setup`` and ``feti.factor``.

    Returns (qp, kplus, NB, elim) — ``elim`` is the :class:`DirichletElim`
    rhs-transform record when dirichlet_by_B=False eliminated Dirichlet
    dofs into the Hessian, else None."""
    _check_slice(opts, contact=BI is not None)
    dev = _rank_device(opts, device)
    with trace("feti.host_setup") as setup:
        qp, Areg, NB, elim = _host_setup(prob, opts, NB, op_dtype, BI, cI, dev)
        _sync(dev)
    with trace("feti.factor") as factor:
        kplus = BandCholInv.from_blockdia(Areg, NB, dtype=as_torch_dtype(kplus_dtype),
                                          refine=kplus_refine)
        _sync(dev)
    if timings is not None:
        timings.update(host_setup_s=setup.seconds, factor_s=factor.seconds)
    return qp, kplus, NB, elim


def _host_setup(prob: SparseFetiProblem, opts: FetiOptions, NB: Optional[int], op_dtype,
                BI, cI, dev: torch.device):
    """The host set-up of :func:`assemble_qp_sparse`: the decomposed QP on
    ``dev`` and the regularized stencil that K+ factorizes.  Returns (qp,
    Areg, NB, elim)."""
    import scipy.sparse as sp

    mesh = opts.mesh
    # under a mesh every rank builds the whole problem on the host and
    # parallel/dist.py puts its own subdomains on its device
    host = dev if mesh is None else torch.device("cpu")
    ns, nl = prob.ns, prob.nl
    # a block that is CSR already is kept as the object it is: equal blocks
    # are often ONE object (the problem generators cache them by box shape), and the
    # per-block setup below runs once per distinct object
    K_blocks = [K if sp.isspmatrix_csr(K) else sp.csr_matrix(K) for K in prob.K_blocks]
    floating = np.asarray(prob.floating, dtype=bool).copy()
    elim = None
    if not opts.dirichlet_by_B and len(prob.dirichlet):
        # Dirichlet-in-Hessian (classical FETI): symmetric zero-rows-columns
        # with alpha = max|diag| on the diagonal, rhs lifted by -K[:,i]*val,
        # and the touched blocks grounded: they get no nullspace column
        # (qpfeti.c:153-312)
        K_blocks, b_elim, touched, elim = eliminate_dirichlet_in_sparse_blocks(prob, K_blocks)
        prob = dataclasses.replace(prob, b_loc=b_elim, dirichlet=np.zeros(0, dtype=np.int64),
                                   dirichlet_values=None)
        floating = floating & ~touched
    fixed_mask = ~floating
    NB, nb, nlp = band_layout(K_blocks, nl, NB)
    probp = padded(prob, nlp)
    l2g, b_loc = probp.l2g, probp.b_loc

    blocks_coo, cE_parts, row_off = [], [], 0
    if opts.dirichlet_by_B and len(prob.dirichlet):
        dr, dc, dv, nd, cvals = build_dirichlet_rows(probp)
        blocks_coo.append((dr, dc, dv))
        cE_parts.append(cvals)
        row_off = nd
    gr, gc, gv, ng = build_gluing(l2g, opts.gluing, opts.scale)
    blocks_coo.append((gr + row_off, gc, gv))
    cE_parts.append(np.zeros(ng))
    rows, cols, vals = (np.concatenate([t[i] for t in blocks_coo]) for i in range(3))
    BE = SubdomainExtension.from_coo(rows, cols, vals, m=row_off + ng, ns=ns, nl=nlp)
    cE_arr = np.concatenate(cE_parts)

    if opts.nullspace == "rbm":
        bases = _rbm_bases(prob, fixed_mask, nlp)
        rr, rc, rv, k = nullspace_columns_from_blocks(bases)
    else:
        bases = None
        rr, rc, rv, k = constant_nullspace_columns(probp, fixed_mask)
    R = Ell.from_scipy(sp.coo_matrix((rv, (rr, rc)), shape=(ns * nlp, k)),
                       device=host) if k else None

    # Kreg = K + rho R_I (R_I'R_I)^{-1} R_I' stays an EXPLICIT rank-k
    # correction (core/dia.RegularizedBlockDia) injected by the factor loop;
    # qp.A — and with it the lumped preconditioner M = B K B' — keeps the
    # original singular K (feti/large.py:359-412)
    A = BlockDia.from_scipy_blocks(K_blocks, nlp=nlp, dtype=op_dtype, device=host)
    reg = []
    rhos = _per_distinct(K_blocks, gershgorin_max_eig_csr)
    for s in range(ns):
        if fixed_mask[s]:
            continue
        if bases is not None:
            Rb = bases[s][:nl]
        else:
            real = np.flatnonzero(prob.l2g[s] >= 0)
            Rb = np.zeros((nl, 1))
            Rb[real, 0] = 1.0 / np.sqrt(len(real))
        rho = rhos[s]
        lo, hi = _fixing_window(Rb, NB, nl)
        I = fixing_dofs(Rb, lo=lo, hi=hi)
        RI = Rb[I]
        Q = rho * (RI @ np.linalg.solve(RI.T @ RI, RI.T))
        bwin = int(I[0] // NB)
        if not (I // NB == bwin).all():
            raise ValueError(f"fixing dofs of subdomain {s} span two band blocks")
        reg.append((s, bwin, I - bwin * NB, Q))
    kfmax = max((len(r[2]) for r in reg), default=1)
    idx_arr = np.zeros((ns, kfmax), dtype=np.int64)
    q_arr = np.zeros((ns, kfmax, kfmax))
    bi_arr = np.zeros(ns, dtype=np.int64)
    for s, bwin, I_loc, Q in reg:
        bi_arr[s] = bwin
        idx_arr[s, : len(I_loc)] = I_loc
        q_arr[s, : len(I_loc), : len(I_loc)] = Q
    Areg = RegularizedBlockDia(
        base=A, idx=torch.as_tensor(idx_arr, device=host),
        q=torch.as_tensor(q_arr, device=host),
        bi=torch.as_tensor(bi_arr, device=host), NB=NB,
    )
    # an all-zero cE carries no information: drop it so the pipeline skips
    # homogenize_eq (one A apply + coarse solve) entirely
    qp = QP(A=A, b=torch.as_tensor(b_loc.reshape(-1), device=host), BE=BE,
            cE=torch.as_tensor(cE_arr, device=dev) if cE_arr.any() else None, R=R)
    if BI is not None:
        qp = qp.replace(BI=BI.replace(nl=nlp, gB=None, gBt=None),
                        cI=None if cI is None else torch.as_tensor(
                            cI, dtype=torch.float64, device=dev))
    if mesh is not None:
        qp, _, _ = shard_qp_sparse(qp, None, mesh, device=dev)
        Areg = shard_blockdia(Areg, *mesh.subdomains(ns), base=qp.A)
    qp = qp.replace(BE=_device_extension(qp.BE, opts, dev),
                    BI=None if qp.BI is None else _device_extension(qp.BI, opts, dev))
    return qp, Areg, NB, elim


def _rank_device(opts: FetiOptions, device) -> torch.device:
    """``device``, or under a mesh without one the rank's device."""
    if opts.mesh is not None and device is None:
        return opts.mesh.device
    return resolve_device(device)


def _rbm_bases(prob: SparseFetiProblem, fixed_mask: np.ndarray, nlp: int):
    """Per-subdomain rigid-body bases (nlp, 3 or 6), (nlp, 0) for a fixed
    block.  The modes are built from the REAL nodes only (dof = node*dim +
    c): padding rows of coords are meaningless, and a nonzero R entry on a
    padding dof (unit diagonal in K) would break K R = 0 and let the
    fixing-dof window pick padding dofs, whose grounding cannot regularize
    the block.  A node must be wholly real or wholly padding."""
    if prob.coords is None:
        raise ValueError("nullspace='rbm' needs prob.coords")
    dim = int(prob.coords.shape[2])
    bases = []
    for s in range(prob.ns):
        if fixed_mask[s]:
            bases.append(np.zeros((nlp, 0)))
            continue
        real_dof = (prob.l2g[s] >= 0).reshape(-1, dim)
        node_real = real_dof[:, 0]
        if (real_dof != node_real[:, None]).any():
            raise ValueError(
                f"subdomain {s}: a node has both real and padding dofs; the rigid "
                "body modes need each node wholly real or wholly padding"
            )
        modes = rigid_body_modes(prob.coords[s][node_real])
        pad = np.zeros((nlp, modes.shape[1]))
        didx = (dim * np.flatnonzero(node_real)[:, None] + np.arange(dim)).ravel()
        pad[didx] = modes
        bases.append(pad)
    return bases


def _solve_prepared(qp, kplus, opts: FetiOptions, tol: Tolerances,
                    kplus_post=None, pf=None):
    """One dual solve of an assembled large-path QP: dualize (band K+) ->
    [homogenize] -> project -> PCPG, or SMALXE/MPRGP when the dual keeps a
    box (contact); folded back to the decomposed solution.  ``kplus_post``
    (the refined K+) serves only the post-solve chain, where f32 noise
    would be amplified by ||K+||; the dual solver keeps the cheap unrefined
    applies (feti/large.py:464-574).  Spans: ``feti.dual_solve`` around the
    call, ``feti.dualize`` (d, e, lambda0 and the projected dual),
    ``feti.post`` (the post chain)."""
    with trace("feti.dual_solve"):
        return _dual_solve(qp, kplus, opts, tol, kplus_post, pf)


def _dual_solve(qp, kplus, opts: FetiOptions, tol: Tolerances, kplus_post, pf):
    steps = []
    pf_holder = None
    with trace("feti.dualize"):
        dual, post_d = dualize(qp, kplus=kplus, coarse=opts.coarse, pf=pf)
        if kplus_post is not None:
            dual_a, post_d = dualize(qp, kplus=kplus_post, coarse=opts.coarse, pf=dual.pf)
        else:
            dual_a = dual
        steps.append((dual_a, post_d))
        cur, cur_a = dual, dual_a
        if cur.cE is not None:
            cur, _ = homogenize_eq(cur)
            cur_a, post_h = homogenize_eq(cur_a)
            steps.append((cur_a, post_h))
        if opts.project and cur.BE is not None:
            pf_holder = cur
            cur, _ = enforce_eq_by_projector(cur)
            _, post_p = enforce_eq_by_projector(cur_a)
            steps.append((cur, post_p))

    def solve_contact(q):
        res = smalxe(q, opts=opts.smalxe, tol=tol)
        with trace("feti.post"):
            sol = compose(steps)(Solution(x=res.x, Bt_lambda=res.Bt_lambda))
        return sol, res, dual

    if not opts.project:
        # SMALBE proper (contact; _check_slice rejects the linear case): no
        # coarse projector at all — the semi-monotonic augmented Lagrangian
        # enforces G lam = 0 itself while MPRGP handles the box
        # (smalxe.c:892-997), so the M1/rho/eta adaptation iterates at scale
        return solve_contact(cur)

    pc = None
    if opts.pc_dual == "lumped" and qp.box is None and qp.BI is None:
        pc = PCDual.create(qp.BE, qp.A, "lumped").mv
    elif opts.pc_dual == "lumped":
        from ..sys import tracing

        tracing.info("pc_dual='lumped' ignored for contact: the MPRGP inner "
                     "solver runs unpreconditioned (qps/impls/mpgp)")

    if pf_holder is None:
        res = cg(cur, tol=tol, precond=pc)
    else:
        if cur.box is not None:
            # contact: the box survives into the projected dual — SMALXE
            # (SMALBE) outer loop with MPRGP inner, the reference's
            # -project 1 contact pipeline (smalxe.c:892-997).  The term
            # rho G'G controls the drift out of im(P), so no reprojection
            # per iteration is needed
            return solve_contact(cur)
        # FULL reprojection, w = P r every iteration (pcpg.c:51-134)
        res = cg(cur, tol=tol, precond=pc, project=pf_holder.pf.apply_p)
    with trace("feti.post"):
        sol = compose(steps)(Solution(x=res.x))
    return sol, res, dual


def feti_solve_sparse(prob: SparseFetiProblem, opts: FetiOptions = FetiOptions(),
                      tol: Tolerances = Tolerances(), NB: Optional[int] = None,
                      kplus_dtype=None, kplus_refine: int = 0, op_dtype=None,
                      primal_refine: int = 0, BI=None, cI=None,
                      device=None) -> FetiResult:
    """TFETI solve on sparse subdomain blocks: dualize (band K+) ->
    homogenize -> project -> CG (SMALXE/MPRGP with contact rows ``BI``,
    ``cI``), then fold back and assemble the global solution.
    ``primal_refine`` > 0 runs that many f64 defect-correction passes over
    the whole FETI solve (residual of the assembled system on the host in
    f64, re-decomposed, solved with the same factors); linear solves only."""
    _check_contact_refine(BI, primal_refine)
    with deterministic_mode(opts.deterministic):
        qp, kplus, NB, elim = assemble_qp_sparse(
            prob, opts, NB=NB, kplus_dtype=kplus_dtype, kplus_refine=kplus_refine,
            op_dtype=op_dtype, BI=BI, cI=cI, device=device,
        )
        if elim is not None:
            # defect-correction passes must see the ELIMINATED system (the
            # one the factors solve)
            prob = elim.eliminated_prob(prob)
        kplus_post = None
        if kplus.refine and kplus.op is not None:
            kplus_post = kplus
            kplus = kplus.replace(refine=0)
        # the mesh / redundancy coarse layout on the function path too
        # (large.py:655-657)
        pf = build_sparse_pf(qp, opts) if (
            opts.mesh is not None and opts.qppf_redundancy) else None
        return _run_prepared_sparse(prob, opts, tol, qp, kplus, kplus_post, primal_refine,
                                    pf=pf)


def _primal_defect_rhs(prob, K_csr, x_global, nlp):
    """f64 host residual of the assembled system in decomposed, D-split,
    padded form (feti/large.py:664-681)."""
    pad = np.asarray(prob.l2g < 0)
    u_lift = np.where(pad, 0.0, x_global[np.maximum(prob.l2g, 0)])
    r_loc = prob.b_loc - np.stack([K_csr[s] @ u_lift[s] for s in range(prob.ns)])
    r_loc[pad] = 0.0
    r_loc = decompose_rhs_by_multiplicity(r_loc, prob.l2g)
    r_pad = np.zeros((prob.ns, nlp))
    r_pad[:, : prob.nl] = r_loc
    return r_pad.reshape(-1), u_lift


def _assemble_mean(x_dec: torch.Tensor, prob, nlp: int, mesh) -> np.ndarray:
    """The global mean of the decomposed solution's copies on the host;
    under a mesh ``x_dec`` holds this rank's subdomains and the ranks'
    blocks are gathered first, so the copies add up in the one-device
    order."""
    if mesh is not None:
        x_dec = all_gather(x_dec, mesh)
    u = x_dec.cpu().numpy().reshape(-1, nlp)[:, : prob.nl]
    return assemble_global_mean(u, prob.l2g, prob.n_global)


def _run_prepared_sparse(prob, opts, tol, qp, kplus, kplus_post, primal_refine,
                         pf=None) -> FetiResult:
    """1 + primal_refine dual solves of an assembled, factorized problem,
    the defect correction on the host; ``pf`` reuses a coarse factor.
    Under a mesh the host residual is computed for every subdomain on every
    rank and each rank takes its own rows."""
    import scipy.sparse as sp

    mesh = opts.mesh
    sol, res, dual = _solve_prepared(qp, kplus, opts, tol, kplus_post=kplus_post, pf=pf)
    results = [res]
    nlp = qp.BE.nl
    lo, hi = (0, prob.ns) if mesh is None else mesh.subdomains(prob.ns)
    x_global = _assemble_mean(sol.x, prob, nlp, mesh)
    if primal_refine:
        K_csr = [sp.csr_matrix(K) for K in prob.K_blocks]
    for _ in range(primal_refine):
        r_flat, u_lift = _primal_defect_rhs(prob, K_csr, x_global, nlp)
        qp_r = qp.replace(b=torch.as_tensor(r_flat[lo * nlp:hi * nlp], device=qp.b.device))
        if qp.cE is not None:
            # the correction must close the remaining constraint gap too:
            # BE dx = cE - BE u  (u = consistent lift, so gluing rows of
            # BE u vanish and only Dirichlet rows contribute)
            u_pad = np.zeros((hi - lo, nlp))
            u_pad[:, : prob.nl] = u_lift[lo:hi]
            qp_r = qp_r.replace(cE=qp.cE - qp.BE.mv(
                torch.as_tensor(u_pad.reshape(-1), device=qp.b.device)))
        sol_r, res, dual = _solve_prepared(qp_r, kplus, opts, tol,
                                           kplus_post=kplus_post, pf=dual.pf)
        results.append(res)
        x_global = x_global + _assemble_mean(sol_r.x, prob, nlp, mesh)
    return FetiResult(x_global=x_global, u_decomposed=sol.x, solution=sol, result=res,
                      qp=qp, dual_qp=dual, results=results)


@dataclasses.dataclass
class BlockCoarse(LinearOperator):
    """Coarse operator G = R'B' exploiting the BLOCK-DIAGONAL structure of
    the nullspace R (<= kf columns per subdomain, kf = 6 for 3-D rigid
    body modes): G v = per-block fixed-tree contractions of R_s against
    the primal image B'v, G'w = B(R w); no (k, m) array is ever formed.

    Exists for the large-k coarse regime (k*m past the dense-G cutoff,
    qp/transforms.DENSE_G_ELEMENTS).  It costs one extra B/B' pair per
    projector application plus O(ns*nlp*kf) flops.  Every coarse column is
    owned by exactly one (subdomain, slot): ``mv`` reads its result through
    ``inv``, the flat slot of each column (a gather; the JAX package
    scatter-adds the slots instead, which on CUDA would mean atomics).
    Reference: the implicit coarse-problem action of qppf.c:610-645 with
    MATEXTENSION G (extension.c:476-540).  Spans: ``coarse.g_mv`` and
    ``coarse.g_rmv``, one a call."""

    Rb: torch.Tensor  # (ns, nlp, kf) f64 block nullspace columns, zero-padded
    cols: torch.Tensor  # (ns, kf) int64 global coarse column ids, pad -> k
    B: Any  # extension operator (m, ns*nlp)
    k: int
    inv: torch.Tensor = None  # (k,) int64: the flat (s*kf + slot) owner of each column
    #: under a mesh (Rb, cols and B this rank's subdomains): ``inv`` points
    #: the columns of other ranks at a zero pad and ``mv`` all-reduces
    mesh: Any = None

    def __post_init__(self):
        if self.inv is None:
            self.inv = _column_owners(self.cols, self.k, partial=self.mesh is not None)

    @property
    def shape(self):
        return (self.k, self.B.shape[0])

    def mv(self, v):
        with trace("coarse.g_mv"):
            ns, nlp, kf = self.Rb.shape
            w = self.B.rmv(v).reshape(ns, nlp).to(self.Rb.dtype)
            s = det_sum(self.Rb, 1, w[:, :, None])  # (ns, kf), fixed tree over the dofs
            if self.mesh is None:
                return s.reshape(-1)[self.inv].to(v.dtype)
            # each column has one owner: the other ranks add exact zeros
            part = torch.cat([s.reshape(-1), s.new_zeros(1)])[self.inv]
            return all_reduce_sum(part, self.mesh).to(v.dtype)

    def rmv(self, w):
        with trace("coarse.g_rmv"):
            ns, nlp, kf = self.Rb.shape
            wb = torch.cat([w.to(self.Rb.dtype),
                            w.new_zeros(1, dtype=self.Rb.dtype)])[self.cols]
            y = self.Rb[:, :, 0] * wb[:, None, 0]
            for t in range(1, kf):  # kf <= 6 adds in slot order
                y = y + self.Rb[:, :, t] * wb[:, None, t]
            return self.B.mv(y.reshape(-1)).to(w.dtype)


def _column_owners(cols: torch.Tensor, k: int, partial: bool = False) -> torch.Tensor:
    """The flat slot of each coarse column from the (ns, kf) table ``cols``
    (pad = k); raises unless the non-pad slots are a bijection onto
    0..k-1.  ``partial`` (a rank's block under a mesh): each column is owned
    at most once, and the columns owned elsewhere get the pad slot
    ns*kf."""
    flat = cols.reshape(-1)
    slots = torch.nonzero(flat < k)[:, 0]
    owned = flat[slots]
    order = torch.argsort(owned)
    if partial:
        if len(torch.unique(owned)) != len(owned):
            raise ValueError("BlockCoarse: a coarse column is owned twice")
        inv = torch.full((k,), flat.numel(), dtype=torch.int64, device=cols.device)
        inv[owned] = slots
        return inv
    if len(slots) != k or not torch.equal(owned[order],
                                          torch.arange(k, device=cols.device)):
        raise ValueError("BlockCoarse: the slots do not own each coarse column exactly once")
    return slots[order]


def _block_shape(B):
    """(ns, nl) of an extension operator, looking through VStack wrappers
    (contact stacks [B_gluing; B_obstacle] over the same primal space)."""
    if hasattr(B, "ns") and hasattr(B, "nl"):
        return B.ns, B.nl
    if isinstance(B, VStack) and B.ops:
        return _block_shape(B.ops[0])
    return None


def block_coarse_from_R(R, B):
    """Host build of :class:`BlockCoarse` from the block-diagonal Ell R:
    each coarse column's support lies inside one subdomain's row block.
    One pass over the nonzeros of R (no loop over the columns).  Returns
    None when R or B lack the required structure (a column that is empty
    or spans two subdomains)."""
    import scipy.sparse as sp

    from ..qp.sparse_rows import to_scipy

    shp = _block_shape(B)
    if shp is None:
        return None
    ns, nlp = shp
    if ns * nlp != B.shape[1]:
        return None
    R_sp = to_scipy(R)
    if R_sp is None:
        return None
    k = R_sp.shape[1]
    Rc = sp.csc_matrix(R_sp)
    Rc.sum_duplicates()
    Rc.sort_indices()
    nnz_col = np.diff(Rc.indptr)
    # under a mesh R holds this rank's rows: the other ranks' columns are empty
    mesh = operator_mesh(B)
    if k == 0 or (mesh is None and (nnz_col == 0).any()):
        return None
    mine = np.flatnonzero(nnz_col > 0)
    owner = Rc.indices[Rc.indptr[mine]].astype(np.int64) // nlp
    if (Rc.indices[Rc.indptr[mine + 1] - 1] // nlp != owner).any():
        return None  # not block-diagonal: the caller falls back
    per_sub = np.bincount(owner, minlength=ns)
    kf = max(int(per_sub.max()), 1)
    # slot of column j: its rank among its subdomain's columns, ascending j
    order = np.argsort(owner, kind="stable")
    slot = np.empty(len(mine), dtype=np.int64)
    slot[order] = np.arange(len(mine)) - (np.cumsum(per_sub) - per_sub)[owner[order]]
    cols = np.full((ns, kf), k, dtype=np.int64)
    cols[owner, slot] = mine
    Rb = np.zeros((ns, nlp, kf))
    col_of = np.repeat(np.arange(len(mine)), nnz_col[mine])
    Rb[owner[col_of], Rc.indices % nlp, slot[col_of]] = Rc.data
    dev = R.vals.device
    return BlockCoarse(Rb=torch.as_tensor(Rb, device=dev), cols=torch.as_tensor(cols, device=dev),
                       B=B, k=int(k), mesh=mesh)


def build_sparse_pf(qp, opts: FetiOptions):
    """Coarse projector for the sparse-coarse regime (host sparse G = R'B'
    and Gram over B = [BE; BI], qp/transforms._sparse_coarse); None outside
    it (small problems keep the dense device Gram of the dualize chain).
    Under a mesh (large.py:827-865) the coarse side is replicated on every
    rank, or with ``qppf_redundancy`` its GG' factor lives on redundancy
    groups over the mesh's last axis (parallel/coarse.py)."""
    if qp.R is None or qp.R.shape[1] == 0 or opts.coarse == "dense":
        return None
    B = qp.BE if qp.BI is None else VStack((qp.BE, qp.BI))
    k = qp.R.shape[1]
    big = k * (global_rows(qp.R) + B.shape[0]) > SPARSE_COARSE_THRESHOLD
    if not (big or opts.coarse == "sparse"):
        return None
    sc = _sparse_coarse(qp.R, B)
    if sc is None:
        return None
    G, gram = sc
    mesh = opts.mesh
    if mesh is not None and opts.qppf_redundancy:
        from ..parallel.coarse import redundant_projector

        return redundant_projector(G, gram, mesh, axis=mesh.axis_names[-1])
    if mesh is not None:
        from ..parallel.dist import replicate_projector

        return replicate_projector(Projector.create(G, gram=gram), mesh)
    return Projector.create(G, gram=gram)


@dataclasses.dataclass
class ReassemblyTables:
    """Device tables of the on-device reassembly: ``copies`` sums each
    global dof's copies in ascending flat order (a gather table, not a
    scatter-add), ``l2g_c`` the clamped global id per padded copy
    (padding -> ng), ``real`` the real-copy mask, ``counts`` the
    multiplicities."""

    copies: GatherTable
    l2g_c: torch.Tensor  # (ns*nlp,) int64
    real: torch.Tensor  # (ns*nlp,) bool
    counts: torch.Tensor  # (ng,) f64
    #: under a mesh ``l2g_c`` and ``real`` cover this rank's subdomains, and
    #: the copy sums run on the ranks' gathered blocks (large.py:1061-1088)
    mesh: Any = None

    @classmethod
    def build(cls, l2g: np.ndarray, nlp: int, device, kernel: bool = True, mesh=None):
        ns, nl = l2g.shape
        ng = int(l2g.max()) + 1
        l2g_pad = np.full((ns, nlp), -1, dtype=np.int64)
        l2g_pad[:, :nl] = l2g
        counts = np.bincount(l2g[l2g >= 0], minlength=ng).astype(np.float64)
        copies = copy_sum_table(l2g_pad, ng, device)
        lo, hi = (0, ns) if mesh is None else mesh.subdomains(ns)
        flat = l2g_pad[lo:hi].reshape(-1)
        real = flat >= 0
        dev = resolve_device(device)
        return cls(
            copies=copies.replace(kernel=kernel),
            l2g_c=torch.as_tensor(np.where(real, flat, ng), device=dev),
            real=torch.as_tensor(real, device=dev),
            counts=torch.as_tensor(np.maximum(counts, 1.0), device=dev),
            mesh=mesh,
        )

    def sum_copies(self, x_dec: torch.Tensor) -> torch.Tensor:
        """(ng,) sums of each global dof's copies in ``x_dec`` (this rank's
        block under a mesh: the ranks' blocks are gathered first, so the
        copies add up in the one-device order)."""
        return self.copies.apply(x_dec if self.mesh is None else all_gather(x_dec, self.mesh))


def make_fast_solve_fn(opts: FetiOptions, tol: Tolerances, nref: int, ng: int):
    """The warm-solve function: dual solve + post chain + global
    reassembly + ``nref`` f64 primal defect-correction passes, all on the
    device (feti/large.py:869-932).  The copy sums run through the
    fixed-order ``ReassemblyTables.copies`` gather table, so the result is
    deterministic on CUDA (the JAX package's scatter-add would use
    atomics there).  Returns ``run(qp, kplus, kplus_post, pf, b, tables)
    -> (x_global, x_dec, results)``.  Spans: ``feti.reassembly`` (each copy
    sum over the multiplicities), ``feti.defect`` (each f64 defect
    residual)."""

    def run(qp, kplus, kplus_post, pf, b, tables: ReassemblyTables):
        real, l2g_c = tables.real, tables.l2g_c
        results = []

        def solve_chain(bb):
            sol, res, _ = _solve_prepared(qp.replace(b=bb), kplus, opts, tol,
                                          kplus_post=kplus_post, pf=pf)
            results.append(res)
            return sol.x

        def assemble(xd):
            with trace("feti.reassembly"):
                return tables.sum_copies(xd) / tables.counts

        def ext(v, fill):
            return torch.cat([v, v.new_full((1,), fill)])[l2g_c]

        x_dec = solve_chain(b)
        xg = assemble(x_dec)
        for _ in range(nref):
            with trace("feti.defect"):
                u_lift = torch.where(real, ext(xg, 0.0), 0.0)
                r = torch.where(real, b - qp.A.mv(u_lift), 0.0)
                # sum the copies (= assembled residual), re-split with
                # D = 1/multiplicity (decompose_rhs_by_multiplicity)
                rg = tables.sum_copies(r)
                r_dec = torch.where(real, ext(rg, 0.0) / ext(tables.counts, 1.0), 0.0)
            xg = xg + assemble(solve_chain(r_dec))
        return xg, x_dec, results

    return run


class FetiSolverSparse:
    """Reusable large-path TFETI solver (QPTFetiPrepareReuseCP at scale,
    qptransform.c:1213-1251): assembly, the band K+ factorization and the
    coarse GG' factorization happen once; solves with new right-hand sides
    reuse every factor.

    >>> solver = FetiSolverSparse(prob, opts, kplus_dtype=torch.float32,
    ...                           kplus_refine=2, primal_refine=1, device="cuda")
    >>> r1 = solver.solve()             # factorized in the constructor
    >>> r2 = solver.solve(b_loc=new_b)  # marginal cost: the dual CG only
    """

    def __init__(self, prob: SparseFetiProblem, opts: FetiOptions = FetiOptions(),
                 NB: Optional[int] = None, kplus_dtype=None, kplus_refine: int = 0,
                 op_dtype=None, primal_refine: int = 0, BI=None, cI=None,
                 device=None):
        _check_contact_refine(BI, primal_refine)
        check_mesh(opts.mesh)
        self.device = _rank_device(opts, device)
        self.opts = opts
        self.primal_refine = primal_refine
        #: host_setup_s and factor_s of the constructor
        self.timings: dict = {}
        self.qp, kplus, self.NB, self._elim = assemble_qp_sparse(
            prob, opts, NB=NB, kplus_dtype=kplus_dtype, kplus_refine=kplus_refine,
            op_dtype=op_dtype, BI=BI, cI=cI, device=self.device, timings=self.timings,
        )
        # keep the problem AS SOLVED: with Dirichlet-in-Hessian the stored
        # blocks/rhs are the eliminated ones, so defect-correction residuals
        # and re-solve rhs handling stay consistent with the factors
        self.prob = prob if self._elim is None else self._elim.eliminated_prob(prob)
        self.kplus_post = None
        if kplus.refine and kplus.op is not None:
            self.kplus_post = kplus
            kplus = kplus.replace(refine=0)
        self.kplus = kplus
        self._pf = None
        self._tables = None

    def _ensure_pf(self):
        """Build the coarse projector directly (host sparse G = R'B' +
        Gram) in the sparse-coarse regime, so even the first solve takes
        the fast path."""
        if self._pf is None:
            self._pf = build_sparse_pf(self.qp, self.opts)

    def solve(self, b_loc=None, tol: Tolerances = Tolerances()) -> FetiResult:
        """One solve on the factors of the constructor, with the load
        ``b_loc`` (default: the problem's); the span ``feti.solve``."""
        with trace("feti.solve"):
            return self._solve(b_loc, tol)

    def _solve(self, b_loc, tol: Tolerances) -> FetiResult:
        prob, qp = self.prob, self.qp
        self._ensure_pf()
        if b_loc is not None:
            with trace("feti.rhs"):
                b_loc = np.asarray(b_loc)
                if self._elim is not None:
                    # re-apply the Dirichlet-in-Hessian rhs transform (lift +
                    # alpha*value rows) — a raw rhs against the eliminated
                    # factors silently violates the boundary conditions
                    b_loc = self._elim.apply_b(b_loc)
                prob = dataclasses.replace(prob, b_loc=b_loc)
                # under a mesh: this rank's subdomains of the new rhs (large.py:1013-1020)
                lo, hi = (0, prob.ns) if self.opts.mesh is None else self.opts.mesh.subdomains(
                    prob.ns)
                b_pad = np.zeros((hi - lo, qp.BE.nl))
                b_pad[:, : prob.nl] = prob.b_loc[lo:hi]
                qp = qp.replace(b=torch.as_tensor(b_pad.reshape(-1), device=self.device))
        from ..sys import tracing

        with deterministic_mode(self.opts.deterministic):
            # debug mode takes the eager path, whose transforms run the
            # self-checks (large.py:1022-1027)
            if self._pf is not None and qp.cE is None and not tracing.debug_enabled:
                return self._solve_fast(prob, qp, tol)
            res = _run_prepared_sparse(prob, self.opts, tol, qp, self.kplus,
                                       self.kplus_post, self.primal_refine, pf=self._pf)
        if self._pf is None and res.dual_qp is not None:
            self._pf = res.dual_qp.pf
        return res

    def _solve_fast(self, prob, qp, tol: Tolerances) -> FetiResult:
        if self._tables is None:
            self._tables = ReassemblyTables.build(
                prob.l2g, qp.BE.nl, self.device, kernel=self.opts.gather_kernel is not False,
                mesh=self.opts.mesh)
        fn = make_fast_solve_fn(self.opts, tol, self.primal_refine, prob.n_global)
        x_global, x_dec, results = fn(qp, self.kplus, self.kplus_post, self._pf, qp.b,
                                      self._tables)
        with trace("feti.to_host"):
            x_host = x_global.cpu().numpy()
        return FetiResult(
            x_global=x_host, u_decomposed=x_dec,
            solution=Solution(x=x_dec), result=results[-1], qp=qp, dual_qp=None,
            results=results,
        )
