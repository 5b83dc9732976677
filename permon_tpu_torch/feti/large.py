"""Large-scale TFETI — sparse per-subdomain blocks + band Cholesky K+; the
port of :mod:`permon_tpu.feti.large` for the LINEAR projected solve.

- :class:`SparseFetiProblem` holds per-subdomain scipy sparse blocks;
- the decomposed operator A is a :class:`~permon_tpu_torch.core.dia.
  BlockDia` stencil, K+ a :class:`~permon_tpu_torch.core.band.BandCholInv`
  with fixing-dof regularization of the floating blocks, optionally f32
  factors with iterative refinement against the f64 stencil;
- dualize -> homogenize -> project -> PCPG, then the primal solution is
  reassembled, with optional f64 primal defect-correction passes;
- B and B' run through the plane-major gather tables and the CUDA gather
  kernel (core/sell.py).

:class:`FetiSolverSparse` factorizes once and re-solves with new right-hand
sides; in the sparse-coarse regime (k*(N+m) > 2^25, e.g. the 101^3 north
star) every solve, the first included, runs :func:`make_fast_solve_fn`:
the whole chain and the defect correction on the device, reassembly
through a fixed-order gather table (no scatter-add).

Outside the slice (contact, elasticity, Dirichlet rows, meshes, lumped
preconditioning, other precisions) the functions raise
``NotImplementedError``; see ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional

import numpy as np
import torch

from .. import as_torch_dtype, not_ported, resolve_device
from ..core.band import BandCholInv, _fixing_window, bandwidth, fixing_dofs, gershgorin_max_eig_csr
from ..core.convergence import Tolerances
from ..core.detred import deterministic_mode
from ..core.dia import BlockDia, RegularizedBlockDia
from ..core.extension import GatherTable, SubdomainExtension, pack_planes
from ..core.linop import Ell
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
from .assembly import build_gluing, constant_nullspace_columns, dirichlet_global_ids
from .solve import FetiOptions, FetiResult, assemble_global_mean


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


def _check_slice(prob: SparseFetiProblem, opts: FetiOptions, BI=None) -> None:
    """Raise for every option the ported slice does not cover."""
    checks = [
        (opts.mesh is not None, "FetiOptions(mesh=...) (multi-device)"),
        (opts.qppf_redundancy, "FetiOptions(qppf_redundancy=True)"),
        (opts.throughput, "FetiOptions(throughput=True)"),
        (opts.pc_dual != "none", f"FetiOptions(pc_dual={opts.pc_dual!r})"),
        (BI is not None, "contact inequalities (BI/cI)"),
        (opts.nullspace != "constant", f"FetiOptions(nullspace={opts.nullspace!r})"),
        (not opts.project, "FetiOptions(project=False)"),
        (opts.orth_G is not None, "FetiOptions(orth_G=...)"),
        (opts.precision != "f64", f"FetiOptions(precision={opts.precision!r})"),
        (len(prob.dirichlet) > 0, "Dirichlet dofs on the problem (build_dirichlet_rows "
                                  "/ in-Hessian elimination)"),
        (opts.coarse not in ("auto", "dense", "sparse"), f"coarse={opts.coarse!r}"),
    ]
    for bad, what in checks:
        if bad:
            raise not_ported(what)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def band_layout(K_blocks, nl: int, NB: Optional[int] = None):
    """(NB, nb, nlp): the band block size (the bandwidth rounded up to a
    multiple of 128 unless given), the block rows per subdomain and the
    padded local size nlp = nb * NB."""
    bw = max(bandwidth(K) for K in K_blocks)
    if NB is None:
        NB = max(((bw + 1 + 127) // 128) * 128, 128)
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
    """The gluing operator BE over a padded l2g, with its gather tables on
    ``device`` (routed through the plain version for gather_kernel=False)."""
    ns, nlp = l2g.shape
    gr, gc, gv, ng = build_gluing(l2g, opts.gluing, opts.scale)
    BE = SubdomainExtension.from_coo(gr, gc, gv, m=ng, ns=ns, nl=nlp).with_gather_apply(device)
    return BE.with_kernel(False) if opts.gather_kernel is False else BE


def assemble_qp_sparse(prob: SparseFetiProblem, opts: FetiOptions = FetiOptions(),
                       NB: Optional[int] = None, kplus_dtype=None,
                       kplus_refine: int = 0, op_dtype=None, device=None,
                       timings: Optional[dict] = None):
    """Build the decomposed QP (A = BlockDia stencil, BE = gluing gather
    tables, R constant nullspace) and the band K+ on ``device``.  Local
    sizes are padded to a multiple of the band block size NB (padding dofs
    get unit diagonals and l2g = -1).  ``timings`` (optional dict) gets
    ``host_setup_s`` and ``factor_s``.

    Returns (qp, kplus, NB, elim) with elim = None (no Dirichlet-in-Hessian
    elimination in the slice)."""
    import scipy.sparse as sp

    _check_slice(prob, opts)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    ns, nl = prob.ns, prob.nl
    K_blocks = [sp.csr_matrix(K) for K in prob.K_blocks]
    fixed_mask = ~np.asarray(prob.floating, dtype=bool)
    NB, nb, nlp = band_layout(K_blocks, nl, NB)
    probp = padded(prob, nlp)
    l2g, b_loc = probp.l2g, probp.b_loc
    BE = gluing_extension(l2g, opts, dev)

    rr, rc, rv, k = constant_nullspace_columns(probp, fixed_mask)
    R = Ell.from_scipy(sp.coo_matrix((rv, (rr, rc)), shape=(ns * nlp, k)), device=dev) if k else None

    # Kreg = K + rho R_I (R_I'R_I)^{-1} R_I' stays an EXPLICIT rank-k
    # correction (core/dia.RegularizedBlockDia) injected by the factor loop;
    # qp.A keeps the original singular K (feti/large.py:359-412)
    A = BlockDia.from_scipy_blocks(K_blocks, nlp=nlp, dtype=op_dtype, device=dev)
    reg = []
    for s in range(ns):
        if fixed_mask[s]:
            continue
        real = np.flatnonzero(prob.l2g[s] >= 0)
        Rb = np.zeros((nl, 1))
        Rb[real, 0] = 1.0 / np.sqrt(len(real))
        rho = gershgorin_max_eig_csr(K_blocks[s])
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
        base=A, idx=torch.as_tensor(idx_arr, device=dev),
        q=torch.as_tensor(q_arr, device=dev),
        bi=torch.as_tensor(bi_arr, device=dev), NB=NB,
    )
    b = torch.as_tensor(b_loc.reshape(-1), device=dev)
    _sync(dev)
    t1 = time.perf_counter()
    kplus = BandCholInv.from_blockdia(Areg, NB, dtype=as_torch_dtype(kplus_dtype),
                                      refine=kplus_refine)
    _sync(dev)
    if timings is not None:
        timings.update(host_setup_s=t1 - t0, factor_s=time.perf_counter() - t1)
    # an all-zero cE carries no information: the pipeline skips homogenize
    qp = QP(A=A, b=b, BE=BE, cE=None, R=R)
    return qp, kplus, NB, None


def _solve_prepared(qp, kplus, opts: FetiOptions, tol: Tolerances,
                    kplus_post=None, pf=None):
    """One dual solve of an assembled large-path QP: dualize (band K+) ->
    [homogenize] -> project -> PCPG, folded back to the decomposed
    solution.  ``kplus_post`` (the refined K+) serves only the post-solve
    chain, where f32 noise would be amplified by ||K+||; the dual CG keeps
    the cheap unrefined applies (feti/large.py:464-574)."""
    steps = []
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
    if cur.BE is None:
        res = cg(cur, tol=tol)
    else:
        pf_holder = cur
        cur, _ = enforce_eq_by_projector(cur)
        _, post_p = enforce_eq_by_projector(cur_a)
        steps.append((cur, post_p))
        # FULL reprojection, w = P r every iteration (pcpg.c:51-134)
        res = cg(cur, tol=tol, project=pf_holder.pf.apply_p)
    sol = compose(steps)(Solution(x=res.x))
    return sol, res, dual


def feti_solve_sparse(prob: SparseFetiProblem, opts: FetiOptions = FetiOptions(),
                      tol: Tolerances = Tolerances(), NB: Optional[int] = None,
                      kplus_dtype=None, kplus_refine: int = 0, op_dtype=None,
                      primal_refine: int = 0, BI=None, cI=None,
                      device=None) -> FetiResult:
    """TFETI solve on sparse subdomain blocks: dualize (band K+) ->
    homogenize -> project -> CG, then fold back and assemble the global
    solution.  ``primal_refine`` > 0 runs that many f64 defect-correction
    passes over the whole FETI solve (residual of the assembled system on
    the host in f64, re-decomposed, solved with the same factors)."""
    _check_slice(prob, opts, BI)
    with deterministic_mode(opts.deterministic):
        qp, kplus, NB, _ = assemble_qp_sparse(
            prob, opts, NB=NB, kplus_dtype=kplus_dtype, kplus_refine=kplus_refine,
            op_dtype=op_dtype, device=device,
        )
        kplus_post = None
        if kplus.refine and kplus.op is not None:
            kplus_post = kplus
            kplus = kplus.replace(refine=0)
        return _run_prepared_sparse(prob, opts, tol, qp, kplus, kplus_post, primal_refine)


def _primal_defect_rhs(prob, K_csr, x_global, nlp):
    """f64 host residual of the assembled system in decomposed, D-split,
    padded form (feti/large.py:664-681)."""
    from .assembly import decompose_rhs_by_multiplicity

    pad = np.asarray(prob.l2g < 0)
    u_lift = np.where(pad, 0.0, x_global[np.maximum(prob.l2g, 0)])
    r_loc = prob.b_loc - np.stack([K_csr[s] @ u_lift[s] for s in range(prob.ns)])
    r_loc[pad] = 0.0
    r_loc = decompose_rhs_by_multiplicity(r_loc, prob.l2g)
    r_pad = np.zeros((prob.ns, nlp))
    r_pad[:, : prob.nl] = r_loc
    return r_pad.reshape(-1), u_lift


def _run_prepared_sparse(prob, opts, tol, qp, kplus, kplus_post, primal_refine,
                         pf=None) -> FetiResult:
    """1 + primal_refine dual solves of an assembled, factorized problem,
    the defect correction on the host; ``pf`` reuses a coarse factor."""
    import scipy.sparse as sp

    sol, res, dual = _solve_prepared(qp, kplus, opts, tol, kplus_post=kplus_post, pf=pf)
    results = [res]
    nlp = qp.BE.nl
    u = sol.x.cpu().numpy().reshape(prob.ns, nlp)
    x_global = assemble_global_mean(u[:, : prob.nl], prob.l2g, prob.n_global)
    if primal_refine:
        K_csr = [sp.csr_matrix(K) for K in prob.K_blocks]
    for _ in range(primal_refine):
        r_flat, _ = _primal_defect_rhs(prob, K_csr, x_global, nlp)
        qp_r = qp.replace(b=torch.as_tensor(r_flat, device=qp.b.device))
        sol_r, res, dual = _solve_prepared(qp_r, kplus, opts, tol,
                                           kplus_post=kplus_post, pf=dual.pf)
        results.append(res)
        du = sol_r.x.cpu().numpy().reshape(prob.ns, nlp)
        x_global = x_global + assemble_global_mean(du[:, : prob.nl], prob.l2g, prob.n_global)
    return FetiResult(x_global=x_global, u_decomposed=sol.x, solution=sol, result=res,
                      qp=qp, dual_qp=dual, results=results)


def build_sparse_pf(qp, opts: FetiOptions):
    """Coarse projector for the sparse-coarse regime (host sparse G = R'B'
    and Gram, qp/transforms._sparse_coarse); None outside it (small
    problems keep the dense device Gram of the dualize chain)."""
    if qp.R is None or qp.R.shape[1] == 0 or opts.coarse == "dense":
        return None
    k = qp.R.shape[1]
    big = k * (qp.R.shape[0] + qp.BE.shape[0]) > SPARSE_COARSE_THRESHOLD
    if not (big or opts.coarse == "sparse"):
        return None
    sc = _sparse_coarse(qp.R, qp.BE)
    if sc is None:
        return None
    G, gram = sc
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

    @classmethod
    def build(cls, l2g: np.ndarray, nlp: int, device, kernel: bool = True):
        ns, nl = l2g.shape
        ng = int(l2g.max()) + 1
        l2g_pad = np.full((ns, nlp), -1, dtype=np.int64)
        l2g_pad[:, :nl] = l2g
        flat = l2g_pad.reshape(-1)
        real = flat >= 0
        pos = np.flatnonzero(real)
        idx, vals, ov = pack_planes(flat[pos], pos.astype(np.int32), np.ones(len(pos)),
                                    ng, ns * nlp, cap=2)
        copies = GatherTable.from_host(idx, vals, device, n_src=ns * nlp, overflow=ov)
        counts = np.bincount(flat[real], minlength=ng).astype(np.float64)
        dev = resolve_device(device)
        return cls(
            copies=copies.replace(kernel=kernel),
            l2g_c=torch.as_tensor(np.where(real, flat, ng), device=dev),
            real=torch.as_tensor(real, device=dev),
            counts=torch.as_tensor(np.maximum(counts, 1.0), device=dev),
        )


def make_fast_solve_fn(opts: FetiOptions, tol: Tolerances, nref: int, ng: int):
    """The warm-solve function: dual solve + post chain + global
    reassembly + ``nref`` f64 primal defect-correction passes, all on the
    device (feti/large.py:869-932).  The copy sums run through the
    fixed-order ``ReassemblyTables.copies`` gather table, so the result is
    deterministic on CUDA (the JAX package's scatter-add would use
    atomics there).  Returns ``run(qp, kplus, kplus_post, pf, b, tables)
    -> (x_global, x_dec, results)``."""

    def run(qp, kplus, kplus_post, pf, b, tables: ReassemblyTables):
        real, l2g_c = tables.real, tables.l2g_c
        results = []

        def solve_chain(bb):
            sol, res, _ = _solve_prepared(qp.replace(b=bb), kplus, opts, tol,
                                          kplus_post=kplus_post, pf=pf)
            results.append(res)
            return sol.x

        def assemble(xd):
            return tables.copies.apply(xd) / tables.counts

        def ext(v, fill):
            return torch.cat([v, v.new_full((1,), fill)])[l2g_c]

        x_dec = solve_chain(b)
        xg = assemble(x_dec)
        for _ in range(nref):
            u_lift = torch.where(real, ext(xg, 0.0), 0.0)
            r = torch.where(real, b - qp.A.mv(u_lift), 0.0)
            # sum the copies (= assembled residual), re-split with
            # D = 1/multiplicity (decompose_rhs_by_multiplicity)
            rg = tables.copies.apply(r)
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
        _check_slice(prob, opts, BI)
        self.device = resolve_device(device)
        self.opts = opts
        self.primal_refine = primal_refine
        #: host_setup_s and factor_s of the constructor
        self.timings: dict = {}
        self.qp, kplus, self.NB, _ = assemble_qp_sparse(
            prob, opts, NB=NB, kplus_dtype=kplus_dtype, kplus_refine=kplus_refine,
            op_dtype=op_dtype, device=self.device, timings=self.timings,
        )
        self.prob = prob
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
        prob, qp = self.prob, self.qp
        self._ensure_pf()
        if b_loc is not None:
            prob = dataclasses.replace(prob, b_loc=np.asarray(b_loc))
            b_pad = np.zeros((prob.ns, qp.BE.nl))
            b_pad[:, : prob.nl] = prob.b_loc
            qp = qp.replace(b=torch.as_tensor(b_pad.reshape(-1), device=self.device))
        with deterministic_mode(self.opts.deterministic):
            if self._pf is not None and qp.cE is None:
                return self._solve_fast(prob, qp, tol)
            res = _run_prepared_sparse(prob, self.opts, tol, qp, self.kplus,
                                       self.kplus_post, self.primal_refine, pf=self._pf)
        if self._pf is None and res.dual_qp is not None:
            self._pf = res.dual_qp.pf
        return res

    def _solve_fast(self, prob, qp, tol: Tolerances) -> FetiResult:
        if self._tables is None:
            self._tables = ReassemblyTables.build(
                prob.l2g, qp.BE.nl, self.device, kernel=self.opts.gather_kernel is not False)
        fn = make_fast_solve_fn(self.opts, tol, self.primal_refine, prob.n_global)
        x_global, x_dec, results = fn(qp, self.kplus, self.kplus_post, self._pf, qp.b,
                                      self._tables)
        return FetiResult(
            x_global=x_global.cpu().numpy(), u_decomposed=x_dec,
            solution=Solution(x=x_dec), result=results[-1], qp=qp, dual_qp=None,
            results=results,
        )
