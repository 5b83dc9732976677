"""TFETI solve facade — the port of :mod:`permon_tpu.feti.solve` (the
KSPFETI analog), the dense path of the PERMON tutorials (feti/ex1.c,
feti/ex71.c) and the options and result types every TFETI path shares.

The decomposed QP has a block-diagonal K (:class:`~permon_tpu_torch.core.
blockdiag.BlockDiagDense`), the gluing and Dirichlet rows as an extension
operator BE and the per-subdomain nullspace R; the chain is

  -> dualize (K+ = the batched per-block regularized Cholesky, G = R'B')
  -> [orthonormalize G] -> homogenize_eq
  -> enforce_eq_by_projector and projected CG (the default -feti
     pipeline, QPTFetiPrepare, qptransform.c:1200-1210), or SMALXE on the
     projected dual when a box survives (contact), or SMALXE on the
     unprojected dual (``project=False``),

then the post-solves fold back to the decomposed primal solution, and the
global solution is the average of each dof's copies (qptransform.c:
1905-1981).  B and B' of BE (and of the contact rows BI) run through the
plane-major gather tables on the CUDA gather kernel
(``FetiOptions(gather_kernel=False)``: the plain PyTorch version); R is an
:class:`~permon_tpu_torch.core.linop.Ell` with its column-major gather
table.  The floating test and the K+ regularization run batched on the
device.

``FetiOptions(throughput=True)`` is the leaf path (feti/leaf.py,
feti/leafqp.py): explicit K+ inverses, dense extension blocks, and the
Krylov / active-set iteration in the scaled-leaf space, whose partner
combine runs on the gather kernel; the row-space chain above still makes
the post-solves.

As in the JAX package, the row path does not shard under
``FetiOptions(mesh=...)``: every rank runs it whole, except that
``qppf_redundancy`` on a two-axis mesh puts the coarse GG' factor on
redundancy groups (parallel/coarse.py; solve.py:380-396) and the leaf path
runs its F apply as the overlapped boundary exchange of
parallel/overlap.py (solve.py:455).  ``qppf_redundancy`` without such a
mesh is ignored there too; a ``mesh`` that is not a mesh raises
``TypeError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import scipy.sparse as sp
import torch

from .. import resolve_device
from ..core.blockdiag import BlockDiagDense
from ..core.convergence import Tolerances
from ..core.detred import deterministic_mode
from ..core.extension import SubdomainExtension
from ..core.factor import BlockDiagCholInv, RaggedBlockDiagCholInv
from ..core.linop import Ell
from ..qp.qp import QP
from ..qp.transforms import (
    Solution,
    compose,
    dualize,
    enforce_eq_by_projector,
    homogenize_eq,
    orthonormalize_eq,
)
from ..solvers.cg import cg
from ..solvers.smalxe import SMALXEOptions, smalxe
from .assembly import (
    GLUING_TYPES,
    FetiProblem,
    build_dirichlet_rows,
    build_gluing,
    constant_nullspace_columns,
    eliminate_dirichlet_in_blocks,
    floating_and_lam_max,
    nullspace_columns_from_blocks,
    numeric_nullspace_blocks,
    rigid_body_modes,
)


@dataclasses.dataclass
class FetiOptions:
    gluing: str = "full"  # QPFetiSetUp default (qpfeti.c:322)
    scale: bool = True  # 1/sqrt(multiplicity) scaling (-SCALE_ON default)
    dirichlet_by_B: bool = True  # enforce Dirichlet by constraint rows (TFETI)
    project: bool = True  # projector pipeline vs SMALXE (-project)
    pc_dual: str = "none"  # 'none' | 'lumped'
    #: None | 'gs' | 'gs_lingen' | 'cholesky' | 'implicit' | 'inexact'
    #: (-dual_qp_E_orth_type)
    orth_G: Optional[str] = None
    #: nullspace source: 'constant' (Poisson), 'numeric' (per-block
    #: eigendecomposition, the MUMPS null-pivot analog; dense path only),
    #: 'rbm' (rigid body modes from ``prob.coords``, elasticity)
    nullspace: str = "constant"
    #: the leaf path: explicit per-block K+ inverses (one batched GEMV) and
    #: dense extension blocks, the dual iteration in the scaled-leaf space
    throughput: bool = False
    #: dense path: 'f64'; 'mixed' (row path: f32 operator storage of the
    #: dual behind f64 vectors; leaf path: f32 leaf state with f64 dots);
    #: 'f32' (the whole dual QP in f32).  The coarse projector and the leaf
    #: path's spectral estimates stay f64.  The large path does not read it
    precision: str = "f64"
    #: bucket heterogeneous subdomain sizes in the K+ factorization
    #: (RaggedBlockDiagCholInv) instead of padding to nl_max
    ragged_kplus: bool = False
    #: a :class:`~permon_tpu_torch.parallel.dist.Mesh` of ranks (make_mesh,
    #: make_mesh2): the large path shards its subdomains over it; the dense
    #: path reads it only for the leaf path and qppf_redundancy
    mesh: Optional[Any] = None
    #: dual coarse-side build: 'auto' | 'dense' | 'sparse'
    coarse: str = "auto"
    #: K+ regularization rho_s: 'auto' (Gershgorin bound for projected
    #: solves with ns >= 128, else exact), 'exact' (largest eigenvalue),
    #: 'gershgorin'
    rho_mode: str = "auto"
    #: pin every solver reduction to a fixed binary tree (core/detred.py);
    #: None inherits the process-global mode
    deterministic: Optional[bool] = None
    #: with a mesh (a two-axis one on the dense path): the coarse GG' factor
    #: on redundancy groups (parallel/coarse.py; -dual_qppf_redundancy)
    qppf_redundancy: bool = False
    #: B/B' gather tables: None or True run the CUDA gather kernel on a
    #: CUDA device (for every table size — the JAX package's 2^19-slot
    #: threshold priced the TPU's SELL schedule, which the port does not
    #: have); False selects the plain PyTorch version
    gather_kernel: Optional[bool] = None
    #: SMALXE options (contact, project=False)
    smalxe: SMALXEOptions = dataclasses.field(default_factory=SMALXEOptions)

    def resolved_rho_mode(self, ns: int) -> str:
        if self.rho_mode != "auto":
            return self.rho_mode
        return "gershgorin" if (self.project and ns >= 128) else "exact"


@dataclasses.dataclass
class FetiResult:
    x_global: np.ndarray
    u_decomposed: Any
    solution: Any
    result: Any  # solver result: CGResult, or SMALXEResult for contact
    qp: Any  # the decomposed primal QP
    dual_qp: Any
    #: every dual solve's result, in order (the large path: the main solve,
    #: then one per primal defect-correction pass); ``result`` is the last
    results: Optional[list] = None


def assemble_global_mean(u: np.ndarray, l2g: np.ndarray, n_global: int) -> np.ndarray:
    """Average the decomposed solution's dof copies into the global vector
    (qptransform.c:1905-1981) — one flat bincount on the host, padding
    (l2g = -1) skipped."""
    flat = l2g.reshape(-1)
    real = flat >= 0
    ids = flat[real]
    x_global = np.bincount(ids, weights=u.reshape(-1)[real], minlength=n_global)
    counts = np.bincount(ids, minlength=n_global)
    return x_global / np.maximum(counts, 1)


def _check_options(opts: FetiOptions) -> None:
    """Raise for a ``mesh`` that is not a mesh (TypeError) and for values
    no path knows."""
    from ..parallel.dist import check_mesh

    check_mesh(opts.mesh)
    for name, value, allowed in (
            ("gluing", opts.gluing, GLUING_TYPES), ("pc_dual", opts.pc_dual, ("none", "lumped")),
            ("nullspace", opts.nullspace, ("constant", "numeric", "rbm")),
            ("coarse", opts.coarse, ("auto", "dense", "sparse")),
            ("rho_mode", opts.rho_mode, ("auto", "exact", "gershgorin"))):
        if value not in allowed:
            raise ValueError(f"FetiOptions({name}={value!r}): one of {allowed}")


def _device_extension(B: SubdomainExtension, opts: FetiOptions, device) -> SubdomainExtension:
    """An extension operator with its gather tables on ``device`` (the
    plain version for gather_kernel=False)."""
    B = B.with_gather_apply(device)
    return B.with_kernel(False) if opts.gather_kernel is False else B


@dataclasses.dataclass
class _Assembled:
    qp: QP
    K_blocks: torch.Tensor  # the blocks of A (after any Dirichlet elimination)
    fixed_mask: np.ndarray
    null_bases: Any
    lam_max: Optional[torch.Tensor]  # largest eigenvalue per block, when computed


def _assemble(prob: FetiProblem, opts: FetiOptions, dev: torch.device,
              timings: Optional[dict] = None) -> _Assembled:
    t0 = time.perf_counter()
    ns, nl, N = prob.ns, prob.nl, prob.n_decomposed
    K_blocks, b_loc = prob.K_blocks, prob.b_loc
    blocks_coo, cE_parts, row_off = [], [], 0
    if opts.dirichlet_by_B and len(prob.dirichlet):
        dr, dc, dv, nd, cvals = build_dirichlet_rows(prob)
        blocks_coo.append((dr, dc, dv))
        cE_parts.append(cvals)
        row_off = nd
    elif len(prob.dirichlet):
        K_blocks, b_loc, _ = eliminate_dirichlet_in_blocks(prob)
    gr, gc, gv, ng = build_gluing(prob.l2g, opts.gluing, opts.scale)
    blocks_coo.append((gr + row_off, gc, gv))
    cE_parts.append(np.zeros(ng))
    rows, cols, vals = (np.concatenate([t[i] for t in blocks_coo]) for i in range(3))
    BE = _device_extension(
        SubdomainExtension.from_coo(rows, cols, vals, m=row_off + ng, ns=ns, nl=nl), opts, dev)
    if opts.throughput:
        BE = BE.with_dense_blocks()
    cE = torch.as_tensor(np.concatenate(cE_parts), dtype=torch.float64, device=dev)
    K_t = torch.as_tensor(np.asarray(K_blocks, dtype=np.float64), device=dev)
    if timings is not None:
        _sync(dev)
        timings["host_setup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()

    # floating subdomains = singular blocks of the FINAL K (matinv.c:55-195),
    # one batched eigvalsh on the device; the largest eigenvalues are kept
    # for the exact K+ regularization
    lam_max = None
    if prob.floating is not None:
        floating = np.asarray(prob.floating, dtype=bool)
    else:
        floating, lam_max = floating_and_lam_max(K_t)
    fixed_mask = ~floating
    if timings is not None:
        _sync(dev)
        timings["floating_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()

    null_bases = None
    if opts.nullspace == "numeric":
        null_bases = numeric_nullspace_blocks(np.asarray(K_blocks), prob.l2g)
        rr, rc, rv, k = nullspace_columns_from_blocks(null_bases)
    elif opts.nullspace == "rbm":
        if prob.coords is None:
            raise ValueError("nullspace='rbm' needs prob.coords")
        null_bases = []
        for s in range(ns):
            if fixed_mask[s]:
                null_bases.append(np.zeros((nl, 0)))
                continue
            # all coordinate rows of the subdomain, padding included, as the
            # JAX package builds them (a padding row carries the
            # translations; B and b vanish there, so the solution does not
            # see it)
            modes = rigid_body_modes(prob.coords[s])
            pad = np.zeros((nl, modes.shape[1]))
            pad[: modes.shape[0], :] = modes
            null_bases.append(pad)
        rr, rc, rv, k = nullspace_columns_from_blocks(null_bases)
    else:
        rr, rc, rv, k = constant_nullspace_columns(prob, fixed_mask)
    R = Ell.from_scipy(sp.coo_matrix((rv, (rr, rc)), shape=(N, k)), device=dev) if k else None
    b = torch.as_tensor(np.asarray(b_loc, dtype=np.float64).reshape(-1), device=dev)
    qp = QP(A=BlockDiagDense(blocks=K_t), b=b, BE=BE, cE=cE, R=R)
    if timings is not None:
        timings["host_setup_s"] += time.perf_counter() - t0
    return _Assembled(qp, K_t, fixed_mask, null_bases, lam_max)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def assemble_qp(prob: FetiProblem, opts: FetiOptions = FetiOptions(), device=None):
    """Build the decomposed-space QP on ``device`` (None: the card):
    A = diag(K_s), BE = [Bd; Bg] with its gather tables, R.  Returns
    (qp, K_blocks, fixed_mask, null_bases), ``K_blocks`` the (ns, nl, nl)
    device tensor of A's blocks (after any Dirichlet elimination)."""
    _check_options(opts)
    a = _assemble(prob, opts, resolve_device(device))
    return a.qp, a.K_blocks, a.fixed_mask, a.null_bases


def ragged_sizes(l2g: np.ndarray) -> Optional[np.ndarray]:
    """True per-subdomain sizes when padding (-1 entries) is a trailing
    suffix of every row; None when sizes are uniform or padding is
    interleaved (the uniform batched path handles those)."""
    real = np.asarray(l2g) >= 0
    sizes = real.sum(axis=1)
    if sizes.min() == sizes.max():
        return None
    if not np.array_equal(real, np.arange(real.shape[1])[None, :] < sizes[:, None]):
        return None
    return sizes


def make_blockdiag_kplus(K_blocks, fixed_mask, prob: FetiProblem, null_bases=None,
                         explicit: bool = False, sizes=None, rho_mode: str = "exact",
                         device=None, lam_max: Optional[torch.Tensor] = None):
    """Batched per-block regularized Cholesky K+ (MAT_INV_BLOCKDIAG with
    MatRegularize, matinv.c:435-590, permonmatregularize.c): K_s + rho_s
    Q_s Q_s' on every regularized block, Q_s its nullspace basis (the
    normalized constant over the real dofs by default), then one batched
    Cholesky on the device.

    ``rho_mode``: 'exact' = the block's largest eigenvalue (batched
    ``eigvalsh`` over the regularized blocks, or ``lam_max`` when the caller
    has it), 'gershgorin' = the largest absolute row sum.  ``K_blocks`` is a
    tensor (used where it lies) or an array (put on ``device``, None: the
    card).  ``sizes`` routes to the bucketed
    :class:`~permon_tpu_torch.core.factor.RaggedBlockDiagCholInv`."""
    K = K_blocks if isinstance(K_blocks, torch.Tensor) else torch.as_tensor(
        np.asarray(K_blocks, dtype=np.float64), device=resolve_device(device))
    ns, nl, _ = K.shape
    if null_bases is not None:
        reg_mask = np.array([b.shape[1] > 0 for b in null_bases])
    elif fixed_mask is not None:
        reg_mask = ~np.asarray(fixed_mask, dtype=bool)
    else:
        reg_mask = np.ones(ns, dtype=bool)
    reg_idx = np.flatnonzero(reg_mask)
    Kreg = K.clone()
    if len(reg_idx):
        ridx = torch.as_tensor(reg_idx, device=K.device)
        Kr = K[ridx]
        if rho_mode == "gershgorin":
            rho = torch.abs(Kr).sum(dim=2).amax(dim=1)
        elif lam_max is not None:
            rho = lam_max[ridx]
        else:
            rho = torch.linalg.eigvalsh(Kr)[:, -1]
        if null_bases is not None:
            kmax = max(null_bases[s].shape[1] for s in reg_idx)
            Q = np.zeros((len(reg_idx), nl, kmax))
            for j, s in enumerate(reg_idx):
                Q[j, :, : null_bases[s].shape[1]] = null_bases[s]
        else:
            real = np.asarray(prob.l2g)[reg_idx] >= 0
            Q = (real / np.sqrt(real.sum(axis=1, keepdims=True)))[:, :, None]
        Qt = torch.as_tensor(Q, dtype=K.dtype, device=K.device)
        Kreg[ridx] = Kr + rho[:, None, None] * torch.bmm(Qt, Qt.transpose(1, 2))
        del Kr, Qt
    if sizes is not None:
        return RaggedBlockDiagCholInv.from_blocks(Kreg, sizes, explicit=explicit)
    return BlockDiagCholInv.from_blocks(Kreg, explicit=explicit)


def _attach_contact(qp: QP, BI, cI, opts: FetiOptions, dev: torch.device) -> QP:
    """qp with the inequality rows BI u <= cI: an extension over the
    decomposed (ns, nl) space gets its gather tables on ``dev``."""
    if isinstance(BI, SubdomainExtension):
        BI = _device_extension(BI, opts, dev)
    cI_t = None if cI is None else torch.as_tensor(np.asarray(cI), dtype=torch.float64,
                                                   device=dev)
    return qp.replace(BI=BI, cI=cI_t)


def _kplus(a: _Assembled, prob: FetiProblem, opts: FetiOptions):
    return make_blockdiag_kplus(
        a.K_blocks, a.fixed_mask, prob, a.null_bases, explicit=opts.throughput,
        sizes=ragged_sizes(prob.l2g) if opts.ragged_kplus else None,
        rho_mode=opts.resolved_rho_mode(prob.ns), lam_max=a.lam_max)


class FetiSolver:
    """Reusable TFETI solver — the QPTFetiPrepareReuseCP analog
    (qptransform.c:1213-1251): the constraint operators and the batched K+
    factorization are built once on ``device`` (None: the card), the coarse
    projector at the first solve, and all are reused by every solve with a
    new right-hand side.

    >>> solver = FetiSolver(prob, opts, device="cuda")
    >>> r1 = solver.solve()                      # factorized in the constructor
    >>> r2 = solver.solve(b_loc=new_loads)       # reuses K+

    As in the JAX package, ``b_loc`` replaces the rhs of the QP as it is:
    with ``dirichlet_by_B=False`` it must already be the eliminated rhs."""

    def __init__(self, prob: FetiProblem, opts: FetiOptions = FetiOptions(),
                 BI=None, cI=None, device=None):
        _check_options(opts)
        self.prob = prob
        self.opts = opts
        self.device = resolve_device(device)
        #: host_setup_s, floating_s and factor_s of the constructor
        self.timings: dict = {}
        a = _assemble(prob, opts, self.device, self.timings)
        self.qp, self._K_blocks, self._fixed_mask, self._null_bases = (
            a.qp, a.K_blocks, a.fixed_mask, a.null_bases)
        if BI is not None:
            self.qp = _attach_contact(self.qp, BI, cI, opts, self.device)
        t0 = time.perf_counter()
        self.kplus = _kplus(a, prob, opts)
        _sync(self.device)
        self.timings["factor_s"] = time.perf_counter() - t0
        self._pf = None  # the coarse projector, from the first solve on
        #: the leaf path's operators, from the first solve on (throughput=True)
        self._leaf: dict = {}

    def solve(self, b_loc=None, tol: Tolerances = Tolerances()) -> FetiResult:
        prob, qp = self.prob, self.qp
        if b_loc is not None:
            prob = dataclasses.replace(prob, b_loc=np.asarray(b_loc))
            qp = qp.replace(b=torch.as_tensor(np.asarray(b_loc, dtype=np.float64).reshape(-1),
                                              device=self.device))
        res = _feti_solve_impl(prob, self.opts, tol, qp, self.kplus, pf=self._pf,
                               leaf_cache=self._leaf)
        if self._pf is None:
            self._pf = res.dual_qp.pf
        return res

    def save(self, path: str) -> None:
        """Checkpoint the factorized state, ``{"kplus", "qp"}`` and, after
        the first solve, the coarse projector ``"pf"`` (utils/checkpoint.py);
        :meth:`load` makes a solver of it again."""
        from ..utils.checkpoint import save

        state = {"kplus": self.kplus, "qp": self.qp}
        if self._pf is not None:
            state["pf"] = self._pf
        save(path, state)

    @classmethod
    def load(cls, path: str, prob: FetiProblem, opts: FetiOptions = FetiOptions(),
             device=None) -> "FetiSolver":
        """A solver of the state :meth:`save` wrote for ``prob`` / ``opts``,
        on ``device`` (None: the card): nothing is assembled or factorized
        again."""
        from ..utils.checkpoint import load

        _check_options(opts)
        state = load(path, device)
        self = cls.__new__(cls)
        self.prob, self.opts, self.device = prob, opts, resolve_device(device)
        self.timings = {}
        self.qp, self.kplus = state["qp"], state["kplus"]
        self._K_blocks, self._fixed_mask, self._null_bases = self.qp.A.blocks, None, None
        self._pf, self._leaf = state.get("pf"), {}
        return self


def feti_solve(prob: FetiProblem, opts: FetiOptions = FetiOptions(),
               tol: Tolerances = Tolerances(), BI=None, cI=None, device=None) -> FetiResult:
    """TFETI solve of ``prob`` on ``device`` (None: the card).  ``BI`` /
    ``cI``: optional decomposed-space inequality rows BI u <= cI (contact;
    ``BI`` a SubdomainExtension over the (ns, nl) space): dualize turns them
    into the dual box lambda_I >= 0, and the solver becomes SMALXE around
    MPRGP."""
    _check_options(opts)
    dev = resolve_device(device)
    a = _assemble(prob, opts, dev)
    qp = a.qp if BI is None else _attach_contact(a.qp, BI, cI, opts, dev)
    return _feti_solve_impl(prob, opts, tol, qp, _kplus(a, prob, opts))


def _feti_solve_impl(prob: FetiProblem, opts: FetiOptions, tol: Tolerances, qp: QP,
                     kplus, pf=None, leaf_cache: Optional[dict] = None) -> FetiResult:
    """One solve of an assembled, factorized problem; ``pf`` reuses the
    coarse projector of an earlier solve (its G = R'B' is the same), and
    ``leaf_cache`` (a dict, filled by the first solve) the leaf path's
    operators."""
    with deterministic_mode(opts.deterministic):
        return _feti_solve_body(prob, opts, tol, qp, kplus, pf, leaf_cache)


def _use_leaf(opts: FetiOptions, qp: QP, kplus) -> bool:
    """The leaf path takes a throughput solve whose constraint rows are
    extension operators and whose K+ has explicit inverses (solve.py:
    428-434)."""
    return (opts.throughput and opts.orth_G is None
            and isinstance(qp.BE, SubdomainExtension)
            and (qp.BI is None or isinstance(qp.BI, SubdomainExtension))
            and hasattr(kplus, "explicitly"))


def _leaf_qp(qp: QP, dual: QP, kplus, cache: Optional[dict], mesh=None):
    """(leaf QP, sls) of ``dual``: the dual of the STACKED [BE; BI] in the
    scaled-leaf space, its cE homogenized; its operators, projector and sls
    come from ``cache`` when an earlier solve put them there.  ``mesh``: the
    F apply is the overlapped exchange over its ranks."""
    from .leafqp import leaf_dual_qp

    cache = {} if cache is None else cache
    if "B_full" not in cache:
        cache["B_full"] = (qp.BE if qp.BI is None
                           else SubdomainExtension.vstack((qp.BE, qp.BI)).with_dense_blocks())
    leaf, sls = leaf_dual_qp(dual, cache["B_full"], kplus, mesh=mesh, reuse=cache.get("leaf"))
    cache.setdefault("leaf", leaf)
    if leaf.cE is not None:
        leaf, _ = homogenize_eq(leaf)
    return leaf, sls


def _leaf_smalxe_opts(sm: SMALXEOptions, leaf64: QP, sls, m: int) -> SMALXEOptions:
    """SMALXE options with the spectral estimates made on the leaf QP being
    solved (projected or not) from the lifted all-ones start, so that the
    power method, and with it M1 / rho / alpha and the counts, follow the
    row-space solve; always on the f64 operators ``leaf64`` (solve.py:
    472-502: an f32 power method shifted the schedule to 41/84 outer/inner
    against f64's 34/91 on the contact example)."""
    from ..core.eig import max_eigenvalue
    from ..core.linop import Penalized

    if leaf64.BE is None:
        return sm
    v0 = sls.lift(torch.ones(m, dtype=leaf64.b.dtype, device=leaf64.b.device))
    if sm.maxeig is None and ((not sm.M1_direct) or (not sm.rho_direct) or sm.inject_maxeig):
        sm = dataclasses.replace(sm, maxeig=max_eigenvalue(
            leaf64.A, v0=v0, tol=sm.maxeig_tol, maxits=sm.maxeig_iter))
    if sm.maxeig_inner is None and not sm.inject_maxeig:
        rho0 = (torch.tensor(sm.rho, dtype=v0.dtype, device=v0.device) if sm.rho_direct
                else sm.rho * torch.as_tensor(sm.maxeig, dtype=v0.dtype, device=v0.device))
        sm = dataclasses.replace(sm, maxeig_inner=max_eigenvalue(
            Penalized(a=leaf64.A, b=leaf64.BE, rho=rho0), v0=v0, tol=sm.maxeig_tol,
            maxits=sm.maxeig_iter))
    return sm


def _leaf_precision(leaf: QP, policy: str, cache: dict) -> QP:
    """The whole-QP policy on the leaf QP: f32 leaf state (iterates,
    axpys, gradient splits), under 'mixed' with every solver dot promoted to
    f64; the projector stays f64.  The f32 copies of the operators are made
    once per cache."""
    if policy == "f64":
        return leaf
    if ("lo", policy) not in cache:
        lo = leaf.with_precision(policy)
        cache[("lo", policy)] = (lo.A, lo.BE)
    A, BE = cache[("lo", policy)]
    # casting what is already f32 keeps the tensors: only b, x0, box, cE are new
    return leaf.replace(A=A, BE=BE).with_precision(policy)


def _leaf_lumped_pc(K_blocks: torch.Tensor, sls, policy: str, cache: dict):
    """The lumped dual preconditioner on scaled-leaf vectors of the stacked
    extension ``cache["B_full"]``, in f32 under a reduced precision policy
    (made once per cache)."""
    from ..core.precision import cast_floats
    from .leafqp import lumped_pc_leaf

    if ("pc", policy) not in cache:
        pc = lumped_pc_leaf(cache["B_full"], K_blocks, sls)
        cache[("pc", policy)] = pc if policy == "f64" else cast_floats(pc, torch.float32)
    return cache[("pc", policy)]


def _row_solution(res, sls) -> Solution:
    """The solver's result as a row-space Solution (restricted from leaf
    space when ``sls`` is given)."""
    bt = getattr(res, "Bt_lambda", None)
    if sls is None:
        return Solution(x=res.x, Bt_lambda=bt)
    return Solution(x=sls.restrict(res.x), Bt_lambda=None if bt is None else sls.restrict(bt))


def _feti_solve_body(prob: FetiProblem, opts: FetiOptions, tol: Tolerances, qp: QP,
                     kplus, pf=None, leaf_cache: Optional[dict] = None) -> FetiResult:
    steps = []
    dual, post_d = dualize(qp, kplus=kplus, coarse=opts.coarse, pf=pf)
    if (pf is None and opts.qppf_redundancy and dual.BE is not None and opts.mesh is not None
            and len(opts.mesh.axis_names) == 2):
        # the redundancy-group coarse solve (-dual_qppf_redundancy): the
        # group-distributed factor in place of the replicated one, for every
        # projector and post-solve application (solve.py:380-396)
        from ..parallel.coarse import redundant_projector
        from ..qp.projector import dense_rows

        Gd = dense_rows(dual.BE).cpu().numpy()
        dual = dual.replace(pf=redundant_projector(dual.BE, Gd @ Gd.T, opts.mesh))
    steps.append((dual, post_d))
    cur = dual
    if opts.precision == "mixed":
        # f32 OPERATOR storage behind an f64 vector interface: the dual
        # vectors stay f64 (ex1's one-iteration convergence needs them),
        # streaming the K+ factors halves
        from ..core.precision import with_precision

        cur = cur.replace(A=with_precision(cur.A, "mixed"))
    elif opts.precision != "f64":
        cur = cur.with_precision(opts.precision)
    if opts.orth_G and cur.BE is not None:
        cur, post_o = orthonormalize_eq(cur, opts.orth_G)
        steps.append((cur, post_o))
    if cur.cE is not None:
        cur, post_h = homogenize_eq(cur)
        steps.append((cur, post_h))

    # the lumped dual preconditioner M = B K B' with the ORIGINAL blocks
    # (pcdual.c:63-78); they are A's unless Dirichlet was eliminated
    use_leaf = _use_leaf(opts, qp, kplus)
    precond = K_orig = None
    if opts.pc_dual == "lumped":
        from ..pc.dual import PCDual

        eliminated = not opts.dirichlet_by_B and len(prob.dirichlet)
        K_op = qp.A if not eliminated else BlockDiagDense(blocks=torch.as_tensor(
            np.asarray(prob.K_blocks, dtype=np.float64), device=qp.b.device))
        K_orig = K_op.blocks
        if not use_leaf:
            precond = PCDual.create(qp.BE, K_op, "lumped").mv

    # the scaled-leaf dual (feti/leafqp.py): the Krylov / active-set
    # iteration moves to leaf space, the row-space chain above still makes
    # the post-solves
    leaf = leaf64 = sls = pc_leaf = None
    if use_leaf:
        leaf_cache = {} if leaf_cache is None else leaf_cache
        leaf, sls = _leaf_qp(qp, dual, kplus, leaf_cache, mesh=opts.mesh)
        leaf64 = leaf
        leaf = _leaf_precision(leaf, opts.precision, leaf_cache)
        if opts.pc_dual == "lumped":
            pc_leaf = _leaf_lumped_pc(K_orig, sls, opts.precision, leaf_cache).mv

    if cur.BE is None:
        # no floating subdomain -> no coarse space: plain (preconditioned) CG
        res = (cg(leaf, tol=tol, precond=pc_leaf) if use_leaf
               else cg(cur, tol=tol, precond=precond))
    elif opts.project:
        pf_holder = cur
        cur, post_p = enforce_eq_by_projector(cur)
        steps.append((cur, post_p))
        if use_leaf:
            leaf_pf = leaf.pf
            leaf, _ = enforce_eq_by_projector(leaf)
            # the f64 twin of the spectral estimates follows the projection
            leaf64 = leaf if opts.precision == "f64" else enforce_eq_by_projector(leaf64)[0]
        if cur.box is None and cur.BE is None:
            if use_leaf:
                project = leaf_pf.apply_p if pc_leaf is not None else None
                res = cg(leaf, tol=tol, precond=pc_leaf, project=project)
            else:
                project = pf_holder.pf.apply_p if precond is not None else None
                res = cg(cur, tol=tol, precond=precond, project=project)
        elif use_leaf:
            # a box survives (contact): SMALXE on the projected dual
            res = smalxe(leaf, opts=_leaf_smalxe_opts(opts.smalxe, leaf64, sls, dual.b.shape[0]),
                         tol=tol)
        else:
            res = smalxe(cur, opts=opts.smalxe, tol=tol)
    elif use_leaf:
        res = smalxe(leaf, opts=_leaf_smalxe_opts(opts.smalxe, leaf64, sls, dual.b.shape[0]),
                     tol=tol)
    else:
        res = smalxe(cur, opts=opts.smalxe, tol=tol)
    sol = compose(steps)(_row_solution(res, sls))

    u = sol.x.detach().cpu().numpy().reshape(prob.ns, prob.nl)
    x_global = assemble_global_mean(u, prob.l2g, prob.n_global)
    return FetiResult(x_global=x_global, u_decomposed=sol.x, solution=sol, result=res,
                      qp=qp, dual_qp=dual)


def prepare_contact_children(prob: FetiProblem, opts: FetiOptions, BI, cI, kplus=None,
                             device=None):
    """The QP the contact pipeline hands to SMALXE — the projected dual with
    its surviving box — in row space, or with ``opts.throughput`` its
    scaled-leaf twin with row-matched spectral estimates (solve.py:
    567-623).  Returns ``(qp_solve, smalxe_opts, sls)``, ``sls`` None on the
    row path, so that ``smalxe(qp_solve, opts=smalxe_opts)`` reproduces the
    iteration of :func:`feti_solve`."""
    _check_options(opts)
    dev = resolve_device(device)
    a = _assemble(prob, opts, dev)
    qp = _attach_contact(a.qp, BI, cI, opts, dev)
    if kplus is None:
        kplus = make_blockdiag_kplus(a.K_blocks, a.fixed_mask, prob, a.null_bases,
                                     explicit=opts.throughput,
                                     rho_mode=opts.resolved_rho_mode(prob.ns),
                                     lam_max=a.lam_max)
    dual, _ = dualize(qp, kplus=kplus, coarse=opts.coarse)
    if not opts.throughput:
        cur = dual
        if cur.cE is not None:
            cur, _ = homogenize_eq(cur)
        cur, _ = enforce_eq_by_projector(cur)
        return cur, opts.smalxe, None
    leaf, sls = _leaf_qp(qp, dual, kplus, None)
    leaf, _ = enforce_eq_by_projector(leaf)
    sm = _leaf_smalxe_opts(opts.smalxe, leaf, sls, dual.b.shape[0])
    # f32 leaf state (+ f64 dots under 'mixed'), the estimates above made
    # on the f64 operators first
    return leaf.with_precision(opts.precision), sm, sls
