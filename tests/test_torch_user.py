"""The public names of permon_tpu_torch (the JAX package's ``__all__`` and
subpackage exports, the examples' helpers) and the user-side modules —
``sys.options``, ``sys.tracing`` with ``Timer``, the debug self-checks,
``viewers``, ``utils.checkpoint`` with ``FetiSolver.save``, ``svm`` —
against the JAX package on the CPU (the oracles of tests/test_components.py::TestSys,
tests/test_debug_checks.py, tests/test_output_diff.py::TestResidualHistory
and tests/test_svm.py).

Tolerances, per check:

- names: every public name of the JAX package's namespace and of its five
  re-exporting subpackages is in the port's, of the same kind; the
  examples' helpers equal; ``__graft_entry__``'s recipe through the names:
  equal iterations, x and the projected-gradient norm to 1e-9;
- options: the same parsed values, the same solve counts as the JAX
  package's solve_from_options on the same QP, the same FetiOptions;
- Timer: the operator's applications counted exactly (the JAX package
  counts traces instead: one per compilation);
- viewers: text equal to the JAX viewer's, character for character, on
  the results of the same solves (equal counts; residual digits agree at
  %.2e on these problems);
- checkpoint: tensors bitwise equal after a round trip; a re-solve of a
  loaded FetiSolver bitwise equal to the live solver's;
- SVC: alpha to 1e-6 of the JAX package's, equal SMALXE outer / inner
  counts, equal training scores; the svm example's main against the JAX
  package's (tests/torch_example_parity.py).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import examples.ex1 as jexqp
import examples.feti_ex71 as jex71
import permon_tpu as jpt
import permon_tpu.feti.solve as jsolve
import permon_tpu.viewers as jviewers
from permon_tpu.sys import options as joptions
from permon_tpu.sys import tracing as jtracing

import permon_tpu_torch as tpt
import permon_tpu_torch.problems as tprob
import permon_tpu_torch.viewers as tviewers
from permon_tpu_torch.core.convergence import Tolerances
from permon_tpu_torch.feti.solve import FetiOptions, FetiSolver, feti_solve
from permon_tpu_torch.sys import options as toptions
from permon_tpu_torch.sys import tracing as ttracing
from permon_tpu_torch.utils import checkpoint

from torch_example_parity import check_example

torch.set_num_threads(2)


def _box_qp(pkg, n=40, seed=0, **kw):
    """tests/test_components.py::small_box_qp on either package."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    return pkg.QP.create(M @ M.T + n * np.eye(n), rng.standard_normal(n), lb=-0.1 * np.ones(n),
                         **kw)


# -- options -------------------------------------------------------------------


def test_options_parse_and_solve(tmp_path, monkeypatch):
    args = ["-qps_rtol", "1e-7", "-qps_type", "mpgp", "-qps_mpgp_gamma", "1.0"]
    opts = toptions.Options.from_args(args, rc=False)
    jopts = joptions.Options.from_args(args, rc=False)
    assert opts.db == jopts.db and opts.get("qps_rtol") == 1e-7
    assert opts.sub("qps_mpgp_") == {"gamma": 1.0}
    res = tpt.solve_from_options(_box_qp(tpt, device="cpu"), opts)
    jres = joptions.solve_from_options(_box_qp(jpt), jopts)
    assert res.reason > 0 and res.rnorm <= 1e-7 * np.linalg.norm(
        _box_qp(tpt, device="cpu").b.numpy())
    assert (res.iterations, res.nmv) == (int(jres.iterations), int(jres.nmv))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0, atol=1e-10)
    # rc files: the home's, then the working directory's, then argv
    home, cwd = tmp_path / "home", tmp_path / "cwd"
    home.mkdir(), cwd.mkdir()
    (home / ".permonrc").write_text("-qps_rtol 1e-3 -qps_max_it 7 # comment\n")
    (cwd / ".permonrc").write_text("-qps_max_it 9\n")
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.chdir(cwd)
    rc = toptions.Options.from_args(["-qps_rtol", "1e-4"])
    assert rc.db == {"qps_rtol": 1e-4, "qps_max_it": 9}
    tol = toptions.tolerances_from_options(rc)
    assert (tol.rtol, tol.max_it) == (1e-4, 9)


def test_feti_options_mapping():
    db = {"feti_gluing_type": "orth", "dual_pc_dual_type": "lumped",
          "dual_qp_E_orth_type": "gslingen", "project": 0, "feti_precision": "mixed",
          "feti_throughput": 1}
    fo = toptions.feti_options_from_options(toptions.Options(**db))
    jfo = joptions.feti_options_from_options(joptions.Options(**db))
    for f in ("gluing", "pc_dual", "orth_G", "project", "precision", "throughput", "scale",
              "nullspace", "qppf_redundancy"):
        assert getattr(fo, f) == getattr(jfo, f), f
    assert fo.orth_G == "gs_lingen" and fo.throughput is True  # the reference's 'gslingen'
    # -feti_throughput now runs: the leaf path on ex71
    prob = tprob.build_ex71((4, 4, 4), (2, 1, 1))
    opts = toptions.feti_options_from_options(toptions.Options.from_args(
        ["-feti_gluing_type", "nonred", "-feti_throughput", "1"], rc=False))
    leaf = feti_solve(prob, opts, device="cpu")
    row = feti_solve(prob, FetiOptions(gluing="nonred"), device="cpu")
    assert leaf.result.iterations == row.result.iterations
    np.testing.assert_allclose(leaf.x_global, row.x_global, rtol=0, atol=1e-9)


def test_not_ported_options_still_raise():
    """The multi-device options run (tests/test_torch_parallel.py); a mesh
    that is not a permon_tpu_torch.parallel Mesh raises TypeError, and
    qppf_redundancy without a mesh is ignored, as in the JAX package."""
    prob = tprob.build_feti_ex1(4, 7)
    with pytest.raises(TypeError, match="Mesh"):
        feti_solve(prob, FetiOptions(mesh=object()), device="cpu")
    res = feti_solve(prob, FetiOptions(qppf_redundancy=True), device="cpu")
    plain = feti_solve(prob, FetiOptions(), device="cpu")
    assert res.result.iterations == plain.result.iterations
    np.testing.assert_array_equal(res.x_global, plain.x_global)


# -- the JAX package's public names ---------------------------------------------


def _kind(obj):
    import inspect

    if inspect.ismodule(obj):
        return "module"
    if inspect.isclass(obj):
        return "class"
    return "function" if callable(obj) else type(obj).__name__


@pytest.mark.parametrize("sub", ["", "solvers", "qp", "qpc", "pc", "core"])
def test_public_names_match_jax(sub):
    """Every public name of the JAX package's namespace (``__all__``; all
    but ``enable_compilation_cache``, which configures JAX's compilation
    cache) and of its five subpackages that re-export names is a name of
    the port's counterpart, of the same kind (class, function or module)."""
    import importlib

    jmod = importlib.import_module("permon_tpu" + (f".{sub}" if sub else ""))
    tmod = importlib.import_module("permon_tpu_torch" + (f".{sub}" if sub else ""))
    if sub:
        names = sorted(n for n in vars(jmod) if not n.startswith("_")
                       and not (_kind(getattr(jmod, n)) == "module"
                                and getattr(jmod, n).__name__.startswith(f"permon_tpu.{sub}.")
                                and n not in ("convergence", "eig", "linop")))
    else:
        names = sorted(set(jmod.__all__) - {"enable_compilation_cache"})
        assert set(names) <= set(tmod.__all__)
    assert names, sub
    kinds = {n: (_kind(getattr(tmod, n, None)), _kind(getattr(jmod, n))) for n in names}
    assert all(t == j for t, j in kinds.values()), kinds
    if sub == "solvers":
        assert tmod.mprgp is tpt.mprgp and tmod.solve is tpt.solve


def test_graft_entry_recipe_through_the_names():
    """``__graft_entry__.entry``'s recipe written against the package
    names (``Dia``, ``QP``, ``mprgp``, ``Tolerances``) runs unchanged on the
    port: the same iterations as the JAX package (the 200 of the cap), x
    and the projected-gradient norm to 1e-9 (200 iterations, not converged)."""
    n = 1024
    A, b, lb = tprob.build_ex1(n)
    out = {}
    for pkg, kw in ((jpt, {}), (tpt, dict(device="cpu"))):
        op = pkg.Dia.from_scipy(sp.csr_matrix(A), **kw)
        res = pkg.mprgp(pkg.QP.create(op, b, lb=lb, **kw), tol=pkg.Tolerances(max_it=200))
        out[pkg.__name__] = (int(res.iterations), np.asarray(res.x), float(res.rnorm))
    (ij, xj, rj), (it, xt, rt) = out["permon_tpu"], out["permon_tpu_torch"]
    assert it == ij
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-9)


def test_example_helpers_match_jax():
    """The JAX examples' helpers under their module paths:
    ``examples.ex2.fobst`` (the formula ``build_ex2`` uses) and
    ``examples.feti_ex71.q1_poisson_emat`` / ``q1_elasticity_emat``, equal
    to the JAX ones."""
    import examples.ex2 as jex2
    from permon_tpu_torch.examples import ex2, feti_ex71

    n = 100
    got = np.array([ex2.fobst(i, n) for i in range(n)])
    np.testing.assert_array_equal(got, [jex2.fobst(i, n) for i in range(n)])
    np.testing.assert_array_equal(ex2.fobst(np.arange(n), n), got)
    lb = ex2.build(n)[2]
    np.testing.assert_array_equal(lb[1:n // 2], got[1:n // 2])
    for dim in (1, 2, 3):
        np.testing.assert_array_equal(feti_ex71.q1_poisson_emat(dim), jex71.q1_poisson_emat(dim))
        np.testing.assert_array_equal(feti_ex71.q1_elasticity_emat(dim, 2.0, 0.5),
                                      jex71.q1_elasticity_emat(dim, 2.0, 0.5))


# -- tracing and Timer ---------------------------------------------------------


def test_tracing_events_and_timer_counts(capsys):
    ttracing.reset()
    with ttracing.trace("setup_phase"):
        pass
    op = tpt.Timer(inner=tpt.aslinearoperator(np.eye(4), device="cpu"), name="K")
    x = torch.ones(4, dtype=torch.float64)
    for _ in range(3):
        op.mv(x)
    op.rmv(x)
    rep = ttracing.event_report()
    assert "setup_phase" in rep and "K.mv" in rep and "K.rmv" in rep
    # applications, where the JAX package counts traces
    assert ttracing.op_counts[("K", "mv")] == 3 and ttracing.op_counts[("K", "rmv")] == 1
    # a Timer around the Hessian of a CG solve sees every product of it
    ttracing.reset()
    qp = _box_qp(tpt, device="cpu").replace(box=None)
    res = tpt.solve(qp.replace(A=tpt.Timer(inner=qp.A, name="A")), qps_type="cg")
    assert ttracing.op_counts[("A", "mv")] == res.nmv
    # trace / info / debug print in the JAX package's words
    old = (ttracing.debug_enabled, ttracing.trace_enabled, ttracing.info_enabled)
    ttracing.set_from_options(debug=True, trace=True, info=True)
    jold = (jtracing.debug_enabled, jtracing.trace_enabled, jtracing.info_enabled)
    jtracing.set_from_options(debug=True, trace=True, info=True)
    try:
        for tr in (ttracing, jtracing):
            tr.debug("value %d", 7)
            tr.info("note")
            with tr.trace("outer"):
                pass
        out = capsys.readouterr().out.splitlines()
    finally:
        ttracing.set_from_options(*old)
        jtracing.set_from_options(*jold)
    half = len(out) // 2
    assert out[:2] == out[half:half + 2] == ["DEBUG: value 7", "INFO: note"]
    assert out[2] == "BEGIN FUNCTION outer" and out[3].startswith("END FUNCTION outer (")


# -- the debug self-checks (tests/test_debug_checks.py) --------------------------


@pytest.fixture
def debug_mode():
    old = ttracing.debug_enabled
    ttracing.set_from_options(debug=True)
    yield
    ttracing.set_from_options(debug=old)


def test_debug_checks(debug_mode):
    """With -permon_debug on, dualize checks K K+ K == K (and the
    Moore-Penrose identity for 'mp'), enforce_eq_by_projector checks P;
    a wrong K+ (twice the inverse) trips the check."""
    from permon_tpu_torch.core.blockdiag import BlockDiagDense
    from permon_tpu_torch.feti.solve import assemble_qp, make_blockdiag_kplus
    from permon_tpu_torch.qp.transforms import dualize

    prob = tprob.build_feti_ex1(3, 5)
    qp, K, fm, nb = assemble_qp(prob, FetiOptions(), device="cpu")
    kplus = make_blockdiag_kplus(K, fm, prob, nb)
    for mode in ("left", "mp"):
        dualize(qp, kplus=kplus, kplus_mode=mode)  # asserts internally
    bad = BlockDiagDense(blocks=2.0 * kplus.explicitly().invs)
    with pytest.raises(AssertionError, match="left generalized inverse"):
        dualize(qp, kplus=bad, kplus_mode="left")
    res = feti_solve(prob, FetiOptions(), device="cpu")  # the projector checks run clean
    assert res.result.reason > 0


def test_debug_mode_takes_the_eager_large_path(debug_mode):
    """large.py:1022-1027: in debug mode FetiSolverSparse re-solves on the
    eager path (the transforms and their checks), to the fast path's x."""
    from permon_tpu_torch.feti.large import FetiSolverSparse

    prob = tprob.build_sparse((6, 6, 6), (2, 2, 2))
    solver = FetiSolverSparse(prob, FetiOptions(gluing="nonred"), device="cpu")
    r1 = solver.solve(tol=Tolerances(rtol=1e-8))
    r2 = solver.solve(b_loc=2.0 * prob.b_loc, tol=Tolerances(rtol=1e-8))
    assert r2.dual_qp is not None  # the eager path returns its dual QP
    ttracing.set_from_options(debug=False)
    r3 = solver.solve(b_loc=2.0 * prob.b_loc, tol=Tolerances(rtol=1e-8))
    assert r3.dual_qp is None  # the fast path
    np.testing.assert_allclose(r2.x_global, r3.x_global, rtol=0, atol=1e-9)
    np.testing.assert_allclose(r2.x_global, 2.0 * r1.x_global, rtol=0, atol=1e-8)


# -- viewers: the JAX viewer's text --------------------------------------------


def test_view_convergence_kkt_history_qp():
    A, b, lb = jexqp.build(100)
    qp = tpt.QP.create(sp.csr_matrix(A), b, lb=lb, device="cpu")
    jqp = jpt.QP.create(sp.csr_matrix(A), b, lb=lb)
    from permon_tpu.solvers.mprgp import mprgp as jmprgp

    from permon_tpu_torch.solvers.mprgp import mprgp

    res, jres = mprgp(qp, history=512), jmprgp(jqp, history=512)
    assert tviewers.view_convergence(res) == jviewers.view_convergence(jres)
    # the history's 12 digits differ in the last one or two: the same text
    # on the same numbers, and the numbers to 1e-10
    jh = np.asarray(jres.rnorm_history)
    np.testing.assert_allclose(res.rnorm_history.numpy()[: res.iterations + 1],
                               jh[: res.iterations + 1], rtol=1e-10)
    same = res.replace(rnorm_history=torch.tensor(jh))
    assert tviewers.view_history(same, "MPGP") == jviewers.view_history(jres, "MPGP")
    assert tviewers.view_history(res, "MPGP").count("\n") == res.iterations
    assert tviewers.view_kkt(qp, res.x) == jviewers.view_kkt(jqp, jres.x)
    assert tviewers.view_qp(qp) == jviewers.view_qp(jqp).replace(
        type(jqp.A).__name__.ljust(22), type(qp.A).__name__.ljust(22))
    assert "last QPSSolve CONVERGED due to CONVERGED_RTOL" in tviewers.view_convergence(res)


def test_view_convergence_smalxe():
    rng = np.random.default_rng(8)
    n = 20
    M = rng.standard_normal((n, n))
    A, b, BE = M @ M.T + n * np.eye(n), rng.standard_normal(n), rng.standard_normal((2, n))
    qp = tpt.QP.create(A, b, BE=BE, cE=np.zeros(2), device="cpu")
    jqp = jpt.QP.create(A, b, BE=BE, cE=np.zeros(2))
    res, jres = tpt.solve(qp, qps_type="smalxe"), jpt.solve(jqp, qps_type="smalxe")
    txt = tviewers.view_convergence_smalxe(res)
    assert txt == jviewers.view_convergence_smalxe(jres)
    assert txt.count("last QPSSolve") == 2


@pytest.fixture(scope="module")
def ex71():
    """The ex71 tutorial's default (7, 8, 9) on (1, 2, 3), full gluing,
    solved by both packages, with its assembled system."""
    prob, jprob = tprob.build_ex71(), jex71.build()
    res = feti_solve(prob, FetiOptions(gluing="full"), device="cpu")
    jres = jsolve.feti_solve(jprob, jsolve.FetiOptions(gluing="full"))
    n = prob.n_global
    A, b = sp.lil_matrix((n, n)), np.zeros(n)
    for s in range(prob.ns):
        real = np.flatnonzero(prob.l2g[s] >= 0)
        g = prob.l2g[s][real]
        A[np.ix_(g, g)] += prob.K_blocks[s][np.ix_(real, real)]
        np.add.at(b, g, prob.b_loc[s][real])
    return prob, res, jres, A.tocsr(), b


def test_view_chain_kkt_feti(ex71):
    """Every line equal to the JAX package's, except the values of the
    lines at round-off (r/||b|| < 1e-10: here the decomposed primal node's
    stationarity), where both must be at round-off; the JAX package's own
    test bounds such lines by magnitude too."""
    import re

    prob, res, jres, A, b = ex71
    txt = tviewers.view_chain_kkt_feti(res, prob=prob, A_asm=A, b_asm=b)
    jtxt = jviewers.view_chain_kkt_feti(jres, prob=prob, A_asm=A, b_asm=b)
    assert res.result.iterations == int(jres.result.iterations) == 9
    assert tviewers.view_convergence(res.result) == jviewers.view_convergence(jres.result)
    lines, jlines = txt.splitlines(), jtxt.splitlines()
    assert len(lines) == len(jlines) == 7
    num = r"\d\.\d\de[+-]\d+"
    for got, want in zip(lines, jlines):
        assert re.sub(num, "#", got) == re.sub(num, "#", want)
        ratio = float(re.findall(num, want)[-1])
        if ratio >= 1e-10:
            assert got == want
        else:
            assert float(re.findall(num, got)[-1]) < 1e-10, got


def test_view_chain(ex71):
    """view_chain / view_qp on the dual QP of both packages: the same lines
    where the operator types are the same (Product, Dense, vectors)."""
    _, res, jres, _, _ = ex71
    steps, jsteps = [(res.dual_qp, None)], [(jres.dual_qp, None)]
    txt, jtxt = tviewers.view_chain(steps, "dual"), jviewers.view_chain(jsteps, "dual")
    assert txt.splitlines()[:4] == jtxt.splitlines()[:4]  # title, stage, A, b
    assert txt.count("\n") == jtxt.count("\n")


# -- checkpoint -----------------------------------------------------------------


def test_checkpoint_round_trip(tmp_path):
    from permon_tpu_torch.core.factor import CholInv

    rng = np.random.default_rng(3)
    M = rng.standard_normal((6, 6))
    kp = CholInv.from_dense(torch.as_tensor(M @ M.T + 6 * np.eye(6)))
    tree = {"kplus": kp, "meta": torch.arange(3), "host": np.arange(4.0), "n": 5,
            "pair": (None, "text"), "dt": torch.float32, "bf": torch.ones(3, dtype=torch.bfloat16)}
    p = str(tmp_path / "state.npz")
    checkpoint.save(p, tree)
    back = checkpoint.load(p, device="cpu")
    assert isinstance(back["kplus"], CholInv) and torch.equal(back["kplus"].chol, kp.chol)
    x = torch.ones(6, dtype=torch.float64)
    assert torch.equal(back["kplus"].mv(x), kp.mv(x))
    assert torch.equal(back["meta"], tree["meta"]) and back["bf"].dtype == torch.bfloat16
    assert back["n"] == 5 and back["pair"] == (None, "text") and back["dt"] == torch.float32
    np.testing.assert_array_equal(back["host"], tree["host"])
    # dump_qp / load_qp: the QP with its SEll Hessian and box
    qp = _box_qp(tpt, device="cpu")
    checkpoint.dump_qp(p, qp)
    q2 = checkpoint.load_qp(p, device="cpu")
    assert type(q2.A) is type(qp.A) and torch.equal(q2.box.lb, qp.box.lb)
    r1, r2 = tpt.solve(qp), tpt.solve(q2)
    assert r1.iterations == r2.iterations and torch.equal(r1.x, r2.x)


def test_checkpoint_refuses_foreign_classes(tmp_path):
    import json

    p = str(tmp_path / "bad.npz")
    struct = {"t": "dc", "cls": "subprocess:Popen", "fields": {}}
    np.savez(p, structure=np.frombuffer(json.dumps(struct).encode(), dtype=np.uint8))
    with pytest.raises(ValueError, match="not a class of permon_tpu_torch"):
        checkpoint.load(p, device="cpu")
    with pytest.raises(TypeError, match="not a class of permon_tpu_torch"):
        checkpoint.save(p, {"x": jsolve.FetiOptions()})


@pytest.mark.parametrize("throughput", [False, True], ids=["row", "leaf"])
def test_feti_solver_save_load(tmp_path, throughput):
    """FetiSolver.save / load: a loaded solver re-solves a new load to a
    bitwise equal x_global, without assembling or factorizing again."""
    prob = tprob.build_ex71((6, 6, 6), (2, 2, 2))
    opts = FetiOptions(gluing="nonred", throughput=throughput)
    solver = FetiSolver(prob, opts, device="cpu")
    solver.solve()
    p = str(tmp_path / "solver.npz")
    solver.save(p)
    loaded = FetiSolver.load(p, prob, opts, device="cpu")
    b_new = 0.5 * prob.b_loc + 0.1
    live, again = solver.solve(b_loc=b_new), loaded.solve(b_loc=b_new)
    assert again.result.iterations == live.result.iterations
    np.testing.assert_array_equal(again.x_global, live.x_global)
    assert torch.equal(loaded.kplus.chols, solver.kplus.chols)


# -- svm (tests/test_svm.py) ------------------------------------------------------


def _blobs(n=120, dim=2, seed=0, margin=1.5):
    return tprob.make_blobs(n, dim, seed, margin)


def _circles(n=120, seed=1):
    rng = np.random.default_rng(seed)
    half = n // 2
    t = rng.uniform(0, 2 * np.pi, n)
    r = np.concatenate([np.full(half, 1.0), np.full(n - half, 3.0)])
    X = np.c_[r * np.cos(t), r * np.sin(t)] + 0.1 * rng.standard_normal((n, 2))
    return X, np.concatenate([np.ones(half), -np.ones(n - half)])


@pytest.mark.parametrize("kernel,data,kw,min_score", [
    ("linear", lambda: _blobs(), {}, 0.97),
    ("rbf", lambda: _circles(), dict(gamma=0.5), 0.95),
    ("poly", lambda: _circles(80, seed=2), dict(degree=2, gamma=1.0), 0.9),
])
def test_svc_against_jax(kernel, data, kw, min_score):
    from examples.svm import make_blobs
    from permon_tpu.svm import SVC as JaxSVC

    from permon_tpu_torch.svm import SVC, svm_dual_qp

    X, y = data()
    clf = SVC(C=1.0, kernel=kernel, device="cpu", **kw).fit(X, y)
    jclf = JaxSVC(C=1.0, kernel=kernel, **kw).fit(X, y)
    r, jr = clf.result_, jclf.result_
    assert (r.reason, r.iterations, r.inner_iterations) == (
        int(jr.reason), int(jr.iterations), int(jr.inner_iterations))
    np.testing.assert_allclose(clf.alpha_, jclf.alpha_, rtol=0, atol=1e-6)
    assert clf.score(X, y) == jclf.score(X, y) >= min_score
    a = clf.alpha_
    assert abs(a @ y) < 1e-4 and a.min() >= -1e-10 and a.max() <= 1.0 + 1e-8
    if kernel == "linear":
        assert len(clf.support_) < len(y) // 2
        np.testing.assert_array_equal(_blobs()[0], make_blobs(120, 2, 0, 1.5)[0])
        qp = svm_dual_qp(X[:40], y[:40], C=2.0, device="cpu")
        assert qp.BE.shape == (1, 40) and float(qp.box.ub[0]) == 2.0


# -- the command-line example of this path --------------------------------------


@pytest.mark.parametrize("name", ["svm"])
def test_example_matches_jax_example(name):
    """The example's main against the JAX package's, in-process: every
    printed line with the numbers masked, and the solution
    (tests/torch_example_parity.py)."""
    check_example(name)
