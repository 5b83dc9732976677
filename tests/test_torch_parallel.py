"""permon_tpu_torch.parallel on real ranks against the port's own
single-device runs and the JAX package's mesh runs.

The JAX package's tests run its mesh on 8 virtual CPU devices; the port's
ranks are processes (``torch.distributed`` with gloo on the CPU).  The file
spawns them twice, once per module-scoped fixture:

- world 2, the flat mesh ``make_mesh()``;
- world 4, the two-level mesh ``make_mesh2((2, 2))``.

Each rank runs every case of its world in one process
(``python -m torch.distributed.run --standalone``, one thread, no ``jax``
import: this file is its own rank worker, run as a script) and writes an
``.npz``; the test functions, one per case, compare those files with
references the parent computes: the port on one device (the cases of
tests/test_parallel.py, test_coarse.py, test_overlap.py and
test_large.py::TestShardedLargePath at their sizes and tolerances), the
JAX package on its own 2-device mesh for the large path's count, the JAX
package on one device for the dense, leaf and redundancy cases on the same
inputs, and the JAX package's overlap plan.  (The JAX package's dense-path
mesh runs cost over a minute of compilation on this CPU; their counts
equal its single-device counts by its own tests.)  Iteration counts must
be EQUAL to the port's one-device and the JAX package's; the sharded F
(one all_reduce of per-rank dual-major partials) must be bitwise equal to
the single-device F on both worlds.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 180
LARGE = ((12,) * 3, (2,) * 3)  # TestShardedLargePath's problem
OBSTACLE = ((15,) * 3, (2,) * 3)
KCS = (3, 8, 13)


def _spd(k, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((k, k))
    return A @ A.T + k * np.eye(k)


def _lam(m, seed=0):
    return np.random.default_rng(seed).standard_normal(m)


# --------------------------------------------------------------- rank side


def _rank_cases(world):
    """{case name: fn(mesh) -> dict of arrays} of a world (run in the ranks)."""
    from permon_tpu_torch.core.convergence import Tolerances
    from permon_tpu_torch.core.detred import deterministic_mode
    from permon_tpu_torch.feti.large import FetiSolverSparse, assemble_qp_sparse, feti_solve_sparse
    from permon_tpu_torch.feti.leaf import LeafDualOperator, leaf_cg
    from permon_tpu_torch.feti.solve import (FetiOptions, assemble_qp, feti_solve,
                                             make_blockdiag_kplus)
    from permon_tpu_torch.parallel import (
        LeafOverlapPlan, OverlappedLeafOperator, RedundantCoarse, feti_dual_apply_hier,
        leaf_apply_overlapped, redundant_projector, shard_qp, shard_qp2, shard_qp_sparse)
    from permon_tpu_torch.parallel.dist import feti_dual_apply_shard_map
    from permon_tpu_torch.problems import (build_feti_contact, build_feti_ex1, build_obstacle,
                                           build_sparse)
    from permon_tpu_torch.qp.projector import Projector
    from permon_tpu_torch.core.linop import Dense
    from permon_tpu_torch.qp.transforms import (Solution, compose, dualize,
                                                enforce_eq_by_projector, homogenize_eq)
    from permon_tpu_torch.solvers.cg import cg
    from permon_tpu_torch.solvers.smalxe import smalxe

    base = dict(gluing="nonred", deterministic=True, coarse="sparse")

    def large_fn(mesh):
        r = feti_solve_sparse(build_sparse(*LARGE), FetiOptions(**base, mesh=mesh),
                              tol=Tolerances(rtol=1e-6), device="cpu")
        return dict(its=r.result.iterations, x=r.x_global)

    def large_solver(mesh):
        prob = build_sparse(*LARGE)
        solver = FetiSolverSparse(prob, FetiOptions(**base, mesh=mesh), device="cpu")
        r1 = solver.solve(tol=Tolerances(rtol=1e-6))
        r2 = solver.solve(b_loc=prob.b_loc * 2.0, tol=Tolerances(rtol=1e-6))
        return dict(its=r1.result.iterations, x=r1.x_global, x2=r2.x_global)

    def large_contact(mesh, redundancy=False):
        prob, BI, cI, _ = build_obstacle(*OBSTACLE)
        r = FetiSolverSparse(prob, FetiOptions(**base, mesh=mesh, qppf_redundancy=redundancy),
                             BI=BI, cI=cI, device="cpu").solve(tol=Tolerances(rtol=1e-5))
        return dict(its=r.result.iterations, inner=r.result.inner_iterations, x=r.x_global)

    def large_layout(mesh):
        prob = build_sparse(*LARGE)
        qp, kplus, _, _ = assemble_qp_sparse(prob, FetiOptions(gluing="nonred"), device="cpu")
        qp_sh, kp_sh, _ = shard_qp_sparse(qp, kplus, mesh)
        lam = torch.as_tensor(_lam(qp.BE.shape[0]))
        F = feti_dual_apply_shard_map(qp_sh.BE, kp_sh, mesh)
        # the main path: assembled under the mesh, this rank's block only
        qp_m, kp_m, _, _ = assemble_qp_sparse(prob, FetiOptions(gluing="nonred", mesh=mesh),
                                              device="cpu")
        Fm = qp_m.BE.mv(kp_m.mv(qp_m.BE.rmv(lam)))
        return dict(Dinv=kp_sh.Dinv.shape, F=kp_sh.F.shape, stencil=qp_sh.A.data.shape,
                    main_Dinv=kp_m.Dinv.shape, main_stencil=qp_m.A.data.shape,
                    Flam=F(lam).numpy(), Flam_main=Fm.numpy(),
                    eq=[torch.equal(kp_m.Dinv, kp_sh.Dinv), torch.equal(kp_m.F, kp_sh.F)])

    def dense_steps(qp_sh, kp_sh, run):
        steps = []
        dual, post_d = dualize(qp_sh, kplus=kp_sh)
        steps.append((dual, post_d))
        cur = dual
        if cur.cE is not None:
            cur, post_h = homogenize_eq(cur)
            steps.append((cur, post_h))
        cur, post_p = enforce_eq_by_projector(cur)
        steps.append((cur, post_p))
        res = run(cur)
        return res, compose(steps)(Solution(x=res.x, Bt_lambda=getattr(res, "Bt_lambda", None)))

    def shard(mesh):  # the two-level placement on ('host', 'sd'), as the JAX tests
        return shard_qp2 if len(mesh.axis_names) == 2 else shard_qp

    def dense_cg(mesh):
        prob = build_feti_ex1(8, 5)
        qp, Kb, fixed, _ = assemble_qp(prob, FetiOptions(), device="cpu")
        qp_sh, kp_sh = shard(mesh)(qp, make_blockdiag_kplus(Kb, fixed, prob), mesh)
        res, sol = dense_steps(qp_sh, kp_sh, lambda q: cg(q, tol=Tolerances()))
        F = feti_dual_apply_shard_map(qp_sh.BE, kp_sh, mesh)
        out = dict(its=res.iterations, u=sol.x.numpy(),
                   Flam=F(torch.as_tensor(_lam(qp.BE.shape[0]))).numpy())
        if len(mesh.axis_names) == 2:
            H = feti_dual_apply_hier(qp_sh.BE, kp_sh, mesh)
            out["Flam_hier"] = H(torch.as_tensor(_lam(qp.BE.shape[0]))).numpy()
        return out

    def dense_smalbe(mesh):
        prob, BI, cI, _ = build_feti_contact(8, 12)
        opts = FetiOptions(gluing="nonred", deterministic=True)
        qp, Kb, fixed, nb = assemble_qp(prob, opts, device="cpu")
        qp = qp.replace(BI=BI.with_gather_apply("cpu"), cI=torch.as_tensor(cI))
        qp_sh, kp_sh = shard(mesh)(qp, make_blockdiag_kplus(Kb, fixed, prob, nb), mesh)
        with deterministic_mode(True):
            res, sol = dense_steps(qp_sh, kp_sh, lambda q: smalxe(
                q, opts=opts.smalxe, tol=Tolerances(rtol=1e-6)))
        return dict(its=res.iterations, inner=res.inner_iterations, u=sol.x.numpy())

    def leaf_setup(ns):
        prob = build_feti_ex1(ns, 5)
        qp, Kb, fixed, _ = assemble_qp(prob, FetiOptions(), device="cpu")
        kplus = make_blockdiag_kplus(Kb, fixed, prob)
        return qp, LeafDualOperator.create(qp.BE, kplus)

    def overlap(mesh):
        out = {}
        for ns in (8, 16):
            qp, op = leaf_setup(ns)
            plan = LeafOverlapPlan.build(op.space, mesh.size)
            ovl = OverlappedLeafOperator.create(op, plan, mesh)
            Lam = op.space.lift(torch.as_tensor(np.random.default_rng(0).normal(
                size=qp.BE.m_dual)))
            out[f"local{ns}"] = leaf_apply_overlapped(op, plan, mesh)(Lam).numpy()
            out[f"full{ns}"] = ovl.apply(Lam).numpy()
            out[f"flat{ns}"] = op.apply(Lam).numpy()
            for f in ("perm", "partners_local", "nb", "ns_loc"):
                out[f"plan{ns}_{f}"] = np.asarray(getattr(plan, f))
            out[f"plan{ns}_offsets"] = np.asarray(plan.offsets)
            for i, (s, r) in enumerate(zip(plan.send_idx, plan.recv_partner)):
                out[f"plan{ns}_send{i}"], out[f"plan{ns}_recv{i}"] = s, r
        qp, op = leaf_setup(16)
        ovl = OverlappedLeafOperator.create(op, LeafOverlapPlan.build(op.space, mesh.size), mesh)
        B_leaf = op.space.lift(torch.as_tensor(np.random.default_rng(1).normal(
            size=qp.BE.m_dual)))
        out["cg_ovl"] = leaf_cg(ovl, B_leaf, tol=Tolerances(max_it=30)).x.numpy()
        out["cg_flat"] = leaf_cg(op, B_leaf, tol=Tolerances(max_it=30)).x.numpy()
        r = feti_solve(build_feti_ex1(8, 5), FetiOptions(throughput=True, mesh=mesh),
                       device="cpu")
        out.update(feti_its=r.result.iterations, feti_reason=int(r.result.reason),
                   feti_x=r.x_global)
        return out

    def coarse(mesh):
        out = {}
        for kc in KCS:
            cp = RedundantCoarse.create(_spd(kc), mesh, axis="sd")
            v = torch.as_tensor(np.random.default_rng(1).standard_normal(kc))
            out[f"mv{kc}"] = cp.mv(v).numpy()
            out[f"L{kc}"] = np.asarray(cp.L.shape)
        rng = np.random.default_rng(2)
        Gd = rng.standard_normal((5, 40))
        G = Dense.create(torch.as_tensor(Gd))
        pf_rep = Projector.create(G, orthonormal_rows=False, gram=Gd @ Gd.T)
        pf_red = redundant_projector(G, Gd @ Gd.T, mesh)
        x = torch.as_tensor(rng.standard_normal(40))
        out.update(p_red=pf_red.apply_p(x).numpy(), p_rep=pf_rep.apply_p(x).numpy(),
                   q_red=pf_red.apply_q(x).numpy(), q_rep=pf_rep.apply_q(x).numpy())
        if len(mesh.axis_names) == 2:
            r = feti_solve(build_feti_ex1(8, 6), FetiOptions(qppf_redundancy=True, mesh=mesh),
                           device="cpu")
            out.update(feti_its=r.result.iterations, feti_x=r.x_global,
                       feti_cp=int(r.dual_qp.pf.cp_dist is not None))
        return out

    def collectives(mesh):
        from permon_tpu_torch.parallel.dist import (all_gather, all_reduce_sum, broadcast,
                                                    ppermute)

        me = torch.tensor([float(mesh.rank + 1)])
        out = dict(sum=all_reduce_sum(me, mesh), bcast=broadcast(me, mesh, src=1),
                   gather=all_gather(me, mesh),
                   recv=torch.cat(ppermute([me, 10 * me], [1, mesh.size - 1], mesh).wait()))
        for ax in mesh.axis_names if len(mesh.axis_names) == 2 else ():
            out[f"sum_{ax}"] = all_reduce_sum(me, mesh, ax)
            out[f"bcast_{ax}"] = broadcast(me, mesh, src=1, axis=ax)
        return out

    cases = dict(collectives=collectives, large_fn=large_fn, large_solver=large_solver,
                 large_contact=large_contact, large_layout=large_layout, dense_cg=dense_cg,
                 dense_smalbe=dense_smalbe, overlap=overlap, coarse=coarse)
    if world == 4:
        cases = dict(collectives=collectives,
                     large_contact_red=lambda mesh: large_contact(mesh, redundancy=True),
                     large_layout=large_layout, dense_cg=dense_cg, dense_smalbe=dense_smalbe,
                     overlap=overlap, coarse=coarse)
    return cases


def _rank_main(out_dir):
    """One rank: every case of the world, into ``out_dir/rank<r>.npz``."""
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    from permon_tpu_torch.parallel import make_mesh, make_mesh2

    world = int(os.environ["WORLD_SIZE"])
    mesh = make_mesh(device="cpu") if world == 2 else make_mesh2((2, 2), device="cpu")
    saved = dict(rank=mesh.rank, lo=mesh.subdomains(8)[0], backend=mesh.backend)
    for name, fn in _rank_cases(world).items():
        for key, val in fn(mesh).items():
            saved[f"{name}.{key}"] = np.asarray(val)
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **saved)
    assert "jax" not in sys.modules and "permon_tpu" not in sys.modules
    # leave together: a gloo group torn down at interpreter exit while a
    # peer is gone can abort the process
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


# ------------------------------------------------------------- parent side


def _start(world, out_dir):
    """Launch a world's ranks; they run while the parent computes its
    references."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
               PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={world}", os.path.abspath(__file__), str(out_dir)]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True), out_dir


def _collect(started, world):
    proc, out_dir = started
    try:
        out, err = proc.communicate(timeout=SPAWN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"world {world} ranks passed {SPAWN_TIMEOUT_S} s:\n{err[-8000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"world {world} ranks failed ({proc.returncode}):\n"
                             f"{out[-4000:]}\n{err[-8000:]}")
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(world)]


@pytest.fixture(scope="module", autouse=True)
def _launched(tmp_path_factory):
    """Both worlds start at once, before any reference is computed."""
    started = {w: _start(w, tmp_path_factory.mktemp(f"world{w}")) for w in (2, 4)}
    yield started
    for proc, _ in started.values():  # a test that failed early leaves none running
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def world2(_launched):
    return _collect(_launched[2], 2)


@pytest.fixture(scope="module")
def world4(_launched):
    return _collect(_launched[4], 4)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request):
    return request.getfixturevalue(f"world{request.param}")


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0][key]


def _slice(ranks_data, r, full, ns):
    n = full.shape[0] // ns
    per = ns // len(ranks_data)
    return full[r * per * n:(r + 1) * per * n]


# -- references (port single device, JAX mesh) --------------------------------


@pytest.fixture(scope="module")
def large_refs():
    from permon_tpu_torch.core.convergence import Tolerances
    from permon_tpu_torch.feti.large import FetiSolverSparse, assemble_qp_sparse, feti_solve_sparse
    from permon_tpu_torch.feti.solve import FetiOptions
    from permon_tpu_torch.problems import build_obstacle, build_sparse

    base = dict(gluing="nonred", deterministic=True, coarse="sparse")
    prob = build_sparse(*LARGE)
    lin = feti_solve_sparse(prob, FetiOptions(**base), tol=Tolerances(rtol=1e-6), device="cpu")
    oprob, BI, cI, _ = build_obstacle(*OBSTACLE)
    con = FetiSolverSparse(oprob, FetiOptions(**base), BI=BI, cI=cI,
                           device="cpu").solve(tol=Tolerances(rtol=1e-5))
    qp, kplus, _, _ = assemble_qp_sparse(prob, FetiOptions(gluing="nonred"), device="cpu")
    lam = torch.as_tensor(_lam(qp.BE.shape[0]))
    return dict(lin=lin, con=con, Flam=qp.BE.mv(kplus.mv(qp.BE.rmv(lam))).numpy(),
                Dinv=tuple(kplus.Dinv.shape), stencil=tuple(qp.A.data.shape))


@pytest.fixture(scope="module")
def jax_large():
    """The JAX package's large path on its 2-device mesh (the counts)."""
    import examples.feti_large as jfl
    from permon_tpu.core.convergence import Tolerances as JTol
    from permon_tpu.feti.large import feti_solve_sparse as jsolve
    from permon_tpu.feti.solve import FetiOptions as JOpts
    from permon_tpu.parallel import make_mesh as jmake_mesh

    r = jsolve(jfl.build_sparse(*LARGE), JOpts(gluing="nonred", deterministic=True,
                                                coarse="sparse", mesh=jmake_mesh(2)),
               tol=JTol(rtol=1e-6))
    return dict(its=int(r.result.iterations), x=np.asarray(r.x_global))


@pytest.fixture(scope="module")
def dense_refs():
    from permon_tpu_torch.core.convergence import Tolerances
    from permon_tpu_torch.feti.solve import FetiOptions, assemble_qp, feti_solve
    from permon_tpu_torch.problems import build_feti_contact, build_feti_ex1

    ex1 = build_feti_ex1(8, 5)
    lin = feti_solve(ex1, FetiOptions(), device="cpu")
    qp, _, _, _ = assemble_qp(ex1, FetiOptions(), device="cpu")
    prob, BI, cI, _ = build_feti_contact(8, 12)
    con = feti_solve(prob, FetiOptions(gluing="nonred", deterministic=True), BI=BI, cI=cI,
                     tol=Tolerances(rtol=1e-6), device="cpu")
    thr = feti_solve(ex1, FetiOptions(throughput=True), device="cpu")
    red = feti_solve(build_feti_ex1(8, 6), FetiOptions(), device="cpu")
    lam = torch.as_tensor(_lam(qp.BE.shape[0]))
    from permon_tpu_torch.feti.solve import make_blockdiag_kplus

    _, Kb, fixed, _ = assemble_qp(ex1, FetiOptions(), device="cpu")
    kplus = make_blockdiag_kplus(Kb, fixed, ex1)
    return dict(lin=lin, con=con, thr=thr, red=red,
                Flam=qp.BE.mv(kplus.mv(qp.BE.rmv(lam))).numpy())


@pytest.fixture(scope="module")
def jax_dense():
    """The JAX package on one device on the inputs of the dense, leaf and
    redundancy cases (dense_refs' solves)."""
    import examples.feti_contact as jcontact
    import examples.feti_ex1 as jex1
    from permon_tpu.core.convergence import Tolerances as JTol
    from permon_tpu.feti.solve import FetiOptions as JOpts, feti_solve as jsolve

    prob, BI, cI, _ = jcontact.build(8, 12)
    return dict(lin=jsolve(jex1.build(8, 5), JOpts()),
                con=jsolve(prob, JOpts(gluing="nonred", deterministic=True), BI=BI, cI=cI,
                           tol=JTol(rtol=1e-6)),
                thr=jsolve(jex1.build(8, 5), JOpts(throughput=True)),
                red=jsolve(jex1.build(8, 6), JOpts()))


def _counts(res):
    r = res.result
    return tuple(int(v) for v in (r.iterations, getattr(r, "inner_iterations", 0)))


@pytest.mark.parametrize("case", ["lin", "con", "thr", "red"])
def test_dense_references_match_jax(dense_refs, jax_dense, case):
    """The port's one-device runs that the ranks are held to: counts equal
    to the JAX package's on the same input, x_global within 1e-10."""
    got, ref = dense_refs[case], jax_dense[case]
    assert _counts(got) == _counts(ref)
    np.testing.assert_allclose(got.x_global, np.asarray(ref.x_global), rtol=0, atol=1e-10)


# -- the collectives -----------------------------------------------------------


def test_collectives(ranks):
    """all_reduce_sum, broadcast, all_gather and ppermute over the whole
    mesh and, on (2, 2), over each axis (rank r contributes r + 1)."""
    n = len(ranks)
    for r, data in enumerate(ranks):
        assert data["collectives.sum"].item() == n * (n + 1) / 2
        assert data["collectives.bcast"].item() == 2.0
        np.testing.assert_array_equal(data["collectives.gather"], np.arange(1, n + 1))
        # offset 1 receives from r - 1, offset n - 1 from r + 1
        np.testing.assert_array_equal(data["collectives.recv"],
                                      [(r - 1) % n + 1, 10 * ((r + 1) % n + 1)])
        if n == 4:  # rank r = 2 h + s on ('host', 'sd')
            h, sd = divmod(r, 2)
            assert data["collectives.sum_sd"].item() == (2 * h + 1) + (2 * h + 2)
            assert data["collectives.sum_host"].item() == (sd + 1) + (sd + 3)
            assert data["collectives.bcast_sd"].item() == 2 * h + 2
            assert data["collectives.bcast_host"].item() == 2 + sd + 1


# -- the large path -----------------------------------------------------------


def test_large_function_path(large_refs, jax_large, world2):
    its = int(_same_on_every_rank(world2, "large_fn.its"))
    assert its == large_refs["lin"].result.iterations == jax_large["its"]
    x = _same_on_every_rank(world2, "large_fn.x")
    np.testing.assert_allclose(x, large_refs["lin"].x_global, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(x, jax_large["x"], rtol=1e-6, atol=1e-7)


def test_large_solver_resolve(large_refs, world2):
    assert int(_same_on_every_rank(world2, "large_solver.its")) == \
        large_refs["lin"].result.iterations
    x = large_refs["lin"].x_global
    np.testing.assert_allclose(_same_on_every_rank(world2, "large_solver.x"), x, atol=1e-7)
    np.testing.assert_allclose(_same_on_every_rank(world2, "large_solver.x2"), 2.0 * x,
                               atol=1e-6)


@pytest.mark.parametrize("case", ["world2", "world4_redundancy"])
def test_large_contact(case, large_refs, world2, world4):
    ranks, key = (world2, "large_contact") if case == "world2" else (world4,
                                                                       "large_contact_red")
    ref = large_refs["con"].result
    assert int(_same_on_every_rank(ranks, f"{key}.its")) == ref.iterations
    if case == "world2":
        assert int(_same_on_every_rank(ranks, f"{key}.inner")) == ref.inner_iterations
    np.testing.assert_allclose(_same_on_every_rank(ranks, f"{key}.x"),
                               large_refs["con"].x_global, atol=1e-8 if case == "world2" else 1e-6)


def test_large_layout_and_bitwise_F(large_refs, ranks):
    """Each rank holds ns/world of Dinv / F and of the stencil; the
    all-reduced F is bitwise equal to the one-device F, from the placement
    of an assembled QP and from the mesh's own assembly."""
    nb, ns, NB, _ = large_refs["Dinv"]
    per = ns // len(ranks)
    for r in ranks:
        assert tuple(r["large_layout.Dinv"]) == tuple(r["large_layout.F"]) == (nb, per, NB, NB)
        assert tuple(r["large_layout.main_Dinv"]) == (nb, per, NB, NB)
        assert tuple(r["large_layout.stencil"]) == tuple(r["large_layout.main_stencil"]) == (
            per,) + large_refs["stencil"][1:]
        assert r["large_layout.eq"].all()
        np.testing.assert_array_equal(r["large_layout.Flam"], large_refs["Flam"])
        np.testing.assert_array_equal(r["large_layout.Flam_main"], large_refs["Flam"])


# -- the dense path -----------------------------------------------------------


def test_dense_shard_qp_cg_and_bitwise_F(dense_refs, jax_dense, ranks):
    ref = dense_refs["lin"]
    assert int(_same_on_every_rank(ranks, "dense_cg.its")) == ref.result.iterations == int(
        jax_dense["lin"].result.iterations)
    u = ref.u_decomposed.numpy()
    for r, data in enumerate(ranks):
        np.testing.assert_allclose(data["dense_cg.u"], _slice(ranks, r, u, 8), atol=1e-12)
        np.testing.assert_array_equal(data["dense_cg.Flam"], dense_refs["Flam"])
        if "dense_cg.Flam_hier" in data:  # the (2, 2) mesh: 'sd' then 'host'
            np.testing.assert_array_equal(data["dense_cg.Flam_hier"], dense_refs["Flam"])


def test_dense_smalbe(dense_refs, jax_dense, ranks):
    ref = dense_refs["con"]
    assert (int(_same_on_every_rank(ranks, "dense_smalbe.its")),
            int(_same_on_every_rank(ranks, "dense_smalbe.inner"))) == _counts(ref) == _counts(
        jax_dense["con"])
    u = ref.u_decomposed.numpy()
    for r, data in enumerate(ranks):
        np.testing.assert_allclose(data["dense_smalbe.u"], _slice(ranks, r, u, 8), atol=1e-10)


# -- overlap ------------------------------------------------------------------


@pytest.mark.parametrize("ns", [8, 16])
def test_overlapped_leaf_apply_matches_flat(ranks, ns):
    per = ns // len(ranks)
    for r, data in enumerate(ranks):
        flat = data[f"overlap.flat{ns}"]
        np.testing.assert_allclose(data[f"overlap.local{ns}"], flat[r * per:(r + 1) * per],
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(data[f"overlap.full{ns}"], flat, rtol=1e-12, atol=1e-12)


def test_overlap_plan_equals_jax(ranks):
    """The vectorized plan is array-equal to the JAX package's loop."""
    from examples.feti_ex1 import build
    from permon_tpu.feti import FetiOptions as JOpts
    from permon_tpu.feti.leaf import LeafDualOperator as JLeaf
    from permon_tpu.feti.solve import assemble_qp as jassemble, make_blockdiag_kplus as jkplus
    from permon_tpu.parallel import LeafOverlapPlan as JPlan

    data = ranks[0]
    for ns in (8, 16):
        prob = build(ns=ns, ne=5)
        qp, Kb, fixed, _ = jassemble(prob, JOpts())
        jp = JPlan.build(JLeaf.create(qp.BE, jkplus(Kb, fixed, prob)).space, len(ranks))
        for f in ("perm", "partners_local"):
            np.testing.assert_array_equal(data[f"overlap.plan{ns}_{f}"], np.asarray(getattr(jp, f)))
        assert int(data[f"overlap.plan{ns}_nb"]) == jp.nb
        assert tuple(data[f"overlap.plan{ns}_offsets"]) == jp.offsets
        for i in range(len(jp.offsets)):
            np.testing.assert_array_equal(data[f"overlap.plan{ns}_send{i}"],
                                          np.asarray(jp.send_idx[i]))
            np.testing.assert_array_equal(data[f"overlap.plan{ns}_recv{i}"],
                                          np.asarray(jp.recv_partner[i]))


def test_overlapped_leaf_cg_and_feti_solve(dense_refs, jax_dense, ranks):
    for data in ranks:
        np.testing.assert_allclose(data["overlap.cg_ovl"], data["overlap.cg_flat"],
                                   rtol=1e-10, atol=1e-10)
    ref = dense_refs["thr"]
    assert int(_same_on_every_rank(ranks, "overlap.feti_reason")) > 0
    assert int(_same_on_every_rank(ranks, "overlap.feti_its")) == ref.result.iterations == int(
        jax_dense["thr"].result.iterations)
    np.testing.assert_allclose(_same_on_every_rank(ranks, "overlap.feti_x"), ref.x_global,
                               atol=1e-10)


# -- redundancy-group coarse solve --------------------------------------------


@pytest.mark.parametrize("kc", KCS)
def test_redundant_coarse_matches_cho_solve(ranks, kc):
    S = _spd(kc)
    v = np.random.default_rng(1).standard_normal(kc)
    got = _same_on_every_rank(ranks, f"coarse.mv{kc}")
    np.testing.assert_allclose(got, np.linalg.solve(S, v), rtol=1e-10, atol=1e-10)
    nsd = 2  # the 'sd' axis of both meshes
    kb = -(-kc // nsd)
    for data in ranks:  # a block row per rank of the group, kc/nsd rows
        assert tuple(data[f"coarse.L{kc}"]) == (kb, nsd * kb)


def test_redundant_projector(ranks):
    for data in ranks:
        for op in ("p", "q"):
            np.testing.assert_allclose(data[f"coarse.{op}_red"], data[f"coarse.{op}_rep"],
                                       rtol=1e-12, atol=1e-12)


def test_feti_solve_with_redundancy(dense_refs, jax_dense, world4):
    ref = dense_refs["red"]
    assert int(_same_on_every_rank(world4, "coarse.feti_cp")) == 1
    assert int(_same_on_every_rank(world4, "coarse.feti_its")) == ref.result.iterations == int(
        jax_dense["red"].result.iterations)
    np.testing.assert_allclose(_same_on_every_rank(world4, "coarse.feti_x"), ref.x_global,
                               atol=1e-10)


def test_interop_redundant_projector():
    """A JAX Projector with a redundancy-group factor ports onto a port
    mesh (here the one-process mesh, no process group): P and Q as the
    replicated formulas give them; without a mesh it raises."""
    import jax.numpy as jnp

    from permon_tpu.core.linop import Dense as JDense
    from permon_tpu.parallel import make_mesh2 as jmake_mesh2, redundant_projector as jred
    from permon_tpu_torch.interop import from_arrays
    from permon_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(2)
    Gd = rng.standard_normal((5, 40))
    jpf = jred(JDense.create(jnp.asarray(Gd)), Gd @ Gd.T, jmake_mesh2((2, 4)))
    with pytest.raises(ValueError, match="mesh="):
        from_arrays(jpf, "cpu")
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.backend) == (1, "none")
    pf = from_arrays(jpf, "cpu", mesh=mesh)
    x = rng.standard_normal(40)
    q = Gd.T @ np.linalg.solve(Gd @ Gd.T, Gd @ x)
    np.testing.assert_allclose(pf.apply_q(torch.as_tensor(x)).numpy(), q, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(pf.apply_p(torch.as_tensor(x)).numpy(), x - q, rtol=1e-12,
                               atol=1e-12)


if __name__ == "__main__":
    _rank_main(sys.argv[1])
