"""The system under test for the large-path 3-D elasticity configurations:
``permon_tpu_torch.feti.large.FetiSolverSparse`` on
``problems.build_sparse_elasticity`` (three dofs a node, the rigid-body
nullspace), built once from the configuration's ``problem`` and ``recipe``
and then driven one load step at a time through
``FetiSolverSparse.solve(b_loc=...)``, as ``feti_large`` drives the Poisson
configurations. Everything but the constructor is ``feti_large``'s: the
load is split over the subdomain copies by multiplicity, dof by dof.

One probe more: ``projector_apply``, one P apply of the coarse projector.
"""

from __future__ import annotations

import time

import numpy as np

from h100bench.harness import HERE, load_module

base = load_module(HERE / "systems" / "feti_large.py")


class System(base.System):
    """One FetiSolverSparse of an elastic box on ``device``; ``overrides``
    replace entries of the recipe (a control's lower precision)."""

    def __init__(self, config: dict, device, overrides: dict | None = None):
        import torch

        from permon_tpu_torch.core.convergence import Tolerances
        from permon_tpu_torch.core.sell import gather_apply
        from permon_tpu_torch.feti.large import FetiSolverSparse
        from permon_tpu_torch.feti.solve import FetiOptions
        from permon_tpu_torch.problems import build_sparse_elasticity

        problem, recipe = config["problem"], {**config["recipe"], **(overrides or {})}
        self.device = torch.device(device)
        self._counter = gather_apply
        self.spans: dict = {}
        t0 = time.perf_counter()
        prob = build_sparse_elasticity(tuple(problem["cells"]), tuple(problem["grid"]),
                                       lam=float(problem["lam"]), mu=float(problem["mu"]))
        self.spans["problem_build_s"] = time.perf_counter() - t0
        self.solver = FetiSolverSparse(
            prob, FetiOptions(**recipe["options"]), kplus_dtype=base._dtype(recipe["kplus_dtype"]),
            kplus_refine=int(recipe["kplus_refine"]),
            op_dtype=base._dtype(recipe.get("op_dtype")),
            primal_refine=int(recipe["primal_refine"]), device=self.device)
        self.timings = dict(self.solver.timings)
        self.tol = Tolerances(rtol=float(recipe["rtol"]))
        flat = prob.l2g.reshape(-1)
        self._real = np.flatnonzero(flat >= 0)
        self._gid = flat[self._real]
        self._share = 1.0 / np.bincount(self._gid, minlength=prob.n_global)[self._gid]
        self._shape = prob.l2g.shape
        self.n_global = prob.n_global

    def projector_apply(self):
        """One apply of the coarse projector P = I - G'(GG')^-1 G on a dual
        vector, as the dual CG applies it each turn (the projector of the
        solves so far)."""
        import torch

        pf = self.solver._pf
        lam = torch.ones(pf.G.shape[1], dtype=torch.float64, device=self.device)
        return lambda: pf.apply_p(lam)
