"""The system under test for the large-path linear TFETI configurations:
``permon_tpu_torch.feti.large.FetiSolverSparse``, built once from the
configuration's ``problem`` and ``recipe`` and then driven one load step at
a time through ``FetiSolverSparse.solve(b_loc=...)``, the entry that the
measured window drives.

The benchmark makes the global load; ``to_input`` splits it over the
subdomain copies by multiplicity (each copy carries 1/multiplicity of its
node's load), the program's right-hand-side layout.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

DTYPES = ("bfloat16", "float32", "float64")


@dataclass
class Answer:
    x: np.ndarray
    ok: bool
    counts: dict = field(default_factory=dict)


def _dtype(name):
    import torch

    if name is None:
        return None
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r}")
    return getattr(torch, name)


class System:
    """One FetiSolverSparse on ``device``; ``overrides`` replace entries of
    the recipe (a control's lower precision)."""

    def __init__(self, config: dict, device, overrides: dict | None = None):
        import torch

        from permon_tpu_torch.core.convergence import Tolerances
        from permon_tpu_torch.core.sell import gather_apply
        from permon_tpu_torch.feti.large import FetiSolverSparse
        from permon_tpu_torch.feti.solve import FetiOptions
        from permon_tpu_torch.problems import build_sparse

        problem, recipe = config["problem"], {**config["recipe"], **(overrides or {})}
        self.device = torch.device(device)
        self._counter = gather_apply
        self.spans: dict = {}
        t0 = time.perf_counter()
        cells, grid = tuple(problem["cells"]), tuple(problem["grid"])
        prob = build_sparse(cells, grid)
        self.spans["problem_build_s"] = time.perf_counter() - t0
        opts = FetiOptions(**recipe["options"])
        self.solver = FetiSolverSparse(
            prob, opts, kplus_dtype=_dtype(recipe["kplus_dtype"]),
            kplus_refine=int(recipe["kplus_refine"]), op_dtype=_dtype(recipe.get("op_dtype")),
            primal_refine=int(recipe["primal_refine"]), device=self.device)
        self.timings = dict(self.solver.timings)
        self.tol = Tolerances(rtol=float(recipe["rtol"]))
        flat = prob.l2g.reshape(-1)
        self._real = np.flatnonzero(flat >= 0)
        self._gid = flat[self._real]
        self._share = 1.0 / np.bincount(self._gid, minlength=prob.n_global)[self._gid]
        self._shape = prob.l2g.shape
        self.n_global = prob.n_global

    def to_input(self, f: np.ndarray) -> np.ndarray:
        b = np.zeros(self._shape[0] * self._shape[1])
        b[self._real] = f[self._gid] * self._share
        return b.reshape(self._shape)

    def solve(self, b_loc: np.ndarray) -> Answer:
        n0 = self._counter.launches
        r = self.solver.solve(b_loc=b_loc, tol=self.tol)
        counts = {"gather_launches": self._counter.launches - n0,
                  "dual_its": int(sum(c.iterations for c in r.results))}
        ok = all(c.reason == 2 for c in r.results)
        return Answer(x=r.x_global, ok=bool(ok), counts=counts)

    def build_seconds(self) -> float:
        """Seconds that nvcc took in this process to build the port's
        kernels (0 where the checkout had them built already)."""
        from permon_tpu_torch.core.sell import BUILD_INFO

        return max((b["seconds"] for b in BUILD_INFO.values()), default=0.0)

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- probes the per-layer metrics time after the window ----------------

    def kplus_apply(self):
        """One apply of the K+ that each F apply runs (unrefined), on a
        vector of the decomposed space."""
        import torch

        kp = self.solver.kplus
        v = torch.ones(self.solver.qp.BE.ns * self.solver.qp.BE.nl, dtype=torch.float64,
                       device=self.device)
        return lambda: kp.mv(v)

    def gather_applies(self):
        """B' and B of the gluing rows, as one F apply runs them."""
        import torch

        BE = self.solver.qp.BE
        lam = torch.ones(BE.shape[0], dtype=torch.float64, device=self.device)
        u = BE.rmv(lam)

        def run():
            BE.rmv(lam)
            BE.mv(u)
        return run

    def close(self):
        self.solver = None
