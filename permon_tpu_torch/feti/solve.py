"""TFETI options and results — the port of ``FetiOptions``, ``FetiResult``
and ``assemble_global_mean`` from :mod:`permon_tpu.feti.solve`.

``FetiOptions`` keeps the JAX package's field names and defaults, so one
options object reads the same in both packages.  The large-path slice
takes ``gluing`` ('nonred' | 'full'), ``scale``, ``coarse``,
``deterministic`` and ``gather_kernel``; every other field must keep its
default, or the solve raises ``NotImplementedError`` (see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass
class FetiOptions:
    gluing: str = "full"  # QPFetiSetUp default (qpfeti.c:322)
    scale: bool = True  # 1/sqrt(multiplicity) scaling (-SCALE_ON default)
    dirichlet_by_B: bool = True  # enforce Dirichlet by constraint rows (TFETI)
    project: bool = True  # projector pipeline vs SMALXE (-project)
    pc_dual: str = "none"  # 'none' | 'lumped'
    orth_G: Optional[str] = None
    #: nullspace source: 'constant' (Poisson), 'numeric', 'rbm' (elasticity)
    nullspace: str = "constant"
    throughput: bool = False
    #: precision policy; only 'f64' is ported
    precision: str = "f64"
    ragged_kplus: bool = False
    #: device mesh of the JAX package; multi-device is not ported
    mesh: Optional[Any] = None
    #: dual coarse-side build: 'auto' | 'dense' | 'sparse'
    coarse: str = "auto"
    rho_mode: str = "auto"
    #: pin every solver reduction to a fixed binary tree (core/detred.py);
    #: None inherits the process-global mode
    deterministic: Optional[bool] = None
    qppf_redundancy: bool = False
    #: B/B' gather tables: None or True run the CUDA gather kernel on a
    #: CUDA device (for every table size — the JAX package's 2^19-slot
    #: threshold priced the TPU's SELL schedule, which the port does not
    #: have); False selects the plain PyTorch version
    gather_kernel: Optional[bool] = None
    #: SMALXE options of the contact path (not ported; kept for the field
    #: set of the JAX package)
    smalxe: Optional[Any] = None


@dataclasses.dataclass
class FetiResult:
    x_global: np.ndarray
    u_decomposed: Any
    solution: Any
    result: Any  # inner solver result (CGResult)
    qp: Any  # the decomposed primal QP
    dual_qp: Any
    #: every dual CG result of the solve, in order (the main solve, then one
    #: per primal defect-correction pass); ``result`` is the last of them
    results: Optional[list] = None


def assemble_global_mean(u: np.ndarray, l2g: np.ndarray, n_global: int) -> np.ndarray:
    """Average the decomposed solution's dof copies into the global vector
    (qptransform.c:1905-1981) — one flat bincount."""
    flat = l2g.reshape(-1)
    real = flat >= 0
    ids = flat[real]
    x_global = np.bincount(ids, weights=u.reshape(-1)[real], minlength=n_global)
    counts = np.bincount(ids, minlength=n_global)
    return x_global / np.maximum(counts, 1)
