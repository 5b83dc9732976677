"""Plain reference of the 3-D elasticity box configurations, in PyTorch on
the CPU, float64.

It builds, from the configuration file alone, the clamped operator of 3-D
isotropic linear elasticity on a box of ``cells`` unit Q1 elements, the
operator of PERMON's ``src/tutorials/feti/ex71.c -pde_type Elasticity``:

- the element stiffness K_e = sum over the 2 x 2 x 2 Gauss points of
  w B' D B on the unit cube (weight 1/8 a point), B the strain-displacement
  matrix of the trilinear shape functions in engineering strain order
  (e_xx, e_yy, e_zz, g_xy, g_yz, g_xz), D the isotropic law of Lame's
  ``lam`` and ``mu`` (lam + 2 mu on the normal diagonal, lam off it, mu on
  the shears); corners numbered x fastest, a node's three components
  interleaved (dof = 3 * node + c), nodes of the box x fastest;
- the x = 0 face clamped in all three components: its rows and columns are
  zeroed and given a unit diagonal, so there the answer equals the load.

It applies the operator element by element, in blocks of elements: the
element dofs' values gathered (E, 24), times K_e, added back with
``index_add_``; the ~95 million nonzeros of the assembled matrix are never
formed.  It judges an answer x of the load f by the relative residual
||A x - f|| / ||f||.

Departures from ex71: ex71 computes its element matrix once with lam = mu
= 1 and stores it as a table (ex71.c:26-99); here it is computed from the
configuration's ``lam`` and ``mu`` (equal to the table at 1, 1).  ex71
clamps its Dirichlet face by rows of the gluing or by elimination in each
subdomain; here the assembled operator is clamped once.  ex71's unit load
is replaced by the traffic's loads.

Nothing here imports the program under test.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DOF = 3
#: elements per block of the apply
BLOCK = 1 << 15
#: (row, displacement component, derivative direction) of each strain
STRAINS = [(0, 0, 0), (1, 1, 1), (2, 2, 2), (3, 0, 1), (3, 1, 0), (4, 1, 2), (4, 2, 1),
           (5, 0, 2), (5, 2, 0)]


def element_matrix(lam: float, mu: float) -> torch.Tensor:
    """(24, 24) stiffness of one unit Q1 element, float64."""
    f64 = torch.float64
    corners = torch.tensor([(a & 1, (a >> 1) & 1, (a >> 2) & 1) for a in range(8)], dtype=f64)
    D = torch.zeros(6, 6, dtype=f64)
    D[:3, :3] = lam
    D[range(3), range(3)] = lam + 2.0 * mu
    D[range(3, 6), range(3, 6)] = mu
    g = (0.5 - 0.5 / np.sqrt(3.0), 0.5 + 0.5 / np.sqrt(3.0))
    K = torch.zeros(24, 24, dtype=f64)
    for q in itertools.product(g, repeat=3):
        x = torch.tensor(q, dtype=f64)
        val = torch.where(corners == 1, x, 1.0 - x)  # (8, 3): each factor of N_a
        der = torch.where(corners == 1, 1.0, -1.0).to(f64)
        dN = torch.stack([der[:, d] * val[:, [e for e in range(3) if e != d]].prod(dim=1)
                          for d in range(3)], dim=1)  # (8, 3): dN_a / dx_d
        B = torch.zeros(6, 24, dtype=f64)
        for row, comp, direction in STRAINS:
            B[row, comp::DOF] = dN[:, direction]
        K += 0.125 * B.T @ D @ B
    return K


class ClampedOperator:
    """The clamped elasticity operator of a box of ``cells`` elements."""

    def __init__(self, cells, lam: float, mu: float):
        Mx, My, Mz = (int(c) + 1 for c in cells)
        self.n = DOF * Mx * My * Mz
        self.Ke = element_matrix(lam, mu)
        i, j, k = torch.meshgrid(torch.arange(Mx - 1), torch.arange(My - 1),
                                 torch.arange(Mz - 1), indexing="ij")
        origin = ((k * My + j) * Mx + i).reshape(-1)
        a = torch.arange(8)
        corner = origin[:, None] + ((a >> 2) * My + ((a >> 1) & 1)) * Mx + (a & 1)
        self.edofs = (DOF * corner[:, :, None] + torch.arange(DOF)).reshape(-1, 8 * DOF)
        node = torch.arange(Mx * My * Mz)
        self.clamped = ((node % Mx) == 0).repeat_interleave(DOF)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        free = torch.where(self.clamped, 0.0, x)
        y = torch.zeros_like(x)
        for e0 in range(0, self.edofs.shape[0], BLOCK):
            idx = self.edofs[e0:e0 + BLOCK]
            y.index_add_(0, idx.reshape(-1), (free[idx] @ self.Ke).reshape(-1))
        return torch.where(self.clamped, x, y)


class Reference:
    """The reference of one configuration: ``check(f, x)`` gives the numbers
    that are compared."""

    def __init__(self, config: dict):
        p = config["problem"]
        self.A = ClampedOperator(p["cells"], float(p.get("lam", 1.0)), float(p.get("mu", 1.0)))

    def check(self, f: np.ndarray, x: np.ndarray) -> dict:
        x = torch.as_tensor(np.asarray(x, dtype=np.float64))
        f = torch.as_tensor(np.asarray(f, dtype=np.float64))
        if x.shape != f.shape or x.shape != (self.A.n,) or not torch.isfinite(x).all():
            return {"residual": float("inf")}
        r = self.A.apply(x) - f
        return {"residual": float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(f))}
