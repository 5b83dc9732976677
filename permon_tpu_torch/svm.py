"""Support-vector machine training on the QP stack — the port of
:mod:`permon_tpu.svm`, the PermonSVM analog.

PERMON is the QP backend of PermonSVM (reference: README.md:3-12); the
C-SVM dual problem is the equality + box QP that SMALXE / MPRGP solve:

    min  1/2 a' Q a - 1'a     Q = (y y') .* K(X, X)
    s.t. y'a = 0              (one equality row: OneRow)
         0 <= a <= C          (box)

The default-solver rule picks SMALXE (an equality is present,
qps.c:422-455) with MPRGP inner solves on the penalized subproblems.  For
the linear kernel the Gram product is applied lazily as
y .* (X (X'(y .* a))) (a 4-factor Product, never materialized: two
tall-skinny GEMVs per product); 'rbf' and 'poly' build the dense (n, n)
Gram matrix once, on the device.  The bias and ``decision_function`` run
on the host, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from . import resolve_device
from .core.convergence import Tolerances
from .core.linop import Dense, Diagonal, OneRow, Product, Transpose
from .qp.qp import QP
from .qpc.box import BoxConstraint
from .solvers.driver import solve


def _kernel_matrix(kernel: str, X: torch.Tensor, Z: torch.Tensor, gamma: float, degree: int,
                   coef0: float) -> torch.Tensor:
    """K(X, Z) on the device of X (full-precision products)."""
    G = X @ Z.T
    if kernel == "linear":
        return G
    if kernel == "rbf":
        x2 = torch.sum(X * X, dim=1)[:, None]
        z2 = torch.sum(Z * Z, dim=1)[None, :]
        return torch.exp(-gamma * (x2 - 2.0 * G + z2))
    if kernel == "poly":
        return (gamma * G + coef0) ** degree
    raise ValueError(f"unknown kernel {kernel!r}")


def svm_dual_qp(X, y, C: float = 1.0, kernel: str = "linear", gamma: Optional[float] = None,
                degree: int = 3, coef0: float = 0.0, device=None) -> QP:
    """Assemble the C-SVM dual QP on ``device`` (None: the card); the Gram
    operator is lazy for 'linear'."""
    dev = resolve_device(device)
    Xt = torch.as_tensor(np.asarray(X, dtype=np.float64), device=dev)
    yt = torch.as_tensor(np.asarray(y, dtype=np.float64), device=dev)
    n, dim = Xt.shape
    gamma = 1.0 / dim if gamma is None else gamma
    Dy = Diagonal.create(yt)
    if kernel == "linear":
        Xop = Dense.create(Xt)
        Q = Product((Dy, Xop, Transpose(Xop), Dy))
    else:
        Q = Product((Dy, Dense.create(_kernel_matrix(kernel, Xt, Xt, gamma, degree, coef0)),
                     Dy))
    ones = torch.ones(n, dtype=Xt.dtype, device=dev)
    return QP(A=Q, b=ones, BE=OneRow(v=yt), cE=torch.zeros(1, dtype=Xt.dtype, device=dev),
              box=BoxConstraint.create(n, lb=torch.zeros_like(ones), ub=C * ones, device=dev))


@dataclasses.dataclass
class SVC:
    """C-SVM classifier trained by SMALXE / MPRGP on the dual QP, on
    ``device`` (None: the card).  Parameters follow the sklearn surface;
    ``kernel`` in {'linear', 'rbf', 'poly'}.  After ``fit``: ``alpha_``,
    ``support_``, ``intercept_``, ``coef_`` (linear only), ``result_`` (the
    solver's result)."""

    C: float = 1.0
    kernel: str = "linear"
    gamma: Optional[float] = None
    degree: int = 3
    coef0: float = 0.0
    rtol: float = 1e-6
    device: Any = None

    def fit(self, X, y) -> "SVC":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if not set(np.unique(y)) <= {-1.0, 1.0}:
            raise ValueError("labels must be +-1")
        qp = svm_dual_qp(X, y, self.C, self.kernel, self.gamma, self.degree, self.coef0,
                         device=self.device)
        res = solve(qp, tol=Tolerances(rtol=self.rtol))
        alpha = res.x.cpu().numpy()
        self.result_ = res
        self.alpha_ = alpha
        self.X_, self.y_ = X, y
        self.support_ = np.flatnonzero(alpha > 1e-6 * self.C)
        self._gamma = 1.0 / X.shape[1] if self.gamma is None else self.gamma
        if self.kernel == "linear":
            self.coef_ = (alpha * y) @ X
        # the bias from the support vectors on the margin (0 < a < C), where
        # the decision function equals y
        on_margin = (alpha > 1e-6 * self.C) & (alpha < (1 - 1e-6) * self.C)
        if not on_margin.any():
            on_margin = alpha > 1e-6 * self.C
        f_no_b = self._decision_no_bias(X[on_margin])
        self.intercept_ = float(np.mean(y[on_margin] - f_no_b))
        return self

    def _decision_no_bias(self, Z):
        Z = np.asarray(Z, dtype=np.float64)
        if self.kernel == "linear":
            return Z @ self.coef_
        Km = _kernel_matrix(self.kernel, torch.as_tensor(Z), torch.as_tensor(self.X_),
                            self._gamma, self.degree, self.coef0)
        return (Km @ torch.as_tensor(self.alpha_ * self.y_)).numpy()

    def decision_function(self, Z):
        return self._decision_no_bias(Z) + self.intercept_

    def predict(self, Z):
        return np.sign(self.decision_function(Z))

    def score(self, Z, y) -> float:
        return float(np.mean(self.predict(Z) == np.asarray(y)))
