"""Soft-margin SVM training as a PERMON-style dual QP, the port of
``examples/svm.py``.

PERMON is the QP backend of PermonSVM (reference: README.md:3-12); the
C-SVM dual problem is the equality+box QP shape SMALXE/MPRGP target:

    min  1/2 a' Q a - 1'a     Q = (y y') .* (X X')   (linear kernel Gram)
    s.t. y'a = 0              (single equality row — OneRow operator)
         0 <= a <= C          (box)

The default-solver rule picks SMALXE (equality present, qps.c:422-455) with
MPRGP inner solves on the penalized subproblems.  Q a is computed as
y .* (X (X'(y .* a))) without materializing Q (a lazy Product of dense
operators on the device).

    python -m permon_tpu_torch.examples.svm [n_samples] [C] [--device cpu]
"""

from __future__ import annotations

import numpy as np

from ..problems import make_blobs


def train(X, y, C=1.0, rtol=1e-6, device=None):
    """Solve the C-SVM dual via permon_tpu_torch.svm; returns (w, b, alpha, result)."""
    from ..svm import SVC

    clf = SVC(C=C, rtol=rtol, device=device).fit(X, y)
    return clf.coef_, clf.intercept_, clf.alpha_, clf.result_


def main(n=200, C=1.0, device=None):
    X, y = make_blobs(n)
    w, b, alpha, res = train(X, y, C, device=device)
    pred = np.sign(X @ w + b)
    acc = float(np.mean(pred == y))
    nsv = int(np.sum(alpha > 1e-6 * C))
    print(
        f"svm: n={n} C={C} outer_its={int(res.iterations)} "
        f"inner_its={int(res.inner_iterations)} reason={int(res.reason)} "
        f"support_vectors={nsv} train_accuracy={acc:.3f}"
    )
    return acc


if __name__ == "__main__":
    from . import split_device

    device, args = split_device()
    n = int(args[0]) if args else 200
    C = float(args[1]) if len(args) > 1 else 1.0
    main(n, C, device=device)
