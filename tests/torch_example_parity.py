"""The check that holds each of the port's command-line examples
(``permon_tpu_torch/examples/``) against the JAX package's ``examples/`` on
the CPU: the example's ``main`` called in-process with the same keyword
arguments in both packages (the port's with ``device="cpu"``), at the JAX
example's own small size or smaller.

Held per example:

- every line either package prints, with the floating-point numbers
  masked: the convergence lines (reason, iteration and step counts, the
  SMALXE hit / update counters, the closing lines of feti_ex1, feti_contact
  and svm) character for character, the KKT lines by their labels;
- the solution against the JAX package's, to the tolerance of the parity
  test of the same path: ex1, ex2, jbearing2 x to 1e-10
  (tests/test_torch_mprgp.py), ex3 the primal x to 1e-10
  (tests/test_torch_factor.py), feti_ex1 x_global to 1e-12
  (tests/test_torch_feti_dense.py), feti_contact x_global to 1e-9 (the
  same file's contact test), feti_ex71 at rtol 1e-10 x_global to 1e-9 of
  max |x| (its ex71 test), feti_large with f64 factors at rtol 1e-9
  x_global to 1e-10 (tests/test_torch_feti_large.py), svm the training
  accuracy equal (its support-vector count and counts are in the line);
- feti_large's default recipe as well (f32 factors, 2 refinement steps,
  one f64 defect pass, rtol 1e-5): its printed count equal at 6^3, x_global
  to 1e-9 and the assembled residuals within a factor of 2 of each other;
  the f64 case's residuals are held so too.  Past 6^3 the defect pass's
  count follows the last bits of the first pass in either package (see
  ``defect_pass_counts.py``), so it is not held there.

Each case runs in the test file of its path (``test_example_matches_jax_example``
there), so that the JAX package's programs it compiles are compiled once
per worker with the other cases of that path.
"""

import contextlib
import importlib
import io
import re

import numpy as np

_FLOAT = re.compile(r"[-+]?\d+\.\d+(e[-+]\d+)?")


def captured(fn):
    """fn()'s return value and what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = fn()
    return ret, out.getvalue()


def _masked(text):
    return [_FLOAT.sub("#", line) for line in text.splitlines()]


def _x(ret):
    return np.asarray(ret[1].x)


CASES = {
    # case: (keyword arguments of both mains, solution of a main's return, its tolerance);
    # the example is the case's name up to its first "-"
    "ex1": (dict(n=100), _x, 1e-10),
    "ex2": (dict(n=100), _x, 1e-10),
    "ex3": (dict(n=100), lambda r: np.asarray(r[3].x), 1e-10),
    "jbearing2": (dict(nx=8, ny=12), _x, 1e-10),
    "feti_ex1": (dict(ns=4, ne=7), lambda r: np.asarray(r[1].x_global), 1e-12),
    "feti_contact": (dict(ns=4, ne=25), lambda r: np.asarray(r[0]), 1e-9),
    "feti_ex71": (dict(cells=(3, 4, 5), grid=(1, 2, 2), rtol=1e-10),
                  lambda r: np.asarray(r[1].x_global), lambda x: 1e-9 * np.abs(x).max()),
    "feti_large": (dict(ncells=6, g=2, f32=False, rtol=1e-9),
                   lambda r: np.asarray(r[0].x_global), 1e-10),
    "feti_large-f32": (dict(ncells=6, g=2), lambda r: np.asarray(r[0].x_global), 1e-9),
    "svm": (dict(n=60), lambda r: r, 0.0),
}


def check_example(name):
    """Run case ``name`` of CASES through both packages' mains and hold
    the port's to the JAX package's."""
    kw, solution, tol = CASES[name]
    example = name.split("-")[0]
    jm = importlib.import_module(f"examples.{example}")
    tm = importlib.import_module(f"permon_tpu_torch.examples.{example}")
    jret, jout = captured(lambda: jm.main(**kw))
    tret, tout = captured(lambda: tm.main(**kw, device="cpu"))
    jlines, tlines = _masked(jout), _masked(tout)
    assert tlines == jlines, "\n".join(["--- port:"] + tlines + ["--- JAX:"] + jlines)
    assert len(tlines) >= 1
    xj, xt = solution(jret), solution(tret)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=tol(xj) if callable(tol) else tol)
    if name.startswith("feti_large"):  # the assembled residuals ||Ax-b||/||b||
        assert 0.5 <= tret[1] / jret[1] <= 2.0, (tret[1], jret[1])
