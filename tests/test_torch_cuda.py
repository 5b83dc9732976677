"""permon_tpu_torch on the card: the CUDA gather kernel against its plain
PyTorch version, and a small solve through the kernel against the same
solve through the plain version.  This file imports no JAX (the machine
with the card has none); every test is marked ``cuda`` and skips without
a card.  Run there with:  python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from permon_tpu_torch.core.convergence import Tolerances
from permon_tpu_torch.core.extension import SubdomainExtension
from permon_tpu_torch.core.sell import gather_apply, gather_apply_plain
from permon_tpu_torch.feti.assembly import build_gluing
from permon_tpu_torch.feti.large import FetiSolverSparse, feti_solve_sparse
from permon_tpu_torch.feti.solve import FetiOptions
from permon_tpu_torch.problems import build_sparse

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gather kernel has no CPU mode")
    return torch.device("cuda")


def _gluing_ext(device, cells=(10, 10, 10), grid=(2, 2, 2)):
    prob = build_sparse(cells, grid)
    r, c, v, m = build_gluing(prob.l2g, "nonred", True)
    return SubdomainExtension.from_coo(r, c, v, m=m, ns=prob.ns,
                                       nl=prob.nl).with_gather_apply(device)


def _plain(tab, x):
    out = gather_apply_plain(tab.idx, tab.vals, x)
    if tab.ov_tgt is not None:
        gather_apply_plain(tab.ov_idx, tab.ov_vals, x, out=out, tgt=tab.ov_tgt)
    return out


@pytest.mark.parametrize("vdt", [torch.float64, torch.float32])
@pytest.mark.parametrize("xdt", [torch.float64, torch.float32])
def test_kernel_equals_plain_bitwise(cuda_device, vdt, xdt):
    B = _gluing_ext(cuda_device)
    assert B.gBt.ov_tgt is not None  # overflow planes exercised
    rng = np.random.RandomState(0)
    for tab, n in ((B.gB, B.ns * B.nl), (B.gBt, B.m_dual)):
        tab = tab.replace(vals=tab.vals.to(vdt), ov_vals=None if tab.ov_vals is None
                          else tab.ov_vals.to(vdt))
        x = torch.as_tensor(rng.standard_normal(n), dtype=xdt, device=cuda_device)
        n0 = gather_apply.launches
        got = tab.apply(x)
        assert gather_apply.launches == n0 + (2 if tab.ov_tgt is not None else 1)
        ref = _plain(tab, x)
        torch.cuda.synchronize()
        assert got.dtype == torch.promote_types(vdt, xdt)
        assert torch.equal(got, ref)


def test_wrapper_raises_on_noncontiguous(cuda_device):
    idx = torch.zeros((4, 2), dtype=torch.int32, device=cuda_device).T
    vals = torch.ones((2, 4), dtype=torch.float64, device=cuda_device)
    x = torch.ones(3, dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError):
        gather_apply(idx, vals, x)


def test_kernel_solve_equals_plain_solve(cuda_device):
    """gather_kernel=None (the kernel) and False (the plain version) give
    the same deterministic solve bit for bit."""
    prob = build_sparse((12,) * 3, (2,) * 3)
    tol = Tolerances(rtol=1e-6)
    runs = []
    for gk in (None, False):
        gather_apply.launches = 0
        res = feti_solve_sparse(prob, FetiOptions(gluing="nonred", deterministic=True,
                                                  gather_kernel=gk),
                                tol=tol, device=cuda_device)
        runs.append((res, gather_apply.launches))
    (rk, nk), (rp, np_) = runs
    assert nk > 0 and np_ == 0
    assert rk.result.iterations == rp.result.iterations
    np.testing.assert_array_equal(rk.x_global, rp.x_global)


def test_fast_path_reuse_on_card(cuda_device):
    prob = build_sparse((12,) * 3, (2,) * 3)
    solver = FetiSolverSparse(prob, FetiOptions(gluing="nonred", coarse="sparse",
                                                deterministic=True),
                              kplus_dtype=torch.float32, kplus_refine=2,
                              primal_refine=1, device=cuda_device)
    r1 = solver.solve(tol=Tolerances(rtol=1e-6))
    r2 = solver.solve(b_loc=prob.b_loc * 1.5, tol=Tolerances(rtol=1e-6))
    assert r1.result.reason == 2 and r2.result.reason == 2
    np.testing.assert_allclose(r2.x_global, 1.5 * r1.x_global, atol=1e-6)
