"""permon_tpu_torch — the PyTorch/CUDA port of permon_tpu.

A second package beside the JAX reference ``permon_tpu``; it imports
``torch``, ``numpy`` and ``scipy`` and never ``jax``, ``flax`` or
``permon_tpu``.  The module layout follows the JAX package so that each
counterpart is easy to find (``permon_tpu_torch.core.band`` <->
``permon_tpu.core.band`` and so on).

Idiom of the port:

- operators and problem objects are plain dataclasses with a ``.replace``
  method (:class:`Struct`) in place of ``flax.struct`` pytrees;
- every tensor is made with an explicit ``device=`` and an explicit dtype;
  importing the package changes no global torch setting (the same process
  may also run JAX);
- no ``jit``: ``lax.scan`` is a Python loop, ``lax.while_loop`` a Python
  loop with one host check per iteration.

Ported: every single-device mode of the JAX package.  The dense TFETI
path of the PERMON tutorials (:func:`~permon_tpu_torch.feti.solve.feti_solve`
and :class:`~permon_tpu_torch.feti.solve.FetiSolver` on a
:class:`~permon_tpu_torch.feti.assembly.FetiProblem`: every gluing type,
Dirichlet rows or elimination in the Hessian, constant / numeric /
rigid-body nullspaces, projected CG with or without the lumped
preconditioner, SMALXE on the projected or the unprojected dual,
``orth_G``, contact rows, and ``throughput=True``: the leaf path of
:mod:`permon_tpu_torch.feti.leaf` / :mod:`~permon_tpu_torch.feti.leafqp`
with explicit K+ inverses; ``FetiSolver.save`` / ``load``); the MATIS entry
:func:`~permon_tpu_torch.feti.matis.feti_problem_from_matis`; the whole QP
transform chain with ``all_in_one`` / ``feti_prepare`` /
``feti_prepare_reuse_cp`` and :mod:`permon_tpu_torch.qp.orth`; the
large-path TFETI solve, linear and with contact
(:mod:`permon_tpu_torch.feti.large`), for Poisson and for 3-D elasticity
(rigid-body nullspace, ``BlockCoarse``, the band factorization of the
coarse GG', ``reorder_rcm``); the band module
(:mod:`permon_tpu_torch.core.band`); the general QP path (``QP.create`` ->
``make_operator`` -> ``SEll`` / ``Dia`` -> ``solve`` -> MPRGP / CG / SMALXE
/ PCPG / the TAO analog, ``dualize`` with the dense K+ of
:mod:`permon_tpu_torch.core.factor`, the precision policies up to
``'bf16_mixed'``); the small core modules; and the user side: the options
database (:class:`Options`, :func:`solve_from_options`), tracing with the
:class:`Timer` wrapper (:mod:`permon_tpu_torch.sys`), the text
:mod:`~permon_tpu_torch.viewers`, :mod:`permon_tpu_torch.utils.checkpoint`
and the SVM (:mod:`permon_tpu_torch.svm`); and the multi-device layer
(:mod:`permon_tpu_torch.parallel`, on ``torch.distributed``: one process
per rank, ``make_mesh`` / ``make_mesh2``), with ``FetiOptions(mesh=...)``
on the large, dense and leaf paths, ``FetiOptions(qppf_redundancy=True)``,
``leaf_dual_qp(mesh=...)`` and the redundancy-group coarse factor
``Projector.cp_dist``.  The namespace holds every public name of
``permon_tpu`` (its ``__all__``) but ``enable_compilation_cache``, and the
``solvers``, ``qp``, ``qpc``, ``pc`` and ``core`` subpackages re-export what
the JAX ones do.  Entry points run on the card: ``device=None``
means the first CUDA device (under a mesh, the rank's) and raises without
one; pass ``device="cpu"`` for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


class Struct:
    """Mixin for the port's dataclasses: ``obj.replace(field=value)``
    returns a shallow copy with the given fields swapped (the
    ``flax.struct`` idiom of the JAX package)."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device the port runs on.

    ``None`` means the card: the first CUDA device.  The CPU is used only
    when the caller asks for ``"cpu"`` (as the CPU tests do); a CUDA device,
    asked for or implied, is never replaced by the CPU: when torch sees no
    card this raises instead."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was asked for but torch sees no CUDA device"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; the port runs on cuda or cpu")
    return dev


def as_torch_dtype(dtype) -> Optional[torch.dtype]:
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    import numpy as np

    return getattr(torch, np.dtype(dtype).name)


def not_ported(what: str) -> NotImplementedError:
    """The error every option outside the ported slice raises."""
    return NotImplementedError(
        f"{what} is not ported to permon_tpu_torch yet; see ROADMAP.md "
        "(queue A) for the order in which the rest of permon_tpu is ported"
    )


# the public names: the JAX package's (permon_tpu/__init__.py) and the
# port's own; imported last because the submodules import the helpers above
# from this module
from .core.linop import (  # noqa: E402
    Dense,
    Diagonal,
    Ell,
    Identity,
    LinearOperator,
    OneRow,
    Penalized,
    Product,
    Scaled,
    Sum,
    Timer,
    Transpose,
    VStack,
    aslinearoperator,
)
from .core.dia import Dia  # noqa: E402
from .core.matutils import make_operator  # noqa: E402
from .core.eig import max_eigenvalue  # noqa: E402
from .core.convergence import ConvergedReason, Tolerances  # noqa: E402
from .core.precision import MixedPrecision, with_precision  # noqa: E402
from .core.detred import set_deterministic  # noqa: E402
from .core import vec  # noqa: E402
from .qp.qp import QP  # noqa: E402
from .qpc.box import BoxConstraint  # noqa: E402
from .solvers.driver import make_solver, solve  # noqa: E402
from .solvers.mprgp import MPRGPOptions, mprgp  # noqa: E402
from .solvers.smalxe import SMALXEOptions, smalxe  # noqa: E402
from .pc.dual import PCDual  # noqa: E402
from .feti.assembly import FetiProblem  # noqa: E402
from .feti.solve import FetiOptions, FetiSolver, feti_solve  # noqa: E402
from .sys.options import Options, solve_from_options  # noqa: E402
from . import viewers  # noqa: E402

__all__ = [
    # the JAX package's names (all but enable_compilation_cache, which
    # points JAX's compilation cache at a directory)
    "LinearOperator", "Dense", "Diagonal", "Ell", "Identity", "OneRow", "Penalized",
    "Product", "Scaled", "Sum", "Timer", "Transpose", "aslinearoperator", "Dia",
    "make_operator", "max_eigenvalue", "ConvergedReason", "Tolerances", "MixedPrecision",
    "with_precision", "set_deterministic", "vec", "QP", "solve", "make_solver",
    "MPRGPOptions", "mprgp", "Options", "solve_from_options",
    # the port's own
    "Struct", "DeviceLike", "resolve_device", "as_torch_dtype", "not_ported",
    "BoxConstraint", "SMALXEOptions", "smalxe", "PCDual", "VStack", "FetiProblem",
    "FetiOptions", "FetiSolver", "feti_solve", "viewers",
]
