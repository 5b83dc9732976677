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

The slice ported so far is the large-path linear TFETI solve
(:mod:`permon_tpu_torch.feti.large`); everything else raises
``NotImplementedError`` pointing at ROADMAP.md.
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

    ``None`` takes the first CUDA card when one is visible and the CPU
    otherwise.  An explicit CUDA device is never replaced by the CPU: when
    no card is visible this raises instead."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dev = torch.device(device)
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


__all__ = ["Struct", "DeviceLike", "resolve_device", "as_torch_dtype", "not_ported"]
