"""Checkpoint / resume of factorizations and solver state — the port of
:mod:`permon_tpu.utils.checkpoint`.

The reference has no checkpointing; its closest mechanisms are
QPTFetiPrepareReuseCP (keep the factorized coarse problem across solves,
qptransform.c:1213-1251) and QPDump (-qp_dump writes A, b to binary files).
Here any structure of the port's objects — factorized inverses, projectors,
whole QP dataclasses, results — is saved to one ``.npz`` and restored, so a
campaign of solves resumes without factorizing again.

The file holds the arrays as ``leaf_<i>`` entries and a ``structure``
entry: JSON of the port's class names and field names, with plain values
(numbers, strings, None, dtypes) inline and each array by its leaf number.
:func:`load` rebuilds dataclasses of ``permon_tpu_torch`` only and refuses
any other name; nothing is unpickled.  Caches kept on an object (a gather
table's launch plan, a cast copy) are not saved; they are made again at
first use, and a gather table's planes are padded again as
:meth:`~permon_tpu_torch.core.extension.GatherTable.from_host` pads them.

The JAX package's files store a pickled JAX treedef; files of the two
packages do not read each other.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
from typing import Any

import numpy as np
import torch

from .. import resolve_device

#: modules whose dataclasses :func:`load` may rebuild
PACKAGE = "permon_tpu_torch"


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


class _Writer:
    def __init__(self):
        self.leaves: list = []
        self.seen: dict = {}  # id(tensor) -> leaf number: a shared tensor is stored once

    def leaf(self, a: np.ndarray, key=None) -> int:
        if key is not None and key in self.seen:
            return self.seen[key]
        self.leaves.append(a)
        if key is not None:
            self.seen[key] = len(self.leaves) - 1
        return len(self.leaves) - 1

    def node(self, obj) -> Any:
        if obj is None or isinstance(obj, (bool, int, float, str)):
            return {"t": "py", "v": obj}
        if isinstance(obj, torch.Tensor):
            t = obj.detach()
            host = (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
            return {"t": "tensor", "dtype": _dtype_name(t.dtype), "i": self.leaf(host, id(obj))}
        if isinstance(obj, np.ndarray):
            return {"t": "ndarray", "i": self.leaf(obj, id(obj))}
        if isinstance(obj, np.generic):
            return {"t": "py", "v": obj.item()}
        if isinstance(obj, torch.dtype):
            return {"t": "dtype", "v": _dtype_name(obj)}
        if isinstance(obj, (tuple, list)):
            return {"t": type(obj).__name__, "items": [self.node(v) for v in obj]}
        if isinstance(obj, dict):
            if not all(isinstance(k, str) for k in obj):
                raise TypeError("checkpoint dicts need str keys")
            return {"t": "dict", "items": {k: self.node(v) for k, v in obj.items()}}
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            cls = type(obj)
            if not cls.__module__.startswith(PACKAGE + "."):
                raise TypeError(f"checkpoint: {cls.__module__}.{cls.__qualname__} is not a "
                                f"class of {PACKAGE}")
            return {"t": "dc", "cls": f"{cls.__module__}:{cls.__qualname__}",
                    "fields": {f.name: self.node(getattr(obj, f.name))
                               for f in dataclasses.fields(obj) if f.init}}
        raise TypeError(f"checkpoint cannot store a {type(obj).__name__}")


def _resolve_class(name: str):
    """The dataclass ``module:qualname`` of the port, or ValueError."""
    module, _, qual = name.partition(":")
    if not (module == PACKAGE or module.startswith(PACKAGE + ".")) or not qual:
        raise ValueError(f"checkpoint names {name!r}, not a class of {PACKAGE}")
    obj = importlib.import_module(module)
    for part in qual.split("."):
        obj = getattr(obj, part, None)
    if not (isinstance(obj, type) and dataclasses.is_dataclass(obj)):
        raise ValueError(f"checkpoint names {name!r}, not a dataclass of {PACKAGE}")
    return obj


class _Reader:
    def __init__(self, data, device: torch.device):
        self.data, self.device = data, device
        self.tensors: dict = {}

    def node(self, n) -> Any:
        t = n["t"]
        if t == "py":
            return n["v"]
        if t == "tensor":
            key = (n["i"], n["dtype"])
            if key not in self.tensors:
                self.tensors[key] = torch.as_tensor(self.data[f"leaf_{n['i']}"]).to(
                    device=self.device, dtype=getattr(torch, n["dtype"]))
            return self.tensors[key]
        if t == "ndarray":
            return self.data[f"leaf_{n['i']}"]
        if t == "dtype":
            return getattr(torch, n["v"])
        if t in ("tuple", "list"):
            items = [self.node(v) for v in n["items"]]
            return tuple(items) if t == "tuple" else items
        if t == "dict":
            return {k: self.node(v) for k, v in n["items"].items()}
        if t == "dc":
            cls = _resolve_class(n["cls"])
            fields = {k: self.node(v) for k, v in n["fields"].items()}
            from ..core.extension import GatherTable, _padded_planes

            if cls is GatherTable:  # the kernel reads planes padded to an aligned stride
                fields["idx"] = _padded_planes(fields["idx"].cpu().numpy(), fields["n_src"],
                                               self.device)
                fields["vals"] = _padded_planes(fields["vals"].cpu().numpy(), 0, self.device)
            return cls(**fields)
        raise ValueError(f"checkpoint: unknown node type {t!r}")


def save(path: str, tree: Any) -> None:
    """Save a structure of the port's objects (dataclasses of
    permon_tpu_torch, tensors, numpy arrays, tuples, lists, str-keyed
    dicts, plain values) to ``path`` (.npz)."""
    w = _Writer()
    structure = w.node(tree)
    payload = {f"leaf_{i}": leaf for i, leaf in enumerate(w.leaves)}
    payload["structure"] = np.frombuffer(json.dumps(structure).encode(), dtype=np.uint8)
    tmp = path + ".tmp.npz"  # savez appends .npz unless already present
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)


def load(path: str, device=None) -> Any:
    """Restore a structure saved by :func:`save`, its tensors on ``device``
    (None: the card); only classes of permon_tpu_torch are rebuilt."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        structure = json.loads(data["structure"].tobytes().decode())
        return _Reader(data, dev).node(structure)


def dump_qp(path: str, qp) -> None:
    """QPDump analog: save the QP's data (operators, b, constraints)."""
    save(path, qp)


def load_qp(path: str, device=None):
    return load(path, device)
