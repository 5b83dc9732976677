"""A load-step generator: three loads a node on a box mesh (a vector
field, as 3-D elasticity takes it).

The harness calls only ``steps(mix, config, seed)``, ``warmup(mix,
config)`` and ``load(mix, config, step)``.

It makes the load of every node of the configuration's box of
``problem.cells`` elements (``cells + 1`` nodes per axis, x fastest), its
three components interleaved as the program numbers its dofs (dof =
3 * node + c): a body load s * (1, 1, 1) of a scale s drawn from ``body``
(the tutorial's unit load on every dof, scaled) plus ``patches`` boxes of
constant load, each with a half width in nodes drawn from
``patch_half_width`` on every axis, centred anywhere on the grid, and an
amplitude of each component drawn from ``patch_amplitude``.  The patches
move the dual iteration count from step to step (a scaled load would leave
it unchanged).  With ``dirichlet_face_zero`` every component of the load
is 0 on the clamped x = 0 face.

As in ``box_patches``, the ``pool`` loads are drawn once, from the mix's
own ``pool_seed``, and a run's ``--seed`` draws only the order in which
they are sent.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from h100bench.harness import rng_for

#: keys a mix of this generator holds
KEYS = ("pool", "pool_seed", "body", "patches", "patch_half_width", "patch_amplitude",
        "dirichlet_face_zero")
#: load components a node
DOF = 3


@dataclass(frozen=True)
class LoadStep:
    """The parameters of one load step: the body load's scale and the
    patches as ((lo, hi) node ranges per axis x, y, z, amplitude of each
    component x, y, z)."""
    index: int
    body: float
    patches: Tuple[Tuple[Tuple[Tuple[int, int], ...], Tuple[float, ...]], ...]


def _nodes(config: dict) -> Tuple[int, ...]:
    return tuple(c + 1 for c in config["problem"]["cells"])


def _draw(mix: dict, nodes, index: int) -> LoadStep:
    rng = rng_for(int(mix["pool_seed"]), 0, index)
    body = float(rng.uniform(*mix["body"]))
    lo_w, hi_w = mix["patch_half_width"]
    patches = []
    for _ in range(int(mix["patches"])):
        box = []
        for M in nodes:
            c = int(rng.integers(0, M))
            h = int(rng.integers(lo_w, hi_w + 1))
            box.append((max(c - h, 0), min(c + h + 1, M)))
        amp = tuple(float(a) for a in rng.uniform(*mix["patch_amplitude"], size=DOF))
        patches.append((tuple(box), amp))
    return LoadStep(index=index, body=body, patches=tuple(patches))


def steps(mix: dict, config: dict, seed: int) -> List[LoadStep]:
    """The pool's load steps in the order ``seed`` sends them; a window that
    outlasts them sends them again in that order."""
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise ValueError(f"traffic mix: missing {missing}")
    order = rng_for(seed, 2).permutation(int(mix["pool"]))
    return [_draw(mix, _nodes(config), int(i)) for i in order]


def warmup(mix: dict, config: dict) -> LoadStep:
    """The set-up's warm-up load: drawn like the pool's, never timed."""
    return _draw(mix, _nodes(config), int(mix["pool"]))


def load(mix: dict, config: dict, step: LoadStep) -> np.ndarray:
    """The global load (float64), node-major with x fastest, the three
    components of a node interleaved: entry 3 * node + c."""
    Mx, My, Mz = _nodes(config)
    f = np.full((Mz, My, Mx, DOF), step.body)
    for ((x0, x1), (y0, y1), (z0, z1)), amp in step.patches:
        f[z0:z1, y0:y1, x0:x1] += np.asarray(amp)
    if mix["dirichlet_face_zero"]:
        f[:, :, 0] = 0.0
    return f.reshape(-1)
