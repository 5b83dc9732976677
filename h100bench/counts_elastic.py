"""The work of one apply of the elasticity configurations' K+ and coarse
projector, computed from the configuration's shapes and dtypes (never from
the program's storage), for the roofline shares of ``layer_metrics/``.
Each input byte is counted once and each output byte once.

The boxes and the decomposition are those of ``counts.py``; a node carries
three dofs, node-major and interleaved (dof = 3 * node + c), nodes x
fastest. The subdomains that touch the clamped x = 0 face (the first of
the grid along x) are grounded and carry no coarse column; every other
subdomain is floating with the six rigid-body modes.
"""

from __future__ import annotations

from math import prod
from typing import Tuple

from . import counts
from .peaks import ITEMSIZE

DOF = 3
#: rigid-body modes of a floating 3-D subdomain
RBM = 6


def bandwidth(nx: int, ny: int) -> int:
    """The lower band of a Q1 elasticity box in its natural ordering: a node
    couples to the nodes nx * ny + nx + 1 away, and a dof to the other two
    dofs of its node."""
    return DOF * (nx * ny + nx + 1) + DOF - 1


def band_factor_entries(nx: int, ny: int, nz: int) -> int:
    """Entries of the Cholesky factor of a Q1 elasticity box in its natural
    ordering: the lower band fills in, so row i holds min(i, w) + 1."""
    n, w = DOF * nx * ny * nz, bandwidth(nx, ny)
    if n <= w:
        return n * (n + 1) // 2
    return n * (w + 1) - w * (w + 1) // 2


def kplus_apply_work(cells, grid, factor_dtype: str = "float32",
                     vector_dtype: str = "float64") -> Tuple[int, int]:
    """(bytes, flops) of one K+ apply: a forward and a backward substitution
    with every subdomain's band factor, read once at the factor's
    precision, the vector read once and written once; two flops per factor
    entry in each substitution."""
    boxes = counts.subdomain_boxes(cells, grid)
    entries = sum(band_factor_entries(*b) for b in boxes)
    n = DOF * sum(prod(b) for b in boxes)
    return entries * ITEMSIZE[factor_dtype] + 2 * n * ITEMSIZE[vector_dtype], 4 * entries


def floating_dofs(cells, grid) -> Tuple[int, int]:
    """(floating subdomains, their dofs): every subdomain but the grid's
    first layer along x."""
    gx = grid[0]
    boxes = counts.subdomain_boxes(cells, grid)
    floating = [b for s, b in enumerate(boxes) if s % gx != 0]
    return len(floating), DOF * sum(prod(b) for b in floating)


def coarse_dim(cells, grid) -> int:
    """k: the coarse columns, six for each floating subdomain."""
    return RBM * floating_dofs(cells, grid)[0]


def gluing_rows(cells, grid) -> Tuple[int, int]:
    """(m, n_loc) of the nonredundant gluing of every dof: three times the
    nodes' (counts.gluing_rows)."""
    m, n_loc = counts.gluing_rows(cells, grid)
    return DOF * m, DOF * n_loc


def gather_pair_work(cells, grid, value_dtype: str = "float64",
                     index_dtype: str = "int32") -> Tuple[int, int]:
    """(bytes, flops) of B' (dual to the decomposed space) and B (back) of
    the gluing rows, counted as ``counts.gather_f_apply_work`` counts them;
    every term of that count is linear in m and n_loc, so three dofs a node
    make it three times the nodes'."""
    nbytes, flops = counts.gather_f_apply_work(cells, grid, value_dtype, index_dtype)
    return DOF * nbytes, DOF * flops


def projector_apply_work(cells, grid, dtype: str = "float64") -> Tuple[int, int]:
    """(bytes, flops) of one P = I - G'(GG')^-1 G apply with G = R'B' kept
    as its blocks: B' of the gluing rows and B back (``gather_pair_work``),
    the rigid-body bases read once in G and once in G' (six columns on each
    floating dof), the k x k coarse inverse read once, the dual vector read
    once and the result written once. Flops: the gathers', a multiply and
    an add for each basis entry in G and in G', 2k^2 for the inverse, one
    subtraction a dual entry."""
    v = ITEMSIZE[dtype]
    m, _ = gluing_rows(cells, grid)
    _, nf = floating_dofs(cells, grid)
    k = coarse_dim(cells, grid)
    gb, gf = gather_pair_work(cells, grid, dtype)
    basis = RBM * nf
    return gb + 2 * basis * v + k * k * v + 2 * m * v, gf + 4 * basis + 2 * k * k + m
