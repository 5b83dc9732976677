"""The work of one apply of a kernel on the main path, computed from the
configuration's shapes and dtypes (never from the program's storage), for
the roofline shares of ``layer_metrics/``.  Each input byte is counted
once and each output byte once.

A box of ``cells`` Q1 elements has M = cells + 1 nodes per axis; the
decomposition into ``grid`` subdomains gives each part of an axis
M // g nodes (the first M % g parts one more) and every part but the first
one more node below (the shared layer), so a subdomain box is nodes
[off[r] - 1, off[r + 1] - 1] on that axis.
"""

from __future__ import annotations

from math import prod
from typing import List, Sequence, Tuple

from .peaks import ITEMSIZE


def axis_parts(M: int, g: int) -> List[int]:
    """Node counts of the g subdomain boxes along an axis of M nodes."""
    base = [M // g + (1 if i < M % g else 0) for i in range(g)]
    return [n + (1 if r > 0 else 0) for r, n in enumerate(base)]


def subdomain_boxes(cells: Sequence[int], grid: Sequence[int]) -> List[Tuple[int, int, int]]:
    px, py, pz = (axis_parts(c + 1, g) for c, g in zip(cells, grid))
    return [(nx, ny, nz) for nz in pz for ny in py for nx in px]


def band_factor_entries(nx: int, ny: int, nz: int) -> int:
    """Entries of the Cholesky factor of a Q1 box in its natural ordering
    (x fastest): the lower band w = nx*ny + nx + 1 fills in, so row i holds
    min(i, w) + 1 entries."""
    n, w = nx * ny * nz, nx * ny + nx + 1
    if n <= w:
        return n * (n + 1) // 2
    return n * (w + 1) - w * (w + 1) // 2


def kplus_apply_work(cells, grid, factor_dtype: str = "float32",
                     vector_dtype: str = "float64") -> Tuple[int, int]:
    """(bytes, flops) of one K+ apply: a forward and a backward substitution
    with every subdomain's band factor, the factor read once at the
    factor's precision, the vector read once and written once; two flops
    per factor entry in each substitution."""
    boxes = subdomain_boxes(cells, grid)
    entries = sum(band_factor_entries(*b) for b in boxes)
    n = sum(prod(b) for b in boxes)
    nbytes = entries * ITEMSIZE[factor_dtype] + 2 * n * ITEMSIZE[vector_dtype]
    return nbytes, 4 * entries


def gluing_rows(cells, grid) -> Tuple[int, int]:
    """(m, n_loc): the rows of the nonredundant gluing (a node of d copies
    has d - 1 rows of two entries) and the decomposed dofs; a node's d is the
    product over the axes of 2 on a shared layer, else 1."""
    n_loc = prod(c + 1 + g - 1 for c, g in zip(cells, grid))
    return n_loc - prod(c + 1 for c in cells), n_loc


def gather_f_apply_work(cells, grid, value_dtype: str = "float64",
                        index_dtype: str = "int32") -> Tuple[int, int]:
    """(bytes, flops) of the two gathers of one F apply, B' (dual to the
    decomposed space) and B (back): each reads the 2m entries once (an index
    and a value each), writes its output once, and reads of its input one
    32-byte sector per entry, at most all of it; two flops per entry."""
    m, n_loc = gluing_rows(cells, grid)
    nnz, v = 2 * m, ITEMSIZE[value_dtype]
    entry = ITEMSIZE[index_dtype] + v
    bt = nnz * entry + n_loc * v + min(32 * nnz, m * v)
    b = nnz * entry + m * v + min(32 * nnz, n_loc * v)
    return bt + b, 4 * nnz
