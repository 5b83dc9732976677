"""Multi-device layout on ``torch.distributed`` — the port of
:mod:`permon_tpu.parallel` (its exports, less ``shard_map_compat``, see
ROADMAP.md).  SPMD with explicit collectives: one process per rank, every
rank running the same code (dist.py)."""

from .coarse import RedundantCoarse, redundant_projector
from .dist import (
    Mesh, make_mesh, replicate_projector, shard_extension, shard_extension_sparse,
    shard_qp, shard_qp_sparse,
)
from .overlap import (
    LeafOverlapPlan, OverlappedLeafOperator, feti_dual_apply_hier,
    leaf_apply_overlapped, make_mesh2, shard_qp2,
)

__all__ = ["Mesh", "RedundantCoarse", "redundant_projector", "make_mesh",
           "replicate_projector", "shard_extension", "shard_extension_sparse", "shard_qp",
           "shard_qp_sparse", "LeafOverlapPlan", "OverlappedLeafOperator",
           "feti_dual_apply_hier", "leaf_apply_overlapped", "make_mesh2", "shard_qp2"]
