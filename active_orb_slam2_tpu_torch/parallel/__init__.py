"""Global bundle adjustment in the point-major layout, on one device or
sharded over a process mesh, and the row-sharded matcher."""

from active_orb_slam2_tpu_torch.parallel.dist_ba import (  # noqa: F401
    PointEdges, anchor_block_order, build_point_major_edges,
    count_dropped_observations, global_ba, build_distributed_ba,
    inverse_permutation,
)
from active_orb_slam2_tpu_torch.parallel.matcher import (  # noqa: F401
    build_sharded_matcher)
from active_orb_slam2_tpu_torch.parallel.mesh import (  # noqa: F401
    initialize_distributed, make_host_chip_mesh, make_mesh)
