"""Active exploration layer — port of ``active_orb_slam2_tpu/active``.

Occupancy-grid mapping from the sparse map, frontier detection,
feature-visibility (localizability) scoring of candidate viewpoints, a
feature-safe planner, and a simulated-RGB-D replanning loop
(``active/explorer.py``).  The grid, the frontier mask and the scorer
run on the map's device; the planner and the goal clustering are host
code, as in the JAX package.
"""

from active_orb_slam2_tpu_torch.active.occupancy import (  # noqa: F401
    GridSpec2D, build_occupancy_grid,
)
from active_orb_slam2_tpu_torch.active.scoring import (  # noqa: F401
    build_visibility_scorer, score_grid_localizability,
)
from active_orb_slam2_tpu_torch.active.frontier import (  # noqa: F401
    frontier_mask, frontier_goals,
)
from active_orb_slam2_tpu_torch.active.planner import astar_plan  # noqa: F401
