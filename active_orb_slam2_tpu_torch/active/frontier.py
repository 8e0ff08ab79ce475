"""Frontier detection on the occupancy grid.

Port of ``active_orb_slam2_tpu/active/frontier.py``: free cells next to
unknown cells (a 3x3 dilation, on the grid's device), clustered into
goal candidates by coarse pooling on the host.
"""

import numpy as np
import torch

from active_orb_slam2_tpu_torch.active.occupancy import FREE, UNKNOWN


def frontier_mask(grid):
    """[H, W] int8 occupancy tensor -> bool mask of frontier cells."""
    grid = torch.as_tensor(grid)
    h, w = grid.shape
    unk = grid == UNKNOWN
    # 3x3 dilation of unknown
    p = torch.zeros((h + 2, w + 2), dtype=torch.bool, device=grid.device)
    p[1:h + 1, 1:w + 1] = unk
    near_unknown = torch.zeros_like(unk)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            near_unknown |= p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    return (grid == FREE) & near_unknown


def goals_from_mask(fm, pool: int = 4, min_cells: int = 3):
    """Goal candidates [(row, col, size)] of a host frontier mask: the
    centroid of each pool x pool block holding ``min_cells`` frontier
    cells or more, largest first."""
    fm = np.asarray(fm)
    h, w = fm.shape
    hp, wp = h // pool, w // pool
    goals = []
    for i in range(hp):
        for j in range(wp):
            blk = fm[i * pool:(i + 1) * pool, j * pool:(j + 1) * pool]
            n = int(blk.sum())
            if n >= min_cells:
                ys, xs = np.nonzero(blk)
                goals.append((i * pool + ys.mean(), j * pool + xs.mean(),
                              n))
    goals.sort(key=lambda g: -g[2])
    return goals


def frontier_goals(grid, pool: int = 4, min_cells: int = 3):
    """Cluster frontier cells by coarse pooling; returns [(row, col,
    size)] goal candidates (cell coords of cluster centroids).  Reads
    the mask to the host."""
    return goals_from_mask(frontier_mask(grid).cpu().numpy(), pool,
                           min_cells)
