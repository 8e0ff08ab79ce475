"""Feature-safe grid planner.

Port of ``active_orb_slam2_tpu/active/planner.py``, host code as there:
A* over the occupancy grid where a cell is valid when it is free (or
unknown, when exploring) and, given the batched localizability sweep
(``active/scoring.py``), clears a feature-count threshold.  The
neighbour order, the tie-breaking tuples and the +-3-cell goal snap are
the JAX package's, so both plan the same path.
"""

import heapq

import numpy as np

from active_orb_slam2_tpu_torch.active.occupancy import FREE, UNKNOWN


def astar_plan(grid, start_cell, goal_cell, localizability=None,
               min_features: int = 0, unknown_ok: bool = False):
    """A* on the grid.  Cells are (row, col).

    Args:
      grid: [H, W] int8 occupancy (numpy, or a CPU tensor).
      localizability: optional [H, W] max-over-headings feature counts;
        cells below ``min_features`` are invalid (the paper's
        feature-safety constraint).
      unknown_ok: allow planning through unknown space (exploration).
    Returns list of (row, col) or None.
    """
    h, w = grid.shape
    g = np.asarray(grid)

    def valid(r, c):
        if not (0 <= r < h and 0 <= c < w):
            return False
        if g[r, c] == FREE or (unknown_ok and g[r, c] == UNKNOWN):
            if localizability is not None and \
                    localizability[r, c] < min_features:
                return False
            return True
        return False

    start = tuple(int(v) for v in start_cell)
    goal = tuple(int(v) for v in goal_cell)
    if not valid(*goal):
        # snap goal to nearest valid cell within a small window
        best = None
        for dr in range(-3, 4):
            for dc in range(-3, 4):
                cand = (goal[0] + dr, goal[1] + dc)
                if valid(*cand):
                    d = abs(dr) + abs(dc)
                    if best is None or d < best[0]:
                        best = (d, cand)
        if best is None:
            return None
        goal = best[1]

    def hcost(a):
        return np.hypot(a[0] - goal[0], a[1] - goal[1])

    open_q = [(hcost(start), 0.0, start, None)]
    came, cost = {}, {start: 0.0}
    while open_q:
        _, c_cost, cur, parent = heapq.heappop(open_q)
        if cur in came:
            continue
        came[cur] = parent
        if cur == goal:
            path = [cur]
            while came[path[-1]] is not None:
                path.append(came[path[-1]])
            return path[::-1]
        for dr, dc, step in ((0, 1, 1.0), (0, -1, 1.0), (1, 0, 1.0),
                             (-1, 0, 1.0), (1, 1, 1.414), (1, -1, 1.414),
                             (-1, 1, 1.414), (-1, -1, 1.414)):
            nxt = (cur[0] + dr, cur[1] + dc)
            if not valid(*nxt) or nxt in came:
                continue
            nc = c_cost + step
            if nc < cost.get(nxt, np.inf):
                cost[nxt] = nc
                heapq.heappush(open_q, (nc + hcost(nxt), nc, nxt, cur))
    return None
