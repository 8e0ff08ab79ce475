"""Active exploration loop over a simulated RGB-D world.

Port of ``active_orb_slam2_tpu/active/explorer.py`` (BASELINE config #5):
goal -> plan -> follow -> replan, with the SLAM system in the loop.
Each iteration:

  1. render an RGB-D frame at the current pose, feed SLAM;
  2. rebuild the occupancy grid from the (live) map arena;
  3. detect frontier goals; score candidate viewpoints with the
     batched localizability scorer;
  4. A* a feature-safe path to the best goal (information gain x
     localizability, the paper's utility);
  5. advance along the path; repeat.

Steps 2-3 run on the map's device.  Their results (the point count, the
grid, the frontier mask and the scores) come to the host in one copy a
step (:func:`read_step`); the goal clustering and A* are host code.  The
only other waits are the JAX package's: ``slam.state`` after a fed frame
drains the pipeline.
"""

from typing import NamedTuple

import numpy as np
import torch

from active_orb_slam2_tpu_torch.active.frontier import (
    frontier_mask, goals_from_mask)
from active_orb_slam2_tpu_torch.active.occupancy import (
    GridSpec2D, build_occupancy_grid)
from active_orb_slam2_tpu_torch.active.planner import astar_plan
from active_orb_slam2_tpu_torch.active.scoring import (
    build_visibility_scorer, score_grid_localizability)
from active_orb_slam2_tpu_torch.io.synthetic import render_rgbd
from active_orb_slam2_tpu_torch.models.system import LOST
from active_orb_slam2_tpu_torch.utils.transfer import landed, to_pinned

HEADINGS = 8
CELL_STRIDE = 2


class ExploreLog(NamedTuple):
    positions: list        # [(x, z)] visited
    n_points: list         # map size over time
    coverage: list         # known-cell fraction over time
    replans: int


def _pose44_from_xz_heading(x, z, heading, y=0.0):
    cy, sy = np.cos(heading), np.sin(heading)
    T = np.eye(4, dtype=np.float32)
    # camera z-axis = world heading direction (matches loop_trajectory)
    fwd = np.array([sy, 0, cy], np.float32)
    up = np.array([0, 1, 0], np.float32)
    right = np.cross(up, fwd)
    T[:3, 0], T[:3, 1], T[:3, 2] = right, up, fwd
    T[:3, 3] = (x, y, z)
    return T


def read_step(occupancy, scorer, m, spec: GridSpec2D):
    """One planning step's device work and its single read: (valid
    points, grid [H, W] int8, frontier mask [H, W] bool, localizability
    [H', W', HEADINGS] int32), all numpy, through one copy into pinned
    host memory."""
    grid = occupancy(m)
    loc = score_grid_localizability(scorer, m, spec, headings=HEADINGS,
                                    cell_stride=CELL_STRIDE)
    packed = torch.cat([m.pt_valid.sum(dtype=torch.int32)[None],
                        grid.flatten().to(torch.int32),
                        frontier_mask(grid).flatten().to(torch.int32),
                        loc.flatten()])
    host = landed(*to_pinned(packed))
    n_cells = spec.height * spec.width
    return (int(host[0]),
            host[1:1 + n_cells].astype(np.int8).reshape(grid.shape),
            host[1 + n_cells:1 + 2 * n_cells].astype(bool).reshape(
                grid.shape),
            host[1 + 2 * n_cells:].reshape(loc.shape))


def plan_step(grid, fm, loc, spec: GridSpec2D, start_cell,
              min_features: int):
    """The host half of a planning step: the frontier goals of mask
    ``fm``, the localizability at cell resolution (``loc_full``) and the
    A* path from ``start_cell`` to the first of the five largest goals
    it reaches in two cells or more.  Returns (goals, loc_full, path or
    None)."""
    goals = goals_from_mask(fm)
    loc_full = np.kron(loc.max(-1), np.ones((CELL_STRIDE, CELL_STRIDE)))[
        :spec.height, :spec.width]
    path = None
    for gr, gc, _size in goals[:5]:
        path = astar_plan(grid, start_cell, (gr, gc),
                          localizability=loc_full,
                          min_features=min_features, unknown_ok=True)
        if path and len(path) > 1:
            break
    return goals, loc_full, path


def run_exploration(slam, world, spec: GridSpec2D, n_steps: int = 30,
                    start_xz=(0.0, -1.0), start_heading: float = 0.0,
                    min_features: int = 30, step_cells: int = 2,
                    timestamp0: float = 0.0):
    """Drive the SLAM system actively through ``world``.

    ``slam`` is a System (RGB-D).  Returns an ExploreLog.
    """
    occupancy = build_occupancy_grid(spec)
    scorer = build_visibility_scorer(slam.cfg.camera)

    x, z = start_xz
    heading = start_heading
    log = ExploreLog([], [], [], 0)
    t = timestamp0

    def feed(px, pz, ph):
        nonlocal t
        Twc = _pose44_from_xz_heading(px, pz, ph)
        gray, depth = render_rgbd(world, slam.cfg.camera, Twc)
        slam.track_rgbd(gray, depth, t)
        t += 1.0 / 30.0

    def recover():
        """Lost mid-motion: rotate in place until relocalization bites
        (the nav-stack's recovery behaviour; drives the reloc path)."""
        nonlocal heading
        for _ in range(100):
            if slam.state != LOST:
                return True
            heading -= 0.06
            feed(x, z, heading)
        return slam.state != LOST

    def move_to(nx, nz, nh, max_step=0.1, max_turn=0.06):
        """Robot-like motion: substep the pose so SLAM sees ~30 fps
        continuity (turn first, then translate)."""
        nonlocal x, z, heading
        dh = (nh - heading + np.pi) % (2 * np.pi) - np.pi
        for _ in range(int(abs(dh) / max_turn)):
            heading += np.sign(dh) * max_turn
            feed(x, z, heading)
            if slam.state == LOST and not recover():
                return
        heading = nh
        d = np.hypot(nx - x, nz - z)
        n_sub = max(int(d / max_step), 1)
        x0, z0 = x, z
        for i in range(1, n_sub + 1):
            feed(x0 + (nx - x0) * i / n_sub, z0 + (nz - z0) * i / n_sub,
                 heading)
            if slam.state == LOST and not recover():
                x, z = (x0 + (nx - x0) * i / n_sub,
                        z0 + (nz - z0) * i / n_sub)
                return
        x, z = nx, nz

    feed(x, z, heading)
    for step in range(n_steps):
        log.positions.append((x, z))
        n_points, grid, fm, loc = read_step(occupancy, scorer, slam.map,
                                            spec)
        log.n_points.append(n_points)
        known = float((grid != -1).mean())
        log.coverage.append(known)

        start_cell = (int((z - spec.origin_z) / spec.resolution),
                      int((x - spec.origin_x) / spec.resolution))
        goals, _, path = plan_step(grid, fm, loc, spec, start_cell,
                                   min_features)
        if not goals or not path or len(path) <= 1:
            break
        log = log._replace(replans=log.replans + 1)

        # advance a couple of cells along the path, facing the motion
        nxt = path[min(step_cells, len(path) - 1)]
        nx = spec.origin_x + (nxt[1] + 0.5) * spec.resolution
        nz = spec.origin_z + (nxt[0] + 0.5) * spec.resolution
        if np.hypot(nx - x, nz - z) < 1e-6:
            break
        move_to(nx, nz, float(np.arctan2(nx - x, nz - z)))
    return log
