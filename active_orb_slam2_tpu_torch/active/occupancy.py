"""Occupancy-grid mapping from the sparse SLAM map.

Port of ``active_orb_slam2_tpu/active/occupancy.py``: every (keyframe,
observed point) ray at once, ``n_ray_samples`` samples strictly inside
each ray counted as free and the endpoint as occupied, a cell free or
occupied from two counts on.  Grid convention follows ROS: int8, -1
unknown, 0 free, 100 occupied, over the x-z plane.

Differences in form: only the x and z coordinates of the samples are
formed (the grid reads nothing else), in chunks of samples so that the
default arena's 25 M samples never stand in memory at once; the counts
are ``index_add_`` of float32 weights, exact below 2^24 whatever the
order the card adds them in (and a count only grows, so the >= 2 tests
cannot change beyond it).
"""

from typing import NamedTuple

import torch

from active_orb_slam2_tpu_torch.models.map_state import (
    MapState, camera_centers)

UNKNOWN = -1
FREE = 0
OCCUPIED = 100

SAMPLE_CHUNK = 1 << 22     # ray samples formed at once


class GridSpec2D(NamedTuple):
    origin_x: float      # world x of cell (0, 0) corner
    origin_z: float
    resolution: float    # metres / cell
    width: int           # cells along x
    height: int          # cells along z


def _cell_index(spec: GridSpec2D, x, z, res):
    """Flat cell index (clipped into the grid) and in-grid flag of each
    (x, z).  ``res`` is the resolution as a device tensor: a tensor
    divisor keeps true division on the card."""
    cx = torch.floor((x - spec.origin_x) / res)
    cz = torch.floor((z - spec.origin_z) / res)
    inb = (cx >= 0) & (cx < spec.width) & (cz >= 0) & (cz < spec.height)
    flat = torch.clamp(cz, 0, spec.height - 1) * spec.width \
        + torch.clamp(cx, 0, spec.width - 1)
    # a NaN coordinate is out of the grid (weight 0); the integer clamp
    # keeps its index in range
    return flat.to(torch.int64).clamp_(0, spec.width * spec.height - 1), inb


def build_occupancy_grid(spec: GridSpec2D, n_ray_samples: int = 48):
    """(m: MapState) -> grid [height, width] int8 on the map's device."""

    def occupancy(m: MapState):
        dev = m.pt_xyz.device
        K, F = m.kf_point.shape
        S = n_ray_samples
        ow = camera_centers(m.kf_pose)                   # [K, 3]
        pt = torch.clamp(m.kf_point, min=0).long()
        obs = (m.kf_point >= 0) & m.kf_valid[:, None] & m.pt_valid[pt]
        ends = m.pt_xyz[pt]                              # [K, F, 3]
        ex, ez = ends[..., 0], ends[..., 2]
        sx, sz = ow[:, None, 0], ow[:, None, 2]
        dx, dz = ex - sx, ez - sz
        s = (torch.arange(S, dtype=torch.float32, device=dev) + 0.5) \
            / torch.full((), S + 1.0, device=dev)
        res = torch.full((), spec.resolution, device=dev)
        w_obs = obs.to(torch.float32)

        n_cells = spec.width * spec.height
        free = torch.zeros(n_cells, device=dev)
        step = max(1, min(S, SAMPLE_CHUNK // max(K * F, 1)))
        for a in range(0, S, step):
            sc = s[a:a + step, None, None]
            fi, f_ok = _cell_index(spec, sx + sc * dx, sz + sc * dz, res)
            free.index_add_(0, fi.flatten(),
                            (w_obs * f_ok).flatten())
        ei, e_ok = _cell_index(spec, ex, ez, res)
        occ = torch.zeros(n_cells, device=dev).index_add_(
            0, ei.flatten(), (w_obs * e_ok).flatten())

        grid = torch.full((n_cells,), UNKNOWN, dtype=torch.int8, device=dev)
        grid = torch.where(free >= 2.0, FREE, grid)
        grid = torch.where(occ >= 2.0, OCCUPIED, grid)
        return grid.reshape(spec.height, spec.width)

    return occupancy
