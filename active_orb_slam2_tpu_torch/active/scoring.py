"""Feature-visibility (localizability) scoring of candidate viewpoints.

Port of ``active_orb_slam2_tpu/active/scoring.py``: a pose is
feature-safe when enough map points pass the ``isInFrustum`` test from
it, and one batched call scores every candidate pose against the whole
point arena.  The JAX package vmaps ``in_frustum`` over the poses and
lets XLA fuse it; here the poses go through ``in_frustum`` in fixed
chunks of ``POSE_POINT_CHUNK`` (pose, point) pairs, so that the [poses,
points, 3] temporaries stay small (50 MB a tensor at the default
chunk), with static shapes and no host read.
"""

import functools

import numpy as np
import torch

from active_orb_slam2_tpu_torch.geometry.projection import (
    CameraParams, in_frustum)
from active_orb_slam2_tpu_torch.geometry.se3 import (
    quat_conj, quat_from_axis_angle, quat_rotate)
from active_orb_slam2_tpu_torch.models.map_state import MapState
from active_orb_slam2_tpu_torch.utils.transfer import upload

POSE_POINT_CHUNK = 1 << 22     # (pose, point) pairs scored at once


def build_visibility_scorer(cam: CameraParams):
    """(poses [Q, 7], m) -> visible-feature counts [Q] int32, on the
    device of ``poses`` and ``m``."""

    def score(poses, m: MapState):
        Q, N = poses.shape[0], m.pt_xyz.shape[0]
        step = max(1, POSE_POINT_CHUNK // max(N, 1))
        out = torch.empty(Q, dtype=torch.int32, device=poses.device)
        for a in range(0, Q, step):
            ok, *_ = in_frustum(cam, poses[a:a + step, None, :], m.pt_xyz,
                                m.pt_normal, m.pt_min_dist, m.pt_max_dist)
            out[a:a + step] = (ok & m.pt_valid).sum(-1, dtype=torch.int32)
        return out

    return score


def pose_from_xz_heading(x, z, heading, y: float = 0.0):
    """World (x, z) position + heading about +y -> Tcw [..., 7] float32,
    on the device of the inputs (arrays and numbers go to the CPU).

    Heading 0 looks along +z; the camera convention matches
    io/synthetic.py's loop trajectory.
    """
    x, z, heading = (torch.as_tensor(v, dtype=torch.float32)
                     for v in (x, z, heading))
    zero = torch.zeros_like(heading)
    axis = torch.stack([zero, torch.ones_like(heading), zero], dim=-1)
    # camera-to-world rotation: R_wc = R_y(heading); Tcw = inverse
    q_cw = quat_conj(quat_from_axis_angle(axis, heading))
    pos = torch.stack([x, torch.full_like(x, y), z], dim=-1)
    t_cw = -quat_rotate(q_cw, pos)
    return torch.cat([q_cw, t_cw], dim=-1)


@functools.lru_cache(maxsize=8)
def grid_poses(spec, headings: int, cell_stride: int, device):
    """The candidate poses of :func:`score_grid_localizability` on
    ``device`` ([len(xs) * len(zs) * headings, 7], x-major as the JAX
    package's ``meshgrid(..., indexing="ij")``), and (len(xs), len(zs)).
    The cell centres are formed in float64 on the host as the JAX
    package forms them and uploaded once without blocking."""
    zs = (np.arange(0, spec.height, cell_stride) + 0.5) \
        * spec.resolution + spec.origin_z
    xs = (np.arange(0, spec.width, cell_stride) + 0.5) \
        * spec.resolution + spec.origin_x
    hs = np.arange(headings) * (2 * np.pi / headings)
    X, Z, H = np.meshgrid(xs, zs, hs, indexing="ij")
    x, z, h = upload(device, *(a.ravel().astype(np.float32)
                               for a in (X, Z, H)))
    return pose_from_xz_heading(x, z, h), (len(xs), len(zs))


def score_grid_localizability(scorer, m: MapState, spec,
                              headings: int = 8, cell_stride: int = 1):
    """Score every (stride-subsampled) grid cell at several headings.

    Returns counts [H', W', headings] int32 on the map's device (the JAX
    package returns them as numpy) — the planner's feature-safety
    lookup.  One batched call for the whole sweep.
    """
    poses, (nx, nz) = grid_poses(spec, headings, cell_stride,
                                 m.pt_xyz.device)
    counts = scorer(poses, m)
    return counts.reshape(nx, nz, headings).permute(1, 0, 2)
