"""The map arena: fixed-shape tensors for points and keyframes.

Port of the arena part of ``active_orb_slam2_tpu/models/map_state.py``
(the covisibility views wait for local mapping).  The fields, shapes and
meanings are the JAX package's; descriptors are int32 with the uint32
bits.  Unlike the JAX pytree, the port's arena is preallocated once and
updated in place by the tracking step (masked writes), so a frame never
copies the map.

Observations are stored forward, as the per-keyframe feature -> point
index map ``kf_point [K, F]`` (-1 = none).
"""

from typing import NamedTuple

import torch

from active_orb_slam2_tpu_torch.config import MapConfig, OrbConfig


class MapState(NamedTuple):
    """The whole map.  P = max_points, K = max_keyframes, F = n_features."""
    # ---- points ----
    pt_xyz: torch.Tensor        # [P, 3] world position
    pt_desc: torch.Tensor       # [P, 8] int32 distinctive descriptor
    pt_normal: torch.Tensor     # [P, 3] mean viewing direction
    pt_min_dist: torch.Tensor   # [P] scale-invariance near bound
    pt_max_dist: torch.Tensor   # [P] scale-invariance far bound
    pt_valid: torch.Tensor      # [P] bool
    pt_visible: torch.Tensor    # [P] int32  (IncreaseVisible)
    pt_found: torch.Tensor      # [P] int32  (IncreaseFound)
    pt_first_kf: torch.Tensor   # [P] int32  creating keyframe counter
    # ---- keyframes ----
    kf_pose: torch.Tensor       # [K, 7] Tcw
    kf_valid: torch.Tensor      # [K] bool
    kf_frame_id: torch.Tensor   # [K] int32 source frame id
    kf_uv: torch.Tensor         # [K, F, 2] undistorted keypoints
    kf_ur: torch.Tensor         # [K, F] right x-coord (<0 = mono)
    kf_level: torch.Tensor      # [K, F] int32 octave
    kf_angle: torch.Tensor      # [K, F] float32
    kf_desc: torch.Tensor       # [K, F, 8] int32
    kf_feat_valid: torch.Tensor  # [K, F] bool
    kf_depth: torch.Tensor      # [K, F] measured depth (<=0 invalid)
    kf_point: torch.Tensor      # [K, F] int32 feature->point (-1 none)
    kf_parent: torch.Tensor     # [K] int32 spanning-tree parent (-1 root)

    @property
    def max_points(self):
        return self.pt_xyz.shape[0]

    @property
    def max_keyframes(self):
        return self.kf_pose.shape[0]

    @property
    def n_features(self):
        return self.kf_uv.shape[1]


def empty_map(map_cfg: MapConfig, orb_cfg: OrbConfig, device=None) -> MapState:
    P, K, F = map_cfg.max_points, map_cfg.max_keyframes, orb_cfg.n_features
    f32, i32 = torch.float32, torch.int32

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    kf_pose = full((K, 7), 0.0, f32)
    kf_pose[:, 0] = 1.0
    return MapState(
        pt_xyz=full((P, 3), 0.0, f32),
        pt_desc=full((P, 8), 0, i32),
        pt_normal=full((P, 3), 0.0, f32),
        pt_min_dist=full((P,), 0.0, f32),
        pt_max_dist=full((P,), 1e9, f32),
        pt_valid=full((P,), False, torch.bool),
        pt_visible=full((P,), 0, i32),
        pt_found=full((P,), 0, i32),
        pt_first_kf=full((P,), -1, i32),
        kf_pose=kf_pose,
        kf_valid=full((K,), False, torch.bool),
        kf_frame_id=full((K,), -1, i32),
        kf_uv=full((K, F, 2), 0.0, f32),
        kf_ur=full((K, F), -1.0, f32),
        kf_level=full((K, F), 0, i32),
        kf_angle=full((K, F), 0.0, f32),
        kf_desc=full((K, F, 8), 0, i32),
        kf_feat_valid=full((K, F), False, torch.bool),
        kf_depth=full((K, F), 0.0, f32),
        kf_point=full((K, F), -1, i32),
        kf_parent=full((K,), -1, i32),
    )


def allocate_slots(valid_mask, want: int):
    """Indices of the first ``want`` free slots, in order.

    Returns (slots [want] int64, ok [want] bool): ok is False where the
    arena is full and the caller must mask its writes.
    """
    order = torch.sort(valid_mask.to(torch.int32), stable=True).indices
    slots = order[:want]
    return slots, ~valid_mask[slots]
