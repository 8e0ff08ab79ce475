"""Monocular bootstrap: the initial matching and the two-keyframe map.

Port of ``active_orb_slam2_tpu/models/mono_init.py``
(``Tracking::MonocularInitialization`` and ``CreateInitialMapMonocular``):
windowed matching of a frame against the reference frame, and, once the
initializer (``models/initializer.py``) has reconstructed the pair, the
map of two keyframes with the triangulated points, scaled so that the
median depth in keyframe 0 is 1, then a global BA over the two (10 + 10
iterations, keyframe 0 fixed).

Copied from the JAX package for parity: the keyframes' ``kf_frame_id``
is their slot (0 and 1), not the source frame; keyframe 1's feature ->
point map is a scatter-max over the match targets (``.at[].max``), so
where two reference features match one current feature the higher slot
wins; and the median is ``jnp.nanmedian``'s (``ops/topk.py::nanmedian``).
The arena is written in place.
"""

import torch

from active_orb_slam2_tpu_torch.config import SlamConfig
from active_orb_slam2_tpu_torch.geometry.se3 import se3_identity
from active_orb_slam2_tpu_torch.models.local_mapping import (
    masked_put, write_back)
from active_orb_slam2_tpu_torch.models.map_state import (
    MapState, allocate_slots)
from active_orb_slam2_tpu_torch.models.optimizer import (
    BAEdges, bundle_adjustment)
from active_orb_slam2_tpu_torch.ops.matching import (
    hamming_matrix, match_mutual, rotation_consistency_mask)
from active_orb_slam2_tpu_torch.ops.topk import nanmedian

INIT_BA_ITERS = (10, 10)     # the reference's 20-iteration global BA
SCALE_FACTOR = 1.2
N_LEVELS_RANGE = 7           # min distance = max distance / 1.2^7


def build_mono_matcher(cfg: SlamConfig, window: float = 100.0,
                       ratio: float = 0.9):
    """``ORBmatcher::SearchForInitialization``: mutual best Hamming match
    within ``window`` px, ratio test, rotation consistency.  Returns
    ``(frame_ref, frame_cur) -> (match_idx [F] int32 into frame_cur's
    features, -1 if none; count [] int)``."""

    def match(frame_ref, frame_cur):
        d = hamming_matrix(frame_ref.desc, frame_cur.desc, frame_ref.valid,
                           frame_cur.valid)
        du = frame_ref.uv[:, 0:1] - frame_cur.uv[None, :, 0]
        dv = frame_ref.uv[:, 1:2] - frame_cur.uv[None, :, 1]
        d = torch.where(du * du + dv * dv <= window * window, d, 1e9)
        idx, _ = match_mutual(d, max_dist=50.0, ratio=ratio)
        keep = rotation_consistency_mask(frame_ref.angle, frame_cur.angle,
                                         idx)
        idx = torch.where(keep, idx, -1)
        return idx, (idx >= 0).sum()

    return match


def build_create_initial_map(cfg: SlamConfig):
    """Return ``(m, frame_ref, frame_cur, pose2, points, point_ok,
    match_idx) -> (m, kp1, pose2', n_points)``: keyframes 0 (identity)
    and 1 (``pose2``) with the points, after the gauge and the BA;
    ``kp1`` is keyframe 1's feature -> point map.  ``m`` is updated in
    place."""
    cam = cfg.camera

    def create(m: MapState, frame_ref, frame_cur, pose2, points, point_ok,
               match_idx):
        F = m.n_features
        dev = points.device
        # median-depth gauge: the median depth in keyframe 0 becomes 1
        scale = 1.0 / torch.clamp(nanmedian(points[:, 2], point_ok), min=1e-6)
        points = points * scale
        pose2 = torch.cat([pose2[:4], pose2[4:7] * scale])

        slots, free = allocate_slots(m.pt_valid, F)
        create_pt = point_ok & free
        dist = torch.linalg.vector_norm(points, dim=-1)   # KF0 at the origin
        normal = points / torch.clamp(dist[:, None], min=1e-9)
        max_d = dist * torch.pow(SCALE_FACTOR,
                                 frame_ref.level.to(torch.float32))
        min_d = max_d / SCALE_FACTOR ** N_LEVELS_RANGE

        def put(arr, val):
            return masked_put(arr, slots, val, create_pt)

        ones = torch.ones(F, dtype=torch.int32, device=dev)
        kp0 = torch.where(create_pt, slots, -1).to(torch.int32)
        tgt = torch.clamp(match_idx, min=0).long()
        kp1 = torch.full((F,), -1, dtype=torch.int32, device=dev).scatter_reduce(
            0, tgt, kp0, "amax", include_self=True)

        ident = se3_identity(device=dev)
        K = m.max_keyframes
        new_kf = torch.arange(K, device=dev) < 2

        def kf_rows(arr, row0, row1):
            return torch.cat([torch.stack([row0, row1]).to(arr.dtype),
                              arr[2:]])

        new = m._replace(
            pt_xyz=put(m.pt_xyz, points),
            pt_desc=put(m.pt_desc, frame_ref.desc),
            pt_normal=put(m.pt_normal, normal),
            pt_min_dist=put(m.pt_min_dist, min_d),
            pt_max_dist=put(m.pt_max_dist, torch.clamp(max_d, min=1e-3)),
            pt_valid=put(m.pt_valid, torch.ones_like(create_pt)),
            pt_visible=put(m.pt_visible, ones),
            pt_found=put(m.pt_found, ones),
            pt_first_kf=put(m.pt_first_kf, torch.zeros_like(ones)),
            kf_pose=kf_rows(m.kf_pose, ident, pose2),
            kf_valid=m.kf_valid | new_kf,
            kf_frame_id=kf_rows(m.kf_frame_id, *torch.arange(2, device=dev)),
            kf_uv=kf_rows(m.kf_uv, frame_ref.uv, frame_cur.uv),
            kf_ur=kf_rows(m.kf_ur, frame_ref.ur, frame_cur.ur),
            kf_level=kf_rows(m.kf_level, frame_ref.level, frame_cur.level),
            kf_angle=kf_rows(m.kf_angle, frame_ref.angle, frame_cur.angle),
            kf_desc=kf_rows(m.kf_desc, frame_ref.desc, frame_cur.desc),
            kf_feat_valid=kf_rows(m.kf_feat_valid, frame_ref.valid,
                                  frame_cur.valid),
            kf_depth=kf_rows(m.kf_depth, frame_ref.depth, frame_cur.depth),
            kf_point=kf_rows(m.kf_point, kp0, kp1),
            kf_parent=kf_rows(m.kf_parent, *(torch.arange(2, device=dev)
                                              - 1)))

        # the initial global BA over both keyframes, keyframe 0 fixed
        pt_loc = torch.arange(F, device=dev)
        no_right = torch.full((F, 1), -1.0, device=dev)
        edges = BAEdges(
            cam_idx=torch.cat([torch.zeros(F, dtype=torch.long, device=dev),
                               torch.ones(F, dtype=torch.long, device=dev)]),
            pt_idx=torch.cat([pt_loc, pt_loc]),
            obs_uvr=torch.cat([torch.cat([frame_ref.uv, no_right], -1),
                               torch.cat([frame_cur.uv[tgt], no_right], -1)]),
            level=torch.cat([frame_ref.level, frame_cur.level[tgt]]),
            has_stereo=torch.zeros(2 * F, dtype=torch.bool, device=dev),
            valid=torch.cat([create_pt, create_pt]))
        res = bundle_adjustment(
            cam, torch.stack([ident, pose2]), new.pt_xyz[slots], edges,
            fixed_cam=torch.arange(2, device=dev) == 0,
            iters_a=INIT_BA_ITERS[0], iters_b=INIT_BA_ITERS[1])
        new = new._replace(
            kf_pose=kf_rows(new.kf_pose, ident, res.poses[1]),
            pt_xyz=masked_put(new.pt_xyz, slots, res.points, create_pt))
        write_back(m, new)
        return m, kp1, res.poses[1], create_pt.sum().to(torch.int32)

    return create
