"""Per-frame tracking: motion-model matching, pose optimization, local-map
tracking, and keyframe insertion.

Port of ``active_orb_slam2_tpu/models/tracking.py``.  The step is the
same sequence (``TrackWithMotionModel`` + ``TrackLocalMap`` + the
keyframe decision + ``CreateNewKeyFrame``) on the same fixed shapes, and
it packs the same per-frame stats vector.  Differences in form:

* the map arena is updated in place (visibility counters, keyframe
  insertion) instead of returned as a new pytree;
* the keyframe insertion, a ``lax.cond`` in the JAX package, is a
  masked write decided on the device, so the step never waits on the
  host (it calls no ``.item()``, ``bool()`` or ``.cpu()``);
* scatter-max ``.at[i].max(v)`` is ``scatter_reduce_(..., "amax")`` on a
  tensor pre-filled as the JAX code does, and ``lax.top_k`` is the
  stable top-k of ``ops/topk.py``.

Localization-only mode (``loc_mode``, a host flag) adds the temporal
points of ``UpdateLastFrame``: the last frame's close-depth features
stand in for its missing map points in the motion-stage search and its
pose optimization (never in the map association), and >= 20
motion-stage inliers keep the frame OK.  With ``loc_mode`` off the step
runs none of those operations.
"""

from typing import NamedTuple

import torch

from active_orb_slam2_tpu_torch.config import SlamConfig
from active_orb_slam2_tpu_torch.geometry.projection import (
    in_frustum, predict_scale, project_stereo)
from active_orb_slam2_tpu_torch.geometry.se3 import (
    quat_conj, quat_rotate, se3_apply, se3_compose, se3_identity,
    se3_inverse)
from active_orb_slam2_tpu_torch.models.frame import FrameData
from active_orb_slam2_tpu_torch.models.map_state import MapState, allocate_slots
from active_orb_slam2_tpu_torch.ops.matching import (
    rotation_consistency_mask, search_by_projection)
from active_orb_slam2_tpu_torch.ops.pose_opt_kernel import (
    pose_optimization_fused)
from active_orb_slam2_tpu_torch.ops.topk import stable_topk

# retired-stats vector layout (the step's packed per-frame scalars):
# [0] motion-stage inliers  [1] local-stage inliers  [2] tracking ok
# [3] close tracked         [4] close unmatched      [5] n associations
# [6] inserted KF slot (-1) [7] reference-KF slot
# [8:15] frame pose Tcw     [15:22] reference-KF pose Tcw
# [22] reference-KF frame id (generation tag of the slot)
STATS_POSE = slice(8, 15)
STATS_REF_POSE = slice(15, 22)
STATS_REF_FID = 22
STATS_LEN = 23


class TrackState(NamedTuple):
    """Carried between frames (the reference's Tracking members); the
    keyframe-decision counters live on the device."""
    pose: torch.Tensor        # [7] Tcw of last tracked frame
    velocity: torch.Tensor    # [7] constant-velocity model
    vel_ok: torch.Tensor      # bool — velocity meaningful
    assoc: torch.Tensor       # [F] int32 feature->point of last frame
    angle: torch.Tensor       # [F] last frame's keypoint orientations
    n_inliers: torch.Tensor   # int32
    ok: torch.Tensor          # bool — tracking good
    frame_id: torch.Tensor    # int32 — id of the NEXT frame to track
    kf_seq: torch.Tensor      # int32 — monotone keyframe counter
    last_kf_slot: torch.Tensor     # int32 — newest KF slot (-1 none)
    last_kf_inliers: torch.Tensor  # int32 — its inlier count at insert
    frames_since_kf: torch.Tensor  # int32
    tmp_xyz: torch.Tensor      # [F, 3] temporal points (world)
    tmp_desc: torch.Tensor     # [F, 8] int32 descriptors
    tmp_max_dist: torch.Tensor  # [F] scale-invariance far bound
    tmp_ok: torch.Tensor       # [F] bool — has usable close depth


def init_track_state(n_features: int, device=None) -> TrackState:
    def scalar(v, dtype=torch.int32):
        return torch.tensor(v, dtype=dtype, device=device)

    F = n_features
    return TrackState(
        pose=se3_identity(device=device),
        velocity=se3_identity(device=device),
        vel_ok=scalar(False, torch.bool),
        assoc=torch.full((F,), -1, dtype=torch.int32, device=device),
        angle=torch.zeros(F, device=device),
        n_inliers=scalar(0),
        ok=scalar(False, torch.bool),
        frame_id=scalar(0),
        kf_seq=scalar(0),
        last_kf_slot=scalar(-1),
        last_kf_inliers=scalar(0),
        frames_since_kf=scalar(0),
        tmp_xyz=torch.zeros((F, 3), device=device),
        tmp_desc=torch.zeros((F, 8), dtype=torch.int32, device=device),
        tmp_max_dist=torch.zeros(F, device=device),
        tmp_ok=torch.zeros(F, dtype=torch.bool, device=device),
    )


def scatter_max(n: int, idx, src):
    """``jnp.full(n, -1).at[idx].max(src)`` for int32 values >= -1."""
    out = torch.full((n,), -1, dtype=torch.int32, device=src.device)
    return out.scatter_reduce_(0, idx.long(), src.to(torch.int32), "amax")


def scatter_any(n: int, idx, mask):
    """``jnp.zeros(n, bool).at[idx].max(mask)``: True where any masked
    index lands.  Unmasked entries go to a spare slot n."""
    out = torch.zeros(n + 1, dtype=torch.bool, device=mask.device)
    out.index_fill_(0, torch.where(mask, idx.long(), n), True)
    return out[:n]


def _scale_radius(level, base):
    return base * torch.pow(1.2, level.to(torch.float32))


def _cam_center(pose):
    return -quat_rotate(quat_conj(pose[:4]), pose[4:7])


def _match_candidates(cam, pose, xyz, desc, max_dist_bound, cand_ok,
                      frame: FrameData, radius_base, ratio, max_dist,
                      already, query_angle=None):
    """Project candidate points [C] and associate them to frame features.

    ``already`` [F] marks features that must not be re-matched;
    ``query_angle`` [C] turns on the rotation-consistency filter of the
    motion-model search.  Returns (idx [C] int32 or -1, ok [C]).
    """
    uvr, z = project_stereo(cam, se3_apply(pose, xyz))
    pred_lv = predict_scale(
        torch.linalg.vector_norm(xyz - _cam_center(pose)[None], dim=-1),
        max_dist_bound, 1.2, 8)
    x0, x1, y0, y1 = cam.bounds()
    in_img = ((z > 0.2) & (uvr[:, 0] >= x0) & (uvr[:, 0] < x1)
              & (uvr[:, 1] >= y0) & (uvr[:, 1] < y1))
    ok = cand_ok & in_img
    radii = _scale_radius(pred_lv, radius_base)
    idx, _ = search_by_projection(
        uvr[:, :2], radii, pred_lv, desc, ok,
        frame.uv, frame.level, frame.desc, frame.valid & ~already,
        max_dist=max_dist, ratio=ratio)
    if query_angle is not None:
        keep = rotation_consistency_mask(query_angle, frame.angle, idx)
        idx = torch.where(keep, idx, -1)
    return torch.where(ok, idx, -1), ok


def _pose_opt(cam, pose0, frame: FrameData, pw, valid):
    """Motion-only BA of the frame's valid features against points pw
    [F, 3] where ``valid``."""
    obs_uvr = torch.cat([frame.uv, frame.ur[:, None]], dim=-1)
    return pose_optimization_fused(cam, pose0, pw, obs_uvr, frame.level,
                                   frame.ur > 0, valid & frame.valid)


def _pose_opt_from_assoc(cam, pose0, m: MapState, frame: FrameData, assoc):
    """Motion-only BA over the current feature -> point associations."""
    pt = torch.clamp(assoc, min=0).long()
    return _pose_opt(cam, pose0, frame, m.pt_xyz[pt],
                     (assoc >= 0) & m.pt_valid[pt])


def apply_visibility_counters(m: MapState, visible_mask, found_mask
                              ) -> MapState:
    """IncreaseVisible / IncreaseFound (the point-culling signals): add
    the masks [P] to the arena's counters in place; returns ``m``."""
    m.pt_visible.add_(visible_mask.to(torch.int32))
    m.pt_found.add_(found_mask.to(torch.int32))
    return m


def build_track_step(cfg: SlamConfig, local_cand: int = 2048):
    """Return the per-frame tracking step with the fused keyframe
    decision and insertion:

      (m, frame, st, allow_kf, loc_mode=False) -> (new_st, stats [23], m)

    ``allow_kf`` (bool or bool tensor) gates NeedNewKeyFrame;
    ``loc_mode`` (a Python bool) turns on localization-only tracking
    with temporal points; ``m`` is updated in place and returned.
    """
    cam = cfg.camera
    tcfg = cfg.tracking
    create_kf_fn = make_create_keyframe_fn(cfg)
    kf_min = max(tcfg.kf_min_interval, 1)
    max_kf = cfg.map.max_keyframes

    def track_step(m: MapState, frame: FrameData, st: TrackState,
                   allow_kf=False, loc_mode: bool = False):
        P = m.max_points
        F = st.assoc.shape[0]
        pred = torch.where(st.vel_ok, se3_compose(st.velocity, st.pose),
                           st.pose)

        # ---- motion-model stage: re-find the last frame's points -------
        # candidate f is the map point of last-frame feature f or, in
        # localization-only mode, its temporal point (same descriptor)
        prev_pts = torch.clamp(st.assoc, min=0).long()
        map_ok = (st.assoc >= 0) & m.pt_valid[prev_pts]
        cand_xyz, cand_desc, cand_maxd, cand_ok = (
            m.pt_xyz[prev_pts], m.pt_desc[prev_pts], m.pt_max_dist[prev_pts],
            map_ok)
        if loc_mode:
            use_tmp = st.tmp_ok & ~map_ok
            cand_xyz = torch.where(use_tmp[:, None], st.tmp_xyz, cand_xyz)
            cand_desc = torch.where(use_tmp[:, None], st.tmp_desc, cand_desc)
            cand_maxd = torch.where(use_tmp, st.tmp_max_dist, cand_maxd)
            cand_ok = map_ok | use_tmp
        idx1, cok = _match_candidates(
            cam, pred, cand_xyz, cand_desc, cand_maxd, cand_ok, frame,
            radius_base=15.0, ratio=tcfg.nn_ratio_motion, max_dist=100.0,
            already=torch.zeros_like(frame.valid), query_angle=st.angle)
        matched_c = (idx1 >= 0) & cok
        # temporal matches feed the motion-only BA, never the map
        # association
        map_c = matched_c & ~use_tmp if loc_mode else matched_c
        assoc1 = scatter_max(F, torch.clamp(idx1, min=0),
                             torch.where(map_c, prev_pts, -1))
        if loc_mode:
            tmp_src = scatter_max(F, torch.clamp(idx1, min=0), torch.where(
                matched_c & use_tmp,
                torch.arange(F, dtype=torch.int32, device=idx1.device), -1))
            tmp_src = torch.where(assoc1 >= 0, -1, tmp_src)
            pw1 = torch.where((tmp_src >= 0)[:, None],
                              st.tmp_xyz[torch.clamp(tmp_src, min=0).long()],
                              m.pt_xyz[torch.clamp(assoc1, min=0).long()])
            res1 = _pose_opt(cam, pred, frame, pw1,
                             (assoc1 >= 0) | (tmp_src >= 0))
        else:
            res1 = _pose_opt_from_assoc(cam, pred, m, frame, assoc1)
        # TrackReferenceKeyFrame-style fallback: on a collapsed motion
        # stage, drop its pose and associations and search wide from the
        # last frame's pose
        mm_ok = res1.n_inliers >= tcfg.min_inliers_track
        assoc1 = torch.where(mm_ok & res1.inliers, assoc1, -1)
        pose = torch.where(mm_ok, res1.pose, st.pose)
        local_radius = torch.where(mm_ok, 4.0, 25.0)

        # ---- local-map stage -------------------------------------------
        # local-KF vote through the forward observation store; on a
        # motion-stage collapse the previous frame's associations vote
        vote_src = torch.where(mm_ok, assoc1, st.assoc)
        vote_mask_p = scatter_any(P, torch.clamp(vote_src, min=0),
                                  vote_src >= 0)
        matched_mask_p = scatter_any(P, torch.clamp(assoc1, min=0),
                                     assoc1 >= 0)
        obs_pt = torch.clamp(m.kf_point, min=0).long()
        votes = ((m.kf_point >= 0) & vote_mask_p[obs_pt]
                 & m.kf_valid[:, None]).to(torch.int32).sum(1)     # [K]
        nloc = min(tcfg.max_local_keyframes, m.max_keyframes)
        vote_w, local_kf = stable_topk(votes, nloc)
        local_kf_ok = vote_w > 0
        lk_point = m.kf_point[local_kf]                            # [L, F]
        lk_obs = (lk_point >= 0) & local_kf_ok[:, None]
        local_mask = scatter_any(P, torch.clamp(lk_point, min=0).reshape(-1),
                                 lk_obs.reshape(-1)) & m.pt_valid

        vis, _, _, _, _ = in_frustum(cam, pose, m.pt_xyz, m.pt_normal,
                                     m.pt_min_dist, m.pt_max_dist)
        cand_mask = local_mask & vis & ~matched_mask_p
        visible_mask = local_mask & vis
        # the local_cand lowest-index candidates
        _, cand_idx = stable_topk(cand_mask.to(torch.int32), local_cand)
        idx2, ok2 = _match_candidates(
            cam, pose, m.pt_xyz[cand_idx], m.pt_desc[cand_idx],
            m.pt_max_dist[cand_idx], cand_mask[cand_idx], frame,
            radius_base=local_radius, ratio=tcfg.nn_ratio_local,
            max_dist=float(tcfg.th_high), already=assoc1 >= 0)
        assoc2 = scatter_max(F, torch.clamp(idx2, min=0),
                             torch.where((idx2 >= 0) & ok2, cand_idx, -1))
        assoc = torch.where(assoc1 >= 0, assoc1, assoc2)

        res2 = _pose_opt_from_assoc(cam, pose, m, frame, assoc)
        assoc = torch.where(res2.inliers, assoc, -1)
        pose = res2.pose
        found_mask = scatter_any(P, torch.clamp(assoc, min=0), assoc >= 0)

        velocity = se3_compose(pose, se3_inverse(st.pose))
        ok = res2.n_inliers >= tcfg.min_inliers_local
        if loc_mode:
            # visual odometry on temporal points when the map is out of
            # view (the reference's mbVO state)
            ok = ok | (res1.n_inliers >= 20)
        # temporal points from this frame's depth (UpdateLastFrame)
        Twc = se3_inverse(pose)
        t_z = frame.depth
        t_x = (frame.uv[:, 0] - cam.cx) / cam.fx * t_z
        t_y = (frame.uv[:, 1] - cam.cy) / cam.fy * t_z
        tmp_pw = se3_apply(Twc, torch.stack([t_x, t_y, t_z], dim=-1))
        tmp_dist = torch.linalg.vector_norm(
            tmp_pw - _cam_center(pose)[None], dim=-1)
        close = frame.valid & (frame.depth > 0.1) \
            & (frame.depth < tcfg.th_depth)

        apply_visibility_counters(m, visible_mask, found_mask)

        # ---- NeedNewKeyFrame + CreateNewKeyFrame, decided on device ------
        close_tracked = (close & (assoc >= 0)).sum()
        close_unmatched = (close & (assoc < 0)).sum()
        since = st.frames_since_kf + 1
        live = m.kf_valid.sum()
        weak = res2.n_inliers < tcfg.kf_ref_ratio * torch.clamp(
            st.last_kf_inliers, min=1)
        need_close = (close_tracked < 100) & (close_unmatched > 70)
        need = (ok & allow_kf & (since >= kf_min) & (live < max_kf)
                & ((since >= tcfg.kf_max_interval)
                   | ((weak | need_close) & (res2.n_inliers > 15))))
        k, inserted = create_kf_fn(m, frame, pose, assoc, st.frame_id,
                                   st.kf_seq, st.last_kf_slot, enable=need)
        kf_slot = torch.where(inserted, k, -1).to(torch.int32)

        i32 = torch.int32
        new_st = TrackState(
            pose=pose, velocity=velocity, vel_ok=st.ok, assoc=assoc,
            angle=frame.angle, n_inliers=res2.n_inliers, ok=ok,
            frame_id=st.frame_id + 1,
            kf_seq=st.kf_seq + inserted.to(i32),
            last_kf_slot=torch.where(inserted, kf_slot, st.last_kf_slot),
            last_kf_inliers=torch.where(inserted, res2.n_inliers,
                                        st.last_kf_inliers),
            frames_since_kf=torch.where(inserted, 0, since).to(i32),
            tmp_xyz=tmp_pw, tmp_desc=frame.desc,
            tmp_max_dist=tmp_dist * torch.pow(
                1.2, frame.level.to(torch.float32)),
            tmp_ok=close)

        # packed per-frame scalars + pose + ref-KF pose: one pull for the
        # host state machine
        ref_slot = torch.clamp(new_st.last_kf_slot, min=0).long().view(1)
        f32 = torch.float32
        stats = torch.cat([torch.stack([
            res1.n_inliers.to(f32), res2.n_inliers.to(f32), ok.to(f32),
            close_tracked.to(f32), close_unmatched.to(f32),
            (assoc >= 0).sum().to(f32), kf_slot.to(f32),
            new_st.last_kf_slot.to(f32)]),
            pose, m.kf_pose[ref_slot][0],
            m.kf_frame_id[ref_slot].to(f32)])
        return new_st, stats, m

    return track_step


def make_create_keyframe_fn(cfg: SlamConfig, max_new_points: int = 512):
    """CreateNewKeyFrame: write the frame into the first free keyframe
    slot and create map points from its close depth features.

      (m, frame, pose, assoc, frame_id, kf_seq, parent, enable=True)
        -> (kf_slot, ok)

    ``m`` is updated in place; every write is masked by ``ok`` (a free
    slot exists and ``enable``), so a False ``enable`` changes nothing.
    """
    cam = cfg.camera
    close_depth = cfg.tracking.th_depth
    max_new_points = min(max_new_points, cfg.orb.n_features)

    def create_keyframe(m: MapState, frame: FrameData, pose, assoc,
                        frame_id, kf_seq, parent, enable=True):
        dev = pose.device
        kf_slots, kf_ok = allocate_slots(m.kf_valid, 1)
        ok = kf_ok[0] & torch.as_tensor(enable, device=dev)

        # new points from depth: unmatched valid features with depth; all
        # closer than ThDepth, or the 100 closest if fewer are close
        new_src = frame.valid & (assoc < 0) & (frame.depth > 0.1)
        order = torch.sort(
            torch.where(new_src, frame.depth, float("inf")),
            stable=True).indices[:max_new_points]
        rank = torch.arange(max_new_points, device=dev)
        src_ok = new_src[order] & ((frame.depth[order] < close_depth)
                                   | (rank < 100))
        pt_slots, pt_free = allocate_slots(m.pt_valid, max_new_points)
        create = src_ok & pt_free & ok

        f_uv = frame.uv[order]
        f_depth = frame.depth[order]
        x = (f_uv[:, 0] - cam.cx) / cam.fx * f_depth
        y = (f_uv[:, 1] - cam.cy) / cam.fy * f_depth
        pw = se3_apply(se3_inverse(pose), torch.stack([x, y, f_depth], -1))
        vec = pw - _cam_center(pose)[None]
        dist = torch.linalg.vector_norm(vec, dim=-1)
        normal = vec / torch.clamp(dist[:, None], min=1e-9)
        max_d = dist * torch.pow(1.2, frame.level[order].to(torch.float32))
        min_d = max_d / (1.2 ** 7)

        def put(arr, idx, val, mask):
            mask = mask.reshape(mask.shape + (1,) * (arr.dim() - 1))
            arr.index_put_((idx,), torch.where(mask, val.to(arr.dtype),
                                               arr[idx]))

        ones = torch.ones_like(pt_slots)
        put(m.pt_xyz, pt_slots, pw, create)
        put(m.pt_desc, pt_slots, frame.desc[order], create)
        put(m.pt_normal, pt_slots, normal, create)
        put(m.pt_min_dist, pt_slots, min_d, create)
        put(m.pt_max_dist, pt_slots, max_d, create)
        put(m.pt_valid, pt_slots, ones.bool(), create)
        put(m.pt_visible, pt_slots, ones, create)
        put(m.pt_found, pt_slots, ones, create)
        put(m.pt_first_kf, pt_slots,
            ones * torch.as_tensor(kf_seq, device=dev), create)

        # keyframe record: existing associations + the new points
        kf_point = assoc.clone()
        kf_point[order] = torch.where(create, pt_slots, kf_point[order]).to(
            kf_point.dtype)
        k = kf_slots
        okk = ok.view(1)
        put(m.kf_pose, k, pose[None], okk)
        put(m.kf_valid, k, okk, okk)
        put(m.kf_frame_id, k, torch.as_tensor(frame_id, device=dev).view(1),
            okk)
        put(m.kf_uv, k, frame.uv[None], okk)
        put(m.kf_ur, k, frame.ur[None], okk)
        put(m.kf_level, k, frame.level[None], okk)
        put(m.kf_angle, k, frame.angle[None], okk)
        put(m.kf_desc, k, frame.desc[None], okk)
        put(m.kf_feat_valid, k, frame.valid[None], okk)
        put(m.kf_depth, k, frame.depth[None], okk)
        put(m.kf_point, k, kf_point[None], okk)
        put(m.kf_parent, k, torch.as_tensor(parent, device=dev).view(1), okk)
        return k[0], ok

    return create_keyframe


def build_create_keyframe(cfg: SlamConfig, max_new_points: int = 512):
    """Keyframe insertion as a standalone step (the RGB-D initializer)."""
    return make_create_keyframe_fn(cfg, max_new_points)
