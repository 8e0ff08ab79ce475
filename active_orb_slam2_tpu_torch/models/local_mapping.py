"""Local mapping at each keyframe event: point creation by triangulation,
fusion with the neighbours, point culling, local BA, keyframe culling.

Port of ``active_orb_slam2_tpu/models/local_mapping.py``.  The stages
are the same functions of the map on the same fixed shapes, and
:func:`build_keyframe_mapping` runs them as one call per keyframe event
with the covisibility matrix computed once, at the start.  Each stage
computes its new fields from the arena and the keyframe-mapping call
writes them back into the arena in place.  No
stage calls ``.item()``, ``bool()`` or ``.cpu()`` or builds a device
tensor from Python data; ``kf_slot`` and ``kf_seq`` may be Python ints
or device tensors.

Differences in form: ``jax.vmap`` over the neighbours is a batch
dimension or a Python loop of 8, ``lax.scan`` a Python loop,
``lax.top_k`` the stable top-k of ``ops/topk.py``.

One difference in result.  The JAX package writes several results back
with scatters whose masked lanes write the old value at the same or a
clipped index (``local_mapping.py:159-164``, ``:368``, ``:509-514``,
``:518-520``); on the CPU the last lane wins, so a masked lane can
undo an active lane's write.  The local-BA write-back loses every
optimized pose that way whenever a local camera reappears as a masked
lane of the fixed ring.  The port writes what the masks say: only
active lanes write (masked lanes go to a spare cell that is dropped),
and where two active lanes of the fusion write one cell the last of
them wins, as in the JAX package's in-order scatter.
"""

import torch

from active_orb_slam2_tpu_torch.config import SlamConfig
from active_orb_slam2_tpu_torch.geometry.projection import project_stereo
from active_orb_slam2_tpu_torch.geometry.se3 import (
    _hat, quat_to_mat, se3_apply, se3_compose, se3_inverse)
from active_orb_slam2_tpu_torch.geometry.triangulation import (
    triangulate_pairs)
from active_orb_slam2_tpu_torch.models.map_state import (
    MapState, allocate_slots, camera_centers, covisibility_weights,
    point_observation_count, scatter_or, update_point_stats)
from active_orb_slam2_tpu_torch.models.optimizer import (
    BAEdges, bundle_adjustment)
from active_orb_slam2_tpu_torch.ops.matching import (
    hamming_matrix, match_mutual, search_by_projection)
from active_orb_slam2_tpu_torch.ops.topk import stable_topk

BIG_FID = 2 ** 30
N_NEIGHBORS = 8          # covisible neighbours searched per keyframe
MAX_NEW_POINTS = 512     # points created per keyframe event at most
REDUNDANCY = 0.9         # KeyFrameCulling: share of redundant points


def _as_index(k, device):
    """A keyframe slot (Python int or tensor) as a long tensor [1]."""
    if isinstance(k, torch.Tensor):
        return k.to(device=device, dtype=torch.long).reshape(1)
    return torch.full((1,), int(k), dtype=torch.long, device=device)


def _as_int32(v, device):
    """A counter (Python int or tensor) as an int32 tensor []."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32).reshape(())
    return torch.full((), int(v), dtype=torch.int32, device=device)


def masked_put(arr, idx, val, mask):
    """``arr[idx[i]] = val[i]`` for the lanes where ``mask[i]``; the other
    lanes write nothing (they go to a spare row that is dropped).
    Returns a new tensor; active indices must be distinct."""
    n = arr.shape[0]
    buf = torch.cat([arr, arr[:1]])
    buf[torch.where(mask, idx.long(), n)] = val.to(arr.dtype)
    return buf[:n]


def last_lane_put(arr, idx, val, mask):
    """``masked_put`` where several active lanes may share an index: the
    highest lane wins, as an in-order scatter leaves it."""
    n = arr.shape[0]
    lanes = torch.arange(idx.shape[0], device=idx.device)
    tgt = torch.where(mask, idx.long(), n)
    last = torch.full((n + 1,), -1, dtype=torch.long, device=idx.device)
    last.scatter_reduce_(0, tgt, lanes, "amax")
    return masked_put(arr, idx, val, mask & (last[tgt] == lanes))


def _neighbours(m: MapState, ks, W, n: int):
    """The n most covisible live keyframes of slot ks [1] (padding has
    weight 0 and is not ok)."""
    row = torch.where(m.kf_valid, W.index_select(0, ks)[0], 0)
    w_n, nbrs = stable_topk(row.index_fill(0, ks, 0), n)
    return nbrs, (w_n > 0) & m.kf_valid[nbrs]


def _kinv(cam, device):
    """K^-1 [3, 3], made on the device by fills (assigning a Python float
    to an element copies it from the host and waits on the card)."""
    def c(v):
        return torch.full((), v, device=device)
    return torch.stack([c(1.0 / cam.fx), c(0.0), c(-cam.cx / cam.fx),
                        c(0.0), c(1.0 / cam.fy), c(-cam.cy / cam.fy),
                        c(0.0), c(0.0), c(1.0)]).view(3, 3)


def write_back(m: MapState, new: MapState) -> MapState:
    """Copy every field of ``new`` that differs in identity into the
    arena ``m`` in place; returns ``m``."""
    for f in MapState._fields:
        src, dst = getattr(new, f), getattr(m, f)
        if src is not dst:
            dst.copy_(src)
    return m


# ------------------------------------------------------- CreateNewMapPoints

def make_create_points_body(cfg: SlamConfig):
    """``LocalMapping::CreateNewMapPoints``: for the best covisible
    neighbours, epipolar-gated mutual matching of unmatched features,
    two-view triangulation, parallax / chirality / reprojection gates,
    allocation with observations in both keyframes.

    (m, kf_slot, kf_seq, W) -> MapState with new fields."""
    cam = cfg.camera

    def create_points(m: MapState, kf_slot, kf_seq, W):
        F = m.n_features
        P = m.max_points
        dev = m.kf_pose.device
        ks = _as_index(kf_slot, dev)
        nbrs, nbr_ok = _neighbours(m, ks, W, N_NEIGHBORS)
        N = nbrs.shape[0]

        pose_k = m.kf_pose.index_select(0, ks)[0]
        kp_k = m.kf_point.index_select(0, ks)[0]
        free_k = m.kf_feat_valid.index_select(0, ks)[0] & (kp_k < 0)
        desc_k = m.kf_desc.index_select(0, ks)[0]
        uv_k = m.kf_uv.index_select(0, ks)[0]
        lvl_k = m.kf_level.index_select(0, ks)[0]
        pose_n = m.kf_pose[nbrs]                               # [N, 7]
        free_n = (m.kf_feat_valid[nbrs] & (m.kf_point[nbrs] < 0)
                  & nbr_ok[:, None])                           # [N, F]
        desc_n, uv_n, lvl_n = m.kf_desc[nbrs], m.kf_uv[nbrs], m.kf_level[nbrs]

        Kinv = _kinv(cam, dev)
        ones = torch.ones((F, 1), device=dev)
        p_k = torch.cat([uv_k, ones], -1)
        idx_all = []
        for j in range(N):
            d = hamming_matrix(desc_k, desc_n[j], free_k, free_n[j])
            # epipolar gate x_n^T F_nk x_k = 0, F = K^-T [t]x R K^-1
            T_nk = se3_compose(pose_n[j], se3_inverse(pose_k))
            E = _hat(T_nk[4:7]) @ quat_to_mat(T_nk[:4])
            Fm = Kinv.T @ E @ Kinv
            p_n = torch.cat([uv_n[j], ones], -1)
            l = p_k @ Fm.T                                     # [F, 3]
            # as the JAX package computes it (``local_mapping.py:80-85``):
            # its einsum yields [F_k, F_n], so the line norm, the sigma
            # and the final transpose index the wrong feature of each
            # pair (ROADMAP queue 3, item h); kept for parity
            d_ep = ((l @ p_n.T) ** 2 / torch.clamp(
                l[None, :, 0] ** 2 + l[None, :, 1] ** 2, min=1e-12))
            sigma2_n = torch.pow(1.2, 2.0 * lvl_n[j].to(torch.float32))
            ep_ok = d_ep < (3.84 * sigma2_n)[:, None]
            d = torch.where(ep_ok.T, d, 1e9)
            idx, _ = match_mutual(d, max_dist=50.0, ratio=0.8)
            idx_all.append(idx)
        idx = torch.stack(idx_all)                             # [N, F]
        matched = idx >= 0
        nidx = torch.clamp(idx, min=0).long()
        uv_m = torch.gather(uv_n, 1, nidx[..., None].expand(N, F, 2))
        xw, okt = triangulate_pairs(cam, pose_k, pose_n[:, None, :],
                                    uv_k[None], uv_m)          # [N, F, 3]
        pc_k = se3_apply(pose_k, xw)
        pc_n = se3_apply(pose_n[:, None, :], xw)
        ow_n = camera_centers(pose_n)
        ow_k = camera_centers(pose_k[None])[0]
        r1 = xw - ow_k
        r2 = xw - ow_n[:, None, :]
        cosp = (r1 * r2).sum(-1) / torch.clamp(
            torch.linalg.vector_norm(r1, dim=-1)
            * torch.linalg.vector_norm(r2, dim=-1), min=1e-12)

        def reproj_err(pc, uv):
            z = torch.clamp(pc[..., 2], min=1e-6)
            pr = torch.stack([cam.fx * pc[..., 0] / z + cam.cx,
                              cam.fy * pc[..., 1] / z + cam.cy], -1)
            return ((pr - uv) ** 2).sum(-1)

        s2k = torch.pow(1.2, 2.0 * lvl_k.to(torch.float32))
        s2n = torch.pow(1.2, 2.0 * torch.gather(lvl_n, 1, nidx)
                        .to(torch.float32))
        good = (matched & okt & (pc_k[..., 2] > 0) & (pc_n[..., 2] > 0)
                & (cosp < 0.9998)
                & (reproj_err(pc_k, uv_k) < 5.991 * s2k)
                & (reproj_err(pc_n, uv_m) < 5.991 * s2n))

        # per new-keyframe feature: the first neighbour with a good
        # triangulation
        any_good = good.any(0)
        first_n = torch.argmax(good.to(torch.uint8), dim=0)    # [F]
        sel_xw = torch.gather(xw, 0, first_n[None, :, None].expand(1, F, 3))[0]
        sel_nidx = torch.gather(idx, 0, first_n[None])[0]
        sel_nbr = nbrs[first_n]

        order = torch.sort((~any_good).to(torch.uint8),
                           stable=True).indices[:MAX_NEW_POINTS]
        src_ok = any_good[order]
        slots, free = allocate_slots(m.pt_valid, MAX_NEW_POINTS)
        create = src_ok & free

        pw = sel_xw[order]
        vec = pw - ow_k[None]
        dist = torch.linalg.vector_norm(vec, dim=-1)
        normal = vec / torch.clamp(dist[:, None], min=1e-9)
        max_d = dist * torch.pow(1.2, lvl_k[order].to(torch.float32))
        min_d = max_d / (1.2 ** 7)
        ones_i = torch.ones_like(slots, dtype=torch.int32)

        def put(arr, val):
            return masked_put(arr, slots, val, create)

        kfp = m.kf_point.view(-1)
        kfp = masked_put(kfp, ks * F + order, slots, create)
        kfp = masked_put(kfp, sel_nbr[order] * F
                         + torch.clamp(sel_nidx[order], min=0), slots, create)
        return m._replace(
            pt_xyz=put(m.pt_xyz, pw),
            pt_desc=put(m.pt_desc, desc_k[order]),
            pt_normal=put(m.pt_normal, normal),
            pt_min_dist=put(m.pt_min_dist, min_d),
            pt_max_dist=put(m.pt_max_dist, torch.clamp(max_d, min=1e-3)),
            pt_valid=put(m.pt_valid, create),
            pt_visible=put(m.pt_visible, ones_i),
            pt_found=put(m.pt_found, ones_i),
            pt_first_kf=put(m.pt_first_kf, ones_i * _as_int32(kf_seq, dev)),
            kf_point=kfp.view(m.max_keyframes, F))

    return create_points


# --------------------------------------------------------- KeyFrameCulling

def make_cull_body(cfg: SlamConfig, force: bool = False):
    """``LocalMapping::KeyFrameCulling``: a covisible keyframe is redundant
    when more than 90% of its tracked points are seen by at least 3 other
    keyframes at the same or a finer scale (octave <= its own + 1).  At
    most one keyframe is culled per call; the anchor (oldest live) and
    the current keyframe never are.  ``force=True`` (arena full) evicts
    the most redundant keyframe when none passes the rule.  Children of
    the victim are re-parented onto their most covisible live, older
    keyframe.

    (m, kf_slot, W) -> (MapState with new fields, victim slot or -1)."""
    L = cfg.orb.n_levels

    def cull(m: MapState, kf_slot, W):
        K, P = m.max_keyframes, m.max_points
        dev = m.kf_pose.device
        ks = _as_index(kf_slot, dev)
        pt = torch.clamp(m.kf_point, min=0).long()
        obs = (m.kf_point >= 0) & m.kf_valid[:, None] & m.kf_feat_valid
        tracked = obs & m.pt_valid[pt]
        lvl = torch.clamp(m.kf_level, 0, L - 1).long()
        # per-point octave histogram of all valid observations, cumulated
        hist = torch.zeros(P * L, dtype=torch.int32, device=dev).index_add_(
            0, (pt * L + lvl).reshape(-1), obs.reshape(-1).to(torch.int32))
        cum = torch.cumsum(hist.view(P, L), dim=1).to(torch.int32).view(-1)
        # other observations at octave <= l + 1 (this one excluded)
        fine = cum[pt * L + torch.clamp(lvl + 1, 0, L - 1)] - 1
        redundant_obs = tracked & (fine >= 3)
        n_tracked = tracked.sum(1)
        frac = redundant_obs.sum(1) / torch.clamp(n_tracked, min=1)
        covis = W.index_select(0, ks)[0] >= 15
        cand = m.kf_valid & covis & (frac > REDUNDANCY) & (n_tracked > 0)
        fid = torch.where(m.kf_valid, m.kf_frame_id, BIG_FID)
        anchor = torch.argmin(fid).view(1)                    # first min
        cand = cand.index_fill(0, ks, False).index_fill(0, anchor, False)
        if force:
            fallback = (m.kf_valid & (n_tracked > 0)).index_fill(
                0, ks, False).index_fill(0, anchor, False)
            cand = torch.where(cand.any(), cand, fallback)
        victim = torch.argmax(torch.where(cand, frac, -1.0)).view(1)
        do = cand[victim]                                     # [1]
        vmask = (torch.arange(K, device=dev) == victim) & do

        kf_valid = m.kf_valid & ~vmask
        kfp = torch.where(vmask[:, None], -1, m.kf_point)
        # re-parent the victim's children onto their most covisible live
        # keyframe that is older than the child (keeps the tree acyclic)
        cand_W = torch.where(kf_valid[None, :], W, -1)
        older = m.kf_frame_id[None, :] < m.kf_frame_id[:, None]
        cand_W = torch.where(older, cand_W, -1)
        cand_W = cand_W - torch.eye(K, dtype=cand_W.dtype,
                                    device=dev) * (10 ** 9)
        best = torch.argmax(cand_W, dim=1)
        best_ok = torch.gather(cand_W, 1, best[:, None])[:, 0] > 0
        vparent = m.kf_parent[victim]                         # [1]
        vp_live = (vparent >= 0) & kf_valid[
            torch.clamp(vparent, min=0).long()]
        fallback_p = torch.where(vp_live, vparent, anchor.to(vparent.dtype))
        newp = torch.where(best_ok, best.to(m.kf_parent.dtype), fallback_p)
        new_parent = torch.where(do & (m.kf_parent == victim), newp,
                                 m.kf_parent)
        # the anchor stays a root if it was the victim's child
        at_anchor = new_parent[anchor]
        new_parent = new_parent.index_put(
            (anchor,), torch.where(at_anchor == anchor.to(at_anchor.dtype),
                                   -1, at_anchor))
        victim_out = torch.where(do, victim, -1).to(torch.int32)[0]
        return m._replace(kf_valid=kf_valid, kf_point=kfp,
                          kf_parent=new_parent), victim_out

    return cull


# -------------------------------------------------------- SearchInNeighbors

def make_fuse_body(cfg: SlamConfig):
    """``LocalMapping::SearchInNeighbors``: project the new keyframe's
    points into its covisible neighbours, fuse duplicates (the older,
    lower-slot point survives) and add observations where the matched
    feature had none.

    (m, kf_slot, W) -> MapState with new kf_point and pt_valid."""
    cam = cfg.camera
    x0, x1, y0, y1 = cam.bounds()

    def fuse(m: MapState, kf_slot, W):
        P, F = m.max_points, m.n_features
        dev = m.kf_pose.device
        ks = _as_index(kf_slot, dev)
        kp_k = m.kf_point.index_select(0, ks)[0]
        src_pts = torch.clamp(kp_k, min=0).long()
        src_ok = (kp_k >= 0) & m.pt_valid[src_pts]
        src_xyz, src_desc = m.pt_xyz[src_pts], m.pt_desc[src_pts]
        nbrs, nbr_ok = _neighbours(m, ks, W, N_NEIGHBORS)

        rep = torch.arange(P, device=dev)
        kfp = m.kf_point.reshape(-1)
        replaced = torch.zeros(P, dtype=torch.bool, device=dev)
        radii = torch.full((F,), 4.0, device=dev)
        pred_lv = torch.zeros(F, dtype=torch.int32, device=dev)
        for j in range(nbrs.shape[0]):
            n = nbrs[j:j + 1]
            uvr, z = project_stereo(cam, se3_apply(m.kf_pose[n][0], src_xyz))
            inb = (nbr_ok[j] & src_ok & (z > 0.2)
                   & (uvr[:, 0] >= x0) & (uvr[:, 0] < x1)
                   & (uvr[:, 1] >= y0) & (uvr[:, 1] < y1))
            idx, _ = search_by_projection(
                uvr[:, :2], radii, pred_lv, src_desc, inb,
                m.kf_uv[n][0], m.kf_level[n][0], m.kf_desc[n][0],
                m.kf_feat_valid[n][0], max_dist=50.0, ratio=1.0,
                level_window=8)
            matched = (idx >= 0) & inb
            cell = n * F + torch.clamp(idx, min=0).long()
            old = kfp[cell].long()
            # duplicate: the neighbour feature already tracks another
            # point -> keep the older (lower slot) of the two
            dup = matched & (old >= 0) & (old != src_pts)
            keep_old = dup & (old < src_pts)
            keep_new = dup & ~keep_old
            tgt = torch.cat([old, src_pts])
            act = torch.cat([keep_new, keep_old])
            rep = last_lane_put(rep, tgt, torch.cat([src_pts, old]), act)
            replaced = replaced | scatter_or(P, tgt, act)
            # unmatched feature: add the observation
            kfp = masked_put(kfp, cell, src_pts, matched & (old < 0))
        # transitive closure over replacement chains
        for _ in range(3):
            rep = rep[rep]
        kfp = kfp.view(m.max_keyframes, F)
        kfp = torch.where(kfp >= 0, rep[torch.clamp(kfp, min=0).long()]
                          .to(kfp.dtype), kfp)
        return m._replace(kf_point=kfp, pt_valid=m.pt_valid & ~replaced)

    return fuse


# ------------------------------------------- MapPointCulling and local BA

def cull_map_points(m: MapState, kf_seq) -> MapState:
    """``LocalMapping::MapPointCulling``: drop points with a found /
    visible ratio under 0.25 (seen at least 8 times), or not observed by
    a second keyframe 3 keyframe insertions after their creation, and
    erase their observations."""
    n_obs = point_observation_count(m)
    found_ratio = m.pt_found.to(torch.float32) / torch.clamp(
        m.pt_visible.to(torch.float32), min=1.0)
    age = _as_int32(kf_seq, m.pt_valid.device) - m.pt_first_kf
    bad = m.pt_valid & (((m.pt_visible >= 8) & (found_ratio < 0.25))
                        | ((age >= 3) & (n_obs <= 1)))
    pt_valid = m.pt_valid & ~bad
    pt = torch.clamp(m.kf_point, min=0).long()
    return m._replace(pt_valid=pt_valid, kf_point=torch.where(
        (m.kf_point >= 0) & ~pt_valid[pt], -1, m.kf_point))


def local_ba_window(cfg: SlamConfig, m: MapState, kf_slot, W):
    """The local BA window of ``Optimizer::LocalBundleAdjustment``: local
    cameras (the new keyframe and its L-1 most covisible ones with weight
    >= 15), the local points they observe (at most Pl, lowest slots
    first), a fixed ring of the Lf keyframes that observe the most local
    points, and one edge per (camera, feature) with a local point.

    Returns (cams [Lt], cams_ok [Lt], fixed_flag [Lt], pt_sel [Pl],
    pt_sel_ok [Pl], edges)."""
    L = Lf = cfg.map.local_ba_keyframes
    Pl = cfg.map.local_ba_points
    K, P, F = m.max_keyframes, m.max_points, m.n_features
    dev = m.kf_pose.device
    ks = _as_index(kf_slot, dev)

    row = torch.where(m.kf_valid, W.index_select(0, ks)[0], 0)
    w_loc, loc = stable_topk(row.index_fill(0, ks, 0), L - 1)
    local_cams = torch.cat([ks, loc])
    # weakly connected keyframes (weight < 15) are not free local
    # cameras; they join the fixed ring if they observe local points
    local_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          w_loc >= 15]) & m.kf_valid[local_cams]

    lk_point = m.kf_point[local_cams]
    pt_mask = scatter_or(P, torch.clamp(lk_point, min=0),
                         (lk_point >= 0) & local_ok[:, None]) & m.pt_valid
    pt_sel = torch.sort((~pt_mask).to(torch.uint8), stable=True).indices[:Pl]
    pt_sel_ok = pt_mask[pt_sel]
    loc_of_pt = torch.full((P,), -1, dtype=torch.long, device=dev)
    loc_of_pt[pt_sel] = torch.where(
        pt_sel_ok, torch.arange(pt_sel.shape[0], device=dev), -1)

    # fixed ring: keyframes observing selected points, not local
    pt = torch.clamp(m.kf_point, min=0).long()
    obs_sel = (m.kf_point >= 0) & (loc_of_pt[pt] >= 0)
    kf_votes = (obs_sel & m.kf_valid[:, None]).sum(1)
    is_local = scatter_or(K, local_cams, local_ok)
    kf_votes = torch.where(is_local, 0, kf_votes)
    w_fix, fix = stable_topk(kf_votes, Lf)
    fixed_ok = (w_fix > 0) & m.kf_valid[fix]

    cams = torch.cat([local_cams, fix])                       # [Lt]
    cams_ok = torch.cat([local_ok, fixed_ok])
    fixed_flag = torch.cat([torch.zeros(L, dtype=torch.bool, device=dev),
                            torch.ones(Lf, dtype=torch.bool, device=dev)])
    # no natural fixed ring (early map): pin the two oldest local cams
    ages = torch.where(local_ok, m.kf_frame_id[local_cams], BIG_FID)
    order2 = torch.sort(ages, stable=True).indices[:2]
    fixed_flag[order2] = fixed_flag[order2] | ~fixed_ok.any()

    Lt = L + Lf
    cam_pt = m.kf_point[cams]                                 # [Lt, F]
    e_pt_loc = loc_of_pt[torch.clamp(cam_pt, min=0).long()]
    e_valid = ((cam_pt >= 0) & (e_pt_loc >= 0) & cams_ok[:, None]
               & m.kf_feat_valid[cams])
    e_cam = torch.arange(Lt, device=dev)[:, None].expand(Lt, F)
    obs_uvr = torch.cat([m.kf_uv[cams], m.kf_ur[cams][..., None]], -1)
    edges = BAEdges(
        cam_idx=e_cam.reshape(-1),
        pt_idx=torch.clamp(e_pt_loc, min=0).reshape(-1),
        obs_uvr=obs_uvr.reshape(-1, 3),
        level=m.kf_level[cams].reshape(-1),
        has_stereo=(m.kf_ur[cams] > 0).reshape(-1),
        valid=e_valid.reshape(-1))
    # a free camera needs enough edges for its 6-DoF pose: else pin it
    fixed_flag = fixed_flag | (e_valid.sum(1) < 12)
    return cams, cams_ok, fixed_flag, pt_sel, pt_sel_ok, edges


def make_mapping_body(cfg: SlamConfig):
    """MapPointCulling, then local BA over :func:`local_ba_window` with the
    4 + 8 schedule, the write-back, the erasure of outlier observations
    and the point-stat refresh.

    (m, kf_slot, kf_seq, W) -> MapState with new fields."""
    cam = cfg.camera

    def mapping_step(m: MapState, kf_slot, kf_seq, W):
        K, F = m.max_keyframes, m.n_features
        dev = m.kf_pose.device
        m = cull_map_points(m, kf_seq)
        cams, cams_ok, fixed_flag, pt_sel, pt_sel_ok, edges = \
            local_ba_window(cfg, m, kf_slot, W)
        res = bundle_adjustment(cam, m.kf_pose[cams], m.pt_xyz[pt_sel], edges,
                                fixed_cam=fixed_flag | ~cams_ok,
                                iters_a=4, iters_b=8)
        # write back what the masks say: each free local camera once,
        # each selected point once
        kf_pose = masked_put(m.kf_pose, cams, res.poses, cams_ok & ~fixed_flag)
        pt_xyz = masked_put(m.pt_xyz, pt_sel, res.points, pt_sel_ok)
        # erase the outlier observations of valid edges
        Lt = cams.shape[0]
        bad_edge = (edges.valid & ~res.edge_inliers).view(Lt, F)
        cell = cams[:, None] * F + torch.arange(F, device=dev)
        erase = scatter_or(K * F, cell, bad_edge).view(K, F)
        m = m._replace(kf_pose=kf_pose, pt_xyz=pt_xyz,
                       kf_point=torch.where(erase, -1, m.kf_point))
        return update_point_stats(m)

    return mapping_step


# ---------------------------------------------------------- standalone steps

def _standalone(body):
    def step(m: MapState, kf_slot, *args):
        return write_back(m, body(m, kf_slot, *args,
                                  covisibility_weights(m)))
    return step


def build_create_new_map_points(cfg: SlamConfig):
    """(m, kf_slot, kf_seq) -> m, CreateNewMapPoints alone (computes W)."""
    return _standalone(make_create_points_body(cfg))


def build_fuse_neighbors(cfg: SlamConfig):
    """(m, kf_slot) -> m, SearchInNeighbors alone (computes W)."""
    return _standalone(make_fuse_body(cfg))


def build_mapping_step(cfg: SlamConfig):
    """(m, kf_slot, kf_seq) -> m, point culling + local BA alone."""
    return _standalone(make_mapping_body(cfg))


def build_keyframe_culling(cfg: SlamConfig, force: bool = False):
    """(m, kf_slot) -> (m, victim), KeyFrameCulling alone (computes W)."""
    body = make_cull_body(cfg, force)

    def cull(m: MapState, kf_slot):
        new, victim = body(m, kf_slot, covisibility_weights(m))
        return write_back(m, new), victim

    return cull


def build_keyframe_mapping(cfg: SlamConfig, triangulate: bool = True,
                           fuse: bool = True, local_ba: bool = True,
                           cull: bool = True):
    """The keyframe-rate mapping pipeline as one call:

      CreateNewMapPoints -> SearchInNeighbors -> MapPointCulling + local
      BA -> KeyFrameCulling

    with the covisibility matrix computed once at the start; every stage
    reads it.  ``triangulate``, ``fuse``, ``local_ba`` and ``cull`` gate
    the stages, as in the JAX package (the endurance script's bisection
    switches): MapPointCulling goes with local BA, and with ``cull`` off
    the victim is -1 and the snapshots are slot 0's.

    Returns (m, kf_slot, kf_seq) -> (m, victim, vparent, vpose, vppose,
    W_out); ``m`` is updated in place.  ``vparent``, ``vpose`` and
    ``vppose`` are the victim's spanning-tree parent, its pose and the
    parent's pose, taken inside the call, since the host reads them one
    keyframe event later; ``W_out`` is the covisibility matrix of the
    updated map, which the loop closer reads.
    """
    create_body = make_create_points_body(cfg) if triangulate else None
    fuse_body = make_fuse_body(cfg) if fuse else None
    map_body = make_mapping_body(cfg) if local_ba else None
    cull_body = make_cull_body(cfg) if cull else None

    def keyframe_mapping(m: MapState, kf_slot, kf_seq):
        W = covisibility_weights(m)
        new = m
        if create_body is not None:
            new = create_body(new, kf_slot, kf_seq, W)
        if fuse_body is not None:
            new = fuse_body(new, kf_slot, W)
        if map_body is not None:
            new = map_body(new, kf_slot, kf_seq, W)
        if cull_body is not None:
            new, victim = cull_body(new, kf_slot, W)
        else:
            victim = torch.full((), -1, dtype=torch.int32,
                                device=m.kf_pose.device)
        vc = torch.clamp(victim, min=0).long().view(1)
        vparent = new.kf_parent[vc]
        vpose = new.kf_pose[vc][0]
        vppose = new.kf_pose[torch.clamp(vparent, min=0).long()][0]
        write_back(m, new)
        return m, victim, vparent[0], vpose, vppose, covisibility_weights(m)

    return keyframe_mapping
