"""The map arena: fixed-shape tensors for points and keyframes, and the
views derived from the observation store.

Port of ``active_orb_slam2_tpu/models/map_state.py``.  The fields, shapes
and meanings are the JAX package's; descriptors are int32 with the
uint32 bits.  Unlike the JAX pytree, the port's arena is preallocated
once and updated in place by the tracking step and the keyframe mapping
(masked writes), so neither copies the map.

Observations are stored forward, as the per-keyframe feature -> point
index map ``kf_point [K, F]`` (-1 = none).  Differences in form:

* ``.at[].max`` on bool is an OR: ``index_fill_`` of True, with the
  unmasked lanes sent to a spare slot that is sliced off;
* the covisibility product of 0/1 indicators is an exact count in
  float32 (TF32 stays off), where the JAX package uses bf16 inputs;
* the medoid descriptor takes its pairwise Hamming distances by XOR and
  popcount (the JAX package's +-1 bf16 product is a TPU stand-in for
  popcount), and the observer lists are written by plain indexing into
  a spare row, since a scatter-max over int32 words would mis-order the
  uint32 bits.
"""

from typing import NamedTuple

import torch

from active_orb_slam2_tpu_torch.config import MapConfig, OrbConfig
from active_orb_slam2_tpu_torch.geometry.se3 import quat_conj, quat_rotate
from active_orb_slam2_tpu_torch.ops.topk import stable_topk

MAX_OBS = 12    # observer descriptors kept per point for the medoid


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


# ------------------------------------------------------------- derived views

def scatter_or(n: int, idx, mask):
    """``jnp.zeros(n, bool).at[idx].max(mask)`` for any shape of idx and
    mask: True where a masked index lands (unmasked lanes go to a spare
    slot n)."""
    out = torch.zeros(n + 1, dtype=torch.bool, device=mask.device)
    out.index_fill_(0, torch.where(mask, idx, n).reshape(-1).long(), True)
    return out[:n]


def observation_indicator(m: MapState):
    """[K, P] bool: keyframe k observes point p (valid both)."""
    K, F = m.kf_point.shape
    P = m.max_points
    flat = (torch.arange(K, device=m.kf_point.device)[:, None] * P
            + torch.clamp(m.kf_point, min=0))
    ind = scatter_or(K * P, flat, m.kf_point >= 0).view(K, P)
    return ind & m.kf_valid[:, None] & m.pt_valid[None, :]


def point_observation_count(m: MapState):
    """[P] int32: MapPoint::Observations() for every point."""
    return observation_indicator(m).sum(0).to(torch.int32)


def covisibility_weights(m: MapState):
    """[K, K] int32 shared-point counts (KeyFrame::UpdateConnections), zero
    on the diagonal: one float32 product of the 0/1 indicator, exact."""
    ind = observation_indicator(m).to(torch.float32)
    W = (ind @ ind.T).to(torch.int32)
    return W.fill_diagonal_(0)


def best_covisible(m: MapState, kf_idx, n: int, min_weight: int = 0):
    """Top-n covisible keyframe slots of ``kf_idx``
    (GetBestCovisibilityKeyFrames).  Returns (idx [n], weights [n]);
    weight-0 entries are padding and their idx is -1."""
    W = covisibility_weights(m)
    row = torch.where(m.kf_valid, W[kf_idx], 0)
    row = torch.where(torch.arange(m.max_keyframes, device=row.device)
                      == kf_idx, 0, row)
    row = torch.where(row >= max(min_weight, 1), row, 0)
    w, idx = stable_topk(row, n)
    return torch.where(w > 0, idx, -1), w


def camera_centers(kf_pose):
    """[K, 7] Tcw -> [K, 3] camera centres Ow = -R^T t."""
    return -quat_rotate(quat_conj(kf_pose[:, :4]), kf_pose[:, 4:7])


def update_point_stats(m: MapState) -> MapState:
    """Batch recompute of the derived point state: distinctive descriptor,
    mean viewing direction, scale-invariance distances
    (``MapPoint::{ComputeDistinctiveDescriptors, UpdateNormalAndDepth}``).
    Returns a MapState with new pt_normal, pt_min_dist, pt_max_dist and
    pt_desc; the other fields are m's."""
    K, F = m.kf_point.shape
    P = m.max_points
    dev = m.kf_point.device
    obs = (m.kf_point >= 0) & m.kf_valid[:, None]
    pt = torch.clamp(m.kf_point, min=0).long()

    ow = camera_centers(m.kf_pose)                          # [K, 3]
    vec = m.pt_xyz[pt] - ow[:, None, :]                     # [K, F, 3]
    dist = torch.linalg.vector_norm(vec, dim=-1)            # [K, F]
    unit = vec / torch.clamp(dist[..., None], min=1e-9)
    flat_pt = pt.reshape(-1)
    w = obs.reshape(-1).to(torch.float32)
    nsum = torch.zeros((P, 3), device=dev).index_add_(
        0, flat_pt, unit.reshape(-1, 3) * w[:, None])
    cnt = torch.zeros(P, device=dev).index_add_(0, flat_pt, w)
    normal = nsum / torch.clamp(cnt[:, None], min=1.0)
    normal = normal / torch.clamp(
        torch.linalg.vector_norm(normal, dim=-1, keepdim=True), min=1e-9)

    # scale-invariance distances from the observation in the highest
    # keyframe slot (the JAX package's stand-in for mpRefKF)
    slot_score = torch.where(obs, torch.arange(K, device=dev)[:, None], -1)
    flat_score = slot_score.reshape(-1).to(torch.int32)
    best_obs = torch.full((P,), -1, dtype=torch.int32, device=dev)
    best_obs.scatter_reduce_(0, flat_pt, flat_score, "amax")
    is_ref = (flat_score == best_obs[flat_pt]) & (w > 0)
    ref_dist = torch.zeros(P, device=dev).scatter_reduce_(
        0, flat_pt, torch.where(is_ref, dist.reshape(-1), 0.0), "amax")
    ref_level = torch.zeros(P, dtype=torch.int32, device=dev).scatter_reduce_(
        0, flat_pt, torch.where(is_ref, m.kf_level.reshape(-1), 0)
        .to(torch.int32), "amax")
    max_dist = ref_dist * torch.pow(1.2, ref_level.to(torch.float32))
    min_dist = max_dist / (1.2 ** 7)

    med_desc, med_ok = _medoid_descriptors(m)
    has_obs = cnt > 0
    return m._replace(
        pt_normal=torch.where(has_obs[:, None], normal, m.pt_normal),
        pt_min_dist=torch.where(has_obs, min_dist, m.pt_min_dist),
        pt_max_dist=torch.where(has_obs, torch.clamp(max_dist, min=1e-3),
                                m.pt_max_dist),
        pt_desc=torch.where((has_obs & med_ok)[:, None], med_desc,
                            m.pt_desc))


def point_observer_descriptors(m: MapState):
    """Capped per-point observer descriptor lists from the forward store,
    with one stable sort: points with more than ``MAX_OBS`` observations
    keep the first ``MAX_OBS`` in flat (keyframe, feature) order.

    Returns (desc [P, O, 8] int32, valid [P, O] bool).
    """
    K, F = m.kf_point.shape
    Pn = m.max_points
    dev = m.kf_point.device
    flat_pt = m.kf_point.reshape(-1)
    ok = ((flat_pt >= 0) & m.kf_valid[:, None].expand(K, F).reshape(-1)
          & m.kf_feat_valid.reshape(-1))
    key = torch.where(ok, flat_pt, Pn)
    sorted_pt, order = torch.sort(key, stable=True)
    first = torch.searchsorted(
        sorted_pt, torch.arange(Pn + 1, dtype=sorted_pt.dtype, device=dev),
        side="left")
    rank = torch.arange(K * F, device=dev) - first[
        torch.clamp(sorted_pt, 0, Pn).long()]
    keep = (sorted_pt < Pn) & (rank < MAX_OBS)
    # kept lanes hit distinct (point, rank) cells; the rest go to a
    # spare row that is sliced off
    dst = torch.where(keep, sorted_pt.long() * MAX_OBS + rank, Pn * MAX_OBS)
    W8 = m.kf_desc.shape[-1]
    desc = torch.zeros((Pn * MAX_OBS + 1, W8), dtype=m.kf_desc.dtype,
                       device=dev)
    desc[dst] = m.kf_desc.reshape(-1, W8)[order]
    valid = torch.zeros(Pn * MAX_OBS + 1, dtype=torch.bool, device=dev)
    valid[dst] = keep
    return (desc[:-1].view(Pn, MAX_OBS, W8),
            valid[:-1].view(Pn, MAX_OBS))


def popcount32(x):
    """Set bits of each int32 word (SWAR; the masks keep the sign bit out
    of every shifted term)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def _medoid_descriptors(m: MapState):
    """Min-median-Hamming medoid descriptor per point (the reference's
    ComputeDistinctiveDescriptors), batched over all points: pairwise
    Hamming distances by XOR and popcount, the median over the row's
    valid entries (self included), the first minimum.

    Returns (desc [P, 8] int32, ok [P] bool).
    """
    desc, valid = point_observer_descriptors(m)
    P, O, _ = desc.shape
    big = 1e9
    # one observer row at a time keeps the XOR tensor at [P, O, 8]
    d = torch.stack([popcount32(desc[:, o:o + 1] ^ desc).sum(-1)
                     for o in range(O)], dim=1).to(torch.float32)
    d = torch.where(valid[:, None, :], d, big)             # mask columns
    d_sorted = torch.sort(d, dim=-1).values
    cnt = valid.sum(-1)
    med_idx = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), min=0)
    med = torch.gather(d_sorted, -1,
                       med_idx[:, None, None].expand(P, O, 1))[..., 0]
    med = torch.where(valid, med, big)                     # mask rows
    best = torch.argmin(med, dim=-1)                       # first min wins
    out = torch.gather(desc, 1, best[:, None, None].expand(P, 1, 8))[:, 0]
    return out, cnt > 0
