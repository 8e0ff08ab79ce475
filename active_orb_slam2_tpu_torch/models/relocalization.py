"""Relocalization: recover a lost camera against the keyframes of the map.

Port of ``active_orb_slam2_tpu/models/relocalization.py``
(``Tracking::Relocalization`` with a 6-point DLT in RANSAC in place of
EPnP).  The JAX package maps one candidate's program over the candidate
keyframes; here every stage runs once on tensors with a leading
candidate axis C:

  * mutual Hamming match of the frame against each candidate's features
    that hold live points ([C, F, F] distances);
  * RANSAC: 256 hypotheses per candidate from Gumbel top-6 samples, a
    batched [C, 256, 12, 12] eigenproblem and 3x3 SVD in float64 (the
    JAX package solves in float32), every hypothesis scored against
    every match;
  * the best hypothesis of each candidate refined by the fused pose
    optimization (K1, ``ops/pose_opt_kernel.py``) over the C problems in
    one call, where the JAX package calls the non-fused
    ``pose_optimization``;
  * the second chance: the candidate's points projected at the refined
    pose and searched in the frame, merged with the first matches, and
    a second batched K1 call.

The candidate with the most inliers (the first among equal counts) wins
and is accepted at >= 50 inliers.  The random numbers come in as an
argument (the Gumbel noise [C, 256, F]), so a caller can feed the JAX
package's.  ``torch.linalg.eigh`` and ``svd`` raise on non-finite input
where JAX returns NaN, so such hypotheses are replaced by the identity
before the solvers and come out as NaN poses, which score no inlier.
The solvers check their results on the host, so a relocalization
attempt waits on the card, as the JAX package's does at ``bool(ok)``.

The hypotheses are solved in float64 because the 6-point normal matrix
is ill-conditioned: a float32 ``eigh`` puts a hypothesis up to ~1e-2
from the truth, and how far depends on the solver's rounding.  The
RANSAC's winner and the refinement that follows then depend on the
device: the same call on the card (cuSOLVER) and on the CPU (LAPACK)
could part by more than 2 inliers and 1% of the associations.  In
float64 the two solvers' hypotheses round to the same float32 pose.
"""

from typing import NamedTuple

import torch

from active_orb_slam2_tpu_torch.config import SlamConfig
from active_orb_slam2_tpu_torch.geometry.linalg3 import det3
from active_orb_slam2_tpu_torch.geometry.projection import (
    CameraParams, predict_scale)
from active_orb_slam2_tpu_torch.geometry.se3 import mat_to_quat, se3_apply
from active_orb_slam2_tpu_torch.models.map_state import MapState
from active_orb_slam2_tpu_torch.ops.matching import (
    hamming_matrix, match_mutual, search_by_projection)
from active_orb_slam2_tpu_torch.ops.pose_opt_kernel import (
    pose_optimization_fused)
from active_orb_slam2_tpu_torch.ops.topk import stable_topk
from active_orb_slam2_tpu_torch.utils import trace

CHI2_2D = 5.991
N_HYPOTHESES = 256
MIN_SET = 6
MIN_INLIERS = 50


class RelocResult(NamedTuple):
    pose: torch.Tensor       # [7]
    n_inliers: torch.Tensor  # int32
    ok: torch.Tensor         # bool
    assoc: torch.Tensor      # [F] feature -> point slot (-1)


def _normalize(cam: CameraParams, uv):
    return torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                        (uv[..., 1] - cam.cy) / cam.fy], dim=-1)


def _finite_or_identity(a):
    """(a with each non-finite matrix [..., n, n] replaced by the
    identity, mask [...] of the matrices that were finite)."""
    ok = torch.isfinite(a).all(-1).all(-1)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return torch.where(ok[..., None, None], a, eye), ok


def pnp_dlt(pw, xn):
    """6+-point DLT pose from world points [..., S, 3] and normalized
    image coordinates [..., S, 2] -> pose [..., 7] (Tcw) in the input's
    dtype, NaN where the system was not finite.  Solved in float64."""
    dtype = pw.dtype
    pw, xn = pw.double(), xn.double()
    X, Y, Z = pw.unbind(-1)
    x, y = xn.unbind(-1)
    zeros = torch.zeros_like(X)
    ones = torch.ones_like(X)
    r1 = torch.stack([X, Y, Z, ones, zeros, zeros, zeros, zeros,
                      -x * X, -x * Y, -x * Z, -x], dim=-1)
    r2 = torch.stack([zeros, zeros, zeros, zeros, X, Y, Z, ones,
                      -y * X, -y * Y, -y * Z, -y], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                   # [..., 2S, 12]
    AtA, ok = _finite_or_identity(A.transpose(-1, -2) @ A)
    _, vecs = torch.linalg.eigh(AtA)
    p = vecs[..., :, 0].reshape(A.shape[:-2] + (3, 4))
    M = p[..., :3]
    # scale and chirality: det(M / s) = 1
    det_m = det3(M)
    s = torch.sign(det_m) * det_m.abs() ** (1.0 / 3.0)
    s = torch.where(s.abs() < 1e-12, 1e-12, s)
    M = M / s[..., None, None]
    t = p[..., 3] / s[..., None]
    # nearest rotation by SVD, with the det flip of the last column of U
    M, ok_m = _finite_or_identity(M)
    U, _, Vh = torch.linalg.svd(M)
    flip = torch.sign(det3(U @ Vh))
    U = torch.cat([U[..., :2], U[..., 2:] * flip[..., None, None]], dim=-1)
    pose = torch.cat([mat_to_quat(U @ Vh), t], dim=-1)
    return torch.where((ok & ok_m)[..., None], pose, float("nan")).to(dtype)


def pnp_ransac(noise, cam: CameraParams, pw, uv, level, valid,
               min_set: int = MIN_SET):
    """Batched DLT-PnP RANSAC over leading axes: pw [..., M, 3], uv
    [..., M, 2], level [..., M] int, valid [..., M] bool, and ``noise``
    [..., H, M], the Gumbel noise whose top ``min_set`` valid entries
    pick each of the H hypotheses.  Returns (pose [..., 7], inliers
    [..., M], n_inliers [...]) of the first hypothesis with the most
    inliers."""
    xn = _normalize(cam, uv)
    g = torch.where(valid[..., None, :], noise, float("-inf"))
    _, picks = stable_topk(g, min_set)                   # [..., H, S]
    poses = pnp_dlt(
        torch.take_along_dim(pw[..., None, :, :], picks[..., None], dim=-2),
        torch.take_along_dim(xn[..., None, :, :], picks[..., None], dim=-2))
    sigma2 = torch.pow(1.2, 2.0 * level.to(torch.float32))
    pc = se3_apply(poses[..., :, None, :], pw[..., None, :, :])  # [..., H, M, 3]
    z = torch.where(pc[..., 2].abs() < 1e-9, 1e-9, pc[..., 2])
    proj = torch.stack([cam.fx * pc[..., 0] / z + cam.cx,
                        cam.fy * pc[..., 1] / z + cam.cy], dim=-1)
    err = ((proj - uv[..., None, :, :]) ** 2).sum(-1) / sigma2[..., None, :]
    inl = valid[..., None, :] & (err < CHI2_2D) & (pc[..., 2] > 0)
    counts = inl.sum(-1)                                 # [..., H]
    best = torch.argmax(counts, dim=-1, keepdim=True)    # first max wins
    pose = torch.take_along_dim(poses, best[..., None], dim=-2)[..., 0, :]
    inl_best = torch.take_along_dim(inl, best[..., None], dim=-2)[..., 0, :]
    return pose, inl_best, torch.take_along_dim(counts, best, -1)[..., 0]


def gumbel_noise(n_candidates: int, n_features: int, generator, device):
    """The RANSAC's random numbers for one attempt: Gumbel noise [C, 256,
    F], -log(-log u) with u uniform in [tiny, 1), drawn from
    ``generator``."""
    u = torch.rand((n_candidates, N_HYPOTHESES, n_features),
                   generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp(
        u, min=torch.finfo(torch.float32).tiny)))


@trace.traced("setup.warm_up")
def warm_up_solvers(n_candidates: int, device):
    """Run the relocalizer's DLT once at its shapes, on zeros, so that
    the one-time setup of its two batched solvers and the loading of
    its float64 kernels on the card are not paid by the first
    relocalization attempt.  On an H100, with the solvers then in
    float32, the first attempt of a process took 94-110 ms without a
    warm-up (80-91 ms of them in the DLT's solves) and 13-23 ms with
    one on identity matrices, against 8-14 ms later; a warm-up on a
    full matrix left 19-132 ms (``scripts/profile_torch_reloc.py``).
    Waits on the card."""
    n = (n_candidates, N_HYPOTHESES, MIN_SET)
    pnp_dlt(torch.zeros(*n, 3, device=device),
            torch.zeros(*n, 2, device=device))


def _scatter_max_rows(idx, src):
    """Row-wise ``full(F, -1).at[idx].max(src)`` for [C, F] int tensors."""
    out = torch.full(idx.shape, -1, dtype=torch.int32, device=idx.device)
    return out.scatter_reduce_(1, torch.clamp(idx, min=0).long(),
                               src.to(torch.int32), "amax")


def build_relocalizer(cfg: SlamConfig, n_candidates: int = 8):
    """Return ``(m, frame, cand_kfs [C] int, noise [C, 256, F]) ->
    RelocResult``, C = ``n_candidates``; candidate slots are padded with
    -1.  The candidates' two pose optimizations are each one batched K1
    call."""
    cam = cfg.camera

    def relocalize(m: MapState, frame, cand_kfs, noise) -> RelocResult:
        C, F = n_candidates, frame.uv.shape[0]
        if tuple(cand_kfs.shape) != (C,):
            raise ValueError(f"relocalize: {tuple(cand_kfs.shape)} candidate "
                             f"slots, expected ({C},)")
        kf_ok = (cand_kfs >= 0)[:, None]
        kfc = torch.clamp(cand_kfs, min=0).long()
        kf_point = m.kf_point[kfc]                              # [C, F]
        has_pt = (kf_point >= 0) & kf_ok
        d = hamming_matrix(frame.desc, m.kf_desc[kfc], frame.valid,
                           m.kf_feat_valid[kfc] & has_pt)       # [C, F, F]
        idx, _ = match_mutual(d, max_dist=50.0, ratio=0.75)
        pt = torch.clamp(kf_point.gather(1, torch.clamp(idx, min=0).long()),
                         min=0).long()
        ok = (idx >= 0) & m.pt_valid[pt] & kf_ok
        pw = m.pt_xyz[pt]
        uv = frame.uv.expand(C, F, 2)
        level = frame.level.expand(C, F).contiguous()
        pose, inl, _ = pnp_ransac(noise, cam, pw, uv, level, ok)

        # refine all candidates with the 4 x 10 pose optimization
        obs_uvr = torch.cat([frame.uv, frame.ur[:, None]], dim=-1).expand(
            C, F, 3).contiguous()
        stereo = (frame.ur > 0).expand(C, F).contiguous()
        res = pose_optimization_fused(cam, pose.contiguous(), pw, obs_uvr,
                                      level, stereo, ok & inl)
        assoc = torch.where(res.inliers & ok, pt, -1)

        # second chance: re-associate the candidate's points by
        # projection at the refined pose, then optimize again
        pts_idx = torch.clamp(kf_point, min=0).long()
        pts_ok = has_pt & m.pt_valid[pts_idx]
        pc = se3_apply(res.pose[:, None, :], m.pt_xyz[pts_idx])  # [C, F, 3]
        z = torch.where(pc[..., 2].abs() < 1e-9, 1e-9, pc[..., 2])
        proj = torch.stack([cam.fx * pc[..., 0] / z + cam.cx,
                            cam.fy * pc[..., 1] / z + cam.cy], dim=-1)
        pred_lv = predict_scale(torch.linalg.vector_norm(pc, dim=-1),
                                m.pt_max_dist[pts_idx], 1.2, 8)
        radii = 10.0 * torch.pow(1.2, pred_lv.to(torch.float32))
        idx2, _ = search_by_projection(
            proj, radii, pred_lv, m.pt_desc[pts_idx], pts_ok & (pc[..., 2] > 0),
            frame.uv, frame.level, frame.desc, frame.valid, max_dist=100.0,
            ratio=1.0, level_window=2)
        assoc2 = _scatter_max_rows(idx2, torch.where((idx2 >= 0) & pts_ok,
                                                     pts_idx, -1))
        assoc_u = torch.where(assoc >= 0, assoc, assoc2)
        pt_u = torch.clamp(assoc_u, min=0).long()
        matched = (assoc_u >= 0) & m.pt_valid[pt_u]
        res2 = pose_optimization_fused(cam, res.pose.contiguous(),
                                       m.pt_xyz[pt_u], obs_uvr, level, stereo,
                                       matched)
        assoc_f = torch.where(res2.inliers & (assoc_u >= 0), assoc_u, -1)

        best = torch.argmax(res2.n_inliers).view(1)       # first max wins
        n = res2.n_inliers.index_select(0, best)[0]
        return RelocResult(pose=res2.pose.index_select(0, best)[0],
                           n_inliers=n, ok=n >= MIN_INLIERS,
                           assoc=assoc_f.index_select(0, best)[0].to(
                               torch.int32))

    return relocalize
