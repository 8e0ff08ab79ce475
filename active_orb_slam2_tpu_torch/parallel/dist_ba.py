"""Global bundle adjustment: point-major layout, Schur PCG or dense
Schur solve, on one device or sharded over a process mesh.

Port of ``active_orb_slam2_tpu/parallel/dist_ba.py`` (the reference's
``Optimizer::GlobalBundleAdjustemnt``):

* every point carries its observer list (keyframe slot, observation) up
  to ``max_obs``, built from the arena's forward store with one stable
  sort (:func:`build_point_major_edges`);
* each LM iteration linearizes all edges, reduces the camera system
  ``S = Hcc - A Hpp^-1 A^T`` and solves it matrix-free by block-Jacobi
  preconditioned CG, or (``dense=True``, one device only) assembles it
  [6K, 6K] and solves it by Cholesky; points are back-substituted.

:func:`build_distributed_ba` splits the point axis (and the observer
lists) into one contiguous block per rank of a ``DeviceMesh``
(``parallel/mesh.py``) and keeps the cameras replicated.  The LM loop,
:func:`global_ba`, takes one ``reduce`` (a sum over the shards, None on
one device) and calls it where the JAX package psums: the inlier count
before the loop, Hcc, g, D and chi2 of each iteration packed into one
buffer, ``y_ap`` in every CG mat-vec and the trial chi2.  Nothing
reduced scales with the point count, and every decision stays a
tensor, so every rank makes the same collectives in the same order.

Differences: ``.at[].add`` is ``index_add_``; the dense assembly takes
the points in chunks that cover all of them (the JAX package's equal
split drops the last ``P % n_chunks``, ROADMAP queue 3 item e);
``inv`` / ``cholesky`` are the ``_ex`` forms, which do not wait on the
card.
"""

from typing import NamedTuple

import torch

from active_orb_slam2_tpu_torch.geometry.linalg3 import inv3
from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
from active_orb_slam2_tpu_torch.geometry.se3 import se3_retract
from active_orb_slam2_tpu_torch.models.map_state import MapState
from active_orb_slam2_tpu_torch.models.optimizer import (
    edge_residual_jac, huber_weight, inv_sigma2)
from active_orb_slam2_tpu_torch.parallel.mesh import MeshShards

MAX_OBS = 16
DENSE_CHUNK = 4096      # points per block of the dense Schur assembly


class PointEdges(NamedTuple):
    """Observer lists: for each point, up to O observations."""
    cam: torch.Tensor         # [P, O] int32 keyframe slot (0 if invalid)
    obs_uvr: torch.Tensor     # [P, O, 3]
    level: torch.Tensor       # [P, O] int32
    has_stereo: torch.Tensor  # [P, O] bool
    valid: torch.Tensor       # [P, O] bool


def _observations(m: MapState):
    """Flat (point index [K*F], observation ok [K*F])."""
    K, F = m.kf_point.shape
    flat_pt = m.kf_point.reshape(-1)
    ok = ((flat_pt >= 0) & m.kf_valid[:, None].expand(K, F).reshape(-1)
          & m.kf_feat_valid.reshape(-1))
    return flat_pt, ok


def build_point_major_edges(m: MapState, max_obs: int = MAX_OBS) -> PointEdges:
    """Invert the forward store kf_point [K, F] into per-point observer
    lists [P, O], in (keyframe, feature) order, with one stable sort."""
    K, F = m.kf_point.shape
    Pn = m.max_points
    dev = m.kf_point.device
    flat_pt, ok = _observations(m)
    key = torch.where(ok, flat_pt, Pn)
    sorted_pt, order = torch.sort(key, stable=True)
    first = torch.searchsorted(
        sorted_pt, torch.arange(Pn + 1, dtype=sorted_pt.dtype, device=dev),
        side="left")
    rank = torch.arange(K * F, device=dev) - first[
        torch.clamp(sorted_pt, 0, Pn).long()]
    keep = (sorted_pt < Pn) & (rank < max_obs)
    # kept lanes hit distinct (point, rank) cells; the rest a spare cell
    dst = torch.where(keep, sorted_pt.long() * max_obs + rank, Pn * max_obs)
    kf_ids = torch.div(order, F, rounding_mode="floor")
    ft_ids = order % F

    def scatter(vals, fill, dtype):
        out = torch.full((Pn * max_obs + 1,) + vals.shape[1:], fill,
                         dtype=dtype, device=dev)
        out[dst] = vals.to(dtype)
        return out[:-1].view((Pn, max_obs) + vals.shape[1:])

    ur = m.kf_ur[kf_ids, ft_ids]
    obs = torch.cat([m.kf_uv[kf_ids, ft_ids], ur[:, None]], -1)
    return PointEdges(
        cam=scatter(torch.where(keep, kf_ids, 0), 0, torch.int32),
        obs_uvr=scatter(torch.where(keep[:, None], obs, 0.0), 0.0,
                        torch.float32),
        level=scatter(torch.where(keep, m.kf_level[kf_ids, ft_ids], 0), 0,
                      torch.int32),
        has_stereo=scatter(keep & (ur > 0), False, torch.bool),
        valid=scatter(keep, False, torch.bool))


def count_dropped_observations(m: MapState, max_obs: int = MAX_OBS):
    """(kept, dropped) observations under the per-point cap, int
    tensors."""
    flat_pt, ok = _observations(m)
    per_pt = torch.zeros(m.max_points, dtype=torch.int32,
                         device=flat_pt.device).index_add_(
        0, torch.clamp(flat_pt, min=0).long(), ok.to(torch.int32))
    kept = torch.clamp(per_pt, max=max_obs).sum()
    return kept, per_pt.sum() - kept


def anchor_block_order(e: PointEdges, kf_frame_id):
    """Permutation [P] of the points by the temporal rank of their anchor
    keyframe (lowest-frame-id observer); points with no observer last."""
    rank = torch.argsort(torch.argsort(kf_frame_id, stable=True), stable=True)
    obs_rank = torch.where(e.valid, rank[e.cam.long()], 2 ** 30)
    return torch.argsort(obs_rank.amin(1), stable=True).to(torch.int32)


def inverse_permutation(perm):
    return torch.argsort(perm, stable=True).to(torch.int32)


# ------------------------------------------------------------ linearization

def _gram(Ja, w, Jb):
    """Per edge sum over residual rows of w Ja^T Jb: [E, n, m]."""
    return (Ja * w[:, None, None]).transpose(1, 2) @ Jb


def _edges_at(cam: CameraParams, poses, points, e: PointEdges, inlier):
    """Residuals, Jacobians, IRLS weights and chi2 of every edge."""
    Pn, O = e.cam.shape
    cam_flat = e.cam.reshape(-1).long()
    pw = points[:, None, :].expand(Pn, O, 3).reshape(-1, 3)
    stereo = e.has_stereo.reshape(-1)
    r, Jc, Jx, zpos = edge_residual_jac(cam, poses[cam_flat], pw,
                                        e.obs_uvr.reshape(-1, 3), stereo)
    w_info = inv_sigma2(e.level.reshape(-1))
    c2 = w_info * (r * r).sum(-1)
    w = w_info * huber_weight(c2, stereo)
    w = torch.where(e.valid.reshape(-1) & inlier.reshape(-1) & zpos, w, 0.0)
    return r, Jc, Jx, w, torch.where(w > 0, c2, 0.0).sum()


def _linearize(cam: CameraParams, poses, points, e: PointEdges, inlier, lam):
    """Returns (Hcc [K,6,6], g [K,6] reduced gradient, D [K,6,6] the
    A Hpp^-1 A^T diagonal blocks, Hpp_inv [P,3,3], bp [P,3], A
    [P,O,6,3], chi2)."""
    K = poses.shape[0]
    Pn, O = e.cam.shape
    dev = points.device
    cam_flat = e.cam.reshape(-1).long()
    r, Jc, Jx, w, chi2 = _edges_at(cam, poses, points, e, inlier)
    wr = (w[:, None] * r)[:, :, None]
    A = _gram(Jc, w, Jx).view(Pn, O, 6, 3)
    Hcc = torch.zeros((K, 6, 6), device=dev).index_add_(
        0, cam_flat, _gram(Jc, w, Jc))
    bc_e = -(Jc.transpose(1, 2) @ wr)[..., 0]
    Hpp = _gram(Jx, w, Jx).view(Pn, O, 3, 3).sum(1)
    bp = -(Jx.transpose(1, 2) @ wr)[..., 0].view(Pn, O, 3).sum(1)
    del r, Jc, Jx, wr
    eye3 = torch.eye(3, device=dev)
    Hpp_inv = inv3(Hpp + lam * Hpp * eye3 + 1e-6 * eye3, eps=1e-30)
    v = (Hpp_inv @ bp[..., None])[..., 0]                    # [P, 3]
    red = (A @ v[:, None, :, None])[..., 0]                  # [P, O, 6]
    g = torch.zeros((K, 6), device=dev).index_add_(
        0, cam_flat, bc_e - red.reshape(-1, 6))
    # block-Jacobi blocks of the Schur diagonal: the o == o term
    AH = A @ Hpp_inv[:, None]                                # [P, O, 6, 3]
    D = torch.zeros((K, 6, 6), device=dev).index_add_(
        0, cam_flat, (AH @ A.transpose(-1, -2)).reshape(-1, 6, 6))
    return Hcc, g, D, Hpp_inv, bp, A, chi2


def _schur_matvec(x, Hcc_damped, A, Hpp_inv, e: PointEdges, free,
                  reduce=None):
    """y = S x with S = Hcc_d - A Hpp^-1 A^T, matrix-free; fixed cameras
    pass x through.  ``reduce`` sums the [K, 6] point-side product over
    the shards."""
    xm = x * free[:, None]
    cam = e.cam.long()
    t = (A.transpose(-1, -2) @ xm[cam][..., None]).sum(1)      # [P, 3, 1]
    back = (A @ (Hpp_inv @ t)[:, None])[..., 0]                # [P, O, 6]
    y_ap = torch.zeros_like(x).index_add_(0, cam.reshape(-1),
                                          back.reshape(-1, 6))
    if reduce is not None:
        y_ap = reduce(y_ap)
    y = (Hcc_damped @ xm[..., None])[..., 0] - y_ap
    return torch.where(free[:, None], y, x)


def _pcg(matvec, Minv, b, iters: int):
    """Block-Jacobi preconditioned CG on [K, 6] block vectors, a fixed
    number of iterations."""
    def prec(r):
        return (Minv @ r[..., None])[..., 0]

    x = torch.zeros_like(b)
    r = b
    z = prec(r)
    p = z
    rz = (r * z).sum()
    for _ in range(iters):
        Ap = matvec(p)
        denom = (p * Ap).sum()
        alpha = rz / torch.where(denom.abs() < 1e-20, 1e-20, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = (r * z).sum()
        beta = rz_new / torch.where(rz.abs() < 1e-20, 1e-20, rz)
        p = z + beta * p
        rz = rz_new
    return x


def _assemble_schur_dense(Hcc_d, A, Hpp_inv, e: PointEdges, free,
                          chunk: int = DENSE_CHUNK):
    """The reduced camera system S = Hcc_d - A Hpp^-1 A^T as a dense
    [6K, 6K] matrix (fixed cameras' rows and columns the identity),
    summed over chunks of ``chunk`` points that cover every point."""
    K = Hcc_d.shape[0]
    Pn = e.cam.shape[0]
    dev = Hcc_d.device
    AH = A @ Hpp_inv[:, None]                                # [P, O, 6, 3]
    S = torch.zeros((K * K, 6, 6), device=dev)
    for c0 in range(0, Pn, chunk):
        AHb, Ab = AH[c0:c0 + chunk], A[c0:c0 + chunk]
        camb = e.cam[c0:c0 + chunk].long()
        T = AHb[:, :, None] @ Ab[:, None].transpose(-1, -2)  # [C, O, O, 6, 6]
        idx = camb[:, :, None] * K + camb[:, None, :]
        S.index_add_(0, idx.reshape(-1), T.reshape(-1, 6, 6))
    diag = torch.arange(K, device=dev) * (K + 1)
    M = (-S).index_add_(0, diag, Hcc_d)
    M = M.view(K, K, 6, 6).transpose(1, 2).reshape(6 * K, 6 * K)
    rows = (~free)[:, None].expand(K, 6).reshape(-1)
    return torch.where(rows[:, None] | rows[None, :],
                       torch.eye(6 * K, device=dev), M)


def _back_substitute(Hpp_inv, bp, A, e: PointEdges, dc_blocks):
    """dp = Hpp_inv (bp - sum_o A[p, o]^T dc[cam[p, o]])."""
    corr = (A.transpose(-1, -2) @ dc_blocks[e.cam.long()][..., None]).sum(1)
    return (Hpp_inv @ (bp[..., None] - corr))[..., 0]


def _precond_inv(Hcc_damped, D, free):
    """Inverse of the Schur diagonal blocks (identity on fixed cameras)."""
    eye = torch.eye(6, device=D.device)
    M = torch.where(free[:, None, None], Hcc_damped - D + 1e-6 * eye, eye)
    return torch.linalg.inv_ex(M)[0]


def _reduce_packed(reduce, *parts):
    """Sums of several tensors over the shards in one collective: packed
    into one flat buffer, reduced, viewed back."""
    buf = reduce(torch.cat([p.reshape(-1) for p in parts]))
    return [b.view(p.shape)
            for p, b in zip(parts, buf.split([p.numel() for p in parts]))]


def _lm_iteration(cam, poses, points, e, inlier, fixed, lam, cg_iters: int,
                  dense: bool = False, reduce=None):
    """One damped GN step; returns (new poses, point steps, chi2 at the
    current estimate)."""
    free = ~fixed
    Hcc, g, D, Hpp_inv, bp, A, chi2 = _linearize(cam, poses, points, e,
                                                 inlier, lam)
    if reduce is not None:
        Hcc, g, D, chi2 = _reduce_packed(reduce, Hcc, g, D, chi2)
    eye6 = torch.eye(6, device=poses.device)
    Hcc_d = Hcc + lam * Hcc * eye6 + 1e-8 * eye6
    g = g * free[:, None]
    if dense:
        L, _ = torch.linalg.cholesky_ex(
            _assemble_schur_dense(Hcc_d, A, Hpp_inv, e, free))
        dc = torch.cholesky_solve(g.reshape(-1, 1), L).view(-1, 6)
    else:
        dc = _pcg(lambda x: _schur_matvec(x, Hcc_d, A, Hpp_inv, e, free,
                                          reduce),
                  _precond_inv(Hcc_d, D, free), g, cg_iters)
    dc = dc * free[:, None]
    return (se3_retract(poses, dc), _back_substitute(Hpp_inv, bp, A, e, dc),
            chi2)


def _chi2_only(cam, poses, points, e, inlier, reduce=None):
    chi2 = _edges_at(cam, poses, points, e, inlier)[4]
    return chi2 if reduce is None else reduce(chi2)


def global_ba(cam: CameraParams, poses, kf_valid, points, pt_valid,
              e: PointEdges, fixed_mask, iters: int = 10, lam0: float = 1e-4,
              cg_iters: int = 48, dense: bool = False, reduce=None):
    """Point-major global BA: ``iters`` LM iterations with chi2-monotone
    acceptance.  Invalid keyframes, ``fixed_mask`` and cameras with fewer
    than 12 inlier edges (a near-singular 6x6 block) stay fixed.
    ``reduce`` sums a tensor over the shards when the points are this
    rank's block (:func:`build_distributed_ba`); None on one device.
    Returns (poses [K, 7], points [P, 3], chi2)."""
    if dense and reduce is not None:
        raise ValueError("the dense Schur solve runs on one device only")
    K = poses.shape[0]
    dev = poses.device
    inlier = e.valid & pt_valid[:, None]
    cnt = torch.zeros(K, dtype=torch.int32, device=dev).index_add_(
        0, e.cam.reshape(-1).long(), inlier.reshape(-1).to(torch.int32))
    if reduce is not None:
        cnt = reduce(cnt)
    fixed = fixed_mask | ~kf_valid | (cnt < 12)
    lam = torch.full((), lam0, device=dev)
    chi2 = torch.zeros((), device=dev)
    for _ in range(iters):
        new_poses, dp, chi2_old = _lm_iteration(cam, poses, points, e, inlier,
                                                fixed, lam, cg_iters, dense,
                                                reduce)
        new_points = points + dp * pt_valid[:, None]
        chi2_new = _chi2_only(cam, new_poses, new_points, e, inlier, reduce)
        accept = chi2_new <= chi2_old
        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e2)
        chi2 = torch.where(accept, chi2_new, chi2_old)
    return poses, points, chi2


def build_distributed_ba(mesh, cam: CameraParams, iters: int = 10,
                         max_obs: int = MAX_OBS, axis="shard",
                         cg_iters: int = 48):
    """The global BA sharded over ``axis`` of ``mesh`` (a ``DeviceMesh``;
    one axis name, or ``("host", "chip")`` from
    :func:`~active_orb_slam2_tpu_torch.parallel.mesh.make_host_chip_mesh`).

    Returns ``fn(poses, kf_valid, points, pt_valid, edges, fixed_mask) ->
    (poses, points, chi2)``, which every rank of the mesh calls with the
    global arrays.  Each rank takes its contiguous block of the points and
    their edges (order them by :func:`anchor_block_order` first, so that a
    block holds a stretch of the trajectory); the cameras stay
    replicated.  Per LM iteration the ranks make one packed reduction of
    Hcc, g, D and chi2, one [K, 6] reduction per CG step and one of the
    trial chi2 (over ``("host", "chip")`` each is a reduction within the
    host, then one across hosts).  The points come back whole on every
    rank, in shard order.  ``fn.shards`` counts the reductions and their
    bytes.  Raises ValueError when the points do not split into equal
    blocks.
    """
    del max_obs  # the edge cap is set at build_point_major_edges time
    shards = MeshShards(mesh, axis)

    def fn(poses, kf_valid, points, pt_valid, e: PointEdges, fixed_mask):
        lo, hi = shards.block(points.shape[0])
        poses, pts, chi2 = global_ba(
            cam, poses, kf_valid, points[lo:hi], pt_valid[lo:hi],
            PointEdges(*(a[lo:hi] for a in e)), fixed_mask, iters=iters,
            cg_iters=cg_iters, reduce=shards.reduce)
        return poses, shards.gather(pts), chi2

    fn.shards = shards
    return fn
