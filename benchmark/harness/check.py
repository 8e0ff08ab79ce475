"""What decides ``correct``: the timed path's answers held against the
plain reference and the generator's ground truth, each number that the
cell's limits (``benchmark/checks/<cell>.json``) name beside its limit.

* ``kp_diff``: share of the keypoints of the sampled window frames, on
  either side, that the other side lacks (the same level and pixel) or
  whose depth differs, between the frames the program built in the
  window and the reference frame pipeline run on the same images.
* ``desc_diff``: share of descriptor bits that differ on the keypoints
  both sides have.
* ``pose_gap_m``: the widest gap, over a sample of the window's
  motion-only pose solves, between the translation the program's solve
  returned and the one the reference solve (``reference/pose_ref.py``,
  float32) returns from the same inputs.  The inputs (the map's points,
  the frame's keypoints, the predicted pose) are the program's own state
  at that step: the reference follows the program step by step there.
* ``ate_m``: RMSE of the camera centres of every frame handed in, after
  Umeyama's rigid alignment to the ground truth.
* ``map_point_m``: median distance of the map's points, moved by that
  alignment, to the nearest surface of the rendered world.
"""

import numpy as np
import torch

from benchmark.reference import frame_ref, pose_ref
from benchmark.reference import trajectory as T

ORDER = ("kp_diff", "desc_diff", "pose_gap_m", "ate_m", "map_point_m")
DEPTH_RTOL = 1e-4


def reference_frame(cam, orb, sensor, a, b, device):
    """The reference's frame of host images (a, b) on ``device``."""
    a = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if sensor == "stereo":
        b = torch.from_numpy(np.ascontiguousarray(b)).to(device)
        return frame_ref.stereo_frame(cam, orb, a, b)
    b = torch.from_numpy(np.ascontiguousarray(b).astype(np.int32)).to(device)
    return frame_ref.rgbd_frame(cam, orb, a, b)


def _keyed(uv, level, valid):
    keys = {}
    for i in np.flatnonzero(valid):
        keys[(int(level[i]), int(round(uv[i, 0] * 1000)),
              int(round(uv[i, 1] * 1000)))] = i
    return keys


def frame_diff(port, ref):
    """(keypoints differing, keypoints, bits differing, bits compared) of
    two frames given as dicts of host arrays."""
    kp = _keyed(port["uv"], port["level"], port["valid"])
    kr = _keyed(ref["uv"], ref["level"], ref["valid"])
    both = kp.keys() & kr.keys()
    ip = np.array([kp[k] for k in both], np.int64)
    ir = np.array([kr[k] for k in both], np.int64)
    dp, dr = port["depth"][ip], ref["depth"][ir]
    same_depth = np.abs(dp - dr) <= DEPTH_RTOL * np.maximum(np.abs(dr), 1.0)
    n_same = int(same_depth.sum())
    differ = (len(kp) - n_same) + (len(kr) - n_same)
    bits = np.unpackbits(
        (port["desc"][ip] ^ ref["desc"][ir]).view(np.uint8), axis=-1).sum()
    return differ, len(kp) + len(kr), int(bits), 256 * len(both)


def host_frame(f):
    return {k: getattr(f, k).detach().cpu().numpy()
            for k in ("uv", "level", "desc", "valid", "depth")}


def frames_numbers(captured, traffic, cam, orb, sensor, device):
    """``kp_diff`` and ``desc_diff`` over the captured frames {traffic
    index: host frame}."""
    differ = total = bits = nbits = 0
    for i, port in sorted(captured.items()):
        ref = host_frame(reference_frame(cam, orb, sensor,
                                         traffic.images[0][i],
                                         traffic.images[1][i], device))
        d, t, b, nb = frame_diff(port, ref)
        differ, total, bits, nbits = differ + d, total + t, bits + b, nbits + nb
    if not total or not nbits:       # nothing to compare fails
        return {"kp_diff": float("nan"), "desc_diff": float("nan")}
    return {"kp_diff": differ / total, "desc_diff": bits / nbits}


def solve_numbers(solves):
    """``pose_gap_m`` over the sampled solves {key: (args, kwargs, out)}."""
    gaps = []
    for args, kw, out in solves.values():
        cam, pose0, pw, obs, level, stereo, valid = args[:7]
        rounds = kw.get("rounds", args[7] if len(args) > 7 else 4)
        iters = kw.get("iters_per_round", args[8] if len(args) > 8 else 10)
        with torch.no_grad():
            ref, _, _ = pose_ref.solve(cam, pose0.float(), pw.float(),
                                       obs.float(), level, stereo, valid,
                                       None, rounds, iters, torch.float32)
        gaps.append(float((out.pose[..., 4:7].float()
                           - ref[..., 4:7]).abs().max()))
    return {"pose_gap_m": max(gaps) if gaps else float("nan")}


def trajectory_numbers(est_idx, est_tcw, pts, traffic):
    """``ate_m`` and ``map_point_m``; ``est_idx`` are
    the traffic indices of the estimated poses ``est_tcw`` [N, 7]."""
    est_tcw = np.asarray(est_tcw, np.float64)
    if not np.isfinite(est_tcw).all() or len(est_tcw) < 3:
        return {"ate_m": float("inf"), "map_point_m": float("inf")}
    est = T.tcw_to_twc(est_tcw)
    gt = traffic.twc[est_idx].astype(np.float64)
    ate = T.umeyama(est[:, :3, 3], gt[:, :3, 3])[2]
    # the map's points go by an alignment of the centres and of a point
    # ahead of each camera, which fixes the rotation on a short arc too
    w = traffic.world
    ahead = w.scale
    R, t, _ = T.umeyama(
        np.concatenate([est[:, :3, 3], est[:, :3, 3] + ahead * est[:, :3, 2]]),
        np.concatenate([gt[:, :3, 3], gt[:, :3, 3] + ahead * gt[:, :3, 2]]))
    dist = T.surface_distance(np.asarray(pts, np.float64) @ R.T + t,
                              w.lo.astype(np.float64),
                              w.hi.astype(np.float64), w.boxes)
    return {"ate_m": float(ate),
            "map_point_m": float(np.median(dist)) if len(dist) else
            float("inf")}


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]) of the numbers that the cell's
    limits name, in ``ORDER``; a number that is missing or not finite
    fails."""
    rows = [(k, numbers.get(k, float("nan")), float(limits[k]))
            for k in ORDER if k in limits]
    ok = bool(rows) and all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
