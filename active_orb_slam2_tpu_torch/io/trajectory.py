"""Trajectory output in the reference's file formats (numpy).

Port of ``active_orb_slam2_tpu/io/trajectory.py``:
  * TUM:   ``timestamp tx ty tz qx qy qz qw`` (camera-to-world)
  * KITTI: 12 floats, row-major 3x4 camera-to-world matrix

Per-frame poses are stored relative to their reference keyframe and
replayed against the final keyframe poses at save time.
"""

import numpy as np

from active_orb_slam2_tpu_torch.utils import np_se3


def _bquat_mul(a, b):
    aw, ax, ay, az = a[:, 0], a[:, 1], a[:, 2], a[:, 3]
    bw, bx, by, bz = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    return np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw], axis=-1)


def _bquat_rot(q, v):
    qw, qv = q[:, :1], q[:, 1:]
    uv = np.cross(qv, v) + qw * v
    return v + 2.0 * np.cross(qv, uv)


def _quat_to_mat(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1).reshape(q.shape[:-1] + (3, 3))


def resolve_frame_poses(rel_records, kf_poses):
    """rel_records: list of (timestamp, ref_kf_slot, Tcr [7]) per frame;
    kf_poses: final [K, 7] Tcw.  Returns (timestamps, Tcw [N, 7]).
    A ref of -1 marks an absolute record."""
    if not rel_records:
        return np.zeros((0,)), np.zeros((0, 7))
    kf = np.asarray(kf_poses, np.float64)
    ts = np.array([t for t, _, _ in rel_records])
    refs = np.array([r for _, r, _ in rel_records], np.int64)
    tcr = np.stack([np.asarray(c, np.float64) for _, _, c in rel_records])
    ident = np.array([1.0, 0, 0, 0, 0, 0, 0])
    ref_pose = np.where((refs >= 0)[:, None], kf[np.maximum(refs, 0)],
                        ident[None])
    q = _bquat_mul(tcr[:, :4], ref_pose[:, :4])
    t3 = _bquat_rot(tcr[:, :4], ref_pose[:, 4:7]) + tcr[:, 4:7]
    out = np.concatenate([q, t3], axis=-1)
    n = np.linalg.norm(out[:, :4], axis=-1, keepdims=True)
    out[:, :4] /= np.maximum(n, 1e-12)
    return ts, out.astype(np.float32)


def save_tum(path, timestamps, poses_cw):
    """Write TUM format (camera-to-world)."""
    with open(path, "w") as f:
        for t, p in zip(timestamps, poses_cw):
            twc = np_se3.se3_inverse(np.asarray(p, np.float64))
            qw, qx, qy, qz = twc[:4]
            tx, ty, tz = twc[4:7]
            f.write(f"{t:.6f} {tx:.7f} {ty:.7f} {tz:.7f} "
                    f"{qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}\n")


def save_kitti(path, poses_cw):
    """Write KITTI format: row-major 3x4 of Twc per line."""
    with open(path, "w") as f:
        for p in poses_cw:
            twc = np_se3.se3_inverse(np.asarray(p, np.float64))
            m = np.concatenate([_quat_to_mat(twc[:4]), twc[4:7, None]], 1)
            f.write(" ".join(f"{v:.9e}" for v in m.reshape(-1)) + "\n")


def camera_centers(poses_cw):
    """[N, 7] Tcw -> [N, 3] camera centers in world (-R^T t)."""
    p = np.asarray(poses_cw, np.float64)
    R = _quat_to_mat(p[:, :4])
    return -np.einsum('nij,ni->nj', R, p[:, 4:7])
