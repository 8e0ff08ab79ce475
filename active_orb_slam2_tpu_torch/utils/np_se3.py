"""Pure-numpy SE3 helpers for per-frame host bookkeeping.

The orchestrator records one relative pose per frame from stats that
are already on the host; tensor ops there would launch tiny device
kernels every frame, so the host path uses numpy mirrors of
geometry/se3.py (same conventions).  A copy of
``active_orb_slam2_tpu/utils/np_se3.py``, so the port imports nothing of
the JAX package.
"""

import numpy as np


def quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dtype=np.float64)


def quat_rotate(q, v):
    qw, qv = q[0], q[1:]
    uv = np.cross(qv, v) + qw * v
    return v + 2.0 * np.cross(qv, uv)


def se3_compose(a, b):
    q = quat_mul(a[:4], b[:4])
    q = q / max(np.linalg.norm(q), 1e-12)
    t = quat_rotate(a[:4], b[4:7]) + a[4:7]
    return np.concatenate([q, t]).astype(np.float32)


def se3_inverse(p):
    qi = p[:4] * np.array([1.0, -1.0, -1.0, -1.0])
    ti = -quat_rotate(qi, p[4:7])
    return np.concatenate([qi, ti]).astype(np.float32)
