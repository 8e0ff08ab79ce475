"""Motion-only bundle adjustment in plain PyTorch: 4 rounds of 10 damped
Gauss-Newton iterations with Huber weights in rounds 0-1 and chi2
reclassification after each round, for one problem or a leading axis of
problems.

A frozen copy of the plain version of the program's pose kernel
(``ops/pose_opt_kernel.py::pose_optimization_fused_torch`` with the
helpers of ``models/optimizer.py`` and ``geometry/se3.py``).  The
benchmark runs it only as the control, with the edges in bfloat16, in
place of the program's kernel; ``solve`` has the kernel entry's
signature.
"""

import torch

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
LOG_SCALE2 = float(2.0 * torch.log(torch.tensor(1.2, dtype=torch.float32)))


def quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def quat_rotate(q, v):
    qw, qv = q[..., :1], q[..., 1:]
    qv, v = torch.broadcast_tensors(qv, v)
    uv = torch.linalg.cross(qv, v, dim=-1) + qw * v
    return v + 2.0 * torch.linalg.cross(qv, uv, dim=-1)


def _solve6(H, b):
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = H[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(s, min=1e-20))
        for i in range(j + 1, n):
            s = H[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)


def _edges(cam, pose, pw, obs, stf):
    fx, fy, cx, cy, bf = cam
    pc = quat_rotate(pose[:4], pw) + pose[4:7]
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    iz = 1.0 / zs
    iz2 = iz * iz
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    r = torch.stack([u - obs[:, 0], v - obs[:, 1],
                     stf * (u - bf * iz - obs[:, 2])])
    zero = torch.zeros_like(x)
    jpc = [[fx * iz, zero, -fx * x * iz2], [zero, fy * iz, -fy * y * iz2],
           [stf * fx * iz, zero, stf * (-fx * x * iz2 + bf * iz2)]]
    px = [[zero, -z, y], [z, zero, -x], [-y, x, zero]]
    J = [[-(jpc[a][0] * px[0][i] + jpc[a][1] * px[1][i]
            + jpc[a][2] * px[2][i]) for i in range(3)] + jpc[a]
         for a in range(3)]
    return r, torch.stack([torch.stack(row) for row in J]), z > 0


def _retract(pose, step):
    w, v = step[:3], step[3:]
    t2 = (w * w).sum()
    t = torch.sqrt(t2)
    small = t < 1e-6
    k = torch.where(small, 0.5 - t2 / 48.0,
                    torch.sin(0.5 * t) / torch.clamp(t, min=1e-20))
    eq = torch.cat([torch.where(small, 1.0 - t2 / 8.0,
                                torch.cos(0.5 * t))[None], k * w])
    a = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(t)) / torch.clamp(t2, min=1e-20))
    b = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (t - torch.sin(t)) / torch.clamp(t2 * t, min=1e-20))
    w1 = torch.linalg.cross(w, v, dim=-1)
    w2 = torch.linalg.cross(w, w1, dim=-1)
    nq = quat_mul(eq, pose[:4])
    nq = nq / torch.clamp(torch.sqrt((nq * nq).sum()), min=1e-12)
    return torch.cat([nq, quat_rotate(eq, pose[4:7]) + (v + a * w1 + b * w2)])


def _one(cam, pose0, pw, obs, level, has_stereo, valid, rounds, iters, dt):
    """One problem; the edges (projections, residuals, Jacobians) are
    computed in ``dt``, the normal equations, the solve and the pose in
    float32."""
    dev = pw.device
    f32, edge_dt = torch.float32, dt
    w_info = torch.exp(-level.float() * LOG_SCALE2)
    stf = has_stereo.to(dt)
    valid_f = valid.to(f32)
    chi2_th = torch.where(has_stereo, CHI2_STEREO, CHI2_MONO).to(f32)
    delta_h = torch.sqrt(chi2_th)
    pw, obs = pw.to(dt), obs.to(dt)

    def lin(pose):
        r, J, zpos = _edges(cam, pose.to(edge_dt), pw, obs, stf)
        r, J = r.to(f32), J.to(f32)
        return r, J, w_info * (r * r).sum(0), zpos.to(f32)

    dt = f32
    pose = pose0.to(dt)
    inl = valid_f
    for rnd in range(rounds):
        best = pose
        best_chi2 = torch.tensor(float("inf"), device=dev, dtype=dt)
        lam = torch.tensor(1e-4, device=dev, dtype=dt)
        for _ in range(iters):
            r, J, c2, zpos = lin(pose)
            gate = inl * zpos
            chi2 = (c2 * gate).sum()
            worse = chi2 > best_chi2
            lam = torch.clamp(torch.where(worse, lam * 4.0, lam * 0.5),
                              1e-8, 1e2)
            best = torch.where(worse, best, pose)
            best_chi2 = torch.minimum(chi2, best_chi2)
            hub = torch.clamp(delta_h / torch.sqrt(torch.clamp(c2, min=1e-12)),
                              max=1.0) if rnd < 2 else 1.0
            w = w_info * hub * gate
            H = ((J[:, :, None, :] * J[:, None, :, :]).sum(0) * w).sum(-1)
            b = -((J * r[:, None, :]).sum(0) * w).sum(-1)
            Hd = H + lam * torch.diag(torch.diagonal(H)) \
                + 1e-9 * torch.eye(6, dtype=dt, device=dev)
            pose = torch.where(worse, best, _retract(pose, _solve6(Hd, b)))
        _, _, c2c, zc = lin(pose)
        pose = torch.where((c2c * inl * zc).sum() <= best_chi2, pose, best)
        _, _, c2r, zr = lin(pose)
        inl = valid_f * zr * (c2r <= chi2_th).to(dt)
    _, _, c2f, _ = lin(pose)
    inliers = inl > 0.5
    out = torch.cat([pose, (c2f * inl).sum()[None]]).float()
    return out, inliers.sum().to(torch.int32), inliers


def solve(cam, pose0, pw, obs_uvr, level, has_stereo, valid, w_table,
          rounds, iters, dtype=torch.bfloat16):
    """The kernel entry's contract: returns (out [(P,) 8] pose and inlier
    chi2, n_inliers [(P)], inliers [(P,) E])."""
    c = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
    if pose0.dim() == 2:
        res = [_one(c, *a, rounds, iters, dtype)
               for a in zip(pose0, pw, obs_uvr, level, has_stereo, valid)]
        return tuple(torch.stack(f) for f in zip(*res))
    return _one(c, pose0, pw, obs_uvr, level, has_stereo, valid, rounds,
                iters, dtype)
