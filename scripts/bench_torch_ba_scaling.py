"""Global BA throughput on the card, and the sharded global BA's parity
and strong scaling over ranks: the PyTorch port's counterpart of
``scripts/bench_ba_scaling.py``.

    python3 scripts/bench_torch_ba_scaling.py device [--device cpu]
    python3 scripts/bench_torch_ba_scaling.py mesh --ranks N --backend gloo|nccl [--device cpu]
    torchrun --nproc_per_node=N scripts/bench_torch_ba_scaling.py mesh --backend nccl

``device``: LM iterations/s of ``global_ba`` at 48 keyframes / 8,192
points / 8 observations (Schur PCG) and at the KITTI-00 scale of
``bench.py::ba_roofline`` (512 / 65,536 / 8), by PCG and by the dense
Schur solve; one JSON line each, with the peak device memory.

``mesh``: the sharded global BA (``build_distributed_ba``) at 512
keyframes / 16,384 points (the JAX script's mesh problem), points in
anchor-block order: parity of the whole group against the single-device
``global_ba`` on rank 0, then the time of 1, 2, 4 and 8 ranks (up to the
group's size).  Under torchrun it runs in torchrun's group; alone it
spawns ``--ranks`` processes.  With ``nccl`` rank r works on ``cuda:r``;
with ``gloo`` the ranks share the cards (``cuda:r % count``) or, with
``--device cpu``, the CPU.  Prints JSON lines from rank 0.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np
import torch

from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
from active_orb_slam2_tpu_torch.parallel.dist_ba import (
    PointEdges, anchor_block_order, build_distributed_ba, global_ba)
from active_orb_slam2_tpu_torch.parallel.mesh import (
    initialize_distributed, make_mesh, spawn_ranks)

CAM = CameraParams(fx=400., fy=400., cx=320., cy=320., bf=40.,
                   width=640, height=640)
MESH_K, MESH_P, MESH_O = 512, 16_384, 8
MESH_ITERS, MESH_CG = 3, 48
# scripts/bench_ba_scaling.py's parity bars at K = 512
PARITY_POSE, PARITY_POINT = 1e-3, 1e-2


def build_problem(K=48, Pn=8192, O=8, seed=0, device="cpu"):
    """``scripts/bench_ba_scaling.py::build_problem`` (:26-55) on ``device``:
    cameras on a ring, identity rotations, points in front; observations
    at fx = fy = 400, cx = cy = 320 with 1 px noise, of the camera center
    stored as the pose's translation.  Returns (poses, kf_valid, points,
    pt_valid, edges, fixed_mask) with camera 0 fixed."""
    rng = np.random.default_rng(seed)
    angles = np.linspace(0, 2 * np.pi, K, endpoint=False)
    poses = np.zeros((K, 7), np.float32)
    poses[:, 0] = 1.0
    poses[:, 4] = 0.3 * np.cos(angles)
    poses[:, 5] = 0.3 * np.sin(angles)
    points = rng.uniform(-1.5, 1.5, (Pn, 3)).astype(np.float32)
    points[:, 2] += 5.0
    cam_ids = rng.integers(0, K, (Pn, O)).astype(np.int32)
    obs = np.zeros((Pn, O, 3), np.float32)
    for o in range(O):
        rel = points - poses[cam_ids[:, o], 4:7]
        z = np.maximum(rel[:, 2], 0.5)
        obs[:, o, 0] = 400 * rel[:, 0] / z + 320 + rng.normal(0, 1, Pn)
        obs[:, o, 1] = 400 * rel[:, 1] / z + 320 + rng.normal(0, 1, Pn)

    def dev(a):
        return torch.from_numpy(a).to(device)

    edges = PointEdges(
        cam=dev(cam_ids), obs_uvr=dev(obs),
        level=torch.zeros((Pn, O), dtype=torch.int32, device=device),
        has_stereo=torch.zeros((Pn, O), dtype=torch.bool, device=device),
        valid=torch.ones((Pn, O), dtype=torch.bool, device=device))
    return (dev(poses), torch.ones(K, dtype=torch.bool, device=device),
            dev(points), torch.ones(Pn, dtype=torch.bool, device=device),
            edges, torch.arange(K, device=device) == 0)


def ba_flops_per_iter(K=48, Pn=8192, O=8):
    """``scripts/bench_ba_scaling.py::ba_flops_per_iter`` (:58): the
    analytic FLOP of one LM iteration's dominant terms, residuals and
    Jacobians, the A / Hcc / Hpp products, the Schur complement and the
    reduced solve, twice for the chi2 re-evaluation pass but the solve."""
    E = Pn * O
    lin = E * 400
    blocks = E * (6 * 3 * 3 * 2 + 6 * 6 * 3 * 2 + 3 * 3 * 3 * 2)
    schur = Pn * O * O * 6 * 3 * 6 * 2 + Pn * O * 6 * 3 * 2
    solve = (K * 6) ** 3 * 2 // 3
    return 2 * (lin + blocks + schur) + solve


def fitted_poses(poses):
    """The poses the observations fit, with camera 0 where it is fixed:
    the observations take the stored translation c_k as a camera center,
    so they fit translations 2 c_0 - c_k (identity rotations)."""
    out = torch.zeros_like(poses)
    out[:, 0] = 1.0
    out[:, 4:7] = 2 * poses[0, 4:7] - poses[:, 4:7]
    return out


def anchor_ordered(prob):
    """The problem with its points in anchor-block order (keyframe slot
    order is temporal order here)."""
    poses, kf_valid, points, pt_valid, e, fixed = prob
    idx = anchor_block_order(
        e, torch.arange(len(poses), dtype=torch.int32,
                        device=poses.device)).long()
    return (poses, kf_valid, points[idx], pt_valid[idx],
            PointEdges(*(a[idx] for a in e)), fixed)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device):
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def run_device(device):
    iters = 10
    for K, Pn, dense in ((48, 8192, False), (512, 65_536, False),
                         (512, 65_536, True)):
        prob = build_problem(K, Pn, 8, device=device)

        def call():
            return global_ba(CAM, *prob, iters=iters, dense=dense)

        call()
        sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            out = call()
        sync(device)
        dt = (time.perf_counter() - t0) / reps
        peak = (torch.cuda.max_memory_allocated(device) - base
                if device.type == "cuda" else None)
        print(json.dumps({
            "metric": f"ba_iters_per_s_{K}kf_{Pn}pt",
            "solve": "dense" if dense else "pcg", "value": iters / dt,
            "unit": "iters/s", "ms_per_iter": dt * 1e3 / iters,
            "peak_bytes_above_inputs": peak,
            "chi2": float(out[2]), "device": device_name(device)}),
            flush=True)


def _mesh_rank(rank, backend, device_kind):
    """One rank of the mesh mode (under torchrun or spawned)."""
    world = torch.distributed.get_world_size()
    if device_kind == "cpu":
        device = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    elif backend == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    prob = anchor_ordered(build_problem(MESH_K, MESH_P, MESH_O,
                                        device=device))
    out = {}
    for n in (1, 2, 4, 8):
        if n > world:
            break
        mesh = make_mesh(n)
        if rank < n:
            fn = build_distributed_ba(mesh, CAM, iters=MESH_ITERS,
                                      cg_iters=MESH_CG)
            fn(*prob)
            sync(device)
            fn.shards.calls = fn.shards.bytes = 0
            t0 = time.perf_counter()
            res = fn(*prob)
            sync(device)
            out[n] = (time.perf_counter() - t0, fn.shards.calls,
                      fn.shards.bytes)
        torch.distributed.barrier()
    if rank == 0:
        ref = global_ba(CAM, *prob, iters=MESH_ITERS, cg_iters=MESH_CG)
        dp = float((res[0] - ref[0]).abs().max())
        dx = float((res[1] - ref[1]).abs().max())
        ok = dp < PARITY_POSE and dx < PARITY_POINT
        print(json.dumps({
            "parity_at_K": MESH_K, "points": MESH_P, "ranks": world,
            "max_pose_diff": dp, "max_point_diff": dx, "ok": ok}),
            flush=True)
        base = out[1][0]
        for n, (sec, calls, nbytes) in out.items():
            print(json.dumps({
                "ranks": n, "backend": backend,
                "device": device_name(device), "time_s": sec,
                "ms_per_lm_iter": sec * 1e3 / MESH_ITERS,
                "speedup": base / sec, "efficiency": base / (sec * n),
                "collectives_per_lm_iter": (calls - 1) / MESH_ITERS,
                "bytes_per_lm_iter": (nbytes - 4 * MESH_K) / MESH_ITERS}),
                flush=True)
        if not ok:
            raise RuntimeError("the sharded BA parts from the single-device "
                               "one beyond the parity bars")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("device", "mesh"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    a = ap.parse_args()
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu for the CPU)")
    if a.mode == "device":
        run_device(torch.device(a.device))
    elif initialize_distributed(a.backend):
        try:
            _mesh_rank(torch.distributed.get_rank(), a.backend, a.device)
        finally:
            torch.distributed.destroy_process_group()
    else:
        spawn_ranks(_mesh_rank, a.ranks, a.backend, args=(a.backend,
                                                         a.device))


if __name__ == "__main__":
    main()
