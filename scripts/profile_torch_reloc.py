#!/usr/bin/env python3
"""Where the time of the PyTorch port's first relocalization attempt
goes, on one CUDA card.  Run from the root of a checkout:

    python3 scripts/profile_torch_reloc.py [--solvers-first]
        [--warm-up {identity,full,none}] [--json PATH]

Times the construction of ``System(cfg_map)`` (the mapping
configuration of ``chip_smoke.py``) with its solver warm-up
(``--warm-up identity``: the package's, on identity matrices; ``full``:
the same on a full matrix; ``none``: no warm-up), and
tracks the first 12 of its VGA frames, so that the map holds keyframes
and the tracking and mapping kernels have run, then times on the host
clock, synchronized at both ends of each call:

* with ``--solvers-first``: the relocalizer's two batched solvers alone,
  on matrices of its shapes (``torch.linalg.eigh`` of [2048, 12, 12],
  ``torch.linalg.svd`` of [2048, 3, 3]), the first call of each and the
  median of 5 more;
* then the relocalizer (``models/relocalization.py``) on frame 12
  against the 8 newest keyframes: its first call and the median of 5
  more, each split into its stages (the matching, the DLT solves, the
  rest of the RANSAC, the two K1 calls, the search by projection, the
  rest), every stage synchronized at both ends.

A first call's excess over the later calls is the one-time setup of what
it runs for the first time in the process.  Imports nothing of JAX.
"""

import argparse
import itertools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_TRACKED = 12
# the relocalizer's stages: the module-level functions it calls
STAGES = ("hamming_matrix", "match_mutual", "pnp_dlt", "pnp_ransac",
          "pose_optimization_fused", "search_by_projection")


def first_and_median(fn, reps=5):
    """(ms of the first call, median ms of ``reps`` later calls), each
    synchronized."""
    import torch
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times[0], float(np.median(times[1:]))


def staged(module, spans):
    """Wrap the ``STAGES`` functions of ``module`` so that each call is
    synchronized at both ends and its ms added to ``spans[-1][name]``;
    ``pnp_ransac``'s time excludes the ``pnp_dlt`` inside it."""
    import torch

    def wrap(name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            dlt = spans[-1].get("pnp_dlt", 0.0)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if name == "pnp_ransac":
                ms -= spans[-1].get("pnp_dlt", 0.0) - dlt
            spans[-1][name] = spans[-1].get(name, 0.0) + ms
            return out
        return timed
    for name in STAGES:
        setattr(module, name, wrap(name, getattr(module, name)))


def full_warm_up(n_candidates, device):
    """The solver warm-up on one full matrix, where the solvers iterate
    their sweeps."""
    import torch
    from active_orb_slam2_tpu_torch.models.relocalization import N_HYPOTHESES
    n = (n_candidates, N_HYPOTHESES)
    a = torch.sin(torch.arange(144, dtype=torch.float32,
                               device=device)).reshape(12, 12)
    torch.linalg.eigh((a.T @ a).expand(*n, 12, 12))
    torch.linalg.svd(a[:3, :3].expand(*n, 3, 3))


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--solvers-first", action="store_true",
                    help="time the two solvers alone before the relocalizer")
    ap.add_argument("--warm-up", choices=("identity", "full", "none"),
                    default="identity", help="System's solver warm-up")
    ap.add_argument("--json", help="write the rows to this file as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_reloc: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from active_orb_slam2_tpu_torch.io.synthetic import (
        default_world, make_sequence, orbit_trajectory)
    from active_orb_slam2_tpu_torch.models import relocalization, system
    from active_orb_slam2_tpu_torch.models.relocalization import (
        N_HYPOTHESES, build_relocalizer, gumbel_noise)
    from active_orb_slam2_tpu_torch.models.system import (
        N_RELOC_CANDIDATES, System)
    system.warm_up_solvers = {"identity": system.warm_up_solvers,
                              "full": full_warm_up,
                              "none": lambda n, device: None}[args.warm_up]
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi gave nothing")
    device = torch.device("cuda", 0)
    rows = {"card": smi, "solvers_first": args.solvers_first,
            "warm_up": args.warm_up}
    cfg = cs.vga_config("mapping")
    frames = [(np.clip(g, 0, 255).astype(np.uint8),
               np.clip(d * 1e3, 0, 65535).astype(np.uint16))
              for g, d, _ in itertools.islice(make_sequence(
                  cs.N_FRAMES, cfg.camera, world=default_world(),
                  trajectory=orbit_trajectory(cs.N_FRAMES, step_deg=0.8)),
                  N_TRACKED + 1)]
    torch.zeros(1, device=device)        # the CUDA context, outside
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam = System(cfg, device=device)
    torch.cuda.synchronize()
    rows["system_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"System(cfg_map), warm-up {args.warm_up}: "
          f"{rows['system_ms']:.2f} ms to construct (synchronized)",
          flush=True)
    for i, images in enumerate(frames[:N_TRACKED]):
        slam.track_rgbd(*images, i / 30.0)
    slam.flush()
    print(f"tracked {N_TRACKED} frames, {slam.kf_seq} keyframes", flush=True)

    if args.solvers_first:
        B = N_RELOC_CANDIDATES * N_HYPOTHESES
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        a = torch.randn((B, 24, 12), generator=gen, device=device)
        ata = a.transpose(-1, -2) @ a
        m3 = torch.randn((B, 3, 3), generator=gen, device=device)
        rows["eigh_ms"] = first_and_median(lambda: torch.linalg.eigh(ata))
        rows["svd_ms"] = first_and_median(lambda: torch.linalg.svd(m3))
        for k in ("eigh_ms", "svd_ms"):
            print(f"{k[:-3]}: first call {rows[k][0]:.2f} ms, later "
                  f"{rows[k][1]:.2f} ms", flush=True)

    relocalize = build_relocalizer(cfg, n_candidates=N_RELOC_CANDIDATES)
    frame, _ = slam.make_rgbd(*slam._upload(*frames[N_TRACKED]))
    cands, = slam._upload(slam._reloc_candidates())
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    noise = gumbel_noise(N_RELOC_CANDIDATES, cfg.orb.n_features, gen, device)
    out, spans = [], []
    staged(relocalization, spans)

    def attempt():
        spans.append({})
        out.append(relocalize(slam.map, frame, cands, noise))
    rows["attempt_ms"] = first_and_median(attempt)
    first, later = spans[0], spans[1:]
    rows["first_stages_ms"] = dict(first, rest=rows["attempt_ms"][0]
                                   - sum(first.values()))
    rows["later_stages_ms"] = {k: float(np.median([s[k] for s in later]))
                               for k in first}
    print(f"relocalizer: first call {rows['attempt_ms'][0]:.2f} ms, later "
          f"{rows['attempt_ms'][1]:.2f} ms (median; each stage "
          f"synchronized), {int(out[-1].n_inliers)} inliers", flush=True)
    for k, ms in rows["first_stages_ms"].items():
        print(f"  {k:24s} first {ms:8.2f} ms  later "
              f"{rows['later_stages_ms'].get(k, float('nan')):8.2f} ms",
              flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
