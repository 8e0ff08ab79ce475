"""The check's control and its planted faults, run through the whole
harness with the timed path replaced underneath.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 \
        --seconds <s> [--mode control|program|<fault>] [--json PATH]

``control``: the reference put in the program's place one precision
below the program's float32: the frame pipeline (``reference/
frame_ref.py``) and the motion-only pose solve (``reference/
pose_ref.py``) computed in bfloat16.  The faults: ``state_unchanged``
(the tracking step hands back the state it was given), ``half_batch``
(half of each frame's keypoints left out), ``answer_altered`` (a word of
every descriptor flipped where the frame is built).  ``program`` runs the
program as it is.  Each seed's numbers print as one JSON line; the
benchmark's own runs never run this.  It needs a CUDA card unless
``--device cpu``.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from benchmark.harness import check, definitions, session  # noqa: E402
from benchmark.reference import frame_ref, pose_ref  # noqa: E402


def _frame_attr(slam):
    return "_make_stereo" if slam.cfg.sensor == "stereo" else "make_rgbd"


def _ensure_stereo(slam):
    if slam.cfg.sensor == "stereo" and slam._make_stereo is None:
        from active_orb_slam2_tpu_torch.models.frame import (
            build_stereo_pipeline)
        slam._make_stereo = build_stereo_pipeline(slam.cfg)


def control_hook(rcam, rorb, dtype=torch.bfloat16):
    """The reference in bfloat16 in place of the frame pipeline and of the
    tracking step's pose solve."""
    def hook(slam):
        from active_orb_slam2_tpu_torch.models import tracking
        from active_orb_slam2_tpu_torch.models.frame import FrameData
        from active_orb_slam2_tpu_torch.models.optimizer import PoseOptResult
        _ensure_stereo(slam)

        def frame(a, b):
            if slam.cfg.sensor == "stereo":
                f = frame_ref.stereo_frame(rcam, rorb, a, b, dtype)
            else:
                f = frame_ref.rgbd_frame(rcam, rorb, a, b.to(torch.int32),
                                         dtype)
            fd = FrameData(uv=f.uv, level=f.level, angle=f.angle,
                           response=f.valid.float(), desc=f.desc,
                           valid=f.valid, ur=f.ur, depth=f.depth)
            n = (fd.valid & (fd.depth > 0.1)).sum().to(torch.int32)
            return fd, n

        def pose_opt(cam, pose0, pw, obs_uvr, level, has_stereo, valid,
                     rounds=4, iters_per_round=10):
            out, n_in, inl = pose_ref.solve(cam, pose0, pw, obs_uvr, level,
                                            has_stereo, valid, None, rounds,
                                            iters_per_round, dtype)
            return PoseOptResult(pose=out[..., :7], inliers=inl,
                                 n_inliers=n_in, chi2=out[..., 7])

        setattr(slam, _frame_attr(slam), frame)
        tracking.pose_optimization_fused = pose_opt
    return hook


def state_unchanged(slam):
    from active_orb_slam2_tpu_torch.models.tracking import STATS_POSE
    step = slam.track_step

    def frozen(m, frame, st, *a, **kw):
        _, stats, m2 = step(m, frame, st, *a, **kw)
        stats = stats.clone()
        stats[STATS_POSE] = st.pose.to(stats.dtype)
        return st, stats, m2

    slam.track_step = frozen


def _frame_fault(fn):
    def hook(slam):
        _ensure_stereo(slam)
        attr = _frame_attr(slam)
        make = getattr(slam, attr)

        def broken(*a):
            f, n = make(*a)
            return fn(f), n

        setattr(slam, attr, broken)
    return hook


def _half(f):
    keep = torch.arange(f.valid.shape[0], device=f.valid.device) % 2 == 0
    return f._replace(valid=f.valid & keep)


def _flip(f):
    return f._replace(desc=torch.cat([~f.desc[:, :1], f.desc[:, 1:]], 1))


FAULTS = {"state_unchanged": state_unchanged,
          "half_batch": _frame_fault(_half),
          "answer_altered": _frame_fault(_flip)}


def hooks_for(mode, cell_name, shrink=None):
    if mode == "program":
        return []
    if mode == "control":
        cj, yaml_path = definitions.config(definitions.cell(cell_name)["config"])
        cfg = session.port_config(cj, yaml_path, shrink)
        rcam, rorb, _ = session.reference_config(cj, yaml_path, cfg)
        return [control_hook(rcam, rorb)]
    return [FAULTS[mode]]


def run_mode(cell_name, seed, seconds, mode, device, shrink=None,
             mix_overrides=None, log=print):
    """(correct, numbers) of one run of ``mode``, the tracking module's
    pose solve restored after it."""
    from active_orb_slam2_tpu_torch.models import tracking
    saved = tracking.pose_optimization_fused
    try:
        r, numbers = session.run(cell_name, seed, seconds, False, device,
                                 hooks=hooks_for(mode, cell_name, shrink),
                                 shrink=shrink, mix_overrides=mix_overrides,
                                 log=log)
    finally:
        tracking.pose_optimization_fused = saved
    ok, _ = check.verdict(numbers, definitions.limits(cell_name))
    return ok, numbers, r


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", default="control",
                    choices=["control", "program", *FAULTS])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        ok, numbers, r = run_mode(
            args.workload, seed, args.seconds, args.mode, device,
            log=lambda m: print(m, file=sys.stderr, flush=True))
        row = {"workload": args.workload, "mode": args.mode, "seed": seed,
               "correct": ok, "frames": r.n_window, "failed": r.failed,
               "numbers": numbers}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
