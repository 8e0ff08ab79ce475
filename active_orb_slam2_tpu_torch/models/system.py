"""System: the public API and host orchestrator (RGB-D tracking path).

Port of the RGB-D subset of ``active_orb_slam2_tpu/models/system.py``.
Each frame is one step on the device (ORB extraction, tracking, the
keyframe decision and insertion) that never blocks the host; the
per-frame stats vectors are retired in batches: the host stacks a group
on the device, starts one non-blocking copy into pinned memory and
records a CUDA event, and runs the state machine (LOST detection,
trajectory records) once the event has completed.  The host therefore
runs a bounded number of frames behind the device.  ``flush()`` drains
the queue; reading ``System.state`` flushes.  On the CPU retirement is
immediate.

What the slice does not run raises ``NotImplementedError`` naming its
ROADMAP item: keyframe mapping (``use_mapping=True``), loop closing,
stereo and monocular input, relocalization of a LOST frame,
localization-only mode, and map checkpoint / save / load.
"""

import json
import time

import numpy as np
import torch

from active_orb_slam2_tpu_torch.config import SlamConfig
from active_orb_slam2_tpu_torch.geometry.se3 import se3_to_mat44
from active_orb_slam2_tpu_torch.io.trajectory import (
    resolve_frame_poses, save_kitti, save_tum)
from active_orb_slam2_tpu_torch.models.frame import build_frame_pipeline
from active_orb_slam2_tpu_torch.models.map_state import empty_map
from active_orb_slam2_tpu_torch.models.tracking import (
    STATS_POSE, STATS_REF_FID, STATS_REF_POSE, build_create_keyframe,
    build_track_step, init_track_state)
from active_orb_slam2_tpu_torch.utils import np_se3

NOT_INITIALIZED = 0
OK = 1
LOST = 2


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to active_orb_slam2_tpu_torch yet "
        f"(ROADMAP item {item})")


class System:
    """RGB-D SLAM engine, tracking path with local mapping off."""

    def __init__(self, cfg: SlamConfig, use_mapping: bool = True,
                 use_loop_closing: bool = False, pipeline_depth: int = 6,
                 retire_batch: int = 4, device="cpu"):
        if use_mapping:
            raise _not_ported("keyframe mapping (use_mapping=True)", 13)
        if use_loop_closing:
            raise _not_ported("loop closing", 15)
        self.cfg = cfg
        self.device = torch.device(device)
        self.make_rgbd = build_frame_pipeline(cfg)
        self.track_step = build_track_step(cfg)
        self.create_kf = build_create_keyframe(cfg)
        self.use_mapping = use_mapping
        self.pipeline_depth = max(int(pipeline_depth), 0)
        self.retire_batch = max(int(retire_batch), 1)
        self._clear()

    # ----------------------------------------------------- state / pipeline

    def _clear(self):
        """Empty map, fresh tracking state and host bookkeeping."""
        self.map = empty_map(self.cfg.map, self.cfg.orb, self.device)
        self.track = init_track_state(self.cfg.orb.n_features, self.device)
        self._state = NOT_INITIALIZED
        self._pending = []               # in-flight frame records
        self.frame_id = 0
        self.kf_seq = 0                  # monotone keyframe counter
        self.last_kf_slot = -1
        self._last_kf_pose_np = None
        self.rel_records = []            # (t, ref_kf_slot, Tcr) per frame
        self.kf_records = []             # (t, kf_slot) per keyframe
        self._live_slots = set()
        self._slot_fid = {}              # slot -> source frame id (gen tag)
        self.metrics = []                # per-frame dict

    def reset(self):
        """``System::Reset``: drop the map and all bookkeeping and return
        to NOT_INITIALIZED."""
        self.flush()
        self._clear()

    @property
    def state(self):
        """Tracking state; reading it drains the pipeline."""
        self.flush()
        return self._state

    def flush(self):
        """Retire every in-flight frame."""
        self._seal_stats_batch()
        while self._pending:
            self._retire(len(self._pending))

    def _seal_stats_batch(self):
        """Stack the open group of per-frame stats on the device and start
        one non-blocking copy of it into pinned host memory."""
        group = [e for e in self._pending if e.get("batch") is None]
        if not group:
            return
        arr = torch.stack([e["stats"] for e in group])
        if arr.is_cuda:
            host = torch.empty(arr.shape, dtype=arr.dtype, pin_memory=True)
            host.copy_(arr, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host, event = arr, None
        batch = {"host": host, "event": event}
        for i, e in enumerate(group):
            e["batch"] = batch
            e["slot"] = i

    @staticmethod
    def _stats_ready(entry) -> bool:
        """Non-blocking: has this frame's stats batch landed on the host?"""
        b = entry.get("batch")
        return b is not None and (b["event"] is None or b["event"].query())

    def _fetch_stats(self, entries):
        for e in entries:
            if e["batch"]["event"] is not None:
                e["batch"]["event"].synchronize()
        return np.stack([e["batch"]["host"][e["slot"]].numpy()
                         for e in entries])

    def _retire(self, n):
        """Pop the n oldest in-flight frames and run the host state
        machine on their stats: metrics, LOST detection, keyframe
        mirrors, trajectory records."""
        batch = self._pending[:n]
        if any(e.get("batch") is None for e in batch):
            self._seal_stats_batch()
        del self._pending[:n]
        stats = self._fetch_stats(batch)
        t_ret = time.perf_counter()
        for e, s in zip(batch, stats):
            (n_mm, n_inliers, ok, _close_tracked, _close_unmatched,
             _n_assoc, kf_slot, ref_slot) = (int(v) for v in s[:8])
            pose_np = s[STATS_POSE].astype(np.float32)
            ref_pose_np = s[STATS_REF_POSE].astype(np.float32)
            self.metrics.append({
                "frame": e["frame_id"], "ts": float(e["ts"]),
                "n_motion_inliers": n_mm, "n_inliers": n_inliers,
                "state": int(self._state), "n_keyframes": self.kf_seq,
                "wall_ms": round((t_ret - e["t_enq"]) * 1e3, 3)})
            if not ok:
                self._state = LOST
            else:
                self._state = OK
                if kf_slot >= 0:
                    self._register_keyframe(kf_slot, e["ts"], e["frame_id"])
            # the generation tag must match: a slot can be culled and
            # re-tenanted while a frame is in flight.  Keyframe culling
            # (and with it the cull-redirect lineage) comes with local
            # mapping, ROADMAP item 13; until then a mismatch freezes
            # the record at the tracked pose.
            ref_fid = int(s[STATS_REF_FID])
            gen_ok = (ref_slot >= 0 and ref_slot in self._live_slots
                      and self._slot_fid.get(ref_slot) == ref_fid)
            if ref_slot >= 0 and not gen_ok:
                self.rel_records.append(
                    (e["ts"], -1, np.asarray(pose_np, np.float64)))
            else:
                self._record_frame(e["ts"], pose_np,
                                   ref=ref_slot if ref_slot >= 0 else None,
                                   ref_pose=ref_pose_np)

    def _register_keyframe(self, k, timestamp, frame_id):
        """Mirror a keyframe the device inserted."""
        self.kf_seq += 1
        self._live_slots.add(k)
        self._slot_fid[k] = frame_id
        self.last_kf_slot = k
        self.kf_records.append((timestamp, k))

    def _upload(self, *arrays):
        """Host numpy arrays -> device tensors, without blocking the host
        on the card (pinned memory, non-blocking copies)."""
        out = []
        for a in arrays:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out.append(t)
        return out

    def _dispatch_track(self, host_inputs, timestamp):
        """Enqueue one frame step; retire what has landed, and a batch if
        the pipeline is deep enough.  Never blocks on the current frame."""
        if self._state == LOST:
            self.flush()
            if self._state == LOST:
                raise _not_ported("relocalization of a LOST frame", 14)
        frame, _ = self.make_rgbd(*host_inputs)
        st, stats, m = self.track_step(
            self.map, frame, self.track,
            self.use_mapping)
        self.map, self.track = m, st
        self._pending.append({"frame_id": self.frame_id, "ts": timestamp,
                              "stats": stats, "t_enq": time.perf_counter()})
        if sum(1 for e in self._pending
               if e.get("batch") is None) >= self.retire_batch:
            self._seal_stats_batch()
        n_ready = 0
        for e in self._pending[:-1]:
            if not self._stats_ready(e):
                break
            n_ready += 1
        if n_ready:
            self._retire(n_ready)
        if len(self._pending) >= self.pipeline_depth + self.retire_batch:
            self._retire(self.retire_batch)
        self.frame_id += 1
        return se3_to_mat44(st.pose)

    # ------------------------------------------------------------- tracking

    def track_rgbd(self, gray, depth, timestamp: float):
        """Process one RGB-D frame; returns Tcw as a 4x4 tensor on the
        device (it may still be computing; ``.cpu()`` waits for it).

        ``gray`` [H, W] uint8 or float 0..255; ``depth`` metric float
        metres (0 = missing) or uint16 millimetres.
        """
        g = np.asarray(gray)
        if g.dtype != np.uint8:
            g = np.clip(g, 0, 255).astype(np.uint8)
        d = np.asarray(depth)
        if d.dtype != np.uint16:
            d = np.clip(d * 1e3, 0, 65535).astype(np.uint16)
        inputs = self._upload(g, d)
        if self._state == NOT_INITIALIZED:
            frame, n_depth = self.make_rgbd(*inputs)
            pose = self._initialize(frame, int(n_depth), timestamp)
            self.frame_id += 1
            return se3_to_mat44(pose)
        return self._dispatch_track(inputs, timestamp)

    def _initialize(self, frame, n_depth, timestamp):
        """StereoInitialization: the first frame with enough depth points
        becomes keyframe 0 at the origin.  Runs once, so it may wait on
        the device."""
        pose = self.track.pose
        if n_depth < 100:
            self._record_frame(timestamp, pose.cpu().numpy())
            return pose
        assoc0 = torch.full((self.cfg.orb.n_features,), -1,
                            dtype=torch.int32, device=self.device)
        k, ok = self.create_kf(self.map, frame, pose, assoc0, self.frame_id,
                               self.kf_seq, -1)
        if not bool(ok):
            self._record_frame(timestamp, pose.cpu().numpy())
            return pose
        k = int(k)
        self.last_kf_slot = k
        self._live_slots.add(k)
        self._slot_fid[k] = self.frame_id
        self.kf_seq += 1
        kf_inliers = int((self.map.kf_point[k] >= 0).sum())
        self._last_kf_pose_np = self.map.kf_pose[k].cpu().numpy()
        self.kf_records.append((timestamp, k))

        def scalar(v, dtype=torch.int32):
            return torch.tensor(v, dtype=dtype, device=self.device)

        self.track = self.track._replace(
            assoc=self.map.kf_point[k].clone(), angle=frame.angle,
            ok=scalar(True, torch.bool), frame_id=scalar(self.frame_id + 1),
            kf_seq=scalar(self.kf_seq), last_kf_slot=scalar(k),
            last_kf_inliers=scalar(kf_inliers),
            frames_since_kf=scalar(0))
        self._state = OK
        self._record_frame(timestamp, pose.cpu().numpy())
        return pose

    def _record_frame(self, timestamp, pose_np, ref=None, ref_pose=None):
        """Store Tcr relative to the reference keyframe."""
        if ref is None:
            ref = max(self.last_kf_slot, 0)
        if ref_pose is None:
            ref_pose = self._last_kf_pose_np
        if ref_pose is None:
            ref_pose = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
        tcr = np_se3.se3_compose(np.asarray(pose_np, np.float64),
                                 np_se3.se3_inverse(
                                     np.asarray(ref_pose, np.float64)))
        self.rel_records.append((timestamp, int(ref), tcr))

    def track_stereo(self, left, right, timestamp: float):
        raise _not_ported("stereo tracking", 16)

    def track_mono(self, gray, timestamp: float):
        raise _not_ported("monocular tracking", 17)

    def activate_localization_mode(self):
        raise _not_ported("localization-only mode", 14)

    # ------------------------------------------------------------- outputs

    def frame_trajectory(self):
        """(timestamps, Tcw [N, 7]) with relative poses replayed against
        the final keyframe poses, like SaveTrajectoryTUM."""
        self.flush()
        return resolve_frame_poses(self.rel_records,
                                   self.map.kf_pose.cpu().numpy())

    def keyframe_trajectory(self):
        self.flush()
        ts = np.array([t for t, _ in self.kf_records])
        kf_pose = self.map.kf_pose.cpu().numpy()
        poses = np.stack([kf_pose[k] for _, k in self.kf_records]) \
            if self.kf_records else np.zeros((0, 7))
        return ts, poses

    def save_trajectory_tum(self, path):
        ts, poses = self.frame_trajectory()
        save_tum(path, ts, poses)

    def save_keyframe_trajectory_tum(self, path):
        ts, poses = self.keyframe_trajectory()
        save_tum(path, ts, poses)

    def save_trajectory_kitti(self, path):
        _, poses = self.frame_trajectory()
        save_kitti(path, poses)

    def save_metrics(self, path):
        """Per-frame metrics as JSONL."""
        self.flush()
        with open(path, "w") as f:
            for m in self.metrics:
                f.write(json.dumps(m) + "\n")

    def checkpoint(self):
        raise _not_ported("map checkpoint", 13)

    def save_map(self, path):
        raise _not_ported("map save / load", 13)
