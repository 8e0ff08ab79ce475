"""System: the public API and host orchestrator (RGB-D, stereo and
monocular tracking with local mapping, loop closing, relocalization,
localization-only mode).

Port of ``active_orb_slam2_tpu/models/system.py``.  Each frame is one
step on the device (ORB extraction, tracking, the
keyframe decision and insertion) that never blocks the host; the
per-frame stats vectors are retired in batches: the host stacks a group
on the device, starts one non-blocking copy into pinned memory and
records a CUDA event, and runs the state machine (LOST detection,
keyframe mapping, trajectory records) once the event has completed.
The host therefore runs a bounded number of frames behind the device.
``flush()`` drains the queue; reading ``System.state`` flushes.  On the
CPU a sealed batch is ready at once.  As in the JAX package, monocular
input retires every frame before the next by default (``pipeline_depth``
0, ``retire_batch`` 1: a keyframe's new points must exist before the
next frame tracks), so a mono frame waits on the card once, at its
retirement; RGB-D and stereo run 6 deep in batches of 4.

Monocular initialization (``MonocularInitialization``) waits on the card:
the first frame with enough features becomes the reference, a later one
is matched against it (``models/mono_init.py``), the homography /
fundamental race reconstructs the pair (``models/initializer.py``, its
Gumbel noise drawn from a generator seeded as the JAX package's
``PRNGKey(3)``), and the two-keyframe map is written with its BA.

Each keyframe the device inserted runs one keyframe-mapping call
(``models/local_mapping.py::build_keyframe_mapping``: triangulation,
fusion, point culling, local BA, keyframe culling) on the arena in
place.  Its cull victim, with the parent and pose snapshots, goes to
pinned memory the same way and is read at the next keyframe event, so
the host never waits on the mapping.  An arena that is full of
keyframes forces an eviction, which does wait on the card, as in the
JAX package.

With ``use_loop_closing`` each keyframe event then runs one step of the
loop closer (``models/loop_closing.py``), fed the mapping call's
covisibility matrix and the host's mirrors of the live keyframes: the
previous event's detection is resolved, verified and corrected (these
wait on the card), a deferred global-BA slice runs, this keyframe's
detection is dispatched.  After a closure the carried tracking pose is
rebased by the new keyframe's correction.

A frame that arrives LOST (after a tracking failure, or the first
frame after ``load_map``) first drains the pipeline and tries
relocalization (``models/relocalization.py``) against the 8 keyframes
that score highest against it in BoW once the loop closer has a
vocabulary, else the 8 newest keyframes; that attempt waits on the
card, as the JAX package's does.
Its solvers' one-time setup on the card runs when the ``System`` is
built, so that the first attempt does not stall on it.  On success the
frame is tracked by the normal step from the recovered pose; on failure
it is recorded LOST at the carried pose.  In
localization-only mode the step inserts no keyframe and tracks on
temporal points where the map is out of view.
"""

import json
import sys
import time

import numpy as np
import torch

from active_orb_slam2_tpu_torch.config import SlamConfig
from active_orb_slam2_tpu_torch.geometry.se3 import (
    se3_compose, se3_inverse, se3_to_mat44)
from active_orb_slam2_tpu_torch.io.trajectory import (
    resolve_frame_poses, save_kitti, save_tum)
from active_orb_slam2_tpu_torch.models import convert
from active_orb_slam2_tpu_torch.models.frame import (
    build_frame_pipeline, build_stereo_pipeline)
from active_orb_slam2_tpu_torch.models.initializer import (
    N_HYPOTHESES as INIT_HYPOTHESES, build_initializer,
    warm_up_solvers as warm_up_initializer)
from active_orb_slam2_tpu_torch.models.local_mapping import (
    build_keyframe_culling, build_keyframe_mapping)
from active_orb_slam2_tpu_torch.models.loop_closing import (
    LoopCloser, warm_up as warm_up_loop_closing)
from active_orb_slam2_tpu_torch.models.map_state import empty_map
from active_orb_slam2_tpu_torch.models.mono_init import (
    build_create_initial_map, build_mono_matcher)
from active_orb_slam2_tpu_torch.models.relocalization import (
    build_relocalizer, gumbel_noise, warm_up_solvers)
from active_orb_slam2_tpu_torch.models.sim3_solver import (
    gumbel_noise as init_noise)
from active_orb_slam2_tpu_torch.models.tracking import (
    STATS_POSE, STATS_REF_FID, STATS_REF_POSE, build_create_keyframe,
    build_track_step, init_track_state)
from active_orb_slam2_tpu_torch.utils import np_se3, trace
from active_orb_slam2_tpu_torch.utils.transfer import (
    landed, to_pinned, upload)

NOT_INITIALIZED = 0
OK = 1
LOST = 2
N_RELOC_CANDIDATES = 8     # keyframes one relocalization attempt tries
RELOC_SEED = 11            # the JAX package's PRNGKey(11)
INIT_SEED = 3              # the JAX package's PRNGKey(3)
MIN_INIT_FEATURES = 100    # features a mono reference frame needs
MIN_INIT_MATCHES = 100     # matches an initialization attempt needs
MIN_INIT_POINTS = 80       # points the initial map needs


def _rebase_pose(pose, old_ref, new_ref):
    """A carried Tcw in loop-corrected coordinates: Tcr = pose old_ref^-1
    is kept, so the pose moves by its reference keyframe's correction
    (the velocity, a relative pose, is unchanged)."""
    return se3_compose(se3_compose(pose, se3_inverse(old_ref)), new_ref)


class System:
    """RGB-D / stereo / monocular SLAM engine: tracking with local mapping
    and loop closing at each keyframe, relocalization and
    localization-only mode.

    Runs on the CUDA card (``device``, by default ``cuda``); a CPU run
    passes ``device="cpu"``.  ``vocab_path`` names a DBoW2 text
    vocabulary for the loop closer; without it the vocabulary is trained
    from the map's descriptors.  ``pipeline_depth`` and ``retire_batch``
    default by sensor: 0 and 1 for ``cfg.sensor == "mono"``, else 6 and
    4.

    The tracer (``utils/trace.py``) records the stages of each call when
    it is on: ``system.track`` is the root of a frame (``frame_id``),
    ``setup.system`` the construction.
    """

    @trace.traced("setup.system")
    def __init__(self, cfg: SlamConfig, use_mapping: bool = True,
                 use_loop_closing: bool = False, pipeline_depth=None,
                 retire_batch=None, device=torch.device("cuda"),
                 vocab_path=None):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "System runs on the CUDA card unless told otherwise, and "
                "this machine has none; pass device=\"cpu\" to run on the "
                "CPU")
        self.make_rgbd, self.make_mono = build_frame_pipeline(cfg)
        self._make_stereo = None         # built at the first stereo frame
        self.track_step = build_track_step(cfg)
        self.create_kf = build_create_keyframe(cfg)
        self.use_mapping = use_mapping
        # the keyframe-rate mapping stages in one call per keyframe
        # event; forced eviction for the arena-full path only
        self.keyframe_mapping = build_keyframe_mapping(cfg)
        self.kf_culling_forced = build_keyframe_culling(cfg, force=True)
        mono = cfg.sensor == "mono"
        if pipeline_depth is None:
            pipeline_depth = 0 if mono else 6
        if retire_batch is None:
            retire_batch = 1 if mono else 4
        self.pipeline_depth = max(int(pipeline_depth), 0)
        self.retire_batch = max(int(retire_batch), 1)
        # the monocular bootstrap, built at the first mono frame
        self._mono_match = self._mono_create = self._mono_init = None
        self.localization_only = False
        self.loop_closer = LoopCloser(cfg, vocab_path=vocab_path) \
            if use_loop_closing else None
        self.relocalizer = None          # built at the first LOST frame
        self._reloc_gen = None           # its random numbers
        if self.device.type == "cuda":
            # the solvers' one-time setup, here and not in the first
            # relocalization attempt or loop verification
            warm_up_solvers(N_RELOC_CANDIDATES, self.device)
            if mono:
                warm_up_initializer(self.device)
            if use_loop_closing:
                warm_up_loop_closing(cfg, self.device)
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
        self.n_live_kf = 0               # live (valid) keyframe count
        self.last_kf_slot = -1
        self.last_kf_inliers = 0         # local inliers at the newest KF
        self._last_kf_pose_np = None
        self.rel_records = []            # (t, ref_kf_slot, Tcr) per frame
        self.kf_records = []             # (t, kf_slot) per keyframe
        self._live_slots = set()
        self._slot_fid = {}              # slot -> source frame id (gen tag)
        # (slot, fid) -> (parent, T_vp, pfid, created_frame): the lineage
        # of culled keyframes that in-flight frames may still reference,
        # path-compressed at cull time and pruned (_prune_redirects)
        self._cull_redirect = {}
        self._kf_ins_frames = []         # frame ids of keyframe insertions
        self._pending_culls = []         # cull snapshots not yet read
        self.n_forced_culls = 0          # arena-full evictions (they wait)
        self.n_loops_closed = 0
        self.metrics = []                # per-frame dict
        self._ref_frame = None           # mono initialization reference
        self._init_gen = None            # its random numbers
        if self.loop_closer is not None:
            self.loop_closer.reset_state()

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
        """Retire every in-flight frame and read every pending cull."""
        self._seal_stats_batch()
        while self._pending:
            self._retire(len(self._pending))
        self._process_pending_culls()

    def _seal_stats_batch(self):
        """Stack the open group of per-frame stats on the device and start
        one non-blocking copy of it into pinned host memory."""
        group = [e for e in self._pending if e.get("batch") is None]
        if not group:
            return
        host, event = to_pinned(torch.stack([e["stats"] for e in group]))
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
                with trace.span("system.wait"):
                    e["batch"]["event"].synchronize()
        return np.stack([e["batch"]["host"][e["slot"]].numpy()
                         for e in entries])

    @trace.traced("system.retire")
    def _retire(self, n):
        """Pop the n oldest in-flight frames and run the host state
        machine on their stats: metrics, LOST detection, keyframe
        mirrors and mapping, trajectory records."""
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
                    self._register_keyframe(kf_slot, e["ts"], e["frame_id"],
                                            n_inliers)
            # the generation tag must match: a slot can be culled and
            # re-tenanted while a frame is in flight.  A mismatched record
            # walks the cull-redirect lineage to a live ancestor.
            ref_fid = int(s[STATS_REF_FID])
            gen_ok = (ref_slot >= 0 and ref_slot in self._live_slots
                      and self._slot_fid.get(ref_slot) == ref_fid)
            if ref_slot >= 0 and not gen_ok:
                self.rel_records.append(self._follow_lineage(
                    e["ts"], pose_np, ref_pose_np, ref_slot, ref_fid))
            else:
                self._record_frame(e["ts"], pose_np,
                                   ref=ref_slot if ref_slot >= 0 else None,
                                   ref_pose=ref_pose_np)
        # arena full: evict a keyframe so the device's (live < max)
        # insertion gate reopens
        if self.n_live_kf >= self.cfg.map.max_keyframes:
            self._cull_for_space()
        self._prune_redirects()

    def _follow_lineage(self, ts, pose_np, ref_pose_np, slot, fid):
        """The trajectory record of a frame whose reference keyframe
        (slot, fid) was culled: Tcr composed along the cull redirects to
        a live ancestor, or an absolute pose where the lineage ends in
        one, or the tracked pose where there is no lineage."""
        tcr = np_se3.se3_compose(
            np.asarray(pose_np, np.float64),
            np_se3.se3_inverse(np.asarray(ref_pose_np, np.float64)))
        hops = 0
        for _ in range(64):                  # bounded lineage walk
            nxt = self._cull_redirect.get((slot, fid))
            if nxt is None:
                break
            tcr = np_se3.se3_compose(tcr, nxt[1])
            slot, fid = nxt[0], nxt[2]
            hops += 1
            if slot < 0:
                break
        if (slot >= 0 and slot in self._live_slots
                and self._slot_fid.get(slot) == fid):
            return (ts, slot, tcr)
        if hops > 0 and slot < 0:
            return (ts, -1, tcr)         # tcr already composes a world pose
        return (ts, -1, np.asarray(pose_np, np.float64))

    def _register_keyframe(self, k, timestamp, frame_id, n_inliers):
        """Mirror a keyframe the device inserted, run the keyframe mapping
        on it, then a loop-closing step.  Nothing here waits on the card
        but a loop verification or correction (and the vocabulary's
        training): the previous event's cull snapshot has landed by now,
        and this event's is read at the next one."""
        # process the previous cull before the new slot is mirrored (the
        # new keyframe may re-tenant the culled slot)
        self._process_pending_culls()
        self.kf_seq += 1
        self.n_live_kf += 1
        self._live_slots.add(k)
        self._slot_fid[k] = frame_id
        self._kf_ins_frames.append(frame_id)
        self.last_kf_slot = k
        self.last_kf_inliers = n_inliers
        self.kf_records.append((timestamp, k))
        W = None
        if self.use_mapping:
            with trace.span("mapping", frame=frame_id):
                _, victim, vparent, vpose, vppose, W = self.keyframe_mapping(
                    self.map, k, self.kf_seq)
            snap = torch.cat([torch.stack([victim, vparent]).to(vpose.dtype),
                              vpose, vppose])
            self._pending_culls.append(to_pinned(snap))
        if self.loop_closer is not None:
            pre_pose_k = self.map.kf_pose[k].clone()
            with trace.span("loop", frame=frame_id):
                self.map, closed = self.loop_closer.process_keyframe(
                    self.map, k, self.kf_seq, W=W, n_live_kf=self.n_live_kf,
                    slot_fid=self._slot_fid)
            if closed:
                self.n_loops_closed += 1
                self.track = self.track._replace(pose=_rebase_pose(
                    self.track.pose, pre_pose_k, self.map.kf_pose[k]))

    def _process_pending_culls(self):
        """Read the cull snapshots of earlier keyframe events (host
        bookkeeping only: the eviction happened in the mapping call)."""
        while self._pending_culls:
            s = landed(*self._pending_culls.pop(0))
            v = int(s[0])
            if v >= 0:
                self._on_keyframe_culled(
                    v, parent=int(s[1]), vpose=s[2:9].astype(np.float64),
                    ppose=s[9:16].astype(np.float64))

    def _cull_for_space(self) -> bool:
        """Evict one keyframe to make room (arena-full path): the 90%
        redundancy rule, else the most redundant non-anchor keyframe.
        Reads the victim at once, so it waits on the card."""
        if self.last_kf_slot < 0:
            return False
        self.n_forced_culls += 1
        _, victim = self.kf_culling_forced(self.map, self.last_kf_slot)
        v = int(victim)
        if v < 0:
            print("[active_orb_slam2_tpu_torch] WARNING: keyframe arena "
                  "full and no evictable keyframe found; mapping is "
                  "stalled (raise MapConfig.max_keyframes)",
                  file=sys.stderr)
            return False
        self._on_keyframe_culled(v)
        return True

    def _on_keyframe_culled(self, victim: int, parent=None, vpose=None,
                            ppose=None):
        """Repoint the trajectory records of a culled keyframe onto its
        spanning-tree parent (the reference's SaveTrajectoryTUM walks
        ``pKF->GetParent()`` while ``pKF->isBad()``): Tcr' = Tcr Tv Tp^-1
        keeps the replayed pose at cull time and lets it follow the
        parent.  The parent must be live; otherwise the temporally
        nearest live keyframe stands in, and with no live keyframe at
        all the records become absolute poses."""
        if victim < 0:
            return
        self.n_live_kf = max(self.n_live_kf - 1, 0)
        self._live_slots.discard(victim)
        victim_fid = self._slot_fid.pop(victim, None)
        if parent is None or vpose is None:
            # forced eviction: the slot cannot have been re-tenanted yet
            parent = int(self.map.kf_parent[victim])
            vpose = self.map.kf_pose[victim].cpu().numpy().astype(np.float64)
        if parent < 0 or parent not in self._live_slots:
            vfid = victim_fid if victim_fid is not None else self.frame_id
            parent = min(self._live_slots,
                         key=lambda s: abs(self._slot_fid.get(s, 0) - vfid)) \
                if self._live_slots else -1
            ppose = None
        if parent >= 0:
            if ppose is None:
                ppose = self.map.kf_pose[parent].cpu().numpy().astype(
                    np.float64)
            t_vp = np_se3.se3_compose(vpose, np_se3.se3_inverse(ppose))
            self.rel_records = [
                (t, parent, np_se3.se3_compose(tcr, t_vp))
                if ref == victim else (t, ref, tcr)
                for (t, ref, tcr) in self.rel_records]
            if victim_fid is not None:
                self._add_redirect(victim, victim_fid, parent, t_vp,
                                   self._slot_fid.get(parent))
        else:
            self.rel_records = [
                (t, -1, np_se3.se3_compose(tcr, vpose))
                if ref == victim else (t, ref, tcr)
                for (t, ref, tcr) in self.rel_records]
            if victim_fid is not None:
                self._add_redirect(victim, victim_fid, -1, vpose, None)
        self.kf_records = [r for r in self.kf_records if r[1] != victim]

    def _add_redirect(self, victim, victim_fid, parent, t_vp, pfid):
        """Record a cull redirect and path-compress the entries that point
        at the victim's generation, so chains stay one hop."""
        vkey = (victim, victim_fid)
        self._cull_redirect[vkey] = (parent, t_vp, pfid, self.frame_id)
        for key, (p, t, pf, cf) in list(self._cull_redirect.items()):
            if key != vkey and (p, pf) == vkey:
                self._cull_redirect[key] = (
                    parent, np_se3.se3_compose(t, t_vp), pfid, cf)

    def _prune_redirects(self):
        """Drop redirects no in-flight frame can reference: an entry
        (slot, fid) is dead once a newer keyframe insertion has been
        retired past by every pending frame."""
        if not self._cull_redirect:
            return
        oldest_pending = (self._pending[0]["frame_id"]
                          if self._pending else self.frame_id)
        cutoff = next((f for f in reversed(self._kf_ins_frames)
                       if f < oldest_pending), None)
        if cutoff is None:
            return
        for key in [k for k, v in self._cull_redirect.items()
                    if k[1] < cutoff and v[3] < oldest_pending]:
            del self._cull_redirect[key]
        self._kf_ins_frames = [f for f in self._kf_ins_frames if f >= cutoff]

    def _scalar(self, v, dtype=torch.int32):
        """A 0-d tensor on the device (a host copy: initialization and
        relocalization only)."""
        return torch.tensor(v, dtype=dtype, device=self.device)

    @trace.traced("system.upload")
    def _upload(self, *arrays):
        """Host numpy arrays -> device tensors, without blocking the host
        on the card (pinned memory, non-blocking copies)."""
        return upload(self.device, *arrays)

    def _dispatch_track(self, frame, timestamp):
        """Enqueue one frame step; retire what has landed, and a batch if
        the pipeline is deep enough.  Never blocks on the current frame,
        except on a LOST frame, which tries relocalization first."""
        if self._state == LOST:
            self.flush()
            if self._state == LOST and not self._try_relocalize(frame):
                self.metrics.append({
                    "frame": self.frame_id, "ts": float(timestamp),
                    "n_motion_inliers": 0, "n_inliers": 0, "state": LOST,
                    "n_keyframes": self.kf_seq, "wall_ms": None})
                self._record_frame(timestamp, self.track.pose.cpu().numpy())
                self.frame_id += 1
                return se3_to_mat44(self.track.pose)
        st, stats, m = self.track_step(
            self.map, frame, self.track,
            self.use_mapping and not self.localization_only,
            self.localization_only)
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
        return self._track_frame(self.make_rgbd, (g, d), timestamp,
                                 self._initialize)

    def _track_frame(self, make, images, timestamp, initialize):
        """Upload the images, build the frame on the device and track it,
        or, before the map exists, hand it to ``initialize(frame,
        n_depth, timestamp)``: the tracer's root span of the frame."""
        with trace.span("system.track", frame=self.frame_id):
            frame, n_depth = make(*self._upload(*images))
            if self._state == NOT_INITIALIZED:
                pose = initialize(frame, n_depth, timestamp)
                self.frame_id += 1
                return se3_to_mat44(pose)
            return self._dispatch_track(frame, timestamp)

    def _initialize(self, frame, n_depth, timestamp):
        """StereoInitialization: the first frame with enough depth points
        becomes keyframe 0 at the origin.  Runs once, so it may wait on
        the device."""
        pose = self.track.pose
        if int(n_depth) < 100:
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
        self._kf_ins_frames.append(self.frame_id)
        self.kf_seq += 1
        self.n_live_kf += 1
        kf_inliers = int((self.map.kf_point[k] >= 0).sum())
        self.last_kf_inliers = kf_inliers
        self._last_kf_pose_np = self.map.kf_pose[k].cpu().numpy()
        self.kf_records.append((timestamp, k))

        scalar = self._scalar
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
        """Process one rectified stereo pair ([H, W] uint8 or float
        0..255 each); returns Tcw as a 4x4 tensor on the device, as
        :meth:`track_rgbd`.  Depth comes from row-band matching with SAD
        refinement; the back end is the RGB-D one."""
        if self._make_stereo is None:
            self._make_stereo = build_stereo_pipeline(self.cfg)
        images = [np.asarray(a) for a in (left, right)]
        images = [a if a.dtype == np.uint8
                  else np.clip(a, 0, 255).astype(np.uint8) for a in images]
        return self._track_frame(self._make_stereo, images, timestamp,
                                 self._initialize)

    def track_mono(self, gray, timestamp: float):
        """Process one monocular frame ([H, W] uint8 or float 0..255);
        returns Tcw as a 4x4 tensor on the device, as :meth:`track_rgbd`.
        Until the map is initialized the pose is the identity."""
        g = np.asarray(gray)
        if g.dtype != np.uint8:
            g = np.clip(g, 0, 255).astype(np.uint8)
        return self._track_frame(
            self.make_mono, (g,), timestamp,
            lambda frame, _, t: self._initialize_mono(frame, t))

    def _initialize_mono(self, frame, timestamp):
        """``MonocularInitialization``: the first frame with enough
        features becomes the reference; a later frame with enough matches
        to it runs the initializer, and on success the two-keyframe map
        (keyframe 0 recorded one frame period before this frame, as in
        the JAX package).  Waits on the card at each of its four gates."""
        if self._mono_match is None:
            self._mono_match = build_mono_matcher(self.cfg)
            self._mono_create = build_create_initial_map(self.cfg)
            self._mono_init = build_initializer(self.cfg.camera)
        pose = self.track.pose

        def not_yet():
            self._record_frame(timestamp, pose.cpu().numpy())
            return pose

        n_valid = int(frame.valid.sum())
        if self._ref_frame is None or n_valid < MIN_INIT_FEATURES:
            if n_valid >= MIN_INIT_FEATURES:
                self._ref_frame = frame
            return not_yet()
        ref = self._ref_frame
        match_idx, n_matches = self._mono_match(ref, frame)
        if int(n_matches) < MIN_INIT_MATCHES:
            self._ref_frame = frame
            return not_yet()
        if self._init_gen is None:
            self._init_gen = torch.Generator(device=self.device)
            self._init_gen.manual_seed(INIT_SEED)
        noise = init_noise(INIT_HYPOTHESES, match_idx.shape[0],
                           self._init_gen, self.device)
        res = self._mono_init(noise, ref.uv,
                              frame.uv[torch.clamp(match_idx, min=0).long()],
                              match_idx >= 0)
        if not bool(res.ok):
            return not_yet()
        self.map, kp1, pose2, n_pts = self._mono_create(
            self.map, ref, frame, res.pose2, res.points, res.point_ok,
            match_idx)
        n_pts = int(n_pts)
        if n_pts < MIN_INIT_POINTS:
            return not_yet()
        # the keyframes' frame ids are their slots (copied for parity)
        self.kf_seq = self.n_live_kf = 2
        self._live_slots.update((0, 1))
        self._slot_fid.update({0: 0, 1: 1})
        self._kf_ins_frames.extend([0, 1])
        self.last_kf_slot = 1
        self.last_kf_inliers = n_pts
        self.kf_records += [(timestamp - 1.0 / 30.0, 0), (timestamp, 1)]

        scalar = self._scalar
        self.track = self.track._replace(
            pose=pose2, assoc=kp1, angle=frame.angle,
            ok=scalar(True, torch.bool), vel_ok=scalar(False, torch.bool),
            frame_id=scalar(self.frame_id + 1), kf_seq=scalar(self.kf_seq),
            last_kf_slot=scalar(1), last_kf_inliers=scalar(n_pts),
            frames_since_kf=scalar(0))
        self._state = OK
        self._last_kf_pose_np = self.map.kf_pose[1].cpu().numpy()
        self._record_frame(timestamp, pose2.cpu().numpy())
        return pose2

    # ------------------------------------------------------ relocalization

    def _reloc_candidates(self, frame=None):
        """Candidate keyframe slots padded with -1: with a loop-closer
        vocabulary, the keyframes scoring highest (> 0) against
        ``frame``'s BoW (``DetectRelocalizationCandidates``; reads the
        scores); else the newest keyframes, newest first, from the host
        records, or, right after ``load_map``, from the arena's frame
        ids."""
        lc = self.loop_closer
        if frame is not None and lc is not None and lc.ensure_vocabulary(
                self.map, n_kf=self.n_live_kf) is not None:
            scores = lc.score_query(self.map, frame.desc, frame.valid) \
                .cpu().numpy().copy()
            scores[~self.map.kf_valid.cpu().numpy()] = -1.0
            cands = np.argsort(-scores, kind="stable")[
                :N_RELOC_CANDIDATES].astype(np.int32)
            cands[scores[cands] <= 0] = -1
            return cands
        slots = [k for _, k in self.kf_records[-N_RELOC_CANDIDATES:]][::-1]
        if not slots:
            valid = np.flatnonzero(self.map.kf_valid.cpu().numpy())
            fid = self.map.kf_frame_id.cpu().numpy()[valid]
            slots = list(valid[np.argsort(-fid, kind="stable")]
                         [:N_RELOC_CANDIDATES])
        cands = np.full(N_RELOC_CANDIDATES, -1, np.int32)
        cands[:len(slots)] = slots
        return cands

    @trace.traced("system.reloc")
    def _try_relocalize(self, frame) -> bool:
        """``Tracking::Relocalization`` against the newest keyframes:
        batched PnP RANSAC and two pose refinements; >= 50 inliers to
        accept.  Waits on the card for the verdict."""
        if self.relocalizer is None:
            self.relocalizer = build_relocalizer(
                self.cfg, n_candidates=N_RELOC_CANDIDATES)
            self._reloc_gen = torch.Generator(device=self.device)
            self._reloc_gen.manual_seed(RELOC_SEED)
        noise = gumbel_noise(N_RELOC_CANDIDATES, self.cfg.orb.n_features,
                             self._reloc_gen, self.device)
        cands, = self._upload(self._reloc_candidates(frame))
        res = self.relocalizer(self.map, frame, cands, noise)
        if not bool(res.ok):
            return False

        scalar = self._scalar
        self.track = self.track._replace(
            pose=res.pose, assoc=res.assoc, angle=frame.angle,
            vel_ok=scalar(False, torch.bool), ok=scalar(True, torch.bool),
            frame_id=scalar(self.frame_id), kf_seq=scalar(self.kf_seq),
            last_kf_slot=scalar(max(self.last_kf_slot, 0)),
            last_kf_inliers=scalar(max(self.last_kf_inliers, 1)))
        self._state = OK
        return True

    # ------------------------------------------------------------ mode API

    def activate_localization_mode(self):
        """Track against the map without inserting keyframes, on temporal
        points where the map is out of view."""
        self.flush()
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.flush()
        self.localization_only = False

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
        """The whole map as a dict of numpy arrays with the JAX package's
        field names and dtypes (descriptors uint32)."""
        self.flush()
        return convert.map_to_jax_numpy(self.map)

    def restore(self, ckpt: dict):
        """Write checkpointed fields into the arena in place (the shapes
        must be the arena's)."""
        self.flush()
        for f, v in ckpt.items():
            getattr(self.map, f).copy_(convert.to_torch(v, self.device))

    def save_map(self, path):
        """The map arena and the host counters in one ``.npz`` file, in
        the JAX package's layout, so either package loads it."""
        ckpt = self.checkpoint()
        ckpt["_host_kf_seq"] = np.int64(self.kf_seq)
        ckpt["_host_last_kf_slot"] = np.int64(self.last_kf_slot)
        np.savez_compressed(path, **ckpt)

    def load_map(self, path):
        """Load a map saved by either package's ``save_map``.  The host
        records of the previous session are dropped and tracking restarts
        LOST, so the next frame relocalizes into the loaded map (the
        map-reuse flow, usually with localization-only mode)."""
        self.flush()
        with np.load(path) as data:
            self.restore({k: data[k] for k in data.files
                          if not k.startswith("_host_")})
            self.kf_seq = int(data["_host_kf_seq"])
            self.last_kf_slot = int(data["_host_last_kf_slot"])
        self.track = init_track_state(self.cfg.orb.n_features, self.device)
        self.rel_records = []
        self.kf_records = []
        self.metrics = []
        self._pending = []
        kf_valid = self.map.kf_valid.cpu().numpy()
        fids = self.map.kf_frame_id.cpu().numpy()
        self.n_live_kf = int(kf_valid.sum())
        self._live_slots = set(int(s) for s in np.flatnonzero(kf_valid))
        self._slot_fid = {s: int(fids[s]) for s in self._live_slots}
        self._cull_redirect = {}
        self._kf_ins_frames = []
        self._pending_culls = []
        self.n_loops_closed = 0
        if self.loop_closer is not None:
            self.loop_closer.reset_state()
        self._last_kf_pose_np = (
            self.map.kf_pose[self.last_kf_slot].cpu().numpy()
            if self.last_kf_slot >= 0 and kf_valid[self.last_kf_slot]
            else None)
        if kf_valid.any():
            self.frame_id = int(fids[kf_valid].max()) + 1
        self._state = LOST if self.kf_seq > 0 else NOT_INITIALIZED
