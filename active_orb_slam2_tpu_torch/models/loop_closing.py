"""Loop closing: detection, Sim3 verification, correction, essential
graph and global BA.

Port of ``active_orb_slam2_tpu/models/loop_closing.py`` (the reference's
loop thread, ``LoopClosing.cc``):

* ``DetectLoop``: BoW score of the new keyframe against every keyframe
  (per-keyframe BoW cached by generation, dense [K, W] rows for small
  vocabularies, sparse rows above 4,096 words), the min-score from the
  covisible neighbours, the group rule and the 3-consecutive
  consistency check, all on the device; the host reads the decision
  (two numbers) at the next keyframe event.
* ``ComputeSim3``: mutual Hamming match of the two keyframes, Horn
  RANSAC, ``OptimizeSim3``, guided re-match through the Sim3 and a
  second ``OptimizeSim3``; the >= 20 / >= 40 gates on the device, one
  read of the verdict.
* ``CorrectLoop``: the Sim3 propagated to the current keyframe's
  covisible group and its points, SearchAndFuse into the group, the
  essential graph, one global-BA iteration, then a health gate on the
  map's mean robust chi2 (one read); the rest of the global BA runs as
  bounded slices at later keyframe events.

The vocabulary is trained on the host from the map's descriptors at 4
and (unless ``vocab_grow`` is off) again at 48 live keyframes.  The
three places that wait on the card are the JAX package's: that
training's descriptor read, ``compute_sim3``'s verdict and ``correct``'s
gate.  The JAX package's jitted programs are plain functions on tensors
here; the keyframe and candidate slots are Python ints.

Differences from the JAX package (ROADMAP queue 3): a pending detection
is resolved only if its candidate slot still holds the keyframe it held
at detection, and a deferred GBA slice runs only while the fixed slot
still holds the loop keyframe (the JAX package checks slot liveness,
``loop_closing.py:790``, and not at all, ``:692``/``:723``); the fuse
writes only active lanes, where the JAX package's masked lanes write
feature 0 of each target back to its old value (item g); a rejected
correction is kept in ``last_rejection``, and written to a file (the JAX
package's dump, plus the covisibility matrix the gate was given) only
where the caller names one (``dump_path``), never to ``/tmp``; trained
vocabularies are cached under a digest of the whole corpus, where the
JAX package's key (its size and first 16 descriptors) hands
one map's vocabulary to another map of the process whose first
keyframe and corpus size are the same.
"""

import hashlib
import sys
from typing import Optional

import numpy as np
import torch

from active_orb_slam2_tpu_torch.config import SlamConfig
from active_orb_slam2_tpu_torch.geometry.horn import horn_align
from active_orb_slam2_tpu_torch.geometry.projection import project_stereo
from active_orb_slam2_tpu_torch.geometry.se3 import (
    quat_conj, quat_rotate, se3_apply, sim3_apply, sim3_compose,
    sim3_from_se3, sim3_inverse, sim3_to_se3)
from active_orb_slam2_tpu_torch.models.convert import map_to_jax_numpy
from active_orb_slam2_tpu_torch.models.local_mapping import (
    last_lane_put, masked_put, write_back)
from active_orb_slam2_tpu_torch.models.map_state import (
    MapState, covisibility_weights, scatter_or)
from active_orb_slam2_tpu_torch.models.optimizer import (
    edge_residual_jac, inv_sigma2)
from active_orb_slam2_tpu_torch.models.pose_graph import (
    build_essential_edges, optimize_essential_graph)
from active_orb_slam2_tpu_torch.models.sim3_solver import (
    N_HYPOTHESES, gumbel_noise, optimize_sim3, sim3_ransac)
from active_orb_slam2_tpu_torch.models.vocabulary import (
    DENSE_MAX_WORDS, detect_candidates_from_scores, l1_score,
    l1_score_sparse, load_text_vocabulary, train_vocabulary, transform,
    transform_sparse)
from active_orb_slam2_tpu_torch.ops.matching import (
    hamming_matrix, match_mutual, search_by_projection)
from active_orb_slam2_tpu_torch.ops.topk import nanmedian, stable_topk
from active_orb_slam2_tpu_torch.parallel.dist_ba import (
    build_point_major_edges, global_ba)
from active_orb_slam2_tpu_torch.utils import trace
from active_orb_slam2_tpu_torch.utils.transfer import (
    landed, synchronize, to_pinned, upload)

SIM3_SEED = 7              # the JAX package's PRNGKey(7)
LOOP_COOLDOWN = 10         # keyframes between closures (the reference's)
# the defaults of LoopCloser's knobs (the JAX package's)
CONSISTENCY_TH = 3         # consecutive groups a candidate must appear in
VOCAB_K, VOCAB_DEPTH = 8, 3    # the first training: 512 words
MIN_SIM3_MATCHES = 20      # RANSAC and OptimizeSim3 inliers
MIN_TOTAL_MATCHES = 40     # guided matches
GBA_ITERS = 6              # global-BA LM iterations per closure
GBA_CG_ITERS = 24          # CG steps per deferred iteration
# (live keyframes, branching, depth) of the retrain once the map is
# larger: 10,000 words, scored through sparse rows
VOCAB_RETRAIN = (48, 10, 4)
CORPUS_MAX = 20000         # vocabulary training descriptors at most
MAX_LOOP_EDGES = 32
# the correction's gate: reject when chi2 after > gate * before + offset
CHI2_GATE, CHI2_GATE_OFFSET = 3.5, 0.25


class LoopCloser:
    """Host orchestrator of loop closing; owns the vocabulary (trained
    from the map's descriptors unless ``vocab_path`` names a DBoW2 text
    file), the BoW cache and the consistency state.  The map arena is
    updated in place.  The knobs and their defaults are the JAX
    package's; ``gba_iters`` counts a closure's global-BA iterations,
    the prompt one included, and that one runs even at 0."""

    def __init__(self, cfg: SlamConfig, consistency_th: int = CONSISTENCY_TH,
                 vocab_k: int = VOCAB_K, vocab_depth: int = VOCAB_DEPTH,
                 min_sim3_matches: int = MIN_SIM3_MATCHES,
                 min_total_matches: int = MIN_TOTAL_MATCHES,
                 gba_iters: int = GBA_ITERS, gba_cg_iters: int = GBA_CG_ITERS,
                 recent_frames_guard: int = 30,
                 vocab_path: Optional[str] = None, vocab_grow: bool = True,
                 dump_path: Optional[str] = None):
        self.cfg = cfg
        # a rejected correction's inputs go to this file (dump_correction)
        self.dump_path = dump_path
        # each knob is read where it is used, so it may be changed after
        # construction (the endurance script sets gba_iters)
        self.consistency_th = consistency_th
        self.min_sim3_matches = min_sim3_matches
        self.min_total_matches = min_total_matches
        self.gba_iters = gba_iters
        self.gba_cg_iters = gba_cg_iters
        # (live keyframes, branching, depth) of each training: 512 words
        # at 4 live keyframes, 10,000 at 48 unless vocab_grow is off
        self.vocab_schedule = ((4, vocab_k, vocab_depth),) \
            + ((VOCAB_RETRAIN,) if vocab_grow else ())
        self.vocab = None
        self._vocab_stage = 0          # trainings of vocab_schedule done
        if vocab_path is not None:     # a loaded vocabulary is not retrained
            with trace.span("setup.vocabulary"):
                self.vocab = load_text_vocabulary(vocab_path)
            self._vocab_stage = len(self.vocab_schedule)
        self.fix_scale = cfg.sensor in ("stereo", "rgbd")
        self.recent_frames_guard = recent_frames_guard
        self.n_rejected = 0            # corrections rejected by the gate
        self.n_candidates = 0          # consistent detections resolved
        self.n_verify_fail = 0         # ComputeSim3 failures
        self._gen = None               # Sim3 RANSAC random numbers
        self.reset_state()

    def reset_state(self):
        """Clear the per-map state (``System.reset`` / ``load_map``)."""
        self._prev_accept = None       # [C-1, K] device bool
        self._n_groups = 0
        self.loop_edges = []           # (loop, cur, loop fid, cur fid)
        self.last_loop_kf_seq = -10
        self.gba_remaining = 0
        self._gba_fixed = (0, None)    # (slot, frame id) pinned in GBA
        self.last_closure = None
        self.last_rejection = None
        self._slot_fid = {}
        self._host_fid = None          # np [K] slot -> frame id, -1 if free
        self._pending_detect = None
        self._bow_fid = None           # np [K] generation of each cached row
        self._bow_dense = None         # [K, W]
        self._bow_words = None         # [K, F] sparse rows
        self._bow_weights = None

    # ------------------------------------------------------------ vocabulary

    def ensure_vocabulary(self, m: MapState, n_kf: Optional[int] = None):
        """Train (and by the schedule retrain) the vocabulary once the map
        has enough live keyframes: the descriptors of every live keyframe
        are read to the host (a wait on the card), at most 20,000 of them
        taken at a uniform stride.  A retrain drops the BoW cache.  The
        whole of a training is the tracer's ``loop.retrain`` span."""
        if self._vocab_stage >= len(self.vocab_schedule):
            return self.vocab
        if n_kf is None:
            n_kf = int(m.kf_valid.sum())
        thresh, k, depth = self.vocab_schedule[self._vocab_stage]
        if n_kf < thresh:
            return self.vocab
        with trace.span("loop.retrain"):
            desc = m.kf_desc.cpu().numpy().view(np.uint32)
            kfv = m.kf_valid.cpu().numpy()
            fv = m.kf_feat_valid.cpu().numpy()
            corpus = desc[kfv][fv[kfv]]
            if corpus.shape[0] > CORPUS_MAX:
                step = corpus.shape[0] / float(CORPUS_MAX)
                corpus = corpus[(np.arange(CORPUS_MAX) * step)
                                .astype(np.int64)]
            self.vocab = train_vocab_cached(corpus, k, depth).to(
                m.kf_desc.device)
            self._vocab_stage += 1
            self._bow_fid = None
        return self.vocab

    def refresh_bows(self, m: MapState):
        """Bring the per-keyframe BoW cache up to date: transform only the
        live slots whose generation (frame id) changed since they were
        cached.  The live slots and their frame ids come from the host's
        mirror (``slot_fid`` of :meth:`process_keyframe`, which ``System``
        keeps exactly); without one they are read from the card."""
        voc = self.vocab
        dev = m.kf_desc.device
        if voc.centers.device != dev:
            self.vocab = voc = voc.to(dev)
        K, F = m.max_keyframes, m.n_features
        if self._bow_fid is None or len(self._bow_fid) != K:
            self._bow_fid = np.full(K, -2, np.int64)
            if voc.n_words <= DENSE_MAX_WORDS:
                self._bow_dense = torch.zeros((K, voc.n_words), device=dev)
                self._bow_words = self._bow_weights = None
            else:
                self._bow_dense = None
                self._bow_words = torch.full((K, F), -1, dtype=torch.int32,
                                             device=dev)
                self._bow_weights = torch.zeros((K, F), device=dev)
        fid = self._host_fid
        if fid is None or len(fid) != K:
            fid = m.kf_frame_id.cpu().numpy()
            valid = m.kf_valid.cpu().numpy()
        else:
            valid = fid >= 0
        idxs = np.flatnonzero(valid & (self._bow_fid != fid))
        if idxs.size == 0:
            return
        ids, = upload(dev, idxs.astype(np.int64))
        desc = m.kf_desc[ids]
        vmask = m.kf_feat_valid[ids] & m.kf_valid[ids][:, None]
        if self._bow_dense is not None:
            self._bow_dense[ids] = transform(voc, desc, vmask)[1]
        else:
            _, w, wt = transform_sparse(voc, desc, vmask)
            self._bow_words[ids] = w
            self._bow_weights[ids] = wt
        self._bow_fid[idxs] = fid[idxs]

    def kf_bows(self, m: MapState):
        """[K, W] dense BoW of every keyframe: the cache for small
        vocabularies, computed on demand for large ones (tests)."""
        self.refresh_bows(m)
        if self._bow_dense is not None:
            return self._bow_dense
        return transform(self.vocab, m.kf_desc,
                         m.kf_feat_valid & m.kf_valid[:, None])[1]

    def _score(self, q_desc, q_valid):
        if self._bow_dense is not None:
            return l1_score(transform(self.vocab, q_desc, q_valid)[1],
                            self._bow_dense)
        _, qw, qwt = transform_sparse(self.vocab, q_desc, q_valid)
        return l1_score_sparse(self.vocab.n_words, qw, qwt, self._bow_words,
                               self._bow_weights)

    def score_query(self, m: MapState, q_desc, q_valid):
        """L1 similarity of one descriptor set [F, 8] against every
        keyframe: [K] on the device."""
        self.refresh_bows(m)
        return self._score(q_desc, q_valid)

    def score_kf(self, m: MapState, kf: int):
        """The same for keyframe slot ``kf``'s own descriptors."""
        self.refresh_bows(m)
        return self._score(m.kf_desc[kf], m.kf_feat_valid[kf] & m.kf_valid[kf])

    # ------------------------------------------------------------- detection

    def _detect(self, m: MapState, cur_kf: int, W, scores, prev_accept):
        """DetectLoop on the device: (candidate slot int32, any consistent
        candidate, the consistency buffer shifted by this group)."""
        K = m.max_keyframes
        is_cur = torch.arange(K, device=W.device) == cur_kf
        covis_row = W[cur_kf]
        covis_mask = (covis_row >= self.cfg.map.covis_min_weight) | is_cur
        neighbors = covis_row > 0
        min_n = torch.where(neighbors, scores, float("inf")).min()
        min_score = torch.where(neighbors.any(), torch.clamp(min_n, min=0.02),
                                0.05)
        # temporal guard: never match very recent keyframes
        recent = m.kf_frame_id >= m.kf_frame_id[cur_kf] \
            - self.recent_frames_guard
        _, accept = detect_candidates_from_scores(
            scores, m.kf_valid & ~recent, covis_mask, min_score,
            covis_weights=W)
        # a candidate (or a covisible neighbour of it) must have been
        # accepted in each of the previous consistency_th - 1 groups
        Wpos = (W > 0).to(torch.float32)
        consistent = accept
        for prev in prev_accept:
            consistent = consistent & (prev | ((Wpos @ prev.to(torch.float32))
                                               > 0))
        if prev_accept.shape[0] > 0:
            prev_accept = torch.cat([prev_accept[1:], accept[None]])
        cand = torch.argmax(torch.where(consistent, scores, -1.0))
        return cand.to(torch.int32), consistent.any(), prev_accept

    def _ensure_buffer(self, K: int, device):
        C1 = max(self.consistency_th - 1, 0)
        if self._prev_accept is None or self._prev_accept.shape != (C1, K):
            self._prev_accept = torch.zeros((C1, K), dtype=torch.bool,
                                            device=device)

    def _push_empty_group(self, m: MapState):
        """Cooldown keyframes record an empty group, so consistency
        chains do not survive a closure's cooldown."""
        K = m.max_keyframes
        self._ensure_buffer(K, m.kf_valid.device)
        self._n_groups += 1
        if self._prev_accept.shape[0] > 0:
            self._prev_accept = torch.cat([
                self._prev_accept[1:],
                torch.zeros((1, K), dtype=torch.bool,
                            device=self._prev_accept.device)])

    def detect_async(self, m: MapState, cur_kf: int, W=None, n_live_kf=None,
                     kf_seq: int = 0):
        """Dispatch loop detection for ``cur_kf`` without reading it: the
        decision goes to pinned memory and is read at the next keyframe
        event.  Returns the pending record, or None."""
        if self.ensure_vocabulary(m, n_kf=n_live_kf) is None:
            return None
        if W is None:
            W = covisibility_weights(m)
        self._ensure_buffer(m.max_keyframes, m.kf_valid.device)
        scores = self.score_kf(m, cur_kf)
        cand, ok, self._prev_accept = self._detect(m, cur_kf, W, scores,
                                                   self._prev_accept)
        self._n_groups += 1
        if self._n_groups < self.consistency_th:
            return None
        fids = self._host_fid.copy() if self._host_fid is not None else None
        return {"kf": int(cur_kf), "fid": self._slot_fid.get(int(cur_kf)),
                "fids": fids, "kf_seq": kf_seq,
                "copy": to_pinned(torch.stack([cand, ok.to(torch.int32)]))}

    def detect(self, m: MapState, cur_kf: int, W=None, n_live_kf=None):
        """Synchronous DetectLoop: the candidate keyframe slot, or -1.  A
        test and diagnostic path on top of :meth:`detect_async` that
        waits on the card for the decision; ``System`` never calls it
        (it reads each decision at the next keyframe event)."""
        pend = self.detect_async(m, cur_kf, W=W, n_live_kf=n_live_kf)
        if pend is None:
            return -1
        cand, ok = landed(*pend["copy"])
        return int(cand) if ok else -1

    # ---------------------------------------------------------------- verify

    def _noise(self, n_hyp: int, m: int, device):
        """The Sim3 RANSAC's Gumbel noise [n_hyp, m] for one verification,
        from a generator seeded once."""
        if self._gen is None:
            self._gen = torch.Generator(device=device)
            self._gen.manual_seed(SIM3_SEED)
        return gumbel_noise(n_hyp, m, self._gen, device)

    def compute_sim3(self, m: MapState, cur_kf: int, loop_kf: int):
        """SearchByBoW -> Sim3 RANSAC -> OptimizeSim3 -> guided
        SearchBySim3 -> OptimizeSim3, gated >= 20 RANSAC and LM inliers
        and >= 40 guided matches.  Returns (ok, S_cm [8] on the device
        mapping loop-keyframe camera coords to current-keyframe camera
        coords, guided matches); reads the verdict (a wait)."""
        cam = self.cfg.camera
        fix = self.fix_scale
        xyz_a, xyz_b, uv_a, uv_b, s2a, s2b, ok = _sim3_match_data(
            m, cur_kf, loop_kf)
        res = sim3_ransac(self._noise(N_HYPOTHESES, ok.shape[0], ok.device),
                          cam, xyz_a, xyz_b, uv_a, uv_b, s2a, s2b, ok,
                          fix_scale=fix)
        s_opt, _, n_opt = optimize_sim3(cam, res.sim3_ab, xyz_a, xyz_b, uv_a,
                                        uv_b, s2a, s2b, ok & res.inliers,
                                        fix_scale=fix)
        s_ref, n_total = _sim3_guided_refine(m, cur_kf, loop_kf, s_opt, cam,
                                             fix)
        ok_all = ((res.n_inliers >= self.min_sim3_matches)
                  & (n_opt >= self.min_sim3_matches)
                  & (n_total >= self.min_total_matches))
        verdict = torch.stack([ok_all.to(torch.int32),
                               n_total.to(torch.int32)]).cpu().numpy()
        if not verdict[0]:
            return False, None, int(verdict[1])
        return True, s_ref, int(verdict[1])

    # --------------------------------------------------------------- correct

    def _loop_window(self, max_loop: int):
        """(li, lj) [max_loop] of the newest loop edges, -1 where a side's
        slot no longer holds the keyframe of the closure; the newest edge
        sits at index len(window) - 1."""
        sf = self._slot_fid
        li = np.full(max_loop, -1, np.int32)
        lj = np.full(max_loop, -1, np.int32)
        window = self.loop_edges[-max_loop:]
        for n, (a, b, fa, fb) in enumerate(window):
            if sf and ((fa is not None and sf.get(a) != fa)
                       or (fb is not None and sf.get(b) != fb)):
                continue
            li[n], lj[n] = a, b
        return li, lj, len(window) - 1

    def _loop_edge(self, cur_kf: int, loop_kf: int):
        """The ``loop_edges`` entry of a closure of cur_kf on loop_kf."""
        sf = self._slot_fid
        return (int(loop_kf), int(cur_kf), sf.get(int(loop_kf)),
                sf.get(int(cur_kf)))

    def next_loop_window(self, cur_kf: int, loop_kf: int,
                         max_loop: int = MAX_LOOP_EDGES):
        """The (li, lj, new_n) that ``correct(m, cur_kf, loop_kf, ...)``
        will hand the essential graph; changes nothing."""
        self.loop_edges.append(self._loop_edge(cur_kf, loop_kf))
        try:
            return self._loop_window(max_loop)
        finally:
            self.loop_edges.pop()

    def correct(self, m: MapState, cur_kf: int, loop_kf: int, s_cm, W=None,
                max_loop: int = MAX_LOOP_EDGES):
        """The prompt part of CorrectLoop on a copy of the map (Sim3
        propagation, point transform, fuse, essential graph, one GBA
        iteration), then the health gate: accepted if every pose and
        point is finite and the map's mean robust chi2 after is at most
        ``CHI2_GATE`` x before + ``CHI2_GATE_OFFSET``.  An accepted
        correction is written into the arena ``m``; the rest of the GBA
        budget runs as :meth:`gba_slice` at later events.  Returns (m,
        accepted)."""
        if W is None:
            W = covisibility_weights(m)
        sf = self._slot_fid
        li, lj, new_n = self.next_loop_window(cur_kf, loop_kf, max_loop)
        self.loop_edges.append(self._loop_edge(cur_kf, loop_kf))
        li_d, lj_d = upload(m.kf_pose.device, li, lj)
        m_new, diag_d = _correct_prompt(self.cfg, m, int(cur_kf), int(loop_kf),
                                        s_cm, W, li_d, lj_d, new_n, max_loop)
        pre_chi2, post_chi2, med_disp, finite = (
            float(v) for v in diag_d.cpu().numpy())
        finite = finite > 0.5 and np.isfinite(post_chi2)
        healthy = finite and (post_chi2 <= CHI2_GATE * pre_chi2
                              + CHI2_GATE_OFFSET)
        diag = {"cur_kf": int(cur_kf), "loop_kf": int(loop_kf),
                "cur_fid": sf.get(int(cur_kf)),
                "loop_fid": sf.get(int(loop_kf)), "chi2_pre": pre_chi2,
                "chi2_post": post_chi2, "med_disp": med_disp,
                "s_cm": s_cm.cpu().numpy()}
        if not healthy:
            print(f"[loop_closing] WARNING: loop correction (cur={cur_kf} "
                  f"loop={loop_kf}) REJECTED (finite={finite} chi2 "
                  f"{pre_chi2:.2f}->{post_chi2:.2f} med_disp={med_disp:.3f})",
                  file=sys.stderr)
            self.last_rejection = diag
            if self.dump_path is not None:
                dump_correction(self.dump_path, m, cur_kf, loop_kf, s_cm, li,
                                lj, new_n, W)
            self.loop_edges.pop()
            self.n_rejected += 1
            return m, False
        self.last_closure = diag
        write_back(m, m_new)
        self.gba_remaining = max(self.gba_iters - 1, 0)
        self._gba_fixed = (int(loop_kf), sf.get(int(loop_kf)))
        return m, True

    def gba_slice(self, m: MapState, iters: int = 2):
        """One bounded global-BA slice on the arena (in place) while
        ``gba_remaining`` > 0, the loop keyframe fixed; the slices
        together do the reference's background global BA.  Ends the
        budget if the loop keyframe's slot holds another keyframe now."""
        if self.gba_remaining <= 0:
            return m
        slot, fid = self._gba_fixed
        if fid is not None and self._slot_fid.get(slot) != fid:
            self.gba_remaining = 0
            return m
        fixed = torch.arange(m.max_keyframes, device=m.kf_pose.device) == slot
        poses, pts, _ = global_ba(
            self.cfg.camera, m.kf_pose, m.kf_valid, m.pt_xyz, m.pt_valid,
            build_point_major_edges(m), fixed, iters=iters,
            cg_iters=self.gba_cg_iters)
        ok = torch.isfinite(poses).all() & torch.isfinite(pts).all()
        m.kf_pose.copy_(torch.where(ok, poses, m.kf_pose))
        m.pt_xyz.copy_(torch.where(ok, pts, m.pt_xyz))
        self.gba_remaining -= iters
        return m

    def _essential_edges(self, pre_sim3, kf_valid, kf_parent, W,
                         newest_loop_rel, max_loop: int = MAX_LOOP_EDGES):
        """The essential-graph edges as ``correct`` builds them (loop edge
        n at slot E - max_loop + n; only the newest carries the verified
        Sim3); for tests."""
        li, lj, new_n = self._loop_window(max_loop)
        li_d, lj_d = upload(pre_sim3.device, li, lj)
        edges = build_essential_edges(pre_sim3, kf_valid, kf_parent, W, li_d,
                                      lj_d, max_loop=max_loop)
        return _with_newest_loop(edges, newest_loop_rel, new_n, max_loop)

    # ------------------------------------------------------------------ main

    def process_keyframe(self, m: MapState, cur_kf: int, kf_seq: int, W=None,
                         n_live_kf=None, slot_fid=None):
        """One loop-closing step per keyframe event; returns (m, closed).

        1. Resolve the previous event's detection (its two numbers have
           landed by now); on a consistent candidate whose slot still
           holds the keyframe it held then, verify and correct.
        2. Run one deferred GBA slice.
        3. Dispatch this keyframe's detection.

        ``W``: the covisibility matrix of the keyframe-mapping call;
        ``n_live_kf`` and ``slot_fid`` (slot -> frame id of the live
        keyframes): the host's mirrors, so nothing here reads the card
        outside vocabulary training, verification and the correction's
        gate."""
        if slot_fid is not None:
            self._slot_fid = dict(slot_fid)
            fid = np.full(m.max_keyframes, -1, np.int64)
            for s, f in slot_fid.items():
                if 0 <= s < len(fid):
                    fid[s] = f
            self._host_fid = fid
        closed = False

        pend, self._pending_detect = self._pending_detect, None
        if pend is not None:
            cand_v, ok_v = landed(*pend["copy"])
            cand = int(cand_v) if ok_v else -1
            sf = self._slot_fid
            live_ok = sf.get(pend["kf"]) == pend["fid"] and (
                not sf or cand < 0 or pend["fids"] is None
                or (cand in sf and sf[cand] == pend["fids"][cand]))
            if (cand >= 0 and cand != pend["kf"] and live_ok
                    and pend["kf_seq"] - self.last_loop_kf_seq
                    >= LOOP_COOLDOWN):
                self.n_candidates += 1
                with trace.span("loop.verify"):
                    ok2, s_cm, _ = self.compute_sim3(m, pend["kf"], cand)
                if not ok2:
                    self.n_verify_fail += 1
                else:
                    with trace.span("loop.correct"):
                        m, closed = self.correct(m, pend["kf"], cand, s_cm,
                                                 W=W)
                    if closed:
                        self.last_loop_kf_seq = kf_seq

        if not closed and self.gba_remaining > 0:
            with trace.span("loop.gba_slice"):
                m = self.gba_slice(m)

        if kf_seq - self.last_loop_kf_seq < LOOP_COOLDOWN:
            self._push_empty_group(m)
            return m, closed
        with trace.span("loop.detect"):
            self._pending_detect = self.detect_async(
                m, cur_kf, W=W, n_live_kf=n_live_kf, kf_seq=kf_seq)
        return m, closed


@trace.traced("setup.warm_up")
def warm_up(cfg: SlamConfig, device):
    """Run the loop closer's forward-mode Jacobians and solvers once on
    tiny problems, so that their one-time setup is paid when the
    ``System`` is built and not by the first verification.  On an H100
    the first ``torch.func.jacfwd`` of a process took 10.5 s and the next
    35.5 ms, a first 4x4 batched ``eigh`` 220 ms and the next 1.6 ms
    (``scripts/profile_torch_loop.py``).  Waits on the card."""
    from active_orb_slam2_tpu_torch.models.pose_graph import Sim3Edges
    ident = sim3_from_se3(torch.zeros(2, 7, device=device)
                          + (torch.arange(7, device=device) == 0))
    xyz = torch.stack(torch.meshgrid(
        torch.arange(2.0, device=device), torch.arange(2.0, device=device),
        torch.arange(3.0, 5.0, device=device), indexing="ij"), -1).view(8, 3)
    horn_align(xyz.expand(N_HYPOTHESES, 8, 3), xyz.expand(N_HYPOTHESES, 8, 3))
    ones = torch.ones(8, device=device)
    uv = torch.stack([xyz[:, 0] / xyz[:, 2], xyz[:, 1] / xyz[:, 2]], -1)
    optimize_sim3(cfg.camera, ident[0], xyz, xyz, uv, uv, ones, ones,
                  ones > 0, iters1=1, iters2=1)
    edge = torch.zeros(1, dtype=torch.int32, device=device)
    optimize_essential_graph(
        ident, Sim3Edges(i=edge, j=edge + 1, meas_ji=ident[:1],
                         valid=edge == 0, weight=ones[:1]),
        torch.arange(2, device=device) == 0, iters=1)
    synchronize(device)


def dump_correction(path, m: MapState, cur_kf: int, loop_kf: int, s_cm, li,
                    lj, new_n: int, W):
    """Write a correction's inputs to ``path`` (``np.savez_compressed``)
    under the keys of the JAX package's rejected-correction dump (every
    ``MapState`` field with the JAX package's dtypes, ``s_cm``,
    ``cur_kf``, ``loop_kf``, ``li``, ``lj``, ``new_n``), plus ``W``, the
    covisibility matrix the correction was given.
    ``scripts/dissect_torch_closure.py`` replays it stage by stage, and
    so does the JAX package's ``scripts/dissect_closure.py``."""
    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)
    np.savez_compressed(path, s_cm=host(s_cm), cur_kf=int(cur_kf),
                        loop_kf=int(loop_kf), li=host(li), lj=host(lj),
                        new_n=int(new_n), W=host(W), **map_to_jax_numpy(m))


# ------------------------------------------------------------ device stages

def _map_mean_chi2(cam, m: MapState):
    """Mean Huber-clipped reprojection chi2 per valid observation over the
    whole map: the correction gate's health metric."""
    K, F = m.kf_point.shape
    pt = torch.clamp(m.kf_point, min=0).long()
    ok = ((m.kf_point >= 0) & m.kf_valid[:, None] & m.kf_feat_valid
          & m.pt_valid[pt]).reshape(-1)
    obs = torch.cat([m.kf_uv.reshape(-1, 2), m.kf_ur.reshape(-1, 1)], -1)
    stereo = m.kf_ur.reshape(-1) > 0
    r, _, _, zpos = edge_residual_jac(
        cam, m.kf_pose[:, None, :].expand(K, F, 7).reshape(-1, 7),
        m.pt_xyz[pt.reshape(-1)], obs, stereo)
    c2 = inv_sigma2(m.kf_level.reshape(-1)) * (r * r).sum(-1)
    # rho(c2) = c2 below the knee, 2 sqrt(k c2) - k above it
    k = torch.where(stereo, 7.815, 5.991)
    rho = torch.where(c2 <= k, c2, 2.0 * torch.sqrt(k * c2) - k)
    ok = ok & zpos
    return torch.where(ok, rho, 0.0).sum() / torch.clamp(
        ok.sum().to(torch.float32), min=1.0)


def _se3_center(p):
    return -quat_rotate(quat_conj(p[..., :4]), p[..., 4:7])


def _sim3_center(g):
    return _se3_center(g) / torch.clamp(g[..., 7:8], min=1e-8)


_vocab_cache = {}


def train_vocab_cached(descs, k, depth):
    key = (descs.shape, k, depth,
           hashlib.sha1(np.ascontiguousarray(descs).tobytes()).digest())
    if key not in _vocab_cache:
        _vocab_cache[key] = train_vocabulary(descs, k=k, depth=depth)
    return _vocab_cache[key]


def _level_sigma2(level):
    return torch.pow(1.2, 2.0 * level.to(torch.float32))


def _sim3_match_data(m: MapState, cur_kf: int, loop_kf: int):
    """SearchByBoW between two keyframes over their features with map
    points: camera-frame point pairs, pixels, level variances, ok."""
    kp_a, kp_b = m.kf_point[cur_kf], m.kf_point[loop_kf]
    va = m.kf_feat_valid[cur_kf] & (kp_a >= 0)
    vb = m.kf_feat_valid[loop_kf] & (kp_b >= 0)
    d = hamming_matrix(m.kf_desc[cur_kf], m.kf_desc[loop_kf], va, vb)
    idx, _ = match_mutual(d, max_dist=50.0, ratio=0.75)
    fb = torch.clamp(idx, min=0).long()
    pa = torch.clamp(kp_a, min=0).long()
    pb = torch.clamp(kp_b[fb], min=0).long()
    ok = (idx >= 0) & m.pt_valid[pa] & m.pt_valid[pb]
    xyz_a = se3_apply(m.kf_pose[cur_kf], m.pt_xyz[pa])
    xyz_b = se3_apply(m.kf_pose[loop_kf], m.pt_xyz[pb])
    return (xyz_a, xyz_b, m.kf_uv[cur_kf], m.kf_uv[loop_kf][fb],
            _level_sigma2(m.kf_level[cur_kf]),
            _level_sigma2(m.kf_level[loop_kf][fb]), ok)


def _sim3_guided_refine(m: MapState, cur_kf: int, loop_kf: int, s_cm, cam,
                        fix_scale: bool):
    """Guided SearchBySim3: the loop keyframe's points projected through
    S_cm into the current keyframe and re-matched in a 7.5 px radius,
    Horn on the matched set, then OptimizeSim3.  Returns (S_cm', guided
    matches); S_cm is kept unless >= 20 matched and >= 10 LM inliers."""
    F = m.n_features
    dev = m.kf_pose.device
    kp_b = m.kf_point[loop_kf]
    pb = torch.clamp(kp_b, min=0).long()
    ok_b = m.kf_feat_valid[loop_kf] & (kp_b >= 0) & m.pt_valid[pb]
    xyz_b = se3_apply(m.kf_pose[loop_kf], m.pt_xyz[pb])
    proj = sim3_apply(s_cm, xyz_b)
    z = torch.clamp(proj[:, 2], min=1e-6)
    uv = torch.stack([cam.fx * proj[:, 0] / z + cam.cx,
                      cam.fy * proj[:, 1] / z + cam.cy], -1)
    ok_b = ok_b & (proj[:, 2] > 0.2)
    kp_a = m.kf_point[cur_kf]
    idx, _ = search_by_projection(
        uv, torch.full((F,), 7.5, device=dev), m.kf_level[loop_kf],
        m.pt_desc[pb], ok_b, m.kf_uv[cur_kf], m.kf_level[cur_kf],
        m.kf_desc[cur_kf], m.kf_feat_valid[cur_kf] & (kp_a >= 0),
        max_dist=100.0, ratio=1.0, level_window=8)
    matched = (idx >= 0) & ok_b
    fa = torch.clamp(idx, min=0).long()
    pa = torch.clamp(kp_a[fa], min=0).long()
    matched = matched & m.pt_valid[pa]
    xyz_a = se3_apply(m.kf_pose[cur_kf], m.pt_xyz[pa])
    q, t, s = horn_align(xyz_b, xyz_a, weights=matched.to(torch.float32),
                         fix_scale=fix_scale)
    s_opt, _, n_opt = optimize_sim3(
        cam, torch.cat([q, t, s[None]]), xyz_a, xyz_b, m.kf_uv[cur_kf][fa],
        m.kf_uv[loop_kf], _level_sigma2(m.kf_level[cur_kf][fa]),
        _level_sigma2(m.kf_level[loop_kf]), matched, fix_scale=fix_scale)
    n = matched.sum()
    return torch.where((n >= 20) & (n_opt >= 10), s_opt, s_cm), n


def _apply_sim3_correction(m: MapState, pre_sim3, corrected_scur, cur_kf: int,
                           group_mask):
    """Propagate the verified Sim3 to the covisible group and move the
    points through their anchor, the lowest-slot group keyframe that
    observes them.  Returns (m', anchor [P] int32, K where a point was
    not moved); the pose-graph write-back reuses the anchor."""
    K = m.max_keyframes
    dev = m.kf_pose.device
    rel = sim3_compose(pre_sim3, sim3_inverse(pre_sim3[cur_kf]))
    new_sim3 = torch.where(group_mask[:, None],
                           sim3_compose(rel, corrected_scur), pre_sim3)
    pt = torch.clamp(m.kf_point, min=0).long()
    obs = (m.kf_point >= 0) & group_mask[:, None] & m.kf_valid[:, None]
    slot_mat = torch.where(obs, torch.arange(K, device=dev)[:, None], K)
    anchor = torch.full((m.max_points,), K, dtype=torch.long, device=dev)
    anchor.scatter_reduce_(0, pt.reshape(-1), slot_mat.reshape(-1), "amin")
    moved = (anchor < K) & m.pt_valid
    return (m._replace(
        kf_pose=torch.where(group_mask[:, None], sim3_to_se3(new_sim3),
                            m.kf_pose),
        pt_xyz=_move_points(m, pre_sim3, new_sim3, anchor, moved)),
        torch.where(moved, anchor, K).to(torch.int32))


def _move_points(m: MapState, old_sim3, new_sim3, anchor, moved):
    """Points moved by their anchor keyframe's change: world -> anchor
    camera under the old Sim3, back under the new one."""
    a = torch.clamp(anchor, 0, m.max_keyframes - 1).long()
    p_cam = sim3_apply(old_sim3[a], m.pt_xyz)
    p_new = sim3_apply(sim3_inverse(new_sim3[a]), p_cam)
    return torch.where(moved[:, None], p_new, m.pt_xyz)


def _fuse(cam, m: MapState, cur_kf: int, loop_kf: int, W,
          n_loop_pts: int = 2048, n_group: int = 8):
    """SearchAndFuse: the loop keyframe's covisible group's points (the
    first ``n_loop_pts`` by slot) projected into the corrected current
    keyframe and its ``n_group`` - 1 most covisible keyframes in turn; a
    matched feature with no point gains the observation, one tracking
    another point has that point replaced (globally, through a
    substitution map closed over chains)."""
    K, P, F = m.max_keyframes, m.max_points, m.n_features
    dev = m.kf_pose.device
    ar = torch.arange(K, device=dev)
    loop_group = (W[loop_kf] > 0) | (ar == loop_kf)
    lp_obs = (m.kf_point >= 0) & loop_group[:, None] & m.kf_valid[:, None]
    loop_pts_mask = scatter_or(P, torch.clamp(m.kf_point, min=0),
                               lp_obs) & m.pt_valid
    cand = torch.sort((~loop_pts_mask).to(torch.uint8),
                      stable=True).indices[:n_loop_pts]
    cand_ok = loop_pts_mask[cand]
    row = torch.where(m.kf_valid & (ar != cur_kf), W[cur_kf], 0)
    w_n, nbrs = stable_topk(row, n_group - 1)
    targets = torch.cat([torch.full((1,), cur_kf, device=dev), nbrs])
    t_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                      (w_n > 0) & m.kf_valid[nbrs]])
    x0, x1, y0, y1 = cam.bounds()
    cand_xyz, cand_desc = m.pt_xyz[cand], m.pt_desc[cand]
    radii = torch.full(cand.shape, 6.0, device=dev)
    pred_lv = torch.zeros(cand.shape, dtype=torch.int32, device=dev)
    kfp = m.kf_point.reshape(-1)
    rep = torch.arange(P, device=dev)
    replaced = torch.zeros(P, dtype=torch.bool, device=dev)
    for j in range(n_group):
        t = targets[j:j + 1]
        uvr, z = project_stereo(cam, se3_apply(m.kf_pose[t][0], cand_xyz))
        ok = (cand_ok & t_ok[j] & (z > 0.2) & (uvr[:, 0] >= x0)
              & (uvr[:, 0] < x1) & (uvr[:, 1] >= y0) & (uvr[:, 1] < y1))
        idx, _ = search_by_projection(
            uvr[:, :2], radii, pred_lv, cand_desc, ok, m.kf_uv[t][0],
            m.kf_level[t][0], m.kf_desc[t][0], m.kf_feat_valid[t][0],
            max_dist=50.0, ratio=1.0, level_window=8)
        matched = (idx >= 0) & ok
        cell = t * F + torch.clamp(idx, min=0).long()
        old = kfp[cell].long()
        dup = matched & (old >= 0) & (old != cand)
        rep = last_lane_put(rep, old, cand, dup)
        replaced = replaced | scatter_or(P, old, dup)
        kfp = masked_put(kfp, cell, cand, matched & (old < 0))
    for _ in range(3):
        rep = rep[rep]
    kfp = kfp.view(K, F)
    kfp = torch.where(kfp >= 0, rep[torch.clamp(kfp, min=0).long()]
                      .to(kfp.dtype), kfp)
    return m._replace(kf_point=kfp, pt_valid=m.pt_valid & ~replaced)


def _apply_posegraph_result(m: MapState, old_sim3, new_sim3,
                            preferred_anchor=None):
    """Write the optimized Sim3s back: poses as SE3 (t / s), points moved
    by their anchor's change: the stage-1 anchor where there is one,
    else the oldest observing keyframe (lowest frame id, then slot)."""
    K = m.max_keyframes
    dev = m.kf_pose.device
    pt = torch.clamp(m.kf_point, min=0).long()
    obs = (m.kf_point >= 0) & m.kf_valid[:, None]
    rank = torch.argsort(torch.argsort(
        torch.where(m.kf_valid, m.kf_frame_id, 2 ** 30), stable=True),
        stable=True)
    key_mat = torch.where(obs, (rank * K + torch.arange(K, device=dev))[:, None],
                          K * K)
    best = torch.full((m.max_points,), K * K, dtype=torch.long, device=dev)
    best.scatter_reduce_(0, pt.reshape(-1), key_mat.reshape(-1), "amin")
    anchor = torch.where(best < K * K, best % K, K)
    if preferred_anchor is not None:
        anchor = torch.where(preferred_anchor < K, preferred_anchor.long(),
                             anchor)
    return m._replace(
        kf_pose=torch.where(m.kf_valid[:, None], sim3_to_se3(new_sim3),
                            m.kf_pose),
        pt_xyz=_move_points(m, old_sim3, new_sim3, anchor,
                            (anchor < K) & m.pt_valid))


def _with_newest_loop(edges, loop_rel, new_n: int, max_loop: int):
    """The edges with the newest loop's measurement (slot E - max_loop +
    new_n) set to the verified Sim3."""
    E = edges.meas_ji.shape[0]
    at = torch.arange(E, device=loop_rel.device) == E - max_loop + new_n
    return edges._replace(meas_ji=torch.where(at[:, None], loop_rel,
                                              edges.meas_ji))


def _correct_prompt(cfg: SlamConfig, m: MapState, cur_kf: int, loop_kf: int,
                    s_cm, W, li, lj, new_n: int, max_loop: int):
    """CorrectLoop's prompt part on new tensors (``m`` is not written):
    returns (corrected map, [chi2 before, chi2 after, median keyframe
    displacement, all finite])."""
    cam = cfg.camera
    K = m.max_keyframes
    ar = torch.arange(K, device=m.kf_pose.device)
    pre_sim3 = sim3_from_se3(m.kf_pose)
    pre_chi2 = _map_mean_chi2(cam, m)
    corrected_scur = sim3_compose(s_cm, sim3_from_se3(m.kf_pose[loop_kf]))
    group = ((W[cur_kf] >= cfg.map.covis_min_weight) | (ar == cur_kf)) \
        & m.kf_valid
    m, corr_anchor = _apply_sim3_correction(m, pre_sim3, corrected_scur,
                                            cur_kf, group)
    m = _fuse(cam, m, cur_kf, loop_kf, W)
    # essential graph: measurements from the poses before the correction,
    # vertices from the partly corrected ones
    edges = build_essential_edges(pre_sim3, m.kf_valid, m.kf_parent, W, li,
                                  lj, max_loop=max_loop)
    edges = _with_newest_loop(edges, sim3_compose(
        corrected_scur, sim3_inverse(pre_sim3[loop_kf])), new_n, max_loop)
    cur_sim3 = sim3_from_se3(m.kf_pose)
    opt_sim3, _ = optimize_essential_graph(cur_sim3, edges,
                                           (ar == loop_kf) | ~m.kf_valid)
    m = _apply_posegraph_result(m, cur_sim3, opt_sim3,
                                preferred_anchor=corr_anchor)
    # one prompt GBA iteration (the Sim3 propagation leaves points and
    # non-group observers inconsistent until BA has run)
    poses, pts, _ = global_ba(cam, m.kf_pose, m.kf_valid, m.pt_xyz,
                              m.pt_valid, build_point_major_edges(m),
                              ar == loop_kf, iters=1, cg_iters=16)
    m = m._replace(kf_pose=poses, pt_xyz=pts)
    post_chi2 = _map_mean_chi2(cam, m)
    disp = torch.linalg.vector_norm(_se3_center(m.kf_pose)
                                    - _sim3_center(pre_sim3), dim=-1)
    finite = torch.isfinite(m.kf_pose).all() & torch.isfinite(m.pt_xyz).all()
    return m, torch.stack([pre_chi2, post_chi2, nanmedian(disp, m.kf_valid),
                           finite.to(torch.float32)])
