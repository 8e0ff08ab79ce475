"""The per-frame step as graph segments (``utils/graphs.py``): the RGB-D
frame pipeline's F1 and F2 around K2, the track step's T1, T2 and T3
around K1.

On the CPU the segments run eagerly.  There a stand-in for CUDA graphs
(``FakeBackend``) gives them a graph's semantics: a capture runs
nothing; a replay runs the captured function again on the static input
buffers and writes its results into the tensors the first replay
returned, so a segment that read a tensor of the capture's call that it
was not fed, or an output that a caller kept without owning it, shows
as a difference from the eager run.  The ``cuda`` cases run the same
checks with real CUDA graphs against the segments run eagerly on the
card (``python3 -m pytest -m cuda tests/test_torch_graphs.py``):

* bit for bit over a 40-frame RGB-D sequence: poses, per-frame rows,
  every ``MapState`` and ``TrackState`` field, with mapping on
  (recaptures after keyframes), in localization mode, through a LOST
  frame that relocalizes, across a ``restore``, and where a map tensor
  is replaced (new keys, and a chain's oldest graphs evicted);
* the counters ``graph.replays``, ``graph.captures`` and ``graph.eager``
  follow the key rule;
* a frame kept by a caller, and K1's arguments kept from a frame, are
  unchanged five frames later;
* on the card, replayed frames make no synchronizing call.
"""

import numpy as np
import pytest
import torch

from active_orb_slam2_tpu_torch.utils import graphs, trace

torch.set_num_threads(1)

SHRINK = dict(factor=0.25, n_features=512, n_levels=4, max_keyframes=16,
              max_points=2048)
SEED = 3_000_016_001
N_FRAMES = 40
LOC_FROM = 20       # localization mode from this frame on
LOST_AT = 25        # a black frame: LOST, the next one relocalizes
SAVE_AT, RESTORE_AT = 12, 30
REPLACE_AT = (16, 18, 21)   # a map tensor replaced: new keys, an eviction
SEGMENTS = ("F1", "F2", "T1", "T2", "T3")


class FakeGraph:
    def __init__(self, fn):
        self.fn, self.out = fn, None

    def replay(self):
        result = self.fn()
        if self.out is None:
            self.out = result
            return
        for o, r in zip(graphs.leaves(self.out), graphs.leaves(result)):
            if isinstance(o, torch.Tensor) and o is not r:
                o.copy_(r)


class FakeBackend:
    def capture(self, fn):
        return FakeGraph(fn)

    def event(self):
        return None


def device_of(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0) if name == "cuda" else torch.device("cpu")


DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def graphed(monkeypatch, device):
    """Graph segments on ``device``: CUDA graphs on the card, the
    stand-in on the CPU."""
    if device.type == "cpu":
        monkeypatch.setattr(graphs, "_backend", lambda d: FakeBackend())


def eager(monkeypatch):
    monkeypatch.setattr(graphs, "_backend", lambda d: None)


_traffic = {}


def setting(device):
    """The benchmark's ``tum_fr1_rgbd`` configuration (a quarter of its
    size on the CPU) and frames of its ``localize_sweep`` traffic."""
    from benchmark.harness import definitions, session
    from benchmark.traffic import generate
    cj, yaml_path = definitions.config("tum_fr1_rgbd")
    cfg = session.port_config(cj, yaml_path,
                              SHRINK if device.type == "cpu" else None)
    if device.type not in _traffic:
        rcam, _, _ = session.reference_config(cj, yaml_path, cfg)
        mix = definitions.mix("localize_sweep")
        mix["path"] = dict(mix["path"], frames=N_FRAMES)
        t = generate.make(mix, rcam, 15.0, "rgbd", SEED, N_FRAMES, device)
        _traffic[device.type] = [
            (np.asarray(t.images[0][i]), np.asarray(t.images[1][i]),
             float(t.timestamps[i])) for i in range(N_FRAMES)]
    return cfg, _traffic[device.type]


def run(device, case, n=N_FRAMES, use_mapping=True, hook=None,
        before_frame=None):
    """Track ``n`` frames one at a time (each retired before the next)
    in the situation ``case``; ``hook(slam)`` runs once the System is
    built, ``before_frame(slam, i)`` before each frame.  Returns the
    System, with ``relocalized``: the outcome of each relocalization
    attempt."""
    from active_orb_slam2_tpu_torch.models.system import System
    cfg, frames = setting(device)
    slam = System(cfg, use_mapping=use_mapping, device=device)
    slam.relocalized, slam.replaced = [], []
    attempt = slam._try_relocalize

    def relocalize(frame):
        slam.relocalized.append(attempt(frame))
        return slam.relocalized[-1]

    slam._try_relocalize = relocalize
    if hook is not None:
        hook(slam)
    saved = None
    for i, (g, d, t) in enumerate(frames[:n]):
        if before_frame is not None:
            before_frame(slam, i)
        if case == "localization" and i == LOC_FROM:
            slam.activate_localization_mode()
        if case == "lost" and i == LOST_AT:
            g, d = np.zeros_like(g), np.zeros_like(d)
        if case == "restore" and i == SAVE_AT:
            saved = slam.checkpoint()
        if case == "restore" and i == RESTORE_AT:
            slam.restore(saved)
        if case == "replaced" and i in REPLACE_AT:
            # the old tensor is kept, so that the new one has a new address
            slam.replaced.append(slam.map.pt_xyz)
            slam.map = slam.map._replace(pt_xyz=slam.map.pt_xyz.clone())
        slam.track_rgbd(g, d, t)
        slam.flush()
    return slam


def snapshot(slam):
    ts, tcw = slam.frame_trajectory()
    rows = [{k: v for k, v in r.items() if k != "wall_ms"}
            for r in slam.metrics]
    fields = {f"map.{f}": getattr(slam.map, f).cpu().numpy()
              for f in slam.map._fields}
    fields.update({f"track.{f}": getattr(slam.track, f).cpu().numpy()
                   for f in slam.track._fields})
    return np.asarray(ts), np.asarray(tcw), rows, fields, slam._state


def counts(before):
    now = trace.counters()
    return {(kind, seg): now.get(f"graph.{kind}.{seg}", 0)
            - before.get(f"graph.{kind}.{seg}", 0)
            for kind in ("replays", "captures", "eager") for seg in SEGMENTS}


@pytest.fixture
def deterministic(request):
    """The card's mapping sums by atomics: a card case runs deterministic
    algorithms on both sides, so that they can agree bit for bit."""
    was = torch.are_deterministic_algorithms_enabled()
    if request.node.callspec.params.get("dev") == "cuda":
        torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("case", ["mapping", "localization", "lost",
                                  "restore", "replaced"])
@pytest.mark.parametrize("dev", DEVICES)
def test_graphs_match_eager_bit_for_bit(dev, case, monkeypatch,
                                        deterministic):
    device = device_of(dev)
    with monkeypatch.context() as mp:
        eager(mp)
        slam = run(device, case)
        ref, ref_reloc = snapshot(slam), slam.relocalized
    before = trace.counters()
    with monkeypatch.context() as mp:
        graphed(mp, device)
        slam = run(device, case)
        got, got_reloc = snapshot(slam), slam.relocalized
    n = counts(before)
    assert ref_reloc == got_reloc
    np.testing.assert_array_equal(ref[0], got[0])
    np.testing.assert_array_equal(ref[1], got[1])
    assert ref[2] == got[2]
    assert ref[4] == got[4]
    for name, want in ref[3].items():
        np.testing.assert_array_equal(want, got[3][name], err_msg=name)
    # the mechanism engaged: every frame built by replay but the first
    # two, the track step replayed on most frames
    assert n["eager", "F1"] == 1 and n["captures", "F1"] == 1
    assert n["replays", "F1"] == N_FRAMES - 1
    assert n["replays", "T1"] > N_FRAMES // 2
    if case == "lost":
        assert got_reloc == [True]
    if case == "replaced":
        # each new address runs the step eagerly once, then captures
        assert n["eager", "T1"] == 1 + len(REPLACE_AT)
        assert n["captures", "T1"] == 1 + len(REPLACE_AT)


def toy_step(chain, x, flag):
    """Two segments around an eager call, the shape of the real steps."""
    run = chain.start(x.device, (graphs.layout(x), flag))
    a, = run("S1", lambda v: (v * 2 + flag,), x)
    mid = run.own(a) + 1                      # the eager call
    b = run("S2", lambda m: a * m, mid)
    return run.own(b)


def test_key_rule_and_counters(monkeypatch):
    """A key's first call runs eagerly, its second in a row captures and
    replays, later ones replay; the chain keeps the graphs of two keys."""
    monkeypatch.setattr(graphs, "_backend", lambda d: FakeBackend())
    chain = graphs.Chain()
    x = torch.arange(4.0)
    flags = [0, 0, 0, 1, 0, 1, 1, 0, 2, 2, 1]
    want = ["eager", "captures", "replays", "eager", "replays", "eager",
            "captures", "replays", "eager", "captures", "eager"]
    for f, kind in zip(flags, want):
        before = trace.counters()
        out = toy_step(chain, x + f, f)
        np.testing.assert_array_equal(out, ((x + f) * 2 + f)
                                      * ((x + f) * 2 + f + 1))
        now = trace.counters()
        for seg in ("S1", "S2"):
            got = {k: now.get(f"graph.{k}.{seg}", 0)
                   - before.get(f"graph.{k}.{seg}", 0)
                   for k in ("replays", "captures", "eager")}
            expect = {"replays": int(kind != "eager"),
                      "captures": int(kind == "captures"),
                      "eager": int(kind == "eager")}
            assert got == expect, (f, kind, seg, got)


def test_cpu_runs_every_segment_eagerly():
    from active_orb_slam2_tpu_torch.models.system import System
    cfg, frames = setting(torch.device("cpu"))
    slam = System(cfg, use_mapping=False, device="cpu")
    before = trace.counters()
    for g, d, t in frames[:4]:
        slam.track_rgbd(g, d, t)
    slam.flush()
    n = counts(before)
    assert {k: v for k, v in n.items() if v} == {
        ("eager", "F1"): 4, ("eager", "F2"): 4, ("eager", "T1"): 3,
        ("eager", "T2"): 3, ("eager", "T3"): 3}


@pytest.mark.parametrize("dev", DEVICES)
def test_kept_outputs_are_the_frames_own(dev, monkeypatch):
    """A FrameData that ``make_rgbd`` returned and K1's arguments of a
    frame, kept by a caller, hold their values five frames later."""
    from active_orb_slam2_tpu_torch.models import tracking
    device = device_of(dev)
    graphed(monkeypatch, device)
    keep_at, now, kept = 10, [0], {}
    solve = tracking.pose_optimization_fused

    def keep_solve(*a, **kw):
        if now[0] == keep_at and "k1" not in kept:
            kept["k1"] = (a[1:], [t.clone() for t in a[1:]])
        return solve(*a, **kw)

    def hook(slam):
        make = slam.make_rgbd

        def keep_frame(*a):
            out = make(*a)
            if now[0] == keep_at:
                kept["frame"] = (out[0], [t.clone() for t in out[0]])
            return out

        slam.make_rgbd = keep_frame

    def before_frame(slam, i):
        now[0] = i
        if i == keep_at + 6:
            for held, copy in kept.values():
                for a, b in zip(held, copy):
                    assert torch.equal(a, b)
            kept["checked"] = True

    monkeypatch.setattr(tracking, "pose_optimization_fused", keep_solve)
    run(device, "localization", n=keep_at + 7, hook=hook,
        before_frame=before_frame)
    assert kept.pop("checked") and set(kept) == {"k1", "frame"}


@pytest.mark.cuda
def test_replayed_frames_make_no_host_sync():
    import warnings
    device = device_of("cuda")
    from active_orb_slam2_tpu_torch.models.system import System
    cfg, frames = setting(device)
    slam = System(cfg, use_mapping=True, device=device)
    n_sync = 0
    before = trace.counters()
    for i, (g, d, t) in enumerate(frames[:12]):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if i >= 4:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                slam.track_rgbd(g, d, t)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        n_sync += sum("synchronizing CUDA operation" in str(w.message)
                      for w in caught)
    slam.flush()
    assert slam.state == 1
    assert n_sync == 0
    n = counts(before)
    assert n["replays", "T3"] >= 8 and n["replays", "F2"] >= 10
