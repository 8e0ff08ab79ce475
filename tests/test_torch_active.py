"""The port's active-exploration layer (``active_orb_slam2_tpu_torch/active``)
beside the JAX package's, on the CPU.

The same numpy maps (``tests/test_active.py``'s toy map, and a seeded
random arena of 32 keyframes and 2,048 point slots with invalid slots
and rays that leave the grid) go through both packages' occupancy grid,
localizability scorer, frontier detection and A*; the port's maps come
across through ``models/convert.py::map_from_jax_numpy``.  Tolerances:

* occupancy grid: equal cells on the toy map; on the random arena >=
  99.5% equal, and every other cell holds a ray sample within 1e-5 m of
  a cell edge (where float32 rounding may fall either side);
* ``pose_from_xz_heading``: <= 1e-6 per quaternion component, and per
  translation component <= 1e-6 m per metre of distance from the origin
  (each package's float32 sin/cos is within an ulp of the true value,
  and the rotation carries a 1-ulp difference to the translation);
* scorer counts: equal on >= 99% of the poses and within +-2 on the
  rest; the chunked scorer equals one chunk exactly;
* frontier mask, goals and A* paths: identical.

``-m slow`` adds both packages' ``run_exploration`` at
``examples/run_exploration.py``'s configuration, with
``tests/test_active.py::test_exploration_loop``'s bars on the port.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from active_orb_slam2_tpu import active as jact
from active_orb_slam2_tpu import config as jcfg
from active_orb_slam2_tpu.active import scoring as jscoring
from active_orb_slam2_tpu.geometry.projection import CameraParams as JCam
from active_orb_slam2_tpu.models import map_state as jms
from active_orb_slam2_tpu_torch import active as tact
from active_orb_slam2_tpu_torch.active import explorer as texp
from active_orb_slam2_tpu_torch.active import scoring as tscoring
from active_orb_slam2_tpu_torch.active.occupancy import (
    FREE, OCCUPIED, UNKNOWN)
from active_orb_slam2_tpu_torch.config import MapConfig, OrbConfig
from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
from active_orb_slam2_tpu_torch.models.convert import map_from_jax_numpy
from active_orb_slam2_tpu_torch.models.map_state import empty_map
from tests import test_active as jtests

torch.set_num_threads(1)

CAM = CameraParams(fx=260.0, fy=260.0, cx=159.5, cy=119.5, bf=20.8,
                   width=320, height=240)
JCAM = JCam(*CAM[:7])
SPEC = tact.GridSpec2D(origin_x=-5.0, origin_z=-5.0, resolution=0.25,
                       width=40, height=40)
# examples/run_exploration.py's grid
EX_SPEC = tact.GridSpec2D(origin_x=-4.0, origin_z=-4.0, resolution=0.25,
                          width=32, height=32)
GRID_AGREE = 0.995
EDGE_TOL_M = 1e-5
POSE_ATOL = 1e-6
SCORE_AGREE = 0.99
SCORE_ATOL = 2


def jax_map(arrays):
    return jms.MapState(**{f: jnp.asarray(a) for f, a in arrays.items()})


def map_arrays(m):
    return {f: np.asarray(getattr(m, f)) for f in m._fields}


def random_arena(seed=0, K=32, P=2048, F=256):
    """numpy fields of a JAX arena: keyframes at random places and
    headings inside +-3 m (some slots invalid), points on 8 random wall
    segments that start within +-7 m in x and z (beyond a 10 m grid;
    some slots invalid), each keyframe observing random points (some
    features unmatched), normals from a random keyframe to the point."""
    rng = np.random.default_rng(seed)
    a = map_arrays(jms.empty_map(jcfg.MapConfig(max_keyframes=K,
                                                max_points=P),
                                 jcfg.OrbConfig(n_features=F)))
    pos = rng.uniform(-3.0, 3.0, (K, 2))
    head = rng.uniform(0.0, 2 * np.pi, K)
    a["kf_pose"] = tscoring.pose_from_xz_heading(
        pos[:, 0], pos[:, 1], head).numpy()
    a["kf_valid"] = rng.random(K) > 0.1
    start = rng.uniform(-7.0, 7.0, (8, 2))
    ang, length = rng.uniform(0, np.pi, 8), rng.uniform(1.5, 4.0, 8)
    wall, t = rng.integers(0, 8, P), rng.uniform(0, 1, P)
    xyz = np.stack([start[wall, 0] + np.cos(ang[wall]) * length[wall] * t,
                    rng.uniform(-1, 1, P),
                    start[wall, 1] + np.sin(ang[wall]) * length[wall] * t],
                   -1).astype(np.float32)
    a["pt_xyz"] = xyz
    a["pt_valid"] = rng.random(P) > 0.15
    src = np.stack([pos[:, 0], np.zeros(K), pos[:, 1]], -1)[
        rng.integers(0, K, P)]
    n = xyz - src
    a["pt_normal"] = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(
        np.float32)
    a["pt_min_dist"] = rng.uniform(0.2, 1.0, P).astype(np.float32)
    a["pt_max_dist"] = rng.uniform(4.0, 10.0, P).astype(np.float32)
    kp = rng.integers(0, P, (K, F)).astype(np.int32)
    kp[rng.random((K, F)) < 0.3] = -1
    a["kf_point"] = kp
    a["kf_feat_valid"] = kp >= 0
    return a


@pytest.fixture(scope="module")
def arena():
    return random_arena()


def edge_cells(spec, a, n_ray_samples=48, tol=EDGE_TOL_M):
    """Flat cells next to a counted ray sample (or endpoint) that lies
    within ``tol`` of a cell edge, from float64 samples."""
    q = a["kf_pose"].astype(np.float64)
    w, v, t = q[:, :1], -q[:, 1:4], q[:, 4:7]      # R^T = R(conj(q))
    uv = np.cross(v, t) + w * t
    ow = -(t + 2.0 * np.cross(v, uv))              # -R^T t
    pt = np.clip(a["kf_point"], 0, None)
    obs = (a["kf_point"] >= 0) & a["kf_valid"][:, None] & a["pt_valid"][pt]
    ends = a["pt_xyz"].astype(np.float64)[pt][obs]
    starts = np.broadcast_to(ow[:, None], a["kf_point"].shape + (3,))[obs]
    s = (np.arange(n_ray_samples) + 0.5) / (n_ray_samples + 1.0)
    samples = np.concatenate([
        (starts[None] + s[:, None, None] * (ends - starts)[None]).reshape(
            -1, 3), ends])
    cells = set()
    for x, z in samples[:, [0, 2]]:
        ux = (x - spec.origin_x) / spec.resolution
        uz = (z - spec.origin_z) / spec.resolution
        if min(abs(ux - round(ux)), abs(uz - round(uz))) \
                * spec.resolution >= tol:
            continue
        for dx in (-tol, tol):
            for dz in (-tol, tol):
                cx = int(np.floor((x + dx - spec.origin_x) / spec.resolution))
                cz = int(np.floor((z + dz - spec.origin_z) / spec.resolution))
                if 0 <= cx < spec.width and 0 <= cz < spec.height:
                    cells.add(cz * spec.width + cx)
    return cells


def grids_agree(spec, a):
    """Both packages' grids of arena ``a``: asserts the stated agreement
    and returns the port's grid and the share of equal cells."""
    jg = np.asarray(jact.build_occupancy_grid(spec)(jax_map(a)))
    tg = tact.build_occupancy_grid(spec)(map_from_jax_numpy(a)).numpy()
    assert tg.shape == jg.shape == (spec.height, spec.width)
    assert tg.dtype == np.int8
    same = tg == jg
    assert same.mean() >= GRID_AGREE
    if not same.all():
        assert set(np.flatnonzero(~same)) <= edge_cells(spec, a)
    return tg, same.mean()


# ------------------------------------------------ tests/test_active.py's cases


def toy_map():
    """``tests/test_active.py::toy_map`` in the port: one keyframe at the
    origin observing a wall of 64 points at z = 3."""
    m = empty_map(MapConfig(max_keyframes=8, max_points=256),
                  OrbConfig(n_features=64))
    n = 64
    xs = np.linspace(-1.5, 1.5, n)
    pts = np.stack([xs, np.zeros(n), np.full(n, 3.0)], -1)
    m.kf_valid[0] = True
    m.kf_feat_valid[0] = True
    m.kf_point[0, :n] = torch.arange(n, dtype=torch.int32)
    m.pt_valid[:n] = True
    m.pt_xyz[:n] = torch.tensor(pts, dtype=torch.float32)
    m.pt_normal[:n] = torch.tensor([0.0, 0.0, 1.0])
    m.pt_min_dist[:n] = 0.1
    m.pt_max_dist[:n] = 50.0
    return m


def test_occupancy_grid():
    grid = tact.build_occupancy_grid(SPEC)(toy_map()).numpy()
    assert grid.shape == (40, 40)
    occ_row = int((3.0 - SPEC.origin_z) / SPEC.resolution)
    assert (grid[occ_row] == OCCUPIED).sum() >= 5
    mid_row = int((1.5 - SPEC.origin_z) / SPEC.resolution)
    assert (grid[mid_row] == FREE).sum() >= 3
    assert grid[0, 0] == UNKNOWN


def test_visibility_scorer():
    scorer = tact.build_visibility_scorer(CAM)
    poses = tscoring.pose_from_xz_heading(
        torch.tensor([0.0, 0.0]), torch.tensor([0.0, 0.0]),
        torch.tensor([0.0, np.pi]))   # facing the wall vs away
    counts = scorer(poses, toy_map()).numpy()
    assert counts.dtype == np.int32
    assert counts[0] > 50
    assert counts[1] == 0


def test_frontier_detection():
    grid = np.full((20, 20), UNKNOWN, np.int8)
    grid[5:15, 5:15] = FREE
    goals = tact.frontier_goals(grid)
    fm = tact.frontier_mask(torch.from_numpy(grid)).numpy()
    assert fm[5, 10] and fm[14, 10] and fm[10, 5]
    assert not fm[10, 10]
    assert len(goals) > 0


def test_astar_basic():
    grid = np.full((20, 20), FREE, np.int8)
    grid[:, 10] = OCCUPIED
    grid[18, 10] = FREE               # gap at the bottom
    path = tact.astar_plan(grid, (1, 1), (1, 18))
    assert path is not None
    assert path[0] == (1, 1) and path[-1] == (1, 18)
    assert [r for r, c in path if c == 10] == [18]


def test_astar_feature_constraint():
    grid = np.full((10, 10), FREE, np.int8)
    loc = np.full((10, 10), 100.0)
    loc[:, 5] = 0.0                   # feature desert column
    loc[9, 5] = 100.0                 # except one safe cell
    path = tact.astar_plan(grid, (0, 0), (0, 9), localizability=loc,
                           min_features=30)
    assert path is not None
    assert [r for r, c in path if c == 5] == [9]


# ------------------------------------------------------------ against JAX


def test_occupancy_toy_map_matches_jax(rng):
    jg = np.asarray(jact.build_occupancy_grid(SPEC)(jtests.toy_map(rng)))
    tg = tact.build_occupancy_grid(SPEC)(toy_map()).numpy()
    np.testing.assert_array_equal(tg, jg)


def test_occupancy_random_arena_matches_jax(arena):
    """Cells equal (>= 99.5%, the rest at sample-on-edge cells); the
    arena's rays leave the grid, and its grid has all three states."""
    tg, agree = grids_agree(SPEC, arena)
    assert {UNKNOWN, FREE, OCCUPIED} <= set(np.unique(tg).tolist())
    # the same arena at the example's 8 m grid: more rays leave it
    grids_agree(EX_SPEC, arena)


def test_occupancy_rays_leaving_the_grid():
    """One keyframe inside the grid, every point far outside it: the
    cells the rays cross inside are free, none is occupied, and the
    samples outside add nothing (the JAX package's grid, cell for
    cell)."""
    a = random_arena(seed=1, K=2, P=64, F=64)
    a["kf_valid"][:] = [True, False]
    a["kf_pose"][0] = [1, 0, 0, 0, 0, 0, 0]
    ang = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    a["pt_xyz"] = np.stack([9 * np.cos(ang), np.zeros(64), 9 * np.sin(ang)],
                           -1).astype(np.float32)
    a["pt_valid"][:] = True
    a["kf_point"][0] = np.arange(64, dtype=np.int32)
    tg, _ = grids_agree(SPEC, a)
    assert (tg == OCCUPIED).sum() == 0
    assert (tg == FREE).sum() > 0


def test_pose_from_xz_heading_matches_jax(rng):
    x, z = rng.uniform(-5, 5, 500), rng.uniform(-5, 5, 500)
    h = rng.uniform(-7, 7, 500)
    jp = np.asarray(jscoring.pose_from_xz_heading(x, z, h, y=0.3))
    tp = tscoring.pose_from_xz_heading(x, z, h, y=0.3).numpy()
    assert tp.dtype == np.float32 and tp.shape == (500, 7)
    np.testing.assert_allclose(tp[:, :4], jp[:, :4], rtol=0, atol=POSE_ATOL)
    # the translation is the position rotated: its error scales with the
    # distance from the origin (measured 4.5e-7 m per metre, a few ulps)
    dist = np.maximum(np.hypot(x, z), 1.0)
    assert (np.abs(tp[:, 4:] - jp[:, 4:]).max(1) / dist).max() <= POSE_ATOL


def scores_agree(tc, jc):
    tc, jc = np.asarray(tc), np.asarray(jc)
    assert tc.shape == jc.shape
    assert (tc == jc).mean() >= SCORE_AGREE
    assert np.abs(tc.astype(np.int64) - jc).max() <= SCORE_ATOL


def test_scorer_matches_jax_and_chunks_exactly(arena, rng):
    """2,048 poses over the random arena, as the example scores them (16
    x 16 cells x 8 headings): counts as the JAX package's within the
    stated agreement; uneven chunks of 7 poses give the single chunk's
    counts bit for bit."""
    Q = 2048
    x, z = rng.uniform(-4, 4, Q), rng.uniform(-4, 4, Q)
    h = rng.uniform(0, 2 * np.pi, Q)
    jp = jscoring.pose_from_xz_heading(x, z, h)
    jc = np.asarray(jact.build_visibility_scorer(JCAM)(jp, jax_map(arena)))
    tm = map_from_jax_numpy(arena)
    poses = torch.from_numpy(np.array(jp))
    scorer = tact.build_visibility_scorer(CAM)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tscoring, "POSE_POINT_CHUNK", Q * 2048)
        one = scorer(poses, tm)
        mp.setattr(tscoring, "POSE_POINT_CHUNK", 7 * 2048)
        chunked = scorer(poses, tm)
    assert one.dtype == torch.int32
    assert (jc > 0).mean() > 0.5        # the arena is seen from most poses
    scores_agree(one, jc)
    assert torch.equal(one, chunked)


def test_score_grid_localizability_layout(arena):
    """[H', W', headings] with rows along z and columns along x (the JAX
    package's ``meshgrid(indexing="ij")`` and ``transpose(1, 0, 2)``):
    equal to the JAX package's sweep within the stated agreement, and
    each entry the scorer's count of its own cell centre and heading."""
    tm = map_from_jax_numpy(arena)
    scorer = tact.build_visibility_scorer(CAM)
    loc = tact.score_grid_localizability(scorer, tm, EX_SPEC, headings=8,
                                         cell_stride=2)
    assert loc.shape == (16, 16, 8)
    jloc = jact.score_grid_localizability(
        jact.build_visibility_scorer(JCAM), jax_map(arena), EX_SPEC,
        headings=8, cell_stride=2)
    scores_agree(loc.numpy(), jloc)
    r, c = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    zc = (2 * r + 0.5) * EX_SPEC.resolution + EX_SPEC.origin_z
    xc = (2 * c + 0.5) * EX_SPEC.resolution + EX_SPEC.origin_x
    for k in (0, 3, 7):
        own = scorer(tscoring.pose_from_xz_heading(
            xc.ravel(), zc.ravel(), np.full(256, k * 2 * np.pi / 8)), tm)
        np.testing.assert_array_equal(loc[..., k].numpy().ravel(),
                                      own.numpy())


def seeded_grids(seed, n=12, size=24):
    """Occupancy grids of free blobs in unknown space with occupied
    specks."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        g = np.full((size, size), UNKNOWN, np.int8)
        for _ in range(rng.integers(2, 6)):
            r, c = rng.integers(0, size, 2)
            h, w = rng.integers(3, 12, 2)
            g[r:r + h, c:c + w] = FREE
        g[rng.random((size, size)) < 0.08] = OCCUPIED
        yield g


def test_frontier_matches_jax():
    for g in seeded_grids(2):
        fm = tact.frontier_mask(torch.from_numpy(g)).numpy()
        np.testing.assert_array_equal(
            fm, np.asarray(jact.frontier_mask(jnp.asarray(g))))
        assert tact.frontier_goals(g) == jact.frontier_goals(jnp.asarray(g))
        for pool, min_cells in ((2, 1), (6, 5)):
            assert tact.frontier_goals(g, pool, min_cells) == \
                jact.frontier_goals(jnp.asarray(g), pool, min_cells)


def test_astar_matches_jax():
    """Paths (or None) identical on seeded grids and start/goal cells,
    without localizability, with it (a threshold), and through unknown
    space."""
    rng = np.random.default_rng(5)
    found = 0
    for g in seeded_grids(3, n=10):
        loc = rng.integers(0, 80, g.shape).astype(np.float64)
        for _ in range(6):
            start = tuple(rng.integers(0, g.shape[0], 2))
            goal = tuple(rng.integers(0, g.shape[0], 2) + rng.random(2))
            for kw in ({}, {"unknown_ok": True},
                       {"localizability": loc, "min_features": 20,
                        "unknown_ok": True},
                       {"localizability": loc, "min_features": 10}):
                tp = tact.astar_plan(g, start, goal, **kw)
                jp = jact.astar_plan(jnp.asarray(g), start, goal, **kw)
                assert tp == jp
                found += tp is not None
    assert found >= 40


def jax_planning_step(a, spec, min_features=30):
    """One planning step of the JAX package's ``run_exploration`` on map
    ``a`` from the grid centre: (points, grid, goals, loc_full, path)."""
    m = jax_map(a)
    grid = np.asarray(jact.build_occupancy_grid(spec)(m))
    goals = jact.frontier_goals(jnp.asarray(grid))
    loc = jact.score_grid_localizability(jact.build_visibility_scorer(JCAM),
                                         m, spec, headings=8, cell_stride=2)
    loc_full = np.kron(loc.max(-1), np.ones((2, 2)))[
        :spec.height, :spec.width]
    start = (spec.height // 2, spec.width // 2)
    path = None
    for gr, gc, _ in goals[:5]:
        path = jact.astar_plan(jnp.asarray(grid), start, (gr, gc),
                               localizability=loc_full,
                               min_features=min_features, unknown_ok=True)
        if path and len(path) > 1:
            break
    return int(np.asarray(m.pt_valid.sum())), grid, goals, loc_full, path


def test_planning_step_matches_jax(arena):
    """``explorer.read_step`` (one copy) and ``explorer.plan_step`` (the
    host half of a step) against the JAX package's step on the same map: point count, grid,
    goals, ``loc_full`` and the path."""
    jn, jgrid, jgoals, jloc_full, jpath = jax_planning_step(arena, EX_SPEC)
    n, grid, fm, loc = texp.read_step(
        tact.build_occupancy_grid(EX_SPEC), tact.build_visibility_scorer(CAM),
        map_from_jax_numpy(arena), EX_SPEC)
    assert n == jn
    np.testing.assert_array_equal(grid, jgrid)
    goals, loc_full, path = texp.plan_step(
        grid, fm, loc, EX_SPEC, (EX_SPEC.height // 2, EX_SPEC.width // 2),
        min_features=30)
    assert goals == jgoals and len(goals) > 0
    np.testing.assert_array_equal(loc_full, jloc_full)
    assert path == jpath and path is not None and len(path) > 1


# ------------------------------------------------------------------- slow


def example_configs():
    """``examples/run_exploration.py``'s configuration for both
    packages."""
    from active_orb_slam2_tpu_torch.config import SlamConfig, TrackingConfig
    tc = SlamConfig(camera=CAM, orb=OrbConfig(n_features=512, n_levels=4),
                    tracking=TrackingConfig(th_depth=10.0),
                    map=MapConfig(max_keyframes=64, max_points=16384,
                                  local_ba_keyframes=8,
                                  local_ba_points=2048))
    jc = jcfg.SlamConfig(
        camera=JCAM, orb=jcfg.OrbConfig(**dataclasses.asdict(tc.orb)),
        tracking=jcfg.TrackingConfig(**dataclasses.asdict(tc.tracking)),
        map=jcfg.MapConfig(**dataclasses.asdict(tc.map)))
    return jc, tc


@pytest.mark.slow
def test_exploration_beside_jax():
    """Both packages' ``run_exploration`` at the example's configuration
    (15 steps from (0, -2) over ``default_world(n_boxes=4)``, loop
    closing on; the JAX System retires each frame before the next).  The
    port meets ``tests/test_active.py::test_exploration_loop``'s bars;
    the step at which the two packages' positions first part, and each
    package's rigid ATE against the poses it rendered, are printed."""
    from active_orb_slam2_tpu.active import explorer as jexp
    from active_orb_slam2_tpu.io.trajectory import camera_centers as jcc
    from active_orb_slam2_tpu.io.synthetic import default_world as jworld
    from active_orb_slam2_tpu.models.system import System as JSystem
    from active_orb_slam2_tpu_torch.io.synthetic import default_world
    from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
    from active_orb_slam2_tpu_torch.models.system import System
    from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment
    jc, tc = example_configs()
    fed = {"port": [], "jax": []}

    def recording(side, render):
        def call(world, cam, Twc, *a, **kw):
            fed[side].append(np.asarray(Twc, np.float64)[:3, 3])
            return render(world, cam, Twc, *a, **kw)
        return call

    def ate(slam, centers, side):
        _, poses = slam.frame_trajectory()
        return umeyama_alignment(np.asarray(centers(poses), np.float64),
                                 np.stack(fed[side]), fix_scale=True)[4]

    spec = dict(origin_x=-4.0, origin_z=-4.0, resolution=0.25, width=32,
                height=32)
    tslam = System(tc, use_loop_closing=True, device="cpu")
    jslam = JSystem(jc, use_loop_closing=True, pipeline_depth=0,
                    retire_batch=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(texp, "render_rgbd", recording("port", texp.render_rgbd))
        mp.setattr(jexp, "render_rgbd", recording("jax", jexp.render_rgbd))
        tlog = texp.run_exploration(tslam, default_world(n_boxes=4),
                                    tact.GridSpec2D(**spec), n_steps=15,
                                    start_xz=(0.0, -2.0))
        jlog = jexp.run_exploration(jslam, jworld(n_boxes=4),
                                    jact.GridSpec2D(**spec), n_steps=15,
                                    start_xz=(0.0, -2.0))
    parted = next((i for i, (a, b) in enumerate(zip(tlog.positions,
                                                    jlog.positions))
                   if np.hypot(a[0] - b[0], a[1] - b[1]) > 1e-6), None)
    print(f"port: {len(tlog.positions)} positions, {tlog.replans} replans, "
          f"coverage {tlog.coverage[0]:.3f} -> {tlog.coverage[-1]:.3f}, "
          f"points {tlog.n_points[0]} -> {tlog.n_points[-1]}, keyframes "
          f"{tslam.kf_seq}, loops {tslam.n_loops_closed}, frames "
          f"{len(fed['port'])}, ATE {ate(tslam, camera_centers, 'port'):.5f} m")
    print(f"jax:  {len(jlog.positions)} positions, {jlog.replans} replans, "
          f"coverage {jlog.coverage[0]:.3f} -> {jlog.coverage[-1]:.3f}, "
          f"points {jlog.n_points[0]} -> {jlog.n_points[-1]}, keyframes "
          f"{jslam.kf_seq}, loops {jslam.n_loops_closed}, frames "
          f"{len(fed['jax'])}, ATE {ate(jslam, jcc, 'jax'):.5f} m")
    print(f"positions first part at step {parted}")
    assert len(tlog.positions) >= 3
    assert tlog.replans >= 1
    assert tlog.coverage[-1] > tlog.coverage[0]
    assert tlog.n_points[-1] >= tlog.n_points[0]


def explore_side(side: str, frames=None):
    """One side of ``test_exploration_beside_jax``'s run, each frame
    retired before the next: ``jax``, ``port``, or ``port-witness`` (the
    port with the JAX package's local-BA write-back, quirk g).  Returns
    the positions, replans, coverage, keyframes and points after every
    fed frame, loops closed and the rigid ATE against the poses fed.
    ``frames``: on the JAX side, the ``jax_frames`` recorder is left
    under ``frames["jax"]``; on a port side, that recorder's frames are
    fed in place of the port's own frame pipeline's."""
    from active_orb_slam2_tpu.active import explorer as jexp
    from active_orb_slam2_tpu.io.synthetic import default_world as jworld
    from active_orb_slam2_tpu.io.trajectory import camera_centers as jcc
    from active_orb_slam2_tpu.models.system import System as JSystem
    from active_orb_slam2_tpu_torch.io.synthetic import default_world
    from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
    from active_orb_slam2_tpu_torch.models.system import System
    from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment
    from tests.test_torch_mapping import jax_frames, jax_write_back
    jc, tc = example_configs()
    is_jax = side == "jax"
    exp, act = (jexp, jact) if is_jax else (texp, tact)
    fed, rows = [], []
    spec = dict(origin_x=-4.0, origin_z=-4.0, resolution=0.25, width=32,
                height=32)

    def recording(render):
        def call(world, cam, Twc, *a, **kw):
            fed.append(np.asarray(Twc, np.float64)[:3, 3])
            return render(world, cam, Twc, *a, **kw)
        return call

    with pytest.MonkeyPatch.context() as mp, contextlib.ExitStack() as stack:
        if side == "port-witness":
            stack.enter_context(jax_write_back())
        if frames is not None and not is_jax:
            stack.enter_context(frames["jax"].port_pipeline())
        slam = JSystem(jc, use_loop_closing=True, pipeline_depth=0,
                       retire_batch=1) if is_jax else \
            System(tc, use_loop_closing=True, device="cpu")
        if frames is not None and is_jax:
            frames["jax"] = jax_frames(slam)
        track = slam.track_rgbd

        def tracked(*a, **kw):
            out = track(*a, **kw)
            slam.state
            rows.append((slam.kf_seq,
                         int(np.asarray(slam.map.pt_valid.sum()))))
            return out
        mp.setattr(slam, "track_rgbd", tracked)
        mp.setattr(exp, "render_rgbd", recording(exp.render_rgbd))
        log = exp.run_exploration(
            slam, (jworld if is_jax else default_world)(n_boxes=4),
            act.GridSpec2D(**spec), n_steps=15, start_xz=(0.0, -2.0))
    _, poses = slam.frame_trajectory()
    ate = umeyama_alignment(np.asarray((jcc if is_jax else camera_centers)(
        poses), np.float64), np.stack(fed), fix_scale=True)[4]
    return {"positions": [list(map(float, p)) for p in log.positions],
            "replans": log.replans, "coverage": list(map(float, log.coverage)),
            "rows": rows, "loops": slam.n_loops_closed, "ate": float(ate)}


def first_parted(a, b):
    """The first step whose positions differ by more than 1e-6."""
    return next((i for i, (p, q) in enumerate(zip(a, b))
                 if np.hypot(p[0] - q[0], p[1] - q[1]) > 1e-6), None)


@pytest.mark.slow
def test_exploration_gap_is_the_frames_and_the_write_back():
    """ROADMAP queue 3, item u, on the CPU.  With only the JAX package's
    local-BA write-back patched in, the port still parts from the JAX
    package at frame 10 (a keyframe the JAX package does not insert: 231
    local-stage inliers against its 233, where the decision's bar is 0.9
    x the last keyframe's 258, 232.2), and the positions at step 6.  The
    frames differ by quirk a: 6-28 of 512 keypoint angles a frame by up
    to 1.5e-4 rad, and 0-1 descriptor a frame (frame 10 has one).  Fed
    the JAX package's own frames as well (``jax_frames``), the port
    visits the JAX package's positions at every step and makes its
    keyframes after every frame; the map points part by 2 of 1,379 at
    frame 88 (measured: 2,744 against 2,730 at the end, ATE 0.10491
    against 0.10542 m), where the write-back patch does not reach (the
    masked lanes of create-points and fuse, quirk g)."""
    frames = {}
    jax_side = explore_side("jax", frames)
    witness = explore_side("port-witness", frames)
    print("jax", jax_side["positions"], jax_side["rows"][-1], jax_side["ate"])
    print("port+write-back+JAX frames", witness["positions"],
          witness["rows"][-1], witness["ate"])
    parted = next((i for i, (a, b) in enumerate(zip(witness["rows"],
                                                     jax_side["rows"]))
                   if a != b), None)
    print("rows first part at frame", parted)
    assert first_parted(witness["positions"], jax_side["positions"]) is None
    assert [r[0] for r in witness["rows"]] == \
        [r[0] for r in jax_side["rows"]]
    for (_, a), (_, b) in zip(witness["rows"], jax_side["rows"]):
        assert abs(a - b) <= 0.01 * b, (a, b)
    assert abs(witness["ate"] - jax_side["ate"]) <= 1e-3


if __name__ == "__main__":
    import argparse
    import json
    ap = argparse.ArgumentParser(
        description="one side of the exploration run, as JSON (ROADMAP "
        "queue 3, item u): JAX_PLATFORMS=cpu python -m "
        "tests.test_torch_active --side jax|port|port-witness --json OUT")
    ap.add_argument("--side", choices=("jax", "port", "port-witness"),
                    required=True)
    ap.add_argument("--json", required=True)
    args = ap.parse_args()
    with open(args.json, "w") as f:
        json.dump(explore_side(args.side), f)
