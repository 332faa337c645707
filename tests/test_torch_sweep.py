"""Port parity: swept-edge CCD (``repro_torch.core.sweep`` and
``repro_torch.core.pipeline.check_edges``) against the reference.

Both packages run on one cubby scene built in one process (the scene seed
is salted per process) and carried across by ``repro_torch.convert``; the
reference runs under ``jax.disable_jit()``.  Forward kinematics agrees
across the packages only to 1e-5, so the exact end-to-end checks hand the
port the reference's FK arrays (``edge_link_geometry`` replaced for the
test); the swept fit, the bisection, every round's plan and the engine
are then the port's own and must give the reference's ``first_hit``,
``collide`` and every counter bit for bit.  On its own FK the port's
modes must agree, upper-bound dense sampling, and match a left-first
descent whose segments the dense SACT decides against every leaf.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipe
from repro.core import sweep as jsweep
from repro.core.octree import build_octree as j_build_octree
from repro.core.wavefront import CollisionEngine as JEngine
from repro.core.wavefront import EngineConfig as JConfig
from repro.data.robotics import PANDA_JOINT_HI, PANDA_JOINT_LO, make_scene
from repro_torch.convert import octree_from_reference
from repro_torch.core import pipeline as tpipe
from repro_torch.core import sweep as tsweep
from repro_torch.core.geometry import NUM_LINKS
from repro_torch.engine.executor import CollisionEngine, EngineConfig
from repro_torch.kernels import _build
from repro_torch.kernels.sact.ops import pack_aabbs, pack_obbs, sact_dense

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

MODES = ("wavefront_persistent", "wavefront", "wavefront_fused")
R = 8


def _edge_batch(seed, E, delta=0.35):
    """Seeded PRM-style edge batch: short joint-space hops."""
    rs = np.random.RandomState(seed)
    qf = rs.uniform(PANDA_JOINT_LO, PANDA_JOINT_HI, (E, 7)).astype(np.float32)
    qt = np.clip(qf + rs.uniform(-delta, delta, (E, 7)).astype(np.float32),
                 PANDA_JOINT_LO, PANDA_JOINT_HI)
    return qf, qt


@pytest.fixture(scope="module")
def scene():
    sc = make_scene("cubby", num_points=3000)
    tree = j_build_octree(sc.points, depth=4)
    return sc, tree, octree_from_reference(tree)


def _engine(ttree, mode):
    return CollisionEngine(ttree, EngineConfig(mode=mode), device="cpu")


def _same_counters(a, b):
    a, b = a.as_dict(), b.as_dict()
    assert a.keys() == b.keys()
    for k in a:
        if k != "wall_time_s":
            assert a[k] == b[k], k


def test_edge_waypoints_and_fk_match_reference(scene):
    sc = scene[0]
    qf, qt = _edge_batch(0, 4)
    assert np.array_equal(tsweep.edge_waypoints(qf, qt, R),
                          jsweep.edge_waypoints(qf, qt, R))
    got = tsweep.edge_link_geometry(qf, qt, R, base_pos=sc.robot_base,
                                    device="cpu")
    want = jsweep.edge_link_geometry(qf, qt, R, base_pos=sc.robot_base)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("width", [1, 2, "mixed"])
def test_swept_obbs_matches_reference_bitwise(scene, width):
    """Fed the reference's FK arrays, the swept fit gives the reference's
    enclosures bit for bit (equal widths, and the mixed widths of one
    gather)."""
    sc = scene[0]
    qf, qt = _edge_batch(3, 6, delta=0.8)
    corners, rot = jsweep.edge_link_geometry(qf, qt, R,
                                             base_pos=sc.robot_base)
    rs = np.random.RandomState(5)
    edge = rs.randint(0, 6, 10).astype(np.int32)
    w = rs.randint(1, 4, 10) if width == "mixed" else np.full(10, width)
    lo = rs.randint(0, R - 3, 10).astype(np.int32)
    hi = np.minimum(lo + w, R).astype(np.int32)
    got = tsweep.swept_obbs(corners, rot, edge, lo, hi, "cpu")
    want = jsweep.swept_obbs(corners, rot, edge, lo, hi)
    for f in ("center", "half", "rot"):
        g, x = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == torch.float32 and np.array_equal(g.numpy(), x), f
    assert got.n == 10 * NUM_LINKS and (got.half > 0).all()


@pytest.fixture(scope="module")
def reference_geometry(scene):
    sc = scene[0]
    qf, qt = _edge_batch(1, 8)
    return qf, qt, jsweep.edge_link_geometry(qf, qt, R,
                                             base_pos=sc.robot_base)


@pytest.mark.parametrize("in_traversal_exit", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_check_edges_matches_reference_exactly(scene, reference_geometry,
                                               monkeypatch, mode,
                                               in_traversal_exit):
    """On the reference's FK arrays: first hits, verdicts and every
    counter of the whole sweep (every round's plan, grouped or boolean)
    equal the reference's ``check_edges`` in the same mode."""
    sc, tree, ttree = scene
    qf, qt, geo = reference_geometry
    monkeypatch.setattr(tsweep, "edge_link_geometry", lambda *a, **k: geo)
    before = _build.launch_counts()
    got = tpipe.check_edges(_engine(ttree, mode), qf, qt, resolution=R,
                            base_pos=sc.robot_base,
                            in_traversal_exit=in_traversal_exit)
    assert _build.launch_counts() == before
    cfg = (dict(stream_meta=False, meta_format="fp32")
           if mode == "wavefront_persistent" else {})
    with jax.disable_jit():
        want = jpipe.check_edges(JEngine(tree, JConfig(mode=mode, **cfg)),
                                 qf, qt, resolution=R,
                                 base_pos=sc.robot_base,
                                 in_traversal_exit=in_traversal_exit)
    assert np.array_equal(got.first_hit, want.first_hit)
    assert np.array_equal(got.collide, want.collide)
    assert got.first_hit.dtype == np.float32 and got.collide.dtype == bool
    _same_counters(got.counters, want.counters)
    assert got.collide.any() and got.counters.ref_arm_fallbacks == 0


def test_check_edges_on_streamed_bf16_rows_matches_reference(
        scene, reference_geometry, monkeypatch):
    """A persistent engine on streamed bf16 rows: every round's owner-group
    tiles read compressed rows and count their windows; on the reference's
    FK arrays the sweep's first hits, verdicts and every counter
    (``meta_rows_streamed`` included) equal the reference's."""
    sc, tree, ttree = scene
    qf, qt, geo = reference_geometry
    monkeypatch.setattr(tsweep, "edge_link_geometry", lambda *a, **k: geo)
    cfg = dict(mode="wavefront_persistent", stream_meta=True,
               meta_format="bf16")
    kw = dict(resolution=R, base_pos=sc.robot_base)
    got = tpipe.check_edges(CollisionEngine(ttree, EngineConfig(**cfg),
                                            device="cpu"), qf, qt, **kw)
    with jax.disable_jit():
        want = jpipe.check_edges(JEngine(tree, JConfig(**cfg)), qf, qt, **kw)
    assert np.array_equal(got.first_hit, want.first_hit)
    assert np.array_equal(got.collide, want.collide)
    _same_counters(got.counters, want.counters)
    assert got.collide.any() and got.counters.meta_rows_streamed > 0


def test_check_edges_on_a_host_mode_engine_matches_reference(
        scene, reference_geometry, monkeypatch):
    """``fig_edges``' no-exit baseline: ``check_edges`` on a
    ``staged_noexit`` engine, whose rounds take the boolean plans and
    reduce on the host whatever ``in_traversal_exit`` says.  On the
    reference's FK arrays its first hits, verdicts and every counter equal
    the reference's; its first hits and verdicts equal the exit arm's."""
    sc, tree, ttree = scene
    qf, qt, geo = reference_geometry
    monkeypatch.setattr(tsweep, "edge_link_geometry", lambda *a, **k: geo)
    kw = dict(resolution=R, base_pos=sc.robot_base)
    got = tpipe.check_edges(_engine(ttree, "staged_noexit"), qf, qt, **kw)
    with jax.disable_jit():
        want = jpipe.check_edges(JEngine(tree, JConfig(mode="staged_noexit")),
                                 qf, qt, **kw)
    assert np.array_equal(got.first_hit, want.first_hit)
    assert np.array_equal(got.collide, want.collide)
    _same_counters(got.counters, want.counters)
    exit_arm = tpipe.check_edges(_engine(ttree, "wavefront"), qf, qt, **kw)
    assert np.array_equal(got.first_hit, exit_arm.first_hit)
    assert np.array_equal(got.collide, exit_arm.collide)
    assert got.collide.any()
    assert got.counters.nodes_traversed >= exit_arm.counters.nodes_traversed


@pytest.fixture(scope="module")
def port_runs(scene):
    """The port on its own FK: every mode and both exit arms, one batch."""
    sc, _, ttree = scene
    qf, qt = _edge_batch(2, 8)
    runs = {(m, ite): tpipe.check_edges(_engine(ttree, m), qf, qt,
                                        resolution=R,
                                        base_pos=sc.robot_base,
                                        in_traversal_exit=ite)
            for m in MODES for ite in (True, False)}
    return qf, qt, runs


def test_check_edges_modes_agree_and_upper_bound_dense(scene, port_runs):
    """Every mode and exit arm gives the same first hits and verdicts; the
    exit arm visits no more nodes; the swept verdicts cover dense
    sampling at the same resolution, and no swept first hit comes after
    the first colliding waypoint."""
    sc, _, ttree = scene
    qf, qt, runs = port_runs
    ref = runs[("wavefront_persistent", True)]
    assert ref.collide.any()
    for (mode, ite), r in runs.items():
        assert np.array_equal(r.first_hit, ref.first_hit), (mode, ite)
        assert np.array_equal(r.collide, ref.collide), (mode, ite)
        if ite:
            assert r.counters.nodes_traversed <= \
                runs[(mode, False)].counters.nodes_traversed
    eng = _engine(ttree, "wavefront_fused")
    flags, _ = tpipe.check_trajectories(
        eng, tsweep.edge_waypoints(qf, qt, R), base_pos=sc.robot_base)
    dense = np.asarray(flags).any(axis=1)
    assert (~dense | ref.collide).all()
    for e in np.flatnonzero(dense):
        first_wp = int(np.argmax(flags[e])) / R
        assert ref.first_hit[e] <= first_wp + 1e-6
    assert np.isinf(ref.first_hit[~ref.collide]).all()


def test_first_hit_matches_naive_descent(scene, port_runs):
    """A left-first descent in which the dense SACT (``sact_dense``, its
    plain version here) decides each segment against every leaf confirms
    the same first sub-intervals as the traversal."""
    sc, _, ttree = scene
    qf, qt, runs = port_runs
    got = runs[("wavefront_persistent", True)]
    corners, rot = tsweep.edge_link_geometry(qf, qt, R,
                                             base_pos=sc.robot_base,
                                             device="cpu")
    leaves = ttree.leaf_aabbs()
    boxes = pack_aabbs(leaves.center, leaves.half)
    ref_hit = np.full(qf.shape[0], np.inf, np.float32)
    for e in range(qf.shape[0]):
        queue = [(0, R)]
        while queue:
            lo, hi = queue.pop(0)
            o = tsweep.swept_obbs(corners, rot, np.asarray([e]),
                                  np.asarray([lo]), np.asarray([hi]),
                                  "cpu")
            collide, _ = sact_dense(pack_obbs(o.center, o.half, o.rot),
                                    boxes)
            if not bool(collide.any()):
                continue
            if hi - lo == 1:
                ref_hit[e] = lo / R
                break
            mid = (lo + hi) // 2
            queue.insert(0, (mid, hi))
            queue.insert(0, (lo, mid))
    assert np.array_equal(got.collide, np.isfinite(ref_hit))
    assert np.array_equal(got.first_hit[got.collide],
                          ref_hit[got.collide])


@pytest.mark.parametrize("mode", MODES)
def test_resolution_one_and_free_batch(scene, mode):
    """Resolution 1 (the whole edge is one payload round) and a batch far
    outside the scene (free, one round, little work)."""
    sc, _, ttree = scene
    eng = _engine(ttree, mode)
    qf, qt = _edge_batch(4, 4)
    first_hit, collide, c = tsweep.sweep_edges(eng, qf, qt, resolution=1,
                                               base_pos=sc.robot_base)
    assert first_hit.shape == (4,)
    assert set(np.unique(first_hit[collide])) <= {0.0}
    assert c.num_queries > 0
    off = np.tile(np.asarray([0.0, -1.5, 0.0, -1.5, 0.0, 1.5, 0.0],
                             np.float32), (3, 1))
    fh, col, cf = tsweep.sweep_edges(eng, off, off + 0.01, resolution=8,
                                     base_pos=np.asarray([50.0, 50.0, 50.0]))
    assert not col.any() and np.isinf(fh).all()
    assert cf.nodes_traversed <= 3 * NUM_LINKS * 2


def test_invalid_resolution_and_shapes_rejected(scene):
    _, _, ttree = scene
    eng = _engine(ttree, "wavefront")
    qf, qt = _edge_batch(5, 2)
    for res in (3, 0, 12):
        with pytest.raises(ValueError, match="power of two"):
            tpipe.check_edges(eng, qf, qt, resolution=res)
    with pytest.raises(ValueError, match="configurations"):
        tsweep.sweep_edges(eng, qf[0], qt[0], resolution=4)
