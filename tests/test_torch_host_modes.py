"""Port parity: the Fig. 11 ablation arms (``naive``, ``rta_like``,
``staged_noexit``, ``predicated``, ``wavefront_host``) against the JAX
reference engine, the reference's identities between modes, and the
helpers the arms stand on (``lookup_children``, ``sact_pairwise*``).

Both sides get the same scene (carried across by ``repro_torch.convert``)
and the same OBB arrays; the JAX engine runs under ``jax.disable_jit()``
(XLA:CPU's jit contracts ``a*b+c`` into fused multiply-adds, eager
PyTorch does not).  Verdicts and every ``Counters`` field but
``wall_time_s`` must be equal.  The port's ``naive`` runs the dense SACT
kernel's plain version here (``kernels/sact/ref.py::sact_ref``), the
reference's ``core/sact.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import geometry as jgeo
from repro.core import octree as joct
from repro.core import sact as jsact
from repro.data import robotics as jrob
from repro.engine import executor as jexe
from repro.engine import plan as jplan
from repro_torch.convert import octree_from_reference
from repro_torch.core import octree as toct
from repro_torch.core import sact as tsact
from repro_torch.core.geometry import AABBs, OBBs
from repro_torch.engine import plan as tplan
from repro_torch.engine.executor import (DEPTH_CAP_MODES, DEVICE_MODES,
                                         MODES, CollisionEngine,
                                         EngineConfig)
from repro_torch.kernels import _build

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

HOST_MODES = ("naive", "rta_like", "staged_noexit", "predicated",
              "wavefront_host")
#: The work counters the reference's mode identities compare
#: (``tests/test_traverse.py::WORK_FIELDS``), with the per-level nodes and
#: the exit histogram.
WORK_FIELDS = ("nodes_traversed", "leaf_tests", "axis_tests_executed",
               "axis_tests_decoded", "sphere_tests", "frontier_overflow",
               "nodes_per_level", "exit_histogram")


@pytest.fixture(scope="module")
def scene():
    sc = jrob.make_scene("cubby", num_points=8192)
    tree = joct.build_octree(sc.points, depth=4)
    obbs = jrob.scene_trajectories(sc, num_trajectories=2, waypoints=8)
    arrays = [np.asarray(x) for x in (obbs.center, obbs.half, obbs.rot)]
    return tree, octree_from_reference(tree), arrays


def _torch_obbs(arrays):
    return OBBs(*(torch.from_numpy(x.copy()) for x in arrays))


def _query(ttree, arrays, mode, max_depth=None, **cfg):
    eng = CollisionEngine(ttree, EngineConfig(mode=mode, **cfg),
                          device="cpu")
    return eng.execute(tplan.plan_queries(_torch_obbs(arrays)),
                       max_depth=max_depth)


def _jax_query(tree, arrays, mode, max_depth=None, **cfg):
    obbs = jgeo.OBBs(*map(jnp.asarray, arrays))
    with jax.disable_jit():
        eng = jexe.CollisionEngine(tree, jexe.EngineConfig(mode=mode, **cfg))
        return eng.execute(jplan.plan_queries(obbs), max_depth=max_depth)


def _assert_same(got, want, skip=()):
    (v, c), (wv, wc) = got, want
    assert np.array_equal(v, np.asarray(wv))
    a, b = c.as_dict(), wc.as_dict()
    assert a.keys() == b.keys()
    for k in a:
        if k not in ("wall_time_s",) + tuple(skip):
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def port_runs(scene):
    """Every mode of the port on the scene, without spheres."""
    _, ttree, arrays = scene
    return {m: _query(ttree, arrays, m) for m in MODES}


@pytest.mark.parametrize("use_spheres", [False, True])
@pytest.mark.parametrize("mode", HOST_MODES)
def test_host_mode_matches_reference(scene, port_runs, mode, use_spheres):
    tree, ttree, arrays = scene
    got = (port_runs[mode] if not use_spheres else
           _query(ttree, arrays, mode, use_spheres=True))
    want = _jax_query(tree, arrays, mode, use_spheres=use_spheres)
    _assert_same(got, want)
    v, c = got
    assert v.dtype == bool and v.any() and not v.all()
    assert c.escalations == 0 and c.frontier_overflow == 0
    assert (c.shader_invocations > 0) == (mode == "rta_like")
    if mode == "naive":
        assert c.nodes_per_level == [] and c.sphere_tests == 0
        assert c.exit_histogram.sum() == arrays[0].shape[0] * ttree.num_leaves
    else:
        assert c.nodes_per_level[0] == arrays[0].shape[0]
        assert (c.sphere_tests > 0) == use_spheres


def test_wavefront_host_depth_cap_matches_reference(scene):
    """``max_depth`` on ``wavefront_host``; the other four arms refuse a cap
    with the reference's message."""
    tree, ttree, arrays = scene
    got = _query(ttree, arrays, "wavefront_host", max_depth=2)
    _assert_same(got, _jax_query(tree, arrays, "wavefront_host", max_depth=2))
    full = _query(ttree, arrays, "wavefront_host")
    assert len(got[1].nodes_per_level) == 3
    assert (got[0] >= full[0]).all()
    assert got[1].nodes_traversed < full[1].nodes_traversed
    assert "wavefront_host" in DEPTH_CAP_MODES
    for mode in HOST_MODES[:-1]:
        with pytest.raises(ValueError) as a:
            _query(ttree, arrays, mode, max_depth=2)
        with pytest.raises(ValueError) as b:
            _jax_query(tree, arrays, mode, max_depth=2)
        assert str(a.value) == str(b.value)


def _big_obbs(n=16, seed=4):
    """A few large OBBs whose no-exit frontier outgrows a small cap."""
    rs = np.random.RandomState(seed)
    rot = np.asarray(jgeo.rotation_from_euler(jnp.asarray(
        rs.uniform(-3, 3, (n, 3)).astype(np.float32))))
    return [rs.uniform(0.2, 0.8, (n, 3)).astype(np.float32),
            rs.uniform(0.04, 0.1, (n, 3)).astype(np.float32), rot]


def test_staged_noexit_overflow_matches_reference(scene):
    """A pinned ``max_frontier`` below a level's child pairs: the host
    cuts the frontier and counts the surplus exactly as the reference."""
    tree, ttree, _ = scene
    arrays = _big_obbs()
    cfg = dict(max_frontier=32)       # every bucket is 32 pairs
    got = _query(ttree, arrays, "staged_noexit", **cfg)
    _assert_same(got, _jax_query(tree, arrays, "staged_noexit", **cfg))
    assert got[1].frontier_overflow > 0
    assert max(got[1].nodes_per_level) == 32


def test_naive_ragged_query_block_equals_default(scene, port_runs):
    """A block that does not divide the query count (112 = 2 x 48 + 16)
    gives the default block's verdicts and counters."""
    _, ttree, arrays = scene
    assert arrays[0].shape[0] % 48
    got = _query(ttree, arrays, "naive", query_block=48)
    _assert_same(got, port_runs["naive"])


def test_grouped_plan_on_host_mode_raises_reference_message(scene):
    tree, ttree, arrays = scene
    Q = arrays[0].shape[0]
    own = np.arange(Q, dtype=np.int32) // 7
    plan = tplan.plan_edges(_torch_obbs(arrays), own, -(-Q // 7))
    jp = jplan.plan_edges(jgeo.OBBs(*map(jnp.asarray, arrays)), own,
                          -(-Q // 7))
    for mode in HOST_MODES:
        with pytest.raises(ValueError) as a:
            CollisionEngine(ttree, EngineConfig(mode=mode),
                            device="cpu").execute(plan)
        with pytest.raises(ValueError) as b:
            jexe.CollisionEngine(tree,
                                 jexe.EngineConfig(mode=mode)).execute(jp)
        assert str(a.value) == str(b.value)


@pytest.mark.parametrize("mode", HOST_MODES)
def test_cpu_host_mode_launches_no_kernel(scene, mode):
    _, ttree, arrays = scene
    before = _build.launch_counts()
    v, _ = _query(ttree, arrays, mode)
    assert _build.launch_counts() == before and v.any()


def test_cuda_host_mode_raises_without_cuda(scene):
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    _, ttree, _ = scene
    for mode in HOST_MODES:
        with pytest.raises(RuntimeError, match="CUDA"):
            CollisionEngine(ttree, EngineConfig(mode=mode))


def test_mode_identities(scene, port_runs):
    """The reference's identities between modes: ``wavefront_host`` and
    ``predicated`` equal ``wavefront`` on verdicts and every work counter
    (the device arm differs only in ``escalations``); ``rta_like`` equals
    ``staged_noexit`` but for its shader calls and their bytes; the
    no-exit arms visit more nodes than the exit arms and fewer than
    ``naive`` tests pairs."""
    runs = port_runs
    wv, wc = runs["wavefront"]
    for mode in ("wavefront_host", "predicated"):
        v, c = runs[mode]
        assert np.array_equal(v, wv)
        for f in WORK_FIELDS + ("bytes_moved",):
            assert np.array_equal(getattr(c, f), getattr(wc, f)), (mode, f)
    _assert_same(runs["rta_like"], runs["staged_noexit"],
                 skip=("shader_invocations", "bytes_moved"))
    rta, tta = runs["rta_like"][1], runs["staged_noexit"][1]
    assert rta.bytes_moved == tta.bytes_moved + 128 * rta.shader_invocations
    for mode in MODES:
        assert np.array_equal(runs[mode][0], wv), mode
    assert wc.nodes_traversed < tta.nodes_traversed
    assert tta.nodes_traversed < runs["naive"][1].nodes_traversed
    assert wc.axis_tests_executed <= tta.axis_tests_executed


def test_engine_config_properties_match_reference():
    for mode in MODES:
        got, want = EngineConfig(mode=mode), jexe.EngineConfig(mode=mode)
        for prop in ("early_exit", "stage_split", "fused", "persistent",
                     "device_resident"):
            assert getattr(got, prop) == getattr(want, prop), (mode, prop)
    assert DEVICE_MODES == jexe.DEVICE_MODES
    assert DEPTH_CAP_MODES == jexe.DEPTH_CAP_MODES


def test_lookup_children_matches_reference(scene):
    """Every parent of a shallow and of the deepest inner level against
    the next level's codes, on the padded int64 row (pads sort last) and
    on the reference's uint32 level, with parent codes of 0 and of the
    largest 27-bit code, which has no children."""
    tree, ttree, _ = scene
    dev = toct.device_octree(ttree, device="cpu")
    for level in (1, tree.depth - 1):
        assert int(dev.codes_unsigned[level + 1, -1]) == int(toct.PAD_CODE)
        parents = np.concatenate([tree.levels[level].codes,
                                  np.asarray([0, 2**27 - 1], np.uint32)])
        cand, idx = toct.lookup_children(dev.codes_unsigned[level + 1],
                                         torch.from_numpy(
                                             parents.astype(np.int64)))
        with jax.disable_jit():
            jc, ji = joct.lookup_children(
                jnp.asarray(tree.levels[level + 1].codes),
                jnp.asarray(parents))
        assert np.array_equal(cand.numpy(), np.asarray(jc).astype(np.int64))
        assert np.array_equal(idx.numpy(), np.asarray(ji))
        assert idx.dtype == torch.int32 and (idx >= 0).any()
        # the reference's padded row gives the same slots
        padded = jnp.asarray(np.asarray(dev.codes_unsigned[level + 1])
                             .astype(np.uint32))
        with jax.disable_jit():
            _, jpad = joct.lookup_children(padded, jnp.asarray(parents))
        assert np.array_equal(idx.numpy(), np.asarray(jpad))


def _touching_planes(seed):
    """Axis-aligned OBBs (signed-permutation rotations) with power-of-two
    extents on a dyadic grid: every product is exact (ROADMAP C.5), many
    faces touch."""
    rs = np.random.RandomState(seed)
    perms = np.asarray([np.eye(3)[list(p)] for p in
                        ((0, 1, 2), (1, 2, 0), (2, 0, 1), (0, 2, 1),
                         (2, 1, 0), (1, 0, 2))], np.float32)
    n, m = 37, 29
    rot = (perms[rs.randint(0, 6, n)]
           * rs.choice([-1.0, 1.0], (n, 1, 3))).astype(np.float32)
    obbs = [(rs.randint(-8, 8, (n, 3)) / 8.0).astype(np.float32),
            (2.0 ** -rs.randint(1, 5, (n, 3))).astype(np.float32), rot]
    aabbs = [(rs.randint(-8, 8, (m, 3)) / 8.0).astype(np.float32),
             (2.0 ** -rs.randint(1, 5, (m, 3))).astype(np.float32)]
    return obbs, aabbs


def _random_planes(seed):
    rs = np.random.RandomState(seed)
    rot = np.asarray(jgeo.rotation_from_euler(jnp.asarray(
        rs.uniform(-3, 3, (37, 3)).astype(np.float32))))
    return ([rs.uniform(-1, 1, (37, 3)).astype(np.float32),
             rs.uniform(0.02, 0.4, (37, 3)).astype(np.float32), rot],
            [rs.uniform(-1, 1, (29, 3)).astype(np.float32),
             rs.uniform(0.02, 0.4, (29, 3)).astype(np.float32)])


@pytest.mark.parametrize("use_spheres", [False, True])
def test_sact_pairwise_functions_match_reference(use_spheres):
    """``sact_pairwise``, ``sact_pairwise_blocked`` (a block that does not
    divide M) and ``sact_collide_only`` on exact-product boxes and on
    random boxes (the engine's ``naive`` arm holds the scene's plane)."""
    for obb_np, aabb_np in (_touching_planes(11), _random_planes(12)):
        tob = OBBs(*(torch.from_numpy(x.copy()) for x in obb_np))
        tab = AABBs(*(torch.from_numpy(x.copy()) for x in aabb_np))
        job = jgeo.OBBs(*map(jnp.asarray, obb_np))
        jab = jgeo.AABBs(*map(jnp.asarray, aabb_np))
        with jax.disable_jit():
            want = jsact.sact_pairwise(job, jab, use_spheres=use_spheres)
            want_b = jsact.sact_pairwise_blocked(job, jab, block=16,
                                                 use_spheres=use_spheres)
            want_c = jsact.sact_collide_only(
                job.center[:, None], job.half[:, None], job.rot[:, None],
                jab.center[None], jab.half[None])
        got = tsact.sact_pairwise(tob, tab, use_spheres=use_spheres)
        got_b = tsact.sact_pairwise_blocked(tob, tab, block=16,
                                            use_spheres=use_spheres)
        got_c = tsact.sact_collide_only(
            tob.center[:, None], tob.half[:, None], tob.rot[:, None],
            tab.center[None], tab.half[None])
        for g, w in ((got, want), (got_b, want_b)):
            for f in w._fields:
                assert np.array_equal(getattr(g, f).numpy(),
                                      np.asarray(getattr(w, f))), f
        assert np.array_equal(got_c.numpy(), np.asarray(want_c))
        assert got.collide.any() and not got.collide.all()
        assert torch.equal(got_c, got.collide) or use_spheres
