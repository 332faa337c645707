"""Port parity: ``CollisionEngine`` in its three device modes against the
JAX reference engine, and the modes against each other.

Both sides get the same scene (carried across by ``repro_torch.convert``)
and the same OBB arrays.  The JAX engine runs under ``jax.disable_jit()``
(XLA:CPU's jit contracts ``a*b+c`` into fused multiply-adds; eager
PyTorch does not) with the resident fp32 rows pinned.  Against its Pallas
kernel arm (``use_pallas_traverse=True``, interpreted) verdicts and every
``Counters`` field must agree; against its default global-pool ref arm
``escalations`` may differ, since the two count overflow differently
(one shared pool vs per tile).  The per-level arms are held against the
reference with its Pallas compaction (and, for ``wavefront_fused``, its
Pallas step kernel), interpreted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import geometry as jgeo
from repro.core import octree as joct
from repro.data import robotics as jrob
from repro.engine import executor as jexe
from repro.engine import plan as jplan
from repro_torch.convert import octree_from_reference
from repro_torch.core.geometry import OBBs
from repro_torch.engine import plan as tplan
from repro_torch.engine.executor import CollisionEngine, EngineConfig
from repro_torch.kernels import _build
from repro_torch.kernels.persist.ops import MAX_TILE_BQ

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

PERSIST = "wavefront_persistent"
LEVEL_MODES = ("wavefront", "wavefront_fused")
#: The reference's Pallas arms of each per-level mode.
PALLAS_ARMS = {"wavefront": dict(use_pallas_compact=True),
               "wavefront_fused": dict(use_pallas_traverse=True,
                                       use_pallas_compact=True)}


@pytest.fixture(scope="module")
def scene():
    sc = jrob.make_scene("cubby", num_points=8192)
    tree = joct.build_octree(sc.points, depth=4)
    obbs = jrob.scene_trajectories(sc, num_trajectories=2, waypoints=8)
    arrays = [np.asarray(x) for x in (obbs.center, obbs.half, obbs.rot)]
    return tree, octree_from_reference(tree), arrays


def _torch_obbs(arrays):
    return OBBs(*(torch.from_numpy(x.copy()) for x in arrays))


def _jax_query(tree, arrays, **cfg):
    cfg = dict(mode=PERSIST, stream_meta=False, meta_format="fp32", **cfg)
    with jax.disable_jit():
        return jexe.CollisionEngine(tree, jexe.EngineConfig(**cfg)).query(
            jgeo.OBBs(*map(jnp.asarray, arrays)))


def _assert_same(got, want, skip=()):
    (v, c), (wv, wc) = got, want
    assert np.array_equal(v, np.asarray(wv))
    a, b = c.as_dict(), wc.as_dict()
    assert a.keys() == b.keys()
    for k in a:
        if k not in ("wall_time_s",) + tuple(skip):
            assert a[k] == b[k], k


@pytest.mark.parametrize("use_spheres", [False, True])
def test_engine_matches_reference_kernel_arm(scene, use_spheres):
    tree, ttree, arrays = scene
    got = CollisionEngine(ttree, EngineConfig(mode=PERSIST,
                                              use_spheres=use_spheres),
                          device="cpu").query(_torch_obbs(arrays))
    want = _jax_query(tree, arrays, use_spheres=use_spheres,
                      use_pallas_traverse=True)
    _assert_same(got, want)
    assert got[0].any() and not got[0].all()
    assert got[1].nodes_per_level[0] == arrays[0].shape[0]


def _big_obbs(n=16, seed=4):
    """A few large OBBs: one tile whose frontier outgrows a small bucket."""
    rs = np.random.RandomState(seed)
    rot = np.asarray(jgeo.rotation_from_euler(jnp.asarray(
        rs.uniform(-3, 3, (n, 3)).astype(np.float32))))
    return [rs.uniform(0.2, 0.8, (n, 3)).astype(np.float32),
            rs.uniform(0.04, 0.1, (n, 3)).astype(np.float32), rot]


def test_engine_escalation_matches_reference_kernel_arm(scene):
    """A tiny first bucket overflows per tile and climbs the 4x replay
    ladder exactly as the reference kernel arm does."""
    tree, ttree, _ = scene
    arrays = _big_obbs()
    cfg = dict(min_bucket=64)
    eng = CollisionEngine(ttree, EngineConfig(mode=PERSIST, **cfg),
                          device="cpu")
    got = eng.query(_torch_obbs(arrays))
    want = _jax_query(tree, arrays, use_pallas_traverse=True, **cfg)
    _assert_same(got, want)
    assert got[1].escalations >= 1 and got[1].frontier_overflow == 0
    # the clean capacity is remembered: a repeat query replays nothing
    again = eng.query(_torch_obbs(arrays))
    assert again[1].escalations == 0
    assert np.array_equal(again[0], got[0])


def test_engine_pinned_capacity_counts_overflow_like_reference(scene):
    tree, ttree, _ = scene
    arrays = _big_obbs()
    cfg = dict(frontier_capacity=16)
    got = CollisionEngine(ttree, EngineConfig(mode=PERSIST, **cfg),
                          device="cpu").query(_torch_obbs(arrays))
    want = _jax_query(tree, arrays, use_pallas_traverse=True, **cfg)
    _assert_same(got, want)
    assert got[1].frontier_overflow > 0


def test_engine_matches_reference_ref_arm(scene):
    """The reference's default CPU arm (global pool): everything but
    ``escalations`` agrees."""
    tree, ttree, arrays = scene
    got = CollisionEngine(ttree, EngineConfig(mode=PERSIST),
                          device="cpu").query(_torch_obbs(arrays))
    want = _jax_query(tree, arrays)
    _assert_same(got, want, skip=("escalations",))


def test_query_batched_equals_flat_query(scene):
    _, ttree, arrays = scene
    eng = CollisionEngine(ttree, EngineConfig(mode=PERSIST), device="cpu")
    flat_v, flat_c = eng.query(_torch_obbs(arrays))
    B = 2
    obbs = _torch_obbs([x.reshape((B, -1) + x.shape[1:]) for x in arrays])
    v, c = eng.query_batched(obbs)
    assert v.shape == (B, arrays[0].shape[0] // B)
    assert np.array_equal(v.reshape(-1), flat_v)
    assert c.nodes_per_level == flat_c.nodes_per_level


@pytest.mark.parametrize("mode", (PERSIST,) + LEVEL_MODES)
def test_cpu_engine_launches_no_kernel(scene, mode):
    _, ttree, arrays = scene
    before = _build.launch_counts()
    CollisionEngine(ttree, EngineConfig(mode=mode),
                    device="cpu").query(_torch_obbs(arrays))
    assert _build.launch_counts() == before


def test_engine_cuda_raises_without_cuda(scene):
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    _, ttree, _ = scene
    with pytest.raises(RuntimeError, match="CUDA"):
        CollisionEngine(ttree, EngineConfig(mode=PERSIST))
    with pytest.raises(RuntimeError, match="CUDA"):
        CollisionEngine(ttree, EngineConfig(mode=PERSIST), device="cuda")


def test_unported_modes_and_options_raise(scene):
    tree, ttree, arrays = scene
    # sharded execution (ROADMAP A.8, now ported) is bounded by the
    # engine's shard devices: one on a CPU engine by default
    with pytest.raises(ValueError, match="shard device"):
        CollisionEngine(ttree, EngineConfig(mode=PERSIST, shards=2),
                        device="cpu")
    # a multi-scene engine (ROADMAP A.5.6, now ported) takes plans of its
    # own scene count only
    two = CollisionEngine([ttree, ttree], EngineConfig(mode=PERSIST),
                          device="cpu")
    plan = tplan.plan_queries(_torch_obbs(arrays))
    with pytest.raises(ValueError, match="engine holds 2"):
        two.execute(plan)
    eng = CollisionEngine(ttree, EngineConfig(mode=PERSIST), device="cpu")
    assert not eng.supports_depth_cap
    with pytest.raises(ValueError, match="depth-cappable"):
        eng.execute(plan, max_depth=2)
    edges = tplan.QueryPlan(
        kind="edges", obb_c=plan.obb_c, obb_h=plan.obb_h, obb_r=plan.obb_r,
        out_shape=(plan.num_queries,),
        payload=torch.zeros(plan.num_queries, dtype=torch.int32))
    # an owner group past the largest tile raises rather than falling back
    # to a plain version; the per-level modes have no tiles and run it
    n = MAX_TILE_BQ + 1
    big = _torch_obbs([np.repeat(x[:1], n, 0) for x in arrays])
    one_group = tplan.plan_edges(big, np.zeros(n, np.int32), 1)
    with pytest.raises(NotImplementedError, match="B.2.5"):
        CollisionEngine(ttree, EngineConfig(mode=PERSIST),
                        device="cpu").execute(one_group)
    for mode in LEVEL_MODES:
        eng = CollisionEngine(ttree, EngineConfig(mode=mode), device="cpu")
        v, c = eng.execute(one_group)
        assert v.shape == (1,) and c.ref_arm_fallbacks == 0
    with pytest.raises(ValueError, match="max_depth"):
        eng.execute(edges, max_depth=2)
    with pytest.raises(ValueError, match=">= 1"):
        eng.execute(plan, max_depth=0)
    # the same scene twice: each half of the batch gets the one-scene
    # verdicts, and twice its work
    pair = [np.stack([x, x]) for x in arrays]
    v2, c2 = CollisionEngine([ttree, ttree], EngineConfig(),
                             device="cpu").execute(
        tplan.plan_scenes(_torch_obbs(pair)))
    v1, c1 = CollisionEngine(ttree, EngineConfig(), device="cpu").query(
        _torch_obbs(arrays))
    assert np.array_equal(v2, np.stack([v1, v1]))
    assert c2.nodes_traversed == 2 * c1.nodes_traversed
    # the streamed layout runs and matches the reference
    eng = CollisionEngine(ttree, EngineConfig(mode=PERSIST, stream_meta=True),
                          device="cpu")
    assert eng.meta_layout == "streamed"
    v, c = eng.query(_torch_obbs(arrays))
    with jax.disable_jit():
        want = jexe.CollisionEngine(tree, jexe.EngineConfig(
            mode=PERSIST, stream_meta=True)).query(
                jgeo.OBBs(*map(jnp.asarray, arrays)))
    _assert_same((v, c), want, skip=("escalations",))
    assert c.meta_rows_streamed > 0
    with pytest.raises(ValueError, match="unknown engine mode"):
        EngineConfig(mode="bogus")


@pytest.mark.parametrize("stream_meta", [False, True])
@pytest.mark.parametrize("fmt", ["fp32", "bf16", "u8"])
def test_engine_rows_and_layouts_match_reference(scene, fmt, stream_meta):
    """Each row format in each layout, against the reference engine's
    plain arm with the same pins: verdicts and every counter,
    ``meta_rows_streamed`` and ``meta_bytes_streamed`` included (the
    streamed rows are the same in every format, their bytes the format's
    row width)."""
    tree, ttree, arrays = scene
    cfg = dict(mode=PERSIST, meta_format=fmt, stream_meta=stream_meta)
    eng = CollisionEngine(ttree, EngineConfig(**cfg), device="cpu")
    assert eng.device_tree.meta_format == fmt
    got = eng.query(_torch_obbs(arrays))
    with jax.disable_jit():
        want = jexe.CollisionEngine(tree, jexe.EngineConfig(**cfg)).query(
            jgeo.OBBs(*map(jnp.asarray, arrays)))
    _assert_same(got, want)
    c = got[1]
    assert (c.meta_rows_streamed > 0) == stream_meta
    assert c.meta_bytes_streamed == c.meta_rows_streamed * {
        "fp32": 16, "bf16": 8, "u8": 4}[fmt]
    fp32 = _level_query(ttree, arrays, PERSIST)
    _assert_same(got, fp32, skip=("meta_rows_streamed", "meta_bytes_streamed",
                                  "bytes_moved"))


@pytest.mark.parametrize("fmt,lanes", [("u8", "owner+payload"),
                                       ("bf16", "payload")])
def test_grouped_plans_on_streamed_rows_match_reference(scene, fmt, lanes):
    """Owner-group tiles and payload lanes on streamed compressed rows:
    the per-group ``best`` words and every counter against the reference
    engine's plain arm, whose window model keys on the same tiles."""
    tree, ttree, arrays = scene
    plan, jplan_ = _grouped_plans(arrays, lanes)
    cfg = dict(meta_format=fmt, stream_meta=True)
    got = CollisionEngine(ttree, EngineConfig(mode=PERSIST, **cfg),
                          device="cpu").execute(plan)
    with jax.disable_jit():
        want = jexe.CollisionEngine(tree, jexe.EngineConfig(
            mode=PERSIST, **cfg)).execute(jplan_)
    _assert_same(got, want)
    assert got[1].meta_rows_streamed > 0


def test_streamed_overflow_replays_like_reference_kernel_arm(scene):
    """A tiny first bucket overflows per tile on streamed u8 rows and
    climbs the replay ladder as the reference's interpreted kernel does;
    the clean run's windows are the ones counted."""
    tree, ttree, _ = scene
    arrays = _big_obbs()
    cfg = dict(min_bucket=64)
    got = CollisionEngine(ttree, EngineConfig(
        mode=PERSIST, meta_format="u8", stream_meta=True, **cfg),
        device="cpu").query(_torch_obbs(arrays))
    with jax.disable_jit():
        want = jexe.CollisionEngine(tree, jexe.EngineConfig(
            mode=PERSIST, meta_format="u8", stream_meta=True,
            use_pallas_traverse=True, **cfg)).query(
                jgeo.OBBs(*map(jnp.asarray, arrays)))
    _assert_same(got, want)
    assert got[1].escalations >= 1 and got[1].meta_rows_streamed > 0


def _jax_level_query(tree, arrays, mode, max_depth=None, **cfg):
    cfg = dict(mode=mode, **PALLAS_ARMS[mode], **cfg)
    obbs = jgeo.OBBs(*map(jnp.asarray, arrays))
    with jax.disable_jit():
        eng = jexe.CollisionEngine(tree, jexe.EngineConfig(**cfg))
        return eng.execute(jplan.plan_queries(obbs), max_depth=max_depth)


def _level_query(ttree, arrays, mode, max_depth=None, **cfg):
    eng = CollisionEngine(ttree, EngineConfig(mode=mode, **cfg),
                          device="cpu")
    return eng.execute(tplan.plan_queries(_torch_obbs(arrays)),
                       max_depth=max_depth)


@pytest.mark.parametrize("mode", LEVEL_MODES)
@pytest.mark.parametrize("case", ["spheres", "depth2", "escalate",
                                  "pinned"])
def test_level_modes_match_reference_pallas_arms(scene, mode, case):
    """Verdicts and every counter, per-level arm against the reference's
    Pallas arm of the same mode: with spheres, and without them under a
    depth cap, through the escalation ladder and overflowing a pinned
    capacity (the full-depth run without spheres is held through
    ``test_three_modes_agree`` and the persistent mode's parity)."""
    tree, ttree, arrays = scene
    kw, max_depth = {}, None
    if case == "spheres":
        kw = dict(use_spheres=True)
    elif case == "depth2":
        max_depth = 2
    elif case == "escalate":
        arrays, kw = _big_obbs(), dict(min_bucket=64)
    elif case == "pinned":
        # the escalation ladder's first rung: the reference's eager ops
        # then reuse the shapes it compiled for the "escalate" case
        arrays, kw = _big_obbs(), dict(frontier_capacity=64)
    got = _level_query(ttree, arrays, mode, max_depth, **kw)
    want = _jax_level_query(tree, arrays, mode, max_depth, **kw)
    _assert_same(got, want)
    c = got[1]
    assert got[0].any() and not got[0].all()
    if case == "escalate":
        assert c.escalations >= 1 and c.frontier_overflow == 0
    if case == "pinned":
        assert c.frontier_overflow > 0 and c.escalations == 0
    if case == "depth2":
        assert len(c.nodes_per_level) <= 3


@pytest.mark.parametrize("use_spheres", [False, True])
def test_three_modes_agree(scene, use_spheres):
    """The port's device modes agree in one process on verdicts and every
    counter but the bytes model and escalations; under a depth cap the two
    per-level arms agree on verdicts and nodes, and cover the full-depth
    hits."""
    _, ttree, arrays = scene
    runs = {m: _level_query(ttree, arrays, m, use_spheres=use_spheres)
            for m in LEVEL_MODES + (PERSIST,)}
    for m in LEVEL_MODES:
        _assert_same(runs[m], runs[PERSIST],
                     skip=("bytes_moved", "escalations"))
    capped = {m: _level_query(ttree, arrays, m, max_depth=2,
                              use_spheres=use_spheres) for m in LEVEL_MODES}
    (va, ca), (vb, cb) = capped.values()
    assert np.array_equal(va, vb)
    assert ca.nodes_traversed == cb.nodes_traversed
    assert (va >= runs[PERSIST][0]).all()
    assert ca.nodes_traversed < runs[PERSIST][1].nodes_traversed


def test_default_config_runs_on_cpu(scene):
    _, ttree, arrays = scene
    eng = CollisionEngine(ttree, device="cpu")
    assert eng.cfg.mode == "wavefront" and eng.supports_depth_cap
    assert eng.meta_format == eng.device_tree.meta_format == "fp32"
    v, c = eng.query(_torch_obbs(arrays))
    want = _level_query(ttree, arrays, PERSIST)
    _assert_same((v, c), want, skip=("bytes_moved", "escalations"))


@pytest.mark.parametrize("fmt", ["bf16", "u8"])
def test_fused_compressed_rows_match_fp32(scene, fmt):
    _, ttree, arrays = scene
    got = _level_query(ttree, arrays, "wavefront_fused", meta_format=fmt)
    want = _level_query(ttree, arrays, "wavefront_fused")
    _assert_same(got, want)


def test_plan_validation_matches_reference_messages(scene):
    _, _, arrays = scene
    obbs = _torch_obbs(arrays)
    plan = tplan.validate_plan(tplan.plan_queries(obbs))
    assert plan.shape_tag == f"queries[Q={obbs.n} S=1 G={obbs.n} lanes=none]"
    assert plan.work_units(10) == 10 * obbs.n
    bad = arrays[0].copy()
    bad[5, 1] = np.nan
    with pytest.raises(tplan.PlanValidationError, match="slot 5"):
        tplan.validate_plan(tplan.plan_queries(
            OBBs(torch.from_numpy(bad), obbs.half, obbs.rot)))
    neg = arrays[1].copy()
    neg[2, 0] = 0.0
    with pytest.raises(tplan.PlanValidationError, match="slot 2"):
        tplan.validate_plan(tplan.plan_queries(
            OBBs(obbs.center, torch.from_numpy(neg), obbs.rot)))
    with pytest.raises(tplan.PlanValidationError, match="float32"):
        tplan.validate_plan(tplan.plan_queries(
            OBBs(obbs.center.double(), obbs.half, obbs.rot)))
    assert tplan.WORKLOADS == jexe.plan_queries.__globals__["WORKLOADS"]


@pytest.mark.parametrize("mode", (PERSIST,) + LEVEL_MODES)
def test_core_wavefront_shim_reexports_engine(scene, mode):
    """``repro_torch.core.wavefront`` serves the engine's public names, as
    ``repro.core.wavefront`` does in the reference."""
    from repro_torch.core import wavefront
    from repro_torch.engine import executor
    for name in wavefront.__all__:
        assert getattr(wavefront, name) is getattr(executor, name)
    _, ttree, arrays = scene
    eng = wavefront.CollisionEngine(ttree, wavefront.EngineConfig(mode=mode),
                                    device="cpu")
    assert eng.device_tree.meta_format == eng.meta_format
    _assert_same(eng.query(_torch_obbs(arrays)),
                 _level_query(ttree, arrays, mode))


def _grouped_lanes(Q, lanes, seed=6):
    """Compact owner ids (groups of 1-14 slots, shuffled) and payloads in
    [0, 8) for a pool of ``Q`` slots."""
    rs = np.random.RandomState(seed)
    sizes = []
    while sum(sizes) < Q:
        sizes.append(int(rs.randint(1, 15)))
    sizes[-1] -= sum(sizes) - Q
    own = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    own = own[rs.permutation(Q)]
    pay = rs.randint(0, 8, Q).astype(np.int32)
    return ((own, len(sizes)) if "owner" in lanes else (None, Q),
            pay if "payload" in lanes else None)


def _grouped_plans(arrays, lanes):
    (own, G), pay = _grouped_lanes(arrays[0].shape[0], lanes)
    obbs = _torch_obbs(arrays)
    jobbs = jgeo.OBBs(*map(jnp.asarray, arrays))
    if own is not None:
        return (tplan.plan_edges(obbs, own, G, payload=pay),
                jplan.plan_edges(jobbs, own, G, payload=pay))
    kw = dict(kind="edges", out_shape=(G,), payload=pay)
    return (tplan.QueryPlan(obb_c=obbs.center, obb_h=obbs.half,
                            obb_r=obbs.rot, **dict(
                                kw, payload=torch.from_numpy(pay))),
            jplan.QueryPlan(obb_c=jobbs.center, obb_h=jobbs.half,
                            obb_r=jobbs.rot, **dict(
                                kw, payload=jnp.asarray(pay))))


def _jax_execute(tree, plan, mode, **cfg):
    if mode == PERSIST:
        cfg = dict(stream_meta=False, meta_format="fp32", **cfg)
    else:
        cfg = dict(PALLAS_ARMS[mode], **cfg)
    with jax.disable_jit():
        return jexe.CollisionEngine(
            tree, jexe.EngineConfig(mode=mode, **cfg)).execute(plan)


@pytest.mark.parametrize("lanes", ["owner", "owner+payload", "payload"])
@pytest.mark.parametrize("mode", (PERSIST,) + LEVEL_MODES)
def test_grouped_plans_match_reference(scene, mode, lanes):
    """Owner and payload lanes in every device mode against the reference
    engine (its tiled plain arm for the persistent mode, its Pallas arms
    for the per-level ones): the per-group ``best`` words and every
    counter; the persistent mode packs an owner-group tiled pool."""
    tree, ttree, arrays = scene
    plan, jplan_ = _grouped_plans(arrays, lanes)
    got = CollisionEngine(ttree, EngineConfig(mode=mode),
                          device="cpu").execute(plan)
    want = _jax_execute(tree, jplan_, mode)
    _assert_same(got, want)
    v = got[0]
    assert v.dtype == np.int32 and v.shape == (plan.groups,)
    hit = v < tplan.PAYLOAD_INF
    assert hit.any() and not hit.all()
    assert got[1].ref_arm_fallbacks == 0


def test_grouped_plan_matches_reference_kernel_arm(scene):
    """The persistent mode's tiled pool against the reference's
    interpreted megakernel on the same owner-group tiles."""
    tree, ttree, arrays = scene
    plan, jplan_ = _grouped_plans(arrays, "owner+payload")
    got = CollisionEngine(ttree, EngineConfig(mode=PERSIST),
                          device="cpu").execute(plan)
    want = _jax_execute(tree, jplan_, PERSIST, use_pallas_traverse=True)
    _assert_same(got, want)
    assert want[1].ref_arm_fallbacks == 0


def test_plan_edges_rejects_non_compact_owner_ids(scene):
    _, _, arrays = scene
    obbs = _torch_obbs(arrays)
    jobbs = jgeo.OBBs(*map(jnp.asarray, arrays))
    Q = obbs.n
    for own, G in ((np.full(Q, 3, np.int32), 3), (np.full(Q, -1, np.int32), 2),
                   (np.zeros(Q, np.int32), Q + 1)):
        with pytest.raises(ValueError) as a:
            tplan.plan_edges(obbs, own, G)
        with pytest.raises(ValueError) as b:
            jplan.plan_edges(jobbs, own, G)
        assert str(a.value) == str(b.value)
    plan = tplan.plan_edges(obbs, np.arange(Q, dtype=np.int32) // 7,
                            -(-Q // 7))
    assert plan.grouped and plan.owner_of_query.dtype == torch.int32
    assert plan.shape_tag == (f"edges[Q={Q} S=1 G={-(-Q // 7)} "
                              f"lanes=owner]")
    from repro_torch import engine
    assert engine.plan_edges is tplan.plan_edges
