"""Port parity: ragged multi-scene batches (``plan_scenes``,
``query_batched_scenes``) against the JAX reference.

Three scenes of mixed sizes, each in a box of its own, built by the
reference and carried across with ``repro_torch.convert``; the same OBB
arrays go into both packages.  The reference runs under
``jax.disable_jit()`` (XLA:CPU's jit contracts ``a*b+c`` into fused
multiply-adds; eager PyTorch does not).  Verdicts and every ``Counters``
field must be equal in each device mode.  The persistent mode counts
overflow per tile, as the reference's kernel arm does, and its plain arm
counts one global pool: so the persistent mode is held against the
reference's interpreted kernel (``use_pallas_traverse=True``) on a run
that escalates, and against its plain arm on overflow-free runs only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import geometry as jgeo
from repro.core import octree as joct
from repro.engine import executor as jexe
from repro.engine import plan as jplan
from repro.kernels.persist import ops as jops
from repro_torch.convert import octree_from_reference
from repro_torch.core import octree as toct
from repro_torch.core.geometry import OBBs
from repro_torch.core.sact import PAYLOAD_INF
from repro_torch.engine import executor as texe
from repro_torch.engine import plan as tplan
from repro_torch.engine.executor import (CollisionEngine, EngineConfig,
                                         query_batched_scenes,
                                         traversal_cache_info)
from repro_torch.kernels.persist import ops as tops
from repro_torch.kernels.persist.ref import (frontier_widths,
                                             traverse_whole_ref)
from repro_torch.kernels.sact.ops import pack_obbs

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

PERSIST = "wavefront_persistent"
FUSED = "wavefront_fused"
DEPTH = 4
SIZES = (900, 120, 400)     # points a scene: mixed level widths
M = 8                       # OBBs a scene
#: a first bucket that holds every level of these scenes' pools, so the
#: reference's global-pool plain arm and the per-tile walk both run clean
CLEAN = dict(min_bucket=4096)


@pytest.fixture(scope="module")
def scenes():
    rs = np.random.RandomState(1)
    jtrees = []
    for i, n in enumerate(SIZES):
        pts = rs.uniform(-1, 1, (n, 3)) * (0.6 + 0.4 * i) + rs.uniform(
            -1, 1, 3)
        jtrees.append(joct.build_octree(pts.astype(np.float32), depth=DEPTH))
    ttrees = [octree_from_reference(t) for t in jtrees]
    S = len(SIZES)
    los = np.stack([np.asarray(t.scene_lo) for t in jtrees])
    side = np.asarray([t.scene_size for t in jtrees], np.float32)
    c = (los[:, None, :] + rs.uniform(0, 1, (S, M, 3))
         * side[:, None, None]).astype(np.float32)
    h = (rs.uniform(0.01, 0.05, (S, M, 3)) * side[:, None, None]).astype(
        np.float32)
    rot = np.asarray(jgeo.rotation_from_euler(jnp.asarray(
        rs.uniform(-3, 3, (S * M, 3)).astype(np.float32)))).reshape(
            S, M, 3, 3)
    return jtrees, ttrees, [c, h, rot]


def _tobbs(arrays):
    return OBBs(*(torch.from_numpy(np.ascontiguousarray(x)) for x in arrays))


def _jobbs(arrays):
    return jgeo.OBBs(*map(jnp.asarray, arrays))


def _assert_same(got, want, skip=()):
    (v, c), (wv, wc) = got, want
    assert np.array_equal(v, np.asarray(wv))
    a, b = c.as_dict(), wc.as_dict()
    assert a.keys() == b.keys()
    for k in a:
        if k not in ("wall_time_s",) + tuple(skip):
            assert a[k] == b[k], (k, a[k], b[k])


def _reference(jtrees, arrays, **cfg):
    with jax.disable_jit():
        return jexe.query_batched_scenes(jtrees, _jobbs(arrays),
                                         jexe.EngineConfig(**cfg))


@pytest.mark.parametrize("fmt", ["fp32", "bf16", "u8"])
def test_scene_tables_match_reference(scenes, fmt):
    """The flat table in each row format and the padded stack equal the
    reference's array for array: roots at flat node s, child pointers
    rebased, each scene's level extents; every padded codes row sorted."""
    jtrees, ttrees, _ = scenes
    got = toct.concat_device_octrees(ttrees, meta_format=fmt, device="cpu")
    want = joct.concat_device_octrees(jtrees, meta_format=fmt)
    for name in ("node_meta", "counts", "cell_sizes", "scene_lo",
                 "scene_off", "scene_counts"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert np.array_equal(got.codes.numpy(),
                          np.asarray(want.codes).view(np.int32))
    assert (got.depth, got.meta_format, got.num_scenes) == (DEPTH, fmt, 3)
    # scene s's root is flat node s of level 0; its children follow the
    # scenes before it at level 1
    off = got.scene_off.numpy()
    assert np.array_equal(off[:, 0], np.arange(3))
    if fmt == "fp32":
        start = got.node_meta[0, :3, 2].numpy()
        assert np.array_equal(start, off[:, 1])

    stack = toct.stack_device_octrees(ttrees, device="cpu")
    jstack = joct.stack_device_octrees(jtrees)
    for name in ("full", "counts", "cell_sizes", "scene_lo", "child_start",
                 "child_mask", "node_meta"):
        g, w = getattr(stack, name).numpy(), np.asarray(getattr(jstack,
                                                                name))
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert np.array_equal(stack.codes.numpy(),
                          np.asarray(jstack.codes).view(np.int32))
    cu = stack.codes_unsigned
    assert bool((cu[..., 1:] >= cu[..., :-1]).all())
    one = stack.scene(1)
    assert one.codes.shape == stack.codes.shape[1:]
    assert one.host_cells == tuple(float(x) for x in stack.cell_sizes[1])


def test_plan_scenes_matches_reference(scenes):
    _, _, arrays = scenes
    got = tplan.plan_scenes(_tobbs(arrays))
    want = jplan.plan_scenes(_jobbs(arrays))
    assert (got.kind, got.out_shape, got.num_scenes) == \
        (want.kind, want.out_shape, want.num_scenes) == ("scenes", (3, M), 3)
    assert np.array_equal(got.scene_of_query.numpy(),
                          np.asarray(want.scene_of_query))
    assert got.scene_of_query.dtype == torch.int32
    for name in ("obb_c", "obb_h", "obb_r"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(want, name)))
    tplan.validate_plan(got)
    assert got.shape_tag == "scenes[Q=24 S=3 G=24 lanes=scene]"


@pytest.mark.parametrize("case", ["scenes", "scenes+owners", "bq16"])
def test_build_tile_map_with_scene_lanes_matches_reference(case):
    """Scene-exclusive tiles (a new tile on every change of scene) with
    and without owner groups inside the scenes, in shuffled slot order:
    every field of the tile map equals the reference's."""
    rs = np.random.RandomState(5)
    sizes = [150, 7, 300, 1]
    soq = np.repeat(np.arange(4), sizes).astype(np.int32)
    own = None
    if case == "scenes+owners":
        own = np.zeros(soq.size, np.int32)
        g, s = -1, None
        for q in range(soq.size):
            if soq[q] != s or rs.rand() < 0.3:
                g, s = g + 1, soq[q]
            own[q] = g
    perm = rs.permutation(soq.size)
    soq = soq[perm]
    own = None if own is None else own[perm]
    bq = 16 if case == "bq16" else 128
    got = tops.build_tile_map(soq.size, bq, soq, own)
    want = jops.build_tile_map(soq.size, bq, soq, own)
    assert got.bq == want.bq and got.num_tiles == want.num_tiles
    assert np.array_equal(got.perm, want.perm)
    for name in tops.Tiling._fields:
        g, w = getattr(got.tiles, name), np.asarray(getattr(want.tiles, name))
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    # every tile holds one scene
    sot = got.tiles.scene_of_tile
    slot_scene = np.repeat(sot, got.bq)
    assert np.array_equal(slot_scene[got.tiles.slot_of_query], soq)
    assert len(sot) > 4
    assert tops.persist_kernel_unsupported(own, soq) \
        == jops.persist_kernel_unsupported(own, soq) is None


def test_owner_group_across_scenes_raises_like_reference():
    soq = np.asarray([0, 0, 1, 1], np.int32)
    own = np.asarray([0, 1, 1, 2], np.int32)
    reason = tops.persist_kernel_unsupported(own, soq)
    assert reason == jops.persist_kernel_unsupported(own, soq) \
        == "an owner group spans multiple scenes"
    with pytest.raises(ValueError) as a:
        tops.build_tile_map(4, 128, soq, own)
    with pytest.raises(ValueError) as b:
        jops.build_tile_map(4, 128, soq, own)
    assert str(a.value) == str(b.value)
    x = torch.zeros(4, 3)
    with pytest.raises(NotImplementedError, match="B.2.5") as err:
        tops.tile_pool(x, x + 1, torch.eye(3).expand(4, 3, 3),
                       torch.from_numpy(own), scene_of_query=soq)
    assert reason in str(err.value)


@pytest.mark.parametrize("mode,fmt", [
    ("wavefront", None), (FUSED, "fp32"), (FUSED, "bf16"), (FUSED, "u8")])
def test_level_modes_match_reference(scenes, mode, fmt):
    """``wavefront`` walks the padded stack one scene after another;
    ``wavefront_fused`` the reference's global-pool walk over the flat
    table, in each row format."""
    jtrees, ttrees, arrays = scenes
    cfg = dict(mode=mode, meta_format=fmt)
    got = query_batched_scenes(ttrees, _tobbs(arrays), EngineConfig(**cfg),
                               device="cpu")
    _assert_same(got, _reference(jtrees, arrays, **cfg))
    v, c = got
    assert v.shape == (3, M) and v.any() and not v.all()
    assert c.nodes_per_level[0] == 3 * M


@pytest.mark.parametrize("stream_meta", [False, True])
@pytest.mark.parametrize("fmt", ["fp32", "bf16", "u8"])
def test_persistent_matches_reference_plain_arm(scenes, fmt, stream_meta):
    """Scene-exclusive tiles in each row format and layout against the
    reference's plain arm on clean runs: verdicts and every counter,
    ``meta_rows_streamed`` included (each tile's windows over its own
    scene's extent); the walk equals the fused mode's."""
    jtrees, ttrees, arrays = scenes
    cfg = dict(mode=PERSIST, meta_format=fmt, stream_meta=stream_meta,
               **CLEAN)
    eng = CollisionEngine(ttrees, EngineConfig(**cfg), device="cpu")
    assert (eng.meta_layout, eng.meta_format) == (
        "streamed" if stream_meta else "resident", fmt)
    got = eng.execute(tplan.plan_scenes(_tobbs(arrays)))
    _assert_same(got, _reference(jtrees, arrays, **cfg))
    c = got[1]
    assert c.escalations == 0 and c.frontier_overflow == 0
    assert (c.meta_rows_streamed > 0) == stream_meta
    # traverse_whole tiles an untiled ragged pool itself
    plan = tplan.plan_scenes(_tobbs(arrays))
    v, st = tops.traverse_whole(
        plan.obb_c, plan.obb_h, plan.obb_r,
        toct.concat_device_octrees(ttrees, meta_format=fmt, device="cpu"),
        eng.last_capacity, use_spheres=False, streamed=stream_meta,
        scene_of_query=plan.scene_of_query)
    assert np.array_equal(v.numpy(), got[0].reshape(-1))
    assert int(st["nodes"]) == c.nodes_traversed
    assert int(st["meta_rows"]) == c.meta_rows_streamed
    fused = query_batched_scenes(ttrees, _tobbs(arrays),
                                 EngineConfig(mode=FUSED, **CLEAN),
                                 device="cpu")
    _assert_same(got, fused, skip=("bytes_moved", "meta_rows_streamed",
                                   "meta_bytes_streamed"))


def test_persistent_escalation_matches_reference_kernel_arm(scenes):
    """A small first bucket overflows some tiles and climbs the replay
    ladder as the reference's interpreted kernel does: per-tile overflow,
    escalations and every counter equal."""
    jtrees, ttrees, arrays = scenes
    big = [arrays[0], arrays[1] * 2.0, arrays[2]]
    cfg = dict(mode=PERSIST, stream_meta=False, meta_format="fp32",
               min_bucket=128)
    got = query_batched_scenes(ttrees, _tobbs(big), EngineConfig(**cfg),
                               device="cpu")
    want = _reference(jtrees, big, use_pallas_traverse=True, **cfg)
    _assert_same(got, want)
    assert got[1].escalations >= 1 and got[1].frontier_overflow == 0


def _grouped_plans(arrays, pkg):
    """One plan a package: the scenes' pool with owner groups of 1-3
    consecutive slots inside each scene (ids ascending, as the front ends
    emit them) and payloads in [0, 5)."""
    rs = np.random.RandomState(9)
    S = arrays[0].shape[0]
    soq = np.repeat(np.arange(S), M).astype(np.int32)
    own = np.zeros(S * M, np.int32)
    g, end = -1, 0
    for q in range(S * M):
        if q >= end or soq[q] != soq[q - 1]:
            g, end = g + 1, q + int(rs.randint(1, 4))
        own[q] = g
    pay = rs.randint(0, 5, S * M).astype(np.int32)
    flat = [x.reshape((S * M,) + x.shape[2:]) for x in arrays]
    kw = dict(kind="edges", out_shape=(g + 1,), num_scenes=S,
              num_groups=g + 1)
    if pkg == "torch":
        return tplan.QueryPlan(
            obb_c=torch.from_numpy(flat[0]), obb_h=torch.from_numpy(flat[1]),
            obb_r=torch.from_numpy(flat[2]),
            scene_of_query=torch.from_numpy(soq),
            owner_of_query=torch.from_numpy(own),
            payload=torch.from_numpy(pay), **kw)
    return jplan.QueryPlan(
        obb_c=jnp.asarray(flat[0]), obb_h=jnp.asarray(flat[1]),
        obb_r=jnp.asarray(flat[2]), scene_of_query=jnp.asarray(soq),
        owner_of_query=jnp.asarray(own), payload=jnp.asarray(pay), **kw)


@pytest.mark.parametrize("mode", [FUSED, PERSIST])
def test_grouped_multi_scene_plans_match_reference(scenes, mode):
    """Owner and payload lanes on a ragged pool: each group's least
    payload that hit, and every counter."""
    jtrees, ttrees, arrays = scenes
    cfg = dict(mode=mode, **CLEAN)
    got = CollisionEngine(ttrees, EngineConfig(**cfg), device="cpu").execute(
        _grouped_plans(arrays, "torch"))
    with jax.disable_jit():
        want = jexe.CollisionEngine(jtrees, jexe.EngineConfig(**cfg)).execute(
            _grouped_plans(arrays, "jax"))
    _assert_same(got, want)
    v = got[0]
    assert v.dtype == np.int32 and (v < PAYLOAD_INF).any() \
        and (v == PAYLOAD_INF).any()
    with pytest.raises(ValueError, match="CSR mode"):
        CollisionEngine(ttrees, EngineConfig(), device="cpu").execute(
            _grouped_plans(arrays, "torch"))


def _pool(arrays, n_pad, seed=3):
    """The first scene's OBBs as a flat pool, with ``n_pad`` junk slots
    appended."""
    rs = np.random.RandomState(seed)
    c, h, r = (torch.from_numpy(np.ascontiguousarray(x[0])) for x in arrays)
    junk = [torch.from_numpy(rs.uniform(-1, 1, (n_pad,) + tuple(x.shape[1:]))
                             .astype(np.float32)) for x in (c, h, r)]
    junk[1] = junk[1].abs() + 0.5
    return [torch.cat([x, j]) for x, j in zip((c, h, r), junk)]


@pytest.mark.parametrize("mode", ["wavefront", FUSED, PERSIST])
def test_num_valid_prefix_walks_as_the_unpadded_pool(scenes, mode):
    """A pool padded past its live prefix gives the prefix's verdicts and
    the same counters: its pads seed nothing (the live prefix that the
    sharded executor passes, `CollisionEngine._exec_sharded`)."""
    _, ttrees, arrays = scenes
    dev = toct.device_octree(ttrees[0], device="cpu")
    padded = _pool(arrays, 11)
    prefix = [x[:M] for x in padded]

    def walk(c, h, r, **kw):
        if mode == "wavefront":
            return texe._traverse(c, h, r, dev, 1024, False, **kw)
        if mode == FUSED:
            return texe._traverse_fused(pack_obbs(c, h, r), dev, 1024, False,
                                        **kw)
        return tops.traverse_whole(c, h, r, dev, 1024, use_spheres=False,
                                   streamed=True, bq=16, **kw)
    v, st = walk(*padded, num_valid=M)
    wv, wst = walk(*prefix)
    assert np.array_equal(v[:M].numpy(), wv.numpy())
    assert not v[M:].any()
    assert wv.any()
    for k in wst:
        assert torch.equal(st[k], wst[k]), k
    full, _ = walk(*padded)
    assert full[M:].any()    # the junk slots do hit when they are live


def test_traverse_whole_ref_num_valid_and_widths(scenes):
    """The fused mode's ragged walk: ``num_valid`` as in the other arms,
    and the processing widths of the reference."""
    jtrees, ttrees, arrays = scenes
    assert frontier_widths(1024) == (128, 256, 512, 1024)
    assert frontier_widths(100) == (100,)
    assert frontier_widths(300, 64) == (64, 128, 256, 300)
    multi = toct.concat_device_octrees(ttrees, device="cpu")
    padded = _pool(arrays, 5)
    soq = torch.zeros(M + 5, dtype=torch.int32)

    def walk(c, h, r, soq, **kw):
        return traverse_whole_ref(c, h, r, multi.node_meta, multi.cell_sizes,
                                  multi.scene_lo, DEPTH, 2048, False,
                                  scene_of_query=soq, **kw)
    v, st = walk(*padded, soq, num_valid=M)
    wv, wst = walk(*[x[:M] for x in padded], soq[:M])
    assert np.array_equal(v[:M].numpy(), wv.numpy()) and not v[M:].any()
    for k in wst:
        assert torch.equal(st[k], wst[k]), k


def test_multi_scene_refusals_and_cache_info(scenes):
    """The reference's refusals: host modes and ``naive`` take no
    multi-scene plan, nor ``max_depth``; a plan's scene count must match
    the engine's.  The table memo serves repeat batches."""
    _, ttrees, arrays = scenes
    plan = tplan.plan_scenes(_tobbs(arrays))
    for mode in ("naive", "wavefront_host", "rta_like"):
        with pytest.raises(ValueError, match="device mode"):
            CollisionEngine(ttrees, EngineConfig(mode=mode),
                            device="cpu").execute(plan)
        with pytest.raises(ValueError, match="device mode"):
            query_batched_scenes(ttrees, _tobbs(arrays),
                                 EngineConfig(mode=mode), device="cpu")
    eng = CollisionEngine(ttrees, EngineConfig(), device="cpu")
    with pytest.raises(ValueError, match="max_depth"):
        eng.execute(plan, max_depth=2)
    with pytest.raises(ValueError, match="3 scene"):
        CollisionEngine(ttrees[0], EngineConfig(), device="cpu").execute(plan)
    with pytest.raises(ValueError, match="shape"):
        query_batched_scenes(ttrees[:2], _tobbs(arrays), EngineConfig(),
                             device="cpu")
    with pytest.raises(ValueError, match="depths"):
        toct.concat_device_octrees([ttrees[0], toct.build_octree(
            np.random.RandomState(0).rand(50, 3), depth=2)], device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        query_batched_scenes(ttrees, _tobbs(arrays),
                             EngineConfig(mode=PERSIST))
    before = traversal_cache_info()
    for _ in range(2):
        query_batched_scenes(ttrees, _tobbs(arrays),
                             EngineConfig(mode=FUSED), device="cpu")
    info = traversal_cache_info()
    assert set(info) == set(jexe.traversal_cache_info())
    assert info["hits"] >= before["hits"] + 1
    assert 1 <= info["entries"] <= texe._TABLE_CACHE_MAX
    # ragged batches never take the sharded path (single-scene pools only)
    assert info["sharded_entries"] == before["sharded_entries"]
    assert any(k[:2] == (FUSED, "single") for k in info["traces"])
