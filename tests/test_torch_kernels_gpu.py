"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device (an H100: the kernels build for sm_90a) and
skip elsewhere; they import neither JAX nor the reference package, so they
also run on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

The collision and sampling comparisons are exact: those kernels are built
with ``--fmad=false`` and keep the plain versions' operation order, and
the SACT planes put pairs that graze a separating plane on their
diagonal.  ``wkv6`` and ``flash_attention`` sum their dot products in
another order than their plain versions and are held to the ``TOL`` of
their ``cases.py``.
"""
import copy
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.core.geometry import OBBs, rotation_from_euler
from repro_torch.core.octree import (build_octree, concat_device_octrees,
                                     device_octree)
from repro_torch.core import sweep
from repro_torch.core.pipeline import check_edges, plan_with_collision_gate
from repro_torch.core.sact import PAYLOAD_INF
from repro_torch.data.robotics import (PANDA_JOINT_HI, PANDA_JOINT_LO,
                                       make_scene)
from repro_torch.engine.executor import (CollisionEngine, EngineConfig,
                                         query_batched_scenes)
from repro_torch.kernels import _build
from repro_torch.core import ballquery as tbq
from repro_torch.core import mcl as tmcl
from repro_torch.kernels.ballquery import ops as bq_ops
from repro_torch.kernels.ballquery.cases import cloud_cases, radius_shell
from repro_torch.kernels.ballquery.ref import ball_query_ref
from repro_torch.kernels.compact import ops as compact_ops
from repro_torch.kernels.compact.ref import compact_ref
from repro_torch.kernels.flash_attention import cases as flash_cases
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.fps import ops as fps_ops
from repro_torch.kernels.fps.cases import tie_cloud
from repro_torch.kernels.fps.ref import fps_ref
from repro_torch.kernels.march import ops as march_ops
from repro_torch.kernels.march.cases import (nonsquare_grid, ray_cases,
                                             wall_points)
from repro_torch.kernels.march.ref import march_ref
from repro_torch.kernels.persist import ops as persist_ops
from repro_torch.kernels.persist.cases import (grazing_pool, owner_group_pool,
                                               ragged_pool, ragged_trees,
                                               skewed_pool, sweep_round_plans,
                                               tiled_pool)
from repro_torch.kernels.persist.ref import persist_tiles_ref
from repro_torch.kernels.sact import ops as sact_ops
from repro_torch.kernels.sact.cases import grazing_plane
from repro_torch.kernels.sact.ref import sact_ref
from repro_torch.kernels.traverse import ops as traverse_ops
from repro_torch.kernels.traverse.cases import grazing_frontier
from repro_torch.kernels.traverse.ref import traverse_test_ref
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.kernels.wkv6.cases import (edge_cases, hard_cases,
                                            make_case, within_tol)
from repro_torch.kernels.wkv6.ref import wkv6_ref
from repro_torch.models import api as lm_api
from repro_torch.models.planner import Planner
from repro_torch.models.transformer import LM

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an H100): torch sees none")
    return torch.device("cuda")


def _scene_and_queries(M, seed=3, depth=4):
    rs = np.random.RandomState(seed)
    tree = build_octree(rs.uniform(-1, 1, (4000, 3)).astype(np.float32),
                        depth=depth)
    c = rs.uniform(-1, 1, (M, 3)).astype(np.float32)
    h = rs.uniform(0.05, 0.3, (M, 3)).astype(np.float32)
    r = rotation_from_euler(torch.from_numpy(
        rs.uniform(-3, 3, (M, 3)).astype(np.float32)))
    return tree, OBBs(torch.from_numpy(c), torch.from_numpy(h), r)


@pytest.mark.parametrize("use_spheres", [False, True])
def test_sact_dense_kernel_matches_plain(cuda, use_spheres):
    obb, aabb = grazing_plane(512, seed=11, use_spheres=use_spheres)
    o, a = torch.from_numpy(obb).to(cuda), torch.from_numpy(aabb).to(cuda)
    before = _build.launch_counts()["sact_dense"]
    c, e = sact_ops.sact_dense(o, a, use_spheres=use_spheres)
    torch.cuda.synchronize()
    assert _build.launch_counts()["sact_dense"] == before + 1
    pc, pe = sact_ref(o, a, use_spheres)
    assert torch.equal(c, pc) and torch.equal(e, pe)


@pytest.mark.parametrize("pool,bq,fcap,ring_cap,use_spheres", [
    ("identity", 16, 32, 4096, False), ("identity", 16, 32, 16, True),
    ("identity", 128, 4096, 256, False),
    ("owner groups", 16, 32, 4096, False),
    ("owner groups", 128, 4096, 256, True),
    ("skewed", 128, None, None, False), ("skewed", 128, None, None, True),
    ("grazing", 128, 16384, 256, False), ("grazing", 128, 16384, 256, True)])
def test_persist_kernel_matches_plain(cuda, pool, bq, fcap, ring_cap,
                                      use_spheres):
    """Identity pools; owner groups (``best`` and the gate shared by a
    group's lanes, which on the card spread over a cluster's ranks); one
    heavy tile whose widest level spans every rank and several lanes a
    thread and spills part way through its children; OBBs that graze
    cells of level 4, so the SACT decides within a rounding."""
    tree, obbs = _scene_and_queries(M=300)
    dev = device_octree(tree, device=cuda)
    if pool == "identity":
        ins = persist_ops.pack_kernel_inputs(obbs.center.to(cuda),
                                             obbs.half.to(cuda),
                                             obbs.rot.to(cuda), dev, bq)
    elif pool == "owner groups":
        ins = owner_group_pool(dev, bq, 5, seed=bq)
    elif pool == "grazing":
        ins = grazing_pool(dev, 3, 256, seed=7, use_spheres=use_spheres)
    else:
        tree = build_octree(np.random.RandomState(3).uniform(
            -1, 1, (20000, 3)).astype(np.float32), depth=5)
        dev = device_octree(tree, device=cuda)
        ins, fcap, ring_cap = skewed_pool(dev, bq, 6, seed=5)
    kw = dict(bq=bq, fcap=fcap, depth=tree.depth, ring_cap=ring_cap,
              use_spheres=use_spheres)
    before = _build.launch_counts()["persist"]
    got = persist_ops.persist_tiles(**ins, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts()["persist"] == before + 1
    want = persist_tiles_ref(**ins, **kw)
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g, w)
    fits = got[3][:, 6] <= ring_cap
    assert torch.equal(got[4][fits], want[4][fits])
    if pool == "skewed":
        assert bool(fits.all()) and int(got[3][:, 6].sum()) > 0


def test_persist_kernel_light_last_level_back_to_back(cuda):
    """Owner-group tiles whose leaf level holds at most a lane a thread, so
    the last expanding level ends with no cluster barrier and a rank can
    reach its final folds while rank 0 is still at that level's gate;
    every launch of many back to back must keep every rank's folds."""
    tree, _ = _scene_and_queries(M=1)
    dev = device_octree(tree, device=cuda)
    ins = owner_group_pool(dev, 16, 64, seed=21, half=(0.003, 0.01))
    kw = dict(bq=16, fcap=4096, depth=tree.depth, ring_cap=256,
              use_spheres=False)
    want = persist_tiles_ref(**ins, **kw)
    leaf = want[1][:, tree.depth]
    assert bool(((leaf > 0) & (leaf <= persist_ops.kernel_shape()["threads"]))
                .all())
    assert int((want[0] != PAYLOAD_INF).sum()) > 100
    outs = [persist_ops.persist_tiles(**ins, **kw) for _ in range(200)]
    torch.cuda.synchronize()
    for got in outs:
        for g, w in zip(got[:4], want[:4]):
            assert torch.equal(g, w)


def test_persist_kernel_with_a_rank_held_back(cuda):
    """Copies of the kernel that spin one rank at one phase mark of every
    level (``tools/persist_race_check.py``) equal the plain version: no
    output depends on how far one rank runs ahead of another."""
    root = Path(__file__).resolve().parents[1]
    p = subprocess.run([sys.executable, str(root / "tools" /
                                            "persist_race_check.py"),
                        "--reps", "5"], capture_output=True, text=True,
                       timeout=900, cwd=root)
    assert p.returncode == 0, p.stdout + p.stderr
    assert p.stdout.count("0 of 5 launches differ") == 24, p.stdout


def test_persist_kernel_shape_fits_the_card(cuda):
    """The cluster fits the card; a tile whose slots overflow a block's
    shared memory is refused at launch and raises."""
    shape = persist_ops.kernel_shape()
    assert shape["cluster"] >= 1 and shape["threads"] % 32 == 0
    assert 0 < shape["smem_bytes"] <= 232448 and shape["max_clusters"] >= 1
    with pytest.raises(RuntimeError, match="persist"):
        x = torch.zeros(1, device=cuda)
        bq = 4096
        persist_ops.persist_tiles(
            x, torch.zeros(1, dtype=torch.int32, device=cuda),
            torch.zeros(1, dtype=torch.int32, device=cuda),
            torch.zeros(bq, 15, device=cuda),
            torch.zeros(1, 1, 4, dtype=torch.int32, device=cuda),
            torch.zeros(bq, dtype=torch.int32, device=cuda),
            torch.zeros(bq, dtype=torch.int32, device=cuda), bq=bq, fcap=8,
            depth=0, ring_cap=1, use_spheres=False)


@pytest.mark.parametrize("bq", [256, 1024])
@pytest.mark.parametrize("fcap", [48, 1 << 17])
def test_persist_kernel_on_large_owner_tiles(cuda, bq, fcap):
    """Owner-group tiles of 256 and 1024 slots (past 48 KB of shared
    memory a CTA), groups of up to 64 slots whose lanes spread over the
    cluster's ranks, with and without frontier overflow."""
    tree, _ = _scene_and_queries(M=1)
    dev = device_octree(tree, device=cuda)
    ins = owner_group_pool(dev, bq, 3, seed=bq + fcap, max_group=64)
    kw = dict(bq=bq, fcap=fcap, depth=tree.depth, ring_cap=1 << 16,
              use_spheres=False)
    got = persist_ops.persist_tiles(**ins, **kw)
    want = persist_tiles_ref(**ins, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (int(got[3][:, 5].sum()) > 0) == (fcap == 48)
    assert int((got[0] != PAYLOAD_INF).sum()) > 0


def _format_pool(cuda, fmt, pool):
    """A pool of ``pool``'s kind on a device tree with ``fmt`` rows, and
    its (bq, fcap, ring_cap): identity pools overflow their tiles, the
    skewed pool spills its heavy tile's widest level."""
    if pool == "skewed":
        tree = build_octree(np.random.RandomState(3).uniform(
            -1, 1, (20000, 3)).astype(np.float32), depth=5)
        dev = device_octree(tree, meta_format=fmt, device=cuda)
        ins, fcap, ring_cap = skewed_pool(dev, 128, 6, seed=5)
        return tree, dev, ins, 128, fcap, ring_cap
    tree, obbs = _scene_and_queries(M=300)
    dev = device_octree(tree, meta_format=fmt, device=cuda)
    if pool == "identity":
        ins = persist_ops.pack_kernel_inputs(obbs.center.to(cuda),
                                             obbs.half.to(cuda),
                                             obbs.rot.to(cuda), dev, 16)
        return tree, dev, ins, 16, 32, 4096
    if pool == "owner groups":
        return tree, dev, owner_group_pool(dev, 128, 5, seed=128), 128, \
            4096, 256
    return tree, dev, grazing_pool(dev, 3, 256, seed=7, use_spheres=True), \
        128, 16384, 256


@pytest.mark.parametrize("pool", ["identity", "owner groups", "skewed",
                                  "grazing"])
@pytest.mark.parametrize("layout", ["resident", "streamed", "wsub 64",
                                    "one window"])
@pytest.mark.parametrize("fmt", ["fp32", "bf16", "u8"])
def test_persist_kernel_rows_and_windows_match_plain(cuda, fmt, layout,
                                                     pool):
    """Rows in each format, resident and streamed (the default window,
    windows of 64 rows, one window as wide as the table), on identity
    pools that overflow, owner groups, the skewed pool that spills and
    grazing pools (both routes to the node centre must give the same
    bits): every output equal to the plain version's, ``meta_rows``
    included."""
    tree, dev, ins, bq, fcap, ring_cap = _format_pool(cuda, fmt, pool)
    kw = dict(bq=bq, fcap=fcap, depth=tree.depth, ring_cap=ring_cap,
              use_spheres=pool == "grazing", meta_format=fmt,
              streamed=layout != "resident",
              wsub={"wsub 64": 64, "one window": dev.node_meta.shape[1]}
              .get(layout))
    got = persist_ops.persist_tiles(**ins, **kw)
    want = persist_tiles_ref(**ins, **kw)
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g, w)
    fits = got[3][:, 6] <= ring_cap
    assert torch.equal(got[4][fits], want[4][fits])
    assert (int(got[3][:, 7].sum()) > 0) == (layout != "resident")
    if pool in ("identity", "skewed"):
        assert int(got[3][:, 5].sum()) > 0


@pytest.mark.parametrize("layout", ["resident", "streamed"])
@pytest.mark.parametrize("fmt", ["fp32", "bf16", "u8"])
def test_persist_kernel_on_ragged_pools_matches_plain(cuda, fmt, layout):
    """Scene-exclusive tiles of three scenes of mixed sizes, each in a box
    of its own (each tile's origin and cell sizes from its scene's row of
    ``scal``, its root at flat node s, its windows over its scene's
    extents), identity pools and owner groups, clean and spilling: every
    output equal to the plain version's."""
    trees = ragged_trees()
    multi = concat_device_octrees(trees, meta_format=fmt, device=cuda)
    for owners, sph in ((False, False), (True, True)):
        ins, bq = ragged_pool(multi, (300, 40, 150), seed=7 + owners,
                              owner_groups=owners, half=(0.01, 0.05))
        assert ins["sot"].unique().tolist() == [0, 1, 2]
        for fcap, ring_cap in ((4096, 256), (48, 4096)):
            kw = dict(bq=bq, fcap=fcap, depth=multi.depth, ring_cap=ring_cap,
                      use_spheres=sph, meta_format=fmt,
                      streamed=layout == "streamed")
            got = persist_ops.persist_tiles(**ins, **kw)
            want = persist_tiles_ref(**ins, **kw)
            for g, w in zip(got[:4], want[:4]):
                assert torch.equal(g, w)
            fits = got[3][:, 6] <= ring_cap
            assert torch.equal(got[4][fits], want[4][fits])
            assert (int(got[3][:, 7].sum()) > 0) == (layout == "streamed")
            assert (int(got[3][:, 5].sum()) > 0) == (fcap == 48)


def _ragged_batch(M=100, seed=11):
    """Three scenes of mixed sizes and (3, M) OBBs, each set inside its
    scene's box."""
    trees = ragged_trees()
    rs = np.random.RandomState(seed)
    lo = np.stack([t.scene_lo for t in trees])
    side = np.asarray([t.scene_size for t in trees], np.float32)
    c = lo[:, None] + rs.uniform(0, 1, (3, M, 3)) * side[:, None, None]
    h = rs.uniform(0.01, 0.06, (3, M, 3)) * side[:, None, None]
    r = rotation_from_euler(torch.from_numpy(
        rs.uniform(-3, 3, (3 * M, 3)).astype(np.float32))).reshape(3, M, 3, 3)
    return trees, OBBs(torch.from_numpy(c.astype(np.float32)),
                       torch.from_numpy(h.astype(np.float32)), r)


@pytest.mark.parametrize("mode", ["wavefront_persistent", "wavefront",
                                  "wavefront_fused"])
def test_cuda_query_batched_scenes_matches_cpu(cuda, mode):
    """A ragged batch on the card in each device mode (the persistent mode
    also on streamed u8 rows) equals the CPU engine: verdicts and every
    counter.  The persistent mode launches ``persist``, ``wavefront``
    ``compact``; the fused mode's ragged walk is the reference's tensor
    code and launches neither."""
    trees, obbs = _ragged_batch()
    cfgs = [EngineConfig(mode=mode, min_bucket=64)]
    if mode == "wavefront_persistent":
        cfgs.append(EngineConfig(mode=mode, min_bucket=64, stream_meta=True,
                                 meta_format="u8"))
    for cfg in cfgs:
        before = _build.launch_counts()
        v, c = query_batched_scenes(trees, obbs, cfg, device=cuda)
        after = _build.launch_counts()
        launched = {k for k in after if after[k] > before[k]}
        assert launched == {"wavefront_persistent": {"persist"},
                            "wavefront": {"compact"},
                            "wavefront_fused": set()}[mode]
        vc, cc = query_batched_scenes(trees, obbs, cfg, device="cpu")
        assert v.shape == (3, 100) and np.array_equal(v, vc)
        assert v.any() and not v.all()
        a, b = c.as_dict(), cc.as_dict()
        for k in a:
            if k != "wall_time_s":
                assert a[k] == b[k], k
        assert (c.meta_rows_streamed > 0) == bool(cfg.stream_meta)


@pytest.mark.parametrize("wsub", [1, 2])
@pytest.mark.parametrize("fmt", ["fp32", "u8"])
def test_persist_window_bitmap_past_shared_memory(cuda, fmt, wsub):
    """Windows of 1 and 2 rows on a 15,104-row table: over 4,096 windows a
    level, a bitmap of over 128 words a parity in the workspace; the
    skewed pool's heavy tile spills."""
    tree, dev, ins, bq, fcap, ring_cap = _format_pool(cuda, fmt, "skewed")
    assert -(-dev.node_meta.shape[1] // wsub) > 4096
    kw = dict(bq=bq, fcap=fcap, depth=tree.depth, ring_cap=ring_cap,
              use_spheres=False, meta_format=fmt, streamed=True, wsub=wsub)
    got = persist_ops.persist_tiles(**ins, **kw)
    want = persist_tiles_ref(**ins, **kw)
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g, w)
    assert int(got[3][:, 7].sum()) > 0 and int(got[3][:, 5].sum()) > 0


@pytest.mark.parametrize("bq", [256, 1024])
@pytest.mark.parametrize("fmt", ["bf16", "u8"])
def test_persist_kernel_compressed_rows_on_large_owner_tiles(cuda, fmt, bq):
    """Owner-group tiles of 256 and 1,024 slots on compressed rows under
    the streamed layout (u8 adds its code stage to every CTA's shared
    memory), with overflow; the launch shape reports the larger CTA."""
    tree, _ = _scene_and_queries(M=1)
    dev = device_octree(tree, meta_format=fmt, device=cuda)
    ins = owner_group_pool(dev, bq, 3, seed=bq + 1, max_group=64)
    kw = dict(bq=bq, fcap=48, depth=tree.depth, ring_cap=1 << 16,
              use_spheres=False, meta_format=fmt, streamed=True, wsub=64)
    got = persist_ops.persist_tiles(**ins, **kw)
    want = persist_tiles_ref(**ins, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[3][:, 5].sum()) > 0
    nwin = -(-dev.node_meta.shape[1] // 64)
    shape = persist_ops.kernel_shape(bq, fmt, nwin)
    base = persist_ops.kernel_shape(bq)
    # u8's codes of the staged pairs; the window bitmaps are in the workspace
    extra = 4096 * 4 if fmt == "u8" else 0
    assert shape["smem_bytes"] == base["smem_bytes"] + extra <= 232448
    assert shape["max_clusters"] >= 1


def _ccd_scene():
    sc = make_scene("cubby", num_points=3000)
    return sc, build_octree(sc.points, depth=4)


def _edge_batch(seed, E):
    rs = np.random.RandomState(seed)
    qf = rs.uniform(PANDA_JOINT_LO, PANDA_JOINT_HI, (E, 7)).astype(np.float32)
    qt = np.clip(qf + rs.uniform(-0.35, 0.35, (E, 7)).astype(np.float32),
                 PANDA_JOINT_LO, PANDA_JOINT_HI)
    return qf, qt


def test_persist_kernel_on_a_sweep_round_tile_map(cuda):
    """Every tiled pool a real sweep sends the persistent engine (whole
    owner groups a tile, pads at each tile's tail, real payloads), on the
    kernel and on its plain version."""
    sc, tree = _ccd_scene()
    qf, qt = _edge_batch(2, 8)
    eng = CollisionEngine(tree, EngineConfig(mode="wavefront_persistent"),
                          device="cpu")
    plans = sweep_round_plans(eng, qf, qt, 8, base_pos=sc.robot_base)
    dev = device_octree(tree, device=cuda)
    assert any(p.payload is not None for p in plans)
    for plan in plans:
        if plan.owner_of_query is None:
            continue
        ins, bq = tiled_pool(dev, plan)
        kw = dict(bq=bq, fcap=1024, depth=tree.depth, ring_cap=256,
                  use_spheres=False)
        got = persist_ops.persist_tiles(**ins, **kw)
        want = persist_tiles_ref(**ins, **kw)
        for g, w in zip(got[:4], want[:4]):
            assert torch.equal(g, w)


@pytest.mark.parametrize("mode", ["wavefront_persistent", "wavefront",
                                  "wavefront_fused"])
def test_cuda_check_edges_matches_cpu(cuda, mode, monkeypatch):
    """``check_edges`` on the card equals the same engine on the CPU: first
    hits, verdicts and every counter.  FK runs on the card once; the CPU
    sweep takes the card's FK arrays (cuBLAS and the CPU sum the 4 x 4
    products differently in the last bits)."""
    sc, tree = _ccd_scene()
    qf, qt = _edge_batch(1, 8)
    kw = dict(resolution=8, base_pos=sc.robot_base)
    want_kernel = {"wavefront_persistent": "persist", "wavefront": "compact",
                   "wavefront_fused": "traverse"}[mode]
    before = _build.launch_counts()[want_kernel]
    got = check_edges(CollisionEngine(tree, EngineConfig(mode=mode),
                                      device=cuda), qf, qt, **kw)
    assert _build.launch_counts()[want_kernel] > before
    geo = sweep.edge_link_geometry(qf, qt, 8, base_pos=sc.robot_base,
                                   device=cuda)
    monkeypatch.setattr(sweep, "edge_link_geometry", lambda *a, **k: geo)
    want = check_edges(CollisionEngine(tree, EngineConfig(mode=mode),
                                       device="cpu"), qf, qt, **kw)
    assert np.array_equal(got.first_hit, want.first_hit)
    assert np.array_equal(got.collide, want.collide)
    a, b = got.counters.as_dict(), want.counters.as_dict()
    for k in a:
        if k != "wall_time_s":
            assert a[k] == b[k], k
    assert got.counters.ref_arm_fallbacks == 0


def test_cuda_engine_matches_cpu_engine(cuda):
    tree, obbs = _scene_and_queries(M=300, seed=5, depth=5)
    cfg = EngineConfig(mode="wavefront_persistent", min_bucket=64)
    before = _build.launch_counts()["persist"]
    v, c = CollisionEngine(tree, cfg, device=cuda).query(obbs)
    assert _build.launch_counts()["persist"] > before
    vc, cc = CollisionEngine(tree, cfg, device="cpu").query(obbs)
    assert np.array_equal(v, vc)
    a, b = c.as_dict(), cc.as_dict()
    for k in a:
        if k != "wall_time_s":
            assert a[k] == b[k], k


@pytest.mark.parametrize("n,density,n_out", [
    (1000, 0.0, 1000), (100_003, 1e-3, 100_003), (100_003, 0.5, 100_003),
    (70_000, 1.0, 70_000), (100_003, 0.5, 20_000)])
def test_compact_kernel_matches_plain(cuda, n, density, n_out):
    rs = np.random.RandomState(n)
    mask = torch.from_numpy(rs.uniform(size=n) < density).to(cuda)
    chans = torch.from_numpy(rs.randint(-2**31, 2**31 - 1, (2, n)).astype(
        np.int32)).to(cuda)
    before = _build.launch_counts()["compact"]
    count, out = compact_ops.compact_channels(mask, chans, n_out)
    torch.cuda.synchronize()
    assert _build.launch_counts()["compact"] == before + 1
    want_count, want = compact_ref(mask, chans.t(), n_out)
    assert int(count) == int(want_count) == min(int(mask.sum()), n_out)
    assert torch.equal(out, want.t())


def _poisoned_compaction(cuda, mask, cols, n_out):
    """compact_columns after the allocator's cache was filled with -1 at
    the output's size, so a slot the kernel fails to write shows."""
    junk = torch.full((len(cols) * n_out + 1,), -1, dtype=torch.int32,
                      device=cuda)
    del junk
    before = _build.launch_counts()["compact"]
    count, out = compact_ops.compact_columns(mask, cols, n_out)
    assert _build.launch_counts()["compact"] == before + 1
    return count, out


def _check_compaction(mask, cols, n_out, count, out):
    want_count, want = compact_ref(mask, torch.stack(list(cols), 1), n_out)
    assert int(count) == int(want_count) == min(int(mask.sum()), n_out)
    assert out.shape == (len(cols), n_out)
    assert torch.equal(out, want.t())


_TILE = compact_ops.TILE


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("n", [_TILE - 1, _TILE, _TILE + 1, 37 * _TILE + 5])
def test_compact_kernel_at_tile_edges(cuda, n, density):
    """One tile, one tile +- 1, many tiles; every density from none to
    all, n_out = N: count and every slot, the zero tail included."""
    rs = np.random.RandomState(n + int(10 * density))
    mask = torch.from_numpy(rs.uniform(size=n) < density).to(cuda)
    cols = [torch.from_numpy(rs.randint(-2**31, 2**31 - 1, n).astype(
        np.int32)).to(cuda) for _ in range(2)]
    count, out = _poisoned_compaction(cuda, mask, cols, n)
    _check_compaction(mask, cols, n, count, out)


@pytest.mark.parametrize("n_out", [0, 1, 3000, 9 * _TILE + 7])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_compact_kernel_n_out_and_channels(cuda, n_out, channels):
    """n_out 0, below the count (survivors dropped) and above N (a zero
    tail longer than the lanes), with 1, 3 and 4 channels."""
    n = 5 * _TILE + 333
    rs = np.random.RandomState(n_out + channels)
    mask = torch.from_numpy(rs.uniform(size=n) < 0.4).to(cuda)
    cols = [torch.from_numpy(rs.randint(-2**31, 2**31 - 1, n).astype(
        np.int32)).to(cuda) for _ in range(channels)]
    count, out = _poisoned_compaction(cuda, mask, cols, n_out)
    _check_compaction(mask, cols, n_out, count, out)


@pytest.mark.parametrize("n_out", [0, 1, 5000])
def test_compact_kernel_no_lanes(cuda, n_out):
    mask = torch.zeros(0, dtype=torch.bool, device=cuda)
    cols = [torch.zeros(0, dtype=torch.int32, device=cuda)] * 2
    count, out = _poisoned_compaction(cuda, mask, cols, n_out)
    assert int(count) == 0 and out.shape == (2, n_out)
    assert not out.any()


def test_compact_kernel_back_to_back_calls_reuse_scratch(cuda):
    """Many calls of different sizes on one stream with no sync between
    them: the reused status words and ticket must not leak from one call
    into the next (a later call with fewer tiles finds an earlier call's
    words past its own tiles and before them)."""
    rs = np.random.RandomState(99)
    calls = []
    for i in range(40):
        n = int(rs.choice([1, 100, _TILE - 1, _TILE + 1, 3 * _TILE,
                           40 * _TILE + 17, 7 * _TILE]))
        n_out = int(rs.choice([0, n // 3, n, 2 * n + 5]))
        mask = torch.from_numpy(rs.uniform(size=n) < rs.uniform()).to(cuda)
        cols = [torch.from_numpy(rs.randint(-2**31, 2**31 - 1, n).astype(
            np.int32)).to(cuda) for _ in range(2)]
        calls.append((mask, cols, n_out,
                      compact_ops.compact_columns(mask, cols, n_out)))
    torch.cuda.synchronize()
    for mask, cols, n_out, (count, out) in calls:
        _check_compaction(mask, cols, n_out, count, out)


def test_compact_pairs_is_one_launch_and_matches_plain(cuda):
    """The frontier pair compaction passes its two columns as they are
    (one launch, no stack) and equals compact_ref on the stacked
    channels."""
    n = 2_097_152
    rs = np.random.RandomState(5)
    mask = torch.from_numpy(rs.uniform(size=n) < 0.03).to(cuda)
    q = torch.from_numpy(rs.randint(0, 10500, n).astype(np.int32)).to(cuda)
    codes = torch.from_numpy(rs.randint(-2**31, 2**31 - 1, n).astype(
        np.int32)).to(cuda)
    before = _build.launch_counts()["compact"]
    count, q_out, c_out = compact_ops.compact_pairs(mask, q, codes, 262_144)
    torch.cuda.synchronize()
    assert _build.launch_counts()["compact"] == before + 1
    want_count, want = compact_ref(mask, torch.stack([q, codes], 1), 262_144)
    assert int(count) == int(want_count)
    assert torch.equal(q_out, want[:, 0]) and torch.equal(c_out, want[:, 1])


def test_compact_kernel_rejects_what_it_cannot_run(cuda):
    mask = torch.ones(10, dtype=torch.bool, device=cuda)
    col = torch.zeros(10, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="at most 4 channels"):
        compact_ops.compact_columns(mask, [col] * 5, 10)
    with pytest.raises(ValueError, match="int32"):
        compact_ops.compact_columns(mask, [col.long()], 10)


def test_compact_kernel_from_four_threads_on_one_stream(cuda):
    """Four host threads launch ``compact`` on one stream, as the
    collision service's worker and the launch threads it abandons do:
    each launch draws its own generation tag, so no call reads another's
    status words, and every result equals ``compact_ref``."""
    rs = np.random.RandomState(17)
    work = [[] for _ in range(4)]
    for calls in work:
        for _ in range(25):
            n = int(rs.choice([100, 3 * _TILE + 5, 40 * _TILE + 17]))
            mask = torch.from_numpy(rs.uniform(size=n) < rs.uniform()).to(
                cuda)
            cols = [torch.from_numpy(rs.randint(-2**31, 2**31 - 1, n).astype(
                np.int32)).to(cuda) for _ in range(2)]
            calls.append((mask, cols, int(rs.choice([n // 3, n]))))
    torch.cuda.synchronize()
    results = [[] for _ in range(4)]
    errors = []

    def run(i):
        try:
            for mask, cols, n_out in work[i]:
                results[i].append(
                    compact_ops.compact_columns(mask, cols, n_out))
        except BaseException as e:            # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    assert not errors, errors
    torch.cuda.synchronize()
    for calls, outs in zip(work, results):
        assert len(outs) == len(calls)
        for (mask, cols, n_out), (count, out) in zip(calls, outs):
            _check_compaction(mask, cols, n_out, count, out)


class _RecordingEngine:
    """Forwards to a CUDA engine and keeps every coalesced pool it runs."""

    def __init__(self, inner):
        self.inner = inner
        self.pools = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def execute(self, plan, **kw):
        out = self.inner.execute(plan, **kw)
        # a copy: the batcher adds its pads to the counters it gets
        self.pools.append((plan, kw, copy.deepcopy(out)))
        return out


@pytest.mark.parametrize("mode", ["wavefront_persistent", "wavefront_fused"])
def test_cuda_batcher_on_launch_threads_matches_cpu(cuda, mode):
    """A batcher over a CUDA engine with ``launch_timeout_s`` set, so every
    engine call runs on a launch thread of its own: each request's
    verdicts equal the CPU engine's, and each coalesced pool equals the
    CPU engine on the same pool, verdicts and every counter."""
    from repro_torch.engine.batcher import RequestBatcher
    from repro_torch.engine.plan import plan_queries
    tree, obbs = _scene_and_queries(M=240, seed=7, depth=5)
    cfg = EngineConfig(mode=mode)
    cpu = CollisionEngine(tree, cfg, device="cpu")
    want = cpu.query(obbs)[0]
    rec = _RecordingEngine(CollisionEngine(tree, cfg, device=cuda))
    got = [None] * 20
    errors = []
    with RequestBatcher(rec, max_wait_ms=2.0, launch_timeout_s=60.0) as b:
        def client(ci):
            try:
                for ri in range(ci, 20, 4):
                    sl = slice(12 * ri, 12 * ri + 12)
                    got[ri] = b.submit(OBBs(obbs.center[sl], obbs.half[sl],
                                            obbs.rot[sl])).result(
                                                timeout=120)[0]
            except BaseException as e:        # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=client, args=(ci,))
                   for ci in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
            assert not t.is_alive()
    assert not errors, errors
    assert np.array_equal(np.concatenate(got), want)
    assert rec.pools and b.num_launches == len(rec.pools)
    for plan, kw, (v, c) in rec.pools:
        vc, cc = cpu.execute(plan_queries(plan.obbs), **kw)
        assert np.array_equal(v, vc)
        a, bb = c.as_dict(), cc.as_dict()
        for k in a:
            if k != "wall_time_s":
                assert a[k] == bb[k], k


@pytest.mark.parametrize("mode", ["wavefront_persistent", "wavefront",
                                  "wavefront_fused"])
def test_cuda_sharded_one_shard_matches_unsharded(cuda, mode):
    """``shards=1`` on the card runs the sharded path (one block, its live
    prefix as ``num_valid``): verdicts and every counter but the wall
    equal the unsharded card engine, and the CPU's sharded engine."""
    tree, obbs = _scene_and_queries(M=301, seed=9, depth=5)
    v0, c0 = CollisionEngine(tree, EngineConfig(mode=mode),
                             device=cuda).query(obbs)
    eng = CollisionEngine(tree, EngineConfig(mode=mode, shards=1),
                          device=cuda)
    assert eng.shard_devices[0].type == "cuda"
    assert len(eng.shard_devices) == torch.cuda.device_count()
    v1, c1 = eng.query(obbs)
    vc, cc = CollisionEngine(tree, EngineConfig(mode=mode, shards=1),
                             device="cpu").query(obbs)
    assert np.array_equal(v0, v1) and np.array_equal(v1, vc)
    a, b, d = c0.as_dict(), c1.as_dict(), cc.as_dict()
    for k in a:
        if k != "wall_time_s":
            assert a[k] == b[k] == d[k], k


@pytest.mark.parametrize("use_spheres", [False, True])
def test_traverse_kernel_matches_plain(cuda, use_spheres):
    tree, _ = _scene_and_queries(M=8, depth=5)
    dev = device_octree(tree, device=cuda)
    f = grazing_frontier(dev, 4, 2048, seed=9, use_spheres=use_spheres)
    f = {k: v.to(cuda) for k, v in f.items()}
    kw = dict(cell=dev.host_cells[4], lo=dev.host_lo, is_leaf=False,
              use_spheres=use_spheres)
    n_live = torch.tensor(f["q_idx"].shape[0] - 300, dtype=torch.int32,
                          device=cuda)
    before = _build.launch_counts()["traverse"]
    got = traverse_ops.traverse_test(f["obb"], f["q_idx"], f["codes"],
                                     f["full"], n_live, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts()["traverse"] == before + 1
    want = traverse_test_ref(f["obb"], f["q_idx"], f["codes"], f["full"],
                             n_live, **kw)
    assert torch.equal(got, want)
    assert not got[-300:].any()


@pytest.mark.parametrize("n_live", ["zero", "one", "capacity", "ragged"])
def test_traverse_kernel_live_prefix_ends(cuda, n_live):
    """The live prefix at 0, 1 and the whole capacity, on a capacity that is
    no multiple of 4 (nor of a CTA's lanes), with queries out of range:
    every word equals the plain version's, and lanes past the prefix are
    0."""
    tree, _ = _scene_and_queries(M=8, depth=5)
    dev = device_octree(tree, device=cuda)
    f = grazing_frontier(dev, 4, 1000, seed=11, use_spheres=True)
    cap = f["q_idx"].shape[0] - 3          # 7997 lanes
    q = f["q_idx"][:cap].clone()
    q[::53] = -1
    q[7::61] = f["obb"].shape[0] + 2
    ins = [x.to(cuda) for x in (f["obb"], q, f["codes"][:cap],
                                f["full"][:cap])]
    n = {"zero": 0, "one": 1, "capacity": cap, "ragged": cap - 5}[n_live]
    n_t = torch.tensor([n], dtype=torch.int32, device=cuda)
    kw = dict(cell=dev.host_cells[4], lo=dev.host_lo, is_leaf=False,
              use_spheres=True)
    got = traverse_ops.traverse_test(*ins, n_t, **kw)
    want = traverse_test_ref(*ins, n_t, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not got[n:].any()


def test_traverse_call_takes_strided_lanes_and_rejects_bad_ones(cuda):
    """The call's one pass of checks: strided lanes are made contiguous and
    launched, what the kernel cannot take raises."""
    tree, _ = _scene_and_queries(M=8, depth=5)
    dev = device_octree(tree, device=cuda)
    f = grazing_frontier(dev, 4, 256, seed=5, use_spheres=False)
    f = {k: v.to(cuda) for k, v in f.items()}
    kw = dict(cell=dev.host_cells[4], lo=dev.host_lo, is_leaf=False,
              use_spheres=False)
    n = torch.tensor([1000], dtype=torch.int32, device=cuda)
    lanes = [f[k] for k in ("q_idx", "codes", "full")]
    strided = [torch.stack([x, x], 1)[:, 0] for x in lanes]
    before = _build.launch_counts()["traverse"]
    got = traverse_ops.traverse_test(f["obb"], *strided, n, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts()["traverse"] == before + 1
    assert torch.equal(got, traverse_test_ref(f["obb"], *lanes, n, **kw))
    with pytest.raises(ValueError, match="int32"):
        traverse_ops.traverse_test(f["obb"], lanes[0].long(), *lanes[1:], n,
                                   **kw)
    with pytest.raises(ValueError, match="share a device"):
        traverse_ops.traverse_test(f["obb"], *lanes, n.cpu(), **kw)
    with pytest.raises(ValueError, match="obb"):
        traverse_ops.traverse_test(f["obb"][:, :14], *lanes, n, **kw)


@pytest.mark.parametrize("mode", ["wavefront", "wavefront_fused"])
def test_cuda_level_modes_match_cpu_engine(cuda, mode):
    tree, obbs = _scene_and_queries(M=300, seed=5, depth=5)
    cfg = EngineConfig(mode=mode, min_bucket=64)
    before = _build.launch_counts()
    v, c = CollisionEngine(tree, cfg, device=cuda).query(obbs)
    after = _build.launch_counts()
    assert after["compact"] > before["compact"]
    assert (after["traverse"] > before["traverse"]) == (
        mode == "wavefront_fused")
    vc, cc = CollisionEngine(tree, cfg, device="cpu").query(obbs)
    assert np.array_equal(v, vc)
    a, b = c.as_dict(), cc.as_dict()
    for k in a:
        if k != "wall_time_s":
            assert a[k] == b[k], k


@pytest.mark.parametrize("mode", ["rta_like", "staged_noexit", "predicated",
                                  "wavefront_host"])
def test_cuda_host_modes_match_cpu_engine(cuda, mode):
    """The host-in-the-loop arms on the card: the compaction kernel once a
    level after the first, no other kernel; verdicts and every counter
    equal the CPU engine's, also under a pinned ``max_frontier`` that the
    frontier overflows."""
    tree, obbs = _scene_and_queries(M=300, seed=5, depth=5)
    for cfg in (EngineConfig(mode=mode, min_bucket=64),
                EngineConfig(mode=mode, use_spheres=True, max_frontier=512)):
        before = _build.launch_counts()
        v, c = CollisionEngine(tree, cfg, device=cuda).query(obbs)
        after = _build.launch_counts()
        launched = {k: after[k] - before[k] for k in after}
        assert launched.pop("compact") == len(c.nodes_per_level) - 1
        assert not any(launched.values()), launched
        vc, cc = CollisionEngine(tree, cfg, device="cpu").query(obbs)
        assert np.array_equal(v, vc)
        a, b = c.as_dict(), cc.as_dict()
        for k in a:
            if k != "wall_time_s":
                assert a[k] == b[k], k
        assert c.escalations == 0 and v.any()
        assert (c.frontier_overflow > 0) == cfg.use_spheres


@pytest.mark.parametrize("block", [128, 37])
def test_cuda_naive_matches_cpu_engine(cuda, block):
    """``naive`` on the card: one ``sact_dense`` launch a block of OBBs
    (37 does not divide 300), nothing else; verdicts, the exit histogram
    and every counter equal the CPU engine's."""
    tree, obbs = _scene_and_queries(M=300, seed=5, depth=5)
    cfg = EngineConfig(mode="naive", query_block=block)
    before = _build.launch_counts()
    v, c = CollisionEngine(tree, cfg, device=cuda).query(obbs)
    after = _build.launch_counts()
    launched = {k: after[k] - before[k] for k in after}
    assert launched.pop("sact_dense") == -(-obbs.n // block)
    assert not any(launched.values()), launched
    vc, cc = CollisionEngine(tree, cfg, device="cpu").query(obbs)
    assert np.array_equal(v, vc)
    a, b = c.as_dict(), cc.as_dict()
    for k in a:
        if k != "wall_time_s":
            assert a[k] == b[k], k
    assert int(c.exit_histogram.sum()) == obbs.n * tree.num_leaves


@pytest.mark.parametrize("B,N,m,first", [
    (1, 2048, 256, 0), (4, 2047, 256, 3), (3, 5000, 128, 4999),
    (2, 100, 130, 0), (3, 1000, 256, 7), (2, 33, 33, 32), (3, 20, 20, 5),
    (4, 1, 1, 0), (2, 1, 4, 0), (2, 8192, 64, 100), (2, 9000, 64, 8999),
    (2, fps_ops.MAX_POINTS, 64, 9)])
def test_fps_kernel_matches_plain(cuda, B, N, m, first):
    """Clouds at the encoder's shapes; N no multiple of threads x points a
    thread and N < 32; one point; the largest clouds, whose coordinates
    stay in shared memory."""
    rs = np.random.RandomState(N)
    pts = torch.from_numpy(rs.uniform(-1, 1, (B, N, 3)).astype(
        np.float32)).to(cuda)
    before = _build.launch_counts()["fps"]
    got = fps_ops.fps(pts, m, first)
    torch.cuda.synchronize()
    assert _build.launch_counts()["fps"] == before + 1
    assert torch.equal(got, fps_ref(pts, m, first))
    assert torch.equal(fps_ops.fps(pts[0], m, first), got[0])


def test_fps_kernel_ties_go_to_the_first_index(cuda):
    pts = torch.from_numpy(np.stack([
        tie_cloud(n_side=5, n_total=1000, spacing=0.125, seed=s)
        for s in range(4)])).to(cuda)
    got = fps_ops.fps(pts, 160)
    assert torch.equal(got, fps_ref(pts, 160))
    assert bool((got[:, 125:] == 0).all())


@pytest.mark.parametrize("first", [0, 3])
def test_fps_kernel_more_picks_than_distinct_points(cuda, first):
    pts = torch.from_numpy(np.stack([
        tie_cloud(n_side=3, n_total=50, spacing=0.25, seed=s)
        for s in range(4)])).to(cuda)
    got = fps_ops.fps(pts, 64, first)
    assert torch.equal(got, fps_ref(pts, 64, first))
    assert bool((got[:, 27:] == 0).all())


def test_fps_kernel_rejects_a_cloud_above_shared_memory(cuda):
    with pytest.raises(ValueError, match="shared memory"):
        fps_ops.fps(torch.zeros(fps_ops.MAX_POINTS + 1, 3, device=cuda), 4)
    got = fps_ops.fps(torch.rand(fps_ops.MAX_POINTS, 3, device=cuda), 8)
    torch.cuda.synchronize()
    assert got.shape == (8,)


@pytest.mark.parametrize("mode", ["straight", "warp_vote"])
@pytest.mark.parametrize("use_spheres", [False, True])
def test_sact_dense_kernel_in_every_stage_mode(cuda, use_spheres, mode):
    assert mode in sact_ops.STAGE_MODES
    obb, aabb = grazing_plane(512, seed=12, use_spheres=use_spheres)
    o, a = torch.from_numpy(obb).to(cuda), torch.from_numpy(aabb).to(cuda)
    c, e = sact_ops.sact_dense_in_mode(o, a, use_spheres, mode)
    pc, pe = sact_ref(o, a, use_spheres)
    assert torch.equal(c, pc) and torch.equal(e, pe)
    assert set(torch.unique(pe).tolist()) == set(range(18)) - (
        set() if use_spheres else {0, 1})


@pytest.mark.parametrize("M,N", [(1, 1), (17, 1023), (33, 5), (16, 512),
                                 (1000, 1026), (16 * 65535 + 17, 2)])
def test_sact_dense_kernel_at_tile_edges(cuda, M, N):
    """OBB counts that are no multiple of a tile (and past 65,535 tiles,
    which the grid strides over), box counts that are no multiple of a
    thread's vector."""
    rs = np.random.RandomState(M + N)
    rot = rotation_from_euler(torch.from_numpy(
        rs.uniform(-3, 3, (M, 3)).astype(np.float32)))
    o = sact_ops.pack_obbs(
        torch.from_numpy(rs.uniform(-1, 1, (M, 3)).astype(np.float32)),
        torch.from_numpy(rs.uniform(0.02, 0.3, (M, 3)).astype(np.float32)),
        rot).to(cuda)
    a = sact_ops.pack_aabbs(
        torch.from_numpy(rs.uniform(-1, 1, (N, 3)).astype(np.float32)),
        torch.from_numpy(rs.uniform(0.02, 0.3, (N, 3)).astype(np.float32))
    ).to(cuda)
    for sph in (False, True):
        for mode in sact_ops.STAGE_MODES:
            c, e = sact_ops.sact_dense_in_mode(o, a, sph, mode)
            pc, pe = sact_ref(o, a, sph)
            assert torch.equal(c, pc) and torch.equal(e, pe), (sph, mode)


@pytest.mark.parametrize("B,M,N,half,r,k", [
    (4, 256, 2048, 0.5, 0.1, 16), (4, 256, 2048, 0.1, 0.1, 16),
    (3, 255, 2047, 1.0, 0.25, 16), (2, 33, 100, 1.0, 0.6, 8)])
def test_ballquery_kernel_matches_plain(cuda, B, M, N, half, r, k):
    rs = np.random.RandomState(M + N)
    pts = torch.from_numpy(rs.uniform(-half, half, (B, N, 3)).astype(
        np.float32)).to(cuda)
    qs = pts[:, :M].contiguous()
    before = _build.launch_counts()["ballquery"]
    idx, cnt = bq_ops.ball_query(qs, pts, r, k)
    torch.cuda.synchronize()
    assert _build.launch_counts()["ballquery"] == before + 1
    widx, wcnt = ball_query_ref(pts, qs, r, k)
    assert torch.equal(idx, widx) and torch.equal(cnt, wcnt)


@pytest.mark.parametrize("r", [0.05, 0.1, 0.2, 0.25, 0.4, 0.6])
def test_ballquery_kernel_at_the_radius(cuda, r):
    pts = torch.from_numpy(radius_shell(r))[None].to(cuda)
    qs = torch.zeros((1, 1, 3), device=cuda)
    for k in (16, pts.shape[1]):
        idx, cnt = bq_ops.ball_query(qs, pts, r, k)
        widx, wcnt = ball_query_ref(pts, qs, r, k)
        assert torch.equal(idx, widx) and torch.equal(cnt, wcnt)
    assert 0 < int(cnt) < pts.shape[1]


@pytest.mark.parametrize("name", [c[0] for c in cloud_cases()])
def test_ballquery_kernel_on_cloud_cases(cuda, name):
    """The design's edges (kernels/ballquery/cases.py): clouds over one
    staged tile, of 1, 31 and 33 points, query counts that are no multiple
    of a block, a block that stops after its first tile, no ball full."""
    _, qs, pts, r, k = next(c for c in cloud_cases() if c[0] == name)
    qs, pts = torch.from_numpy(qs).to(cuda), torch.from_numpy(pts).to(cuda)
    idx, cnt = bq_ops.ball_query(qs, pts, r, k)
    widx, wcnt = ball_query_ref(pts, qs, r, k)
    assert torch.equal(idx, widx) and torch.equal(cnt, wcnt)


@pytest.mark.parametrize("qb", [1, 2, 4, 8, 16, 32, 64])
def test_ballquery_kernel_at_every_query_block(cuda, qb, monkeypatch):
    """Every block size the rule can pick, on ragged query counts and a
    cloud over one tile, whatever the card's SM count."""
    monkeypatch.setattr(bq_ops, "_block", lambda *a: qb)
    rs = np.random.RandomState(qb)
    for B, M, N in ((3, 67, 300), (2, 130, 2500)):
        pts = torch.from_numpy(rs.uniform(-1, 1, (B, N, 3)).astype(
            np.float32)).to(cuda)
        qs = pts[:, :M].contiguous()
        idx, cnt = bq_ops.ball_query(qs, pts, 0.3, 32)
        widx, wcnt = ball_query_ref(pts, qs, 0.3, 32)
        assert torch.equal(idx, widx) and torch.equal(cnt, wcnt)


def test_ballquery_kernel_takes_unaligned_clouds(cuda):
    """Clouds that start off a 16-byte boundary (a view at an odd offset):
    the staging copies take any alignment."""
    rs = np.random.RandomState(7)
    flat = torch.from_numpy(rs.uniform(-1, 1, 3 * 2 * 3001 + 1).astype(
        np.float32)).to(cuda)
    pts = flat[1:].view(2, 3001, 3)
    qs = pts[:, 5:70].contiguous()
    idx, cnt = bq_ops.ball_query(qs, pts, 0.25, 16)
    widx, wcnt = ball_query_ref(pts, qs, 0.25, 16)
    assert torch.equal(idx, widx) and torch.equal(cnt, wcnt)


@pytest.mark.parametrize("sampling", ["fps", "random"])
def test_cuda_planner_path_matches_cpu(cuda, sampling):
    tree, _ = _scene_and_queries(M=8, seed=6, depth=5)
    rs = np.random.RandomState(2)
    cloud = rs.uniform(-1, 1, (600, 3)).astype(np.float32)
    q0, goal = (rs.uniform(-1, 1, 7).astype(np.float32) for _ in range(2))
    runs = []
    for dev in (cuda, "cpu"):
        planner = Planner(64, 64, generator=torch.Generator().manual_seed(0),
                          device=dev)
        eng = CollisionEngine(tree, EngineConfig(mode="wavefront_persistent"),
                              device=dev)
        before = _build.launch_counts()
        res = plan_with_collision_gate(
            planner, eng, cloud, q0, goal, num_steps=8, sampling=sampling,
            generator=torch.Generator().manual_seed(3))
        after = _build.launch_counts()
        runs.append(res)
        launched = {k for k in after if after[k] > before[k]}
        want = set()
        if dev == cuda:
            want = {"ballquery", "persist"} | (
                {"fps"} if sampling == "fps" else set())
        assert launched == want
    np.testing.assert_allclose(runs[0].trajectory, runs[1].trajectory,
                               rtol=1e-4, atol=1e-4)


def _wkv6_inputs(case, dev, dtype):
    r, k, v = (torch.from_numpy(case[n]).to(dev, dtype) for n in "rkv")
    logw, u = (torch.from_numpy(case[n]).to(dev) for n in ("logw", "u"))
    return r, k, v, logw, u


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", hard_cases(), ids=lambda c: c["name"])
def test_wkv6_kernel_matches_plain(cuda, case, dtype):
    ins = _wkv6_inputs(case, cuda, dtype)
    before = _build.launch_counts()["wkv6"]
    o, s = wkv6_ops.wkv6(*ins)
    torch.cuda.synchronize()
    assert _build.launch_counts()["wkv6"] == before + 1
    assert o.dtype == dtype and s.dtype == torch.float32
    assert bool(o.isfinite().all()) and bool(s.isfinite().all())
    want_o, want_s = wkv6_ref(*ins)
    assert within_tol(o, want_o, str(dtype)[6:]) <= 0
    assert within_tol(s, want_s, "float32") <= 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", edge_cases(), ids=lambda c: c["name"])
def test_wkv6_kernel_at_chunk_edges(cuda, case, dtype):
    """Lengths at the kernel's chunk edges at every width it is built for,
    and D = 33, whose rows it cannot copy 16 bytes at a time."""
    ins = _wkv6_inputs(case, cuda, dtype)
    o, s = wkv6_ops.wkv6(*ins)
    torch.cuda.synchronize()
    assert o.dtype == dtype and s.dtype == torch.float32
    assert bool(o.isfinite().all()) and bool(s.isfinite().all())
    want_o, want_s = wkv6_ref(*ins)
    assert within_tol(o, want_o, str(dtype)[6:]) <= 0
    assert within_tol(s, want_s, "float32") <= 0


@pytest.mark.parametrize("decay", ["ordinary", "strong"])
def test_wkv6_heads_kernel_bf16_at_model_width(cuda, decay):
    """bf16 (B, H, T, D) views of (B, T, H, D) projections at the model's
    D = 64, over several chunks and a partial one, in one launch."""
    B, H, T, D = 2, 3, 100, 64
    case = make_case(B * H, T, D, decay, per_row_u=False, seed=7)
    u = torch.from_numpy(np.random.RandomState(7).normal(
        size=(H, D)).astype(np.float32)).to(cuda)
    views = [torch.from_numpy(case[n]).to(cuda, dt).reshape(B, H, T, D)
             .transpose(1, 2).contiguous().transpose(1, 2)
             for n, dt in (("r", torch.bfloat16), ("k", torch.bfloat16),
                           ("v", torch.bfloat16), ("logw", torch.float32))]
    before = _build.launch_counts()["wkv6"]
    o, s = wkv6_ops.wkv6_heads(*views, u)
    torch.cuda.synchronize()
    assert _build.launch_counts()["wkv6"] == before + 1
    fold = [x.reshape(B * H, T, D) for x in views]
    want_o, want_s = wkv6_ref(*fold, u[None].expand(B, H, D).reshape(-1, D))
    assert within_tol(o.reshape(B * H, T, D), want_o, "bfloat16") <= 0
    assert within_tol(s.reshape(B * H, D, D), want_s, "float32") <= 0


@pytest.mark.parametrize("D", [8, 64, 100, 128])
def test_wkv6_heads_kernel_reads_the_model_layout(cuda, D):
    """(B, H, T, D) views of (B, T, H, D) projections, a bonus row per
    head, one launch for all heads."""
    B, H, T = 2, 3, 45
    case = make_case(B * H, T, D, per_row_u=False, seed=D)
    u = torch.from_numpy(np.random.RandomState(D).normal(
        size=(H, D)).astype(np.float32)).to(cuda)
    views = [torch.from_numpy(case[n]).to(cuda).reshape(B, H, T, D)
             .transpose(1, 2).contiguous().transpose(1, 2)
             for n in ("r", "k", "v", "logw")]
    before = _build.launch_counts()["wkv6"]
    o, s = wkv6_ops.wkv6_heads(*views, u)
    torch.cuda.synchronize()
    assert _build.launch_counts()["wkv6"] == before + 1
    assert o.stride() == views[0].stride() and s.shape == (B, H, D, D)
    fold = [x.reshape(B * H, T, D) for x in views]
    want_o, want_s = wkv6_ref(*fold, u[None].expand(B, H, D).reshape(-1, D))
    assert within_tol(o.reshape(B * H, T, D), want_o, "float32") <= 0
    assert within_tol(s.reshape(B * H, D, D), want_s, "float32") <= 0


def test_wkv6_kernel_rejects_what_it_cannot_run(cuda):
    case = make_case(2, 8, 16, seed=1)
    r, k, v, logw, u = _wkv6_inputs(case, cuda, torch.float32)
    with pytest.raises(ValueError, match="unit stride"):
        wkv6_ops.wkv6(*(x.transpose(1, 2).contiguous().transpose(1, 2)
                        for x in (r, k, v, logw)), u)
    with pytest.raises(ValueError, match="one layout"):
        wkv6_ops.wkv6(r, k.transpose(0, 1).contiguous().transpose(0, 1), v,
                      logw, u)
    with pytest.raises(NotImplementedError, match="no backward"):
        wkv6_ops.wkv6(r.requires_grad_(), k, v, logw, u)
    big = torch.zeros((1, 4, 129), device=cuda)
    with pytest.raises(ValueError, match="D <= 128"):
        wkv6_ops.wkv6(big, big, big, big, torch.zeros(129, device=cuda))


def test_cuda_rwkv_serving_matches_cpu(cuda, monkeypatch):
    """The smoke model's prefill and decode on the card against the CPU:
    one ``wkv6`` launch per layer in prefill, none in decode."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_smoke_config("rwkv6_1_6b")
    cpu = LM(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = LM(cfg, torch.Generator().manual_seed(0), device=cuda)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 40)))
    prefill, decode = (lm_api.make_prefill_fn(cfg),
                       lm_api.make_decode_fn(cfg))
    before = _build.launch_counts()["wkv6"]
    logits, caches = prefill(card, {"tokens": tokens.to(cuda)})
    torch.cuda.synchronize()
    assert _build.launch_counts()["wkv6"] == before + cfg.num_layers
    want_logits, want_caches = prefill(cpu, {"tokens": tokens})
    tok = torch.tensor([3, 7])
    step, _ = decode(card, tok.to(cuda), 40, caches)
    torch.cuda.synchronize()
    assert _build.launch_counts()["wkv6"] == before + cfg.num_layers
    want_step, _ = decode(cpu, tok, 40, want_caches)
    for got, want in [(logits, want_logits), (step, want_step)] + [
            (caches[key], want_caches[key]) for key in want_caches]:
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", flash_cases.hard_cases(),
                         ids=lambda c: c["name"])
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    q, k, v = flash_cases.tensors(case, cuda, dtype)
    before = _build.launch_counts()["flash_attention"]
    o = flash_ops.flash_attention(q, k, v, case["causal"])
    torch.cuda.synchronize()
    assert _build.launch_counts()["flash_attention"] == before + 1
    assert o.shape == q.shape and o.dtype == dtype
    assert bool(o.isfinite().all())
    want = attention_ref(q, k, v, case["causal"])
    assert flash_cases.within_tol(o, want, str(dtype)[6:],
                                  case["score_scale"]) <= 0


def test_flash_attention_kernel_rejects_what_it_cannot_run(cuda):
    case = flash_cases.make_case(1, 1, 2, 8, 8, 16, True)
    q, k, v = flash_cases.tensors(case, cuda)
    with pytest.raises(NotImplementedError, match="no backward"):
        flash_ops.flash_attention(q.clone().requires_grad_(), k, v)
    with pytest.raises(ValueError, match="several devices"):
        flash_ops.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(q.numel() + 1, device=cuda)   # 4 bytes off
        flash_ops.flash_attention(flat[1:].view(q.shape), k, v)
    odd = torch.zeros((1, 2, 8, 24), device=cuda)
    with pytest.raises(ValueError, match="head width"):
        flash_ops.flash_attention(odd, odd[:, :1], odd[:, :1])


def test_cuda_glm4_serving_matches_cpu(cuda, monkeypatch):
    """The smoke model's prefill and decode on the card against the CPU:
    one ``flash_attention`` launch per layer in prefill, none in decode."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_smoke_config("glm4_9b")
    cpu = LM(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = LM(cfg, torch.Generator().manual_seed(0), device=cuda)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 40)))
    prefill, decode = (lm_api.make_prefill_fn(cfg, 48),
                       lm_api.make_decode_fn(cfg))
    before = _build.launch_counts()["flash_attention"]
    logits, caches = prefill(card, {"tokens": tokens.to(cuda)})
    torch.cuda.synchronize()
    assert _build.launch_counts()["flash_attention"] == before + cfg.num_layers
    want_logits, want_caches = prefill(cpu, {"tokens": tokens})
    tok = torch.tensor([3, 7])
    step, caches = decode(card, tok.to(cuda), 40, caches)
    torch.cuda.synchronize()
    assert _build.launch_counts()["flash_attention"] == before + cfg.num_layers
    want_step, want_caches = decode(cpu, tok, 40, want_caches)
    for got, want in [(logits, want_logits), (step, want_step)] + [
            (caches["kv"][key], want_caches["kv"][key]) for key in "kv"]:
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-4)


def _march_grids(cuda):
    """Fig. 19's grid (192 x 192, walls and boxes) and one that is not
    square, with no walls (rays leave it)."""
    fig19 = tmcl.make_corridor_world(0, size=192, device=cuda)
    return {"fig19": fig19,
            "nonsquare": tmcl.OccupancyGrid(
                occ=torch.from_numpy(nonsquare_grid()).to(cuda), cell=0.05)}


@pytest.mark.parametrize("grid_name", ["fig19", "nonsquare"])
def test_march_kernel_matches_plain(cuda, grid_name):
    """Fig. 19's 4,608 scan rays, rays grazing cell edges and corners along
    the axes and diagonals, rays leaving the grid: 1, 16 and every step of
    a 6 m cast, pos, dist and active bit for bit."""
    grid = _march_grids(cuda)[grid_name]
    max_range = 6.0
    steps = int(np.ceil(max_range / grid.cell)) + 1
    for name, (org, ang) in ray_cases(grid.shape, grid.cell).items():
        dirv = tmcl.ray_directions(torch.from_numpy(ang).to(cuda))
        for n in (1, 16, steps):
            runs = []
            for fn in (march_ops.march, march_ref):
                st = (torch.tensor(org, device=cuda), dirv,
                      torch.zeros(len(ang), device=cuda),
                      torch.ones(len(ang), dtype=torch.bool, device=cuda))
                before = _build.launch_counts()["march"]
                fn(grid.occ, grid.origin, grid.cell, *st, max_range, n)
                torch.cuda.synchronize()
                launched = _build.launch_counts()["march"] - before
                assert launched == (fn is march_ops.march), (name, n)
                runs.append(st)
            for got, want in zip(runs[0], runs[1]):
                assert torch.equal(got, want), (grid_name, name, n)
            if n == steps:
                assert not bool(runs[0][3].any()), (grid_name, name)


def test_ray_casts_on_the_card_match_cpu(cuda):
    grid = _march_grids(cuda)["fig19"]
    org, ang = ray_cases(grid.shape, grid.cell)["scan"]
    dirs = tmcl.ray_directions(torch.from_numpy(ang).to(cuda))
    cpu_grid = tmcl.OccupancyGrid(grid.occ.cpu(), grid.cell)
    for cast in (tmcl.ray_cast_dense, tmcl.ray_cast_compacted):
        got, cells = cast(grid, torch.from_numpy(org).to(cuda),
                          torch.from_numpy(ang).to(cuda), 6.0)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tmcl, "ray_directions", lambda a: dirs.cpu())
            want, want_cells = cast(cpu_grid, torch.from_numpy(org),
                                    torch.from_numpy(ang), 6.0)
        assert torch.equal(got.cpu(), want) and cells == want_cells


def test_march_kernel_rejects_what_it_cannot_run(cuda):
    grid = _march_grids(cuda)["fig19"]
    pos = torch.zeros((8, 2), device=cuda)
    dirv = torch.ones((8, 2), device=cuda)
    dist = torch.zeros(8, device=cuda)
    active = torch.ones(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        march_ops.march(grid.occ, grid.origin, grid.cell,
                        torch.zeros((8, 4), device=cuda)[:, ::2], dirv,
                        dist, active, 6.0, 4)
    with pytest.raises(ValueError, match="float32"):
        march_ops.march(grid.occ, grid.origin, grid.cell, pos.double(), dirv,
                        dist, active, 6.0, 4)
    with pytest.raises(ValueError, match="one device"):
        march_ops.march(grid.occ.cpu(), grid.origin, grid.cell, pos, dirv,
                        dist, active, 6.0, 4)


@pytest.mark.parametrize("arm", ["ee", "noexit", "pray"])
def test_cuda_ball_query_tree_forms_match_cpu(cuda, arm):
    """P-Sphere with and without the early exit and P-Ray, card against
    CPU: indices in order, counts and every counter; counts also against
    the ``ballquery`` kernel's brute force."""
    rs = np.random.RandomState(6)
    pts = rs.uniform(-1, 1, (20000, 3)).astype(np.float32)
    qs = pts[rs.choice(len(pts), 96, replace=False)]
    tree = build_octree(pts, depth=5)
    r, k = 0.12, 16

    def run(dev):
        P, Q = torch.from_numpy(pts).to(dev), torch.from_numpy(qs).to(dev)
        if arm == "pray":
            return tbq.ball_query_pray(P, Q, r, k, depth=3)
        return tbq.ball_query_psphere(tree, Q, r, k, chunk=4,
                                      early_exit=arm == "ee")
    before = _build.launch_counts()["compact"]
    idx, cnt, c = run(cuda)
    torch.cuda.synchronize()
    assert _build.launch_counts()["compact"] > before
    want_idx, want_cnt, wc = run("cpu")
    assert torch.equal(idx.cpu(), want_idx) and torch.equal(cnt.cpu(),
                                                            want_cnt)
    a, b = c.as_dict(), wc.as_dict()
    assert {f: v for f, v in a.items() if f != "wall_time_s"} == {
        f: v for f, v in b.items() if f != "wall_time_s"}
    _, bcnt = bq_ops.ball_query(torch.from_numpy(qs).to(cuda),
                                torch.from_numpy(pts).to(cuda), r, k)
    assert torch.equal(bcnt.cpu(), want_cnt)
    assert 0 < int((want_cnt == k).sum()) < len(qs)


def test_cuda_gated_mcl_update_matches_cpu(cuda):
    """One gated filter step at Fig. 19's shape on the card against the
    CPU: the CPU takes the card's directions and footprint OBBs; ranges
    (through the resampled particles), cells and the gate exact, weights
    to rtol 1e-5; one ``march`` and one ``persist`` launch."""
    grid = tmcl.make_corridor_world(0, size=192, device=cuda)
    cpu_grid = tmcl.OccupancyGrid(grid.occ.cpu(), grid.cell)
    tree = build_octree(wall_points(grid.occ.cpu().numpy(), grid.cell),
                        depth=6)
    engines = {d: CollisionEngine(tree, EngineConfig(
        mode="wavefront_persistent"), device=d) for d in (cuda, "cpu")}
    angles = torch.linspace(-np.pi, np.pi, 25)[:-1]
    obs = torch.rand(24, generator=torch.Generator().manual_seed(1)) * 6.0
    st = tmcl.init_particles(torch.Generator().manual_seed(2), cpu_grid, 192)
    noise = torch.randn((192, 3), generator=torch.Generator().manual_seed(3))
    noise *= 0.02
    seen = {}
    for dev, g in ((cuda, grid), ("cpu", cpu_grid)):
        with pytest.MonkeyPatch.context() as mp:
            rec = seen.setdefault(dev, {"w": []})
            weights = tmcl.particle_weights
            mp.setattr(tmcl, "particle_weights",
                       lambda *a: rec["w"].append(weights(*a)) or rec["w"][-1])
            if dev == "cpu":
                mp.setattr(tmcl, "ray_directions",
                           lambda a: seen[cuda]["dirs"].cpu())
                mp.setattr(tmcl, "footprint_obbs",
                           lambda *a, **k: OBBs(*(x.cpu() for x in (
                               seen[cuda]["obbs"].center,
                               seen[cuda]["obbs"].half,
                               seen[cuda]["obbs"].rot))))
            else:
                dirs_fn, obbs_fn = tmcl.ray_directions, tmcl.footprint_obbs
                mp.setattr(tmcl, "ray_directions", lambda a: rec.setdefault(
                    "dirs", dirs_fn(a)))
                mp.setattr(tmcl, "footprint_obbs", lambda *a, **k: (
                    rec.setdefault("obbs", obbs_fn(*a, **k))))
            state = tmcl.MCLState(st.particles.to(dev), st.weights.to(dev))
            before = _build.launch_counts()
            new, stats = tmcl.mcl_update(
                state, g, obs.to(dev), angles.to(dev),
                torch.zeros(3, device=dev), noise.to(dev), 0.37, "dense",
                sigma=0.5, collision_engine=engines[dev])
            after = _build.launch_counts()
            rec.update(new=new.particles.cpu(), stats=stats)
            if dev != "cpu":
                torch.cuda.synchronize()
                assert after["march"] - before["march"] == 1
                assert after["persist"] - before["persist"] >= 1
    a, b = seen[cuda], seen["cpu"]
    # no step of the resampling within 1e-6 of a cumulative weight, where
    # the card's and the CPU's sums could part
    cum = np.cumsum(b["w"][0].numpy().astype(np.float64))
    steps = (0.37 + np.arange(192)) / 192
    assert np.abs(steps[:, None] - cum[None, :]).min() > 1e-6
    assert {f: v for f, v in a["stats"].items() if f != "time_s"} == {
        f: v for f, v in b["stats"].items() if f != "time_s"}
    assert 0 < a["stats"]["colliding_particles"] < 192
    np.testing.assert_allclose(a["w"][0].cpu().numpy(), b["w"][0].numpy(),
                               rtol=1e-5, atol=0)
    assert torch.equal(a["new"], b["new"])
