"""Port parity: the persistent megakernel's plain version and dispatch.

``persist_tiles_ref`` is held bitwise against the reference Pallas kernel
(``make_persist_call`` under ``interpret=True``, run eagerly inside
``jax.disable_jit()``) on the same packed inputs: per-slot ``best``,
per-level counts, exit histogram, work scalars, and the spill ring of
every tile whose total spill fits the ring (where one level spills more
than ``ring_cap`` pairs, several pairs share a ring slot and neither
side defines which one stays).  Identity pools and the owner-group pools
of ``kernels/persist/cases.py`` (tile-local verdict groups, random
payloads: the ``best`` fold and the expand gate at work).

Rows in all three formats and the streamed layout's window count
(``meta_rows``) are held against the reference's global-pool plain arm
(``traverse_whole_ref`` with the same window model) on clean runs, and
against its interpreted kernel on one small overflowing case (C.10).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import octree as joct
from repro.kernels.persist import ops as jops
from repro.kernels.persist.kernel import make_persist_call
from repro.kernels.persist.ref import csr_child_slots as j_csr_child_slots
from repro.kernels.persist.ref import decode_meta_rows as j_decode_meta_rows
from repro.kernels.persist.ref import traverse_whole_ref
from repro_torch.convert import octree_from_reference
from repro_torch.core.geometry import rotation_from_euler
from repro_torch.core.octree import build_octree, device_octree
from repro_torch.kernels.persist import cases, ops
from repro_torch.kernels.persist.ref import (csr_child_slots,
                                             decode_meta_rows, popcount8,
                                             persist_tiles_ref)

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

DEPTH = 4


def _scene_and_queries(M=40, seed=3):
    rs = np.random.RandomState(seed)
    pts = rs.uniform(-1, 1, (4000, 3)).astype(np.float32)
    tree = joct.build_octree(pts, depth=DEPTH)
    c = rs.uniform(-1, 1, (M, 3)).astype(np.float32)
    h = rs.uniform(0.05, 0.3, (M, 3)).astype(np.float32)
    r = rotation_from_euler(torch.from_numpy(
        rs.uniform(-3, 3, (M, 3)).astype(np.float32))).numpy()
    return tree, c, h, r


def _reference_outputs(ins, tree, T, bq, fcap, ring_cap, use_spheres,
                       stream=False, meta_fmt="fp32", wsub=1024):
    L = DEPTH + 1
    off = np.zeros(L, np.int32)
    cnt = np.asarray([len(lv.codes) for lv in tree.levels], np.int32)
    call = make_persist_call(T, bq, fcap, DEPTH, ins["meta"].shape[1],
                             ring_cap, use_spheres, True, stream,
                             meta_fmt=meta_fmt, wsub=wsub)
    a = {k: jnp.asarray(v.numpy()) for k, v in ins.items()}
    with jax.disable_jit():
        out = call(a["scal"], jnp.asarray(off), jnp.asarray(cnt), a["sot"],
                   a["nvalid"], a["obb"], a["meta"], a["payload"],
                   a["owner"])
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("bq,fcap,ring_cap,use_spheres,overflows", [
    (16, 32, 1024, False, True),    # spills, every spill fits the ring
    (16, 32, 16, True, True),       # ring overrun (ring not compared)
    (16, 2048, 64, False, False),   # overflow-free
])
def test_persist_tiles_ref_matches_pallas_kernel(bq, fcap, ring_cap,
                                                 use_spheres, overflows):
    tree, c, h, r = _scene_and_queries()
    dev = device_octree(octree_from_reference(tree), device="cpu")
    ins = ops.pack_kernel_inputs(torch.from_numpy(c), torch.from_numpy(h),
                                 torch.from_numpy(r), dev, bq)
    T = ins["sot"].shape[0]
    got = [x.numpy() for x in ops.persist_tiles(
        **ins, bq=bq, fcap=fcap, depth=DEPTH, ring_cap=ring_cap,
        use_spheres=use_spheres)]
    ref = _reference_outputs(ins, tree, T, bq, fcap, ring_cap, use_spheres)
    for name, g, w in zip(("best", "per_level", "hist", "scalars"), got, ref):
        assert g.shape == w.shape and np.array_equal(g, w), name
    spill = got[3][:, 6]
    assert (spill.sum() > 0) == overflows
    fits = spill <= ring_cap
    assert np.array_equal(got[4][fits], ref[4][fits])
    if ring_cap == 1024:
        assert fits.all() and (got[4] != 0).any()


@pytest.mark.parametrize("bq,fcap,ring_cap,use_spheres", [
    (16, 32, 1024, False),          # spills
    (16, 2048, 64, True),           # overflow-free
])
def test_persist_tiles_ref_matches_pallas_kernel_on_owner_groups(
        bq, fcap, ring_cap, use_spheres):
    tree, _, _, _ = _scene_and_queries()
    dev = device_octree(octree_from_reference(tree), device="cpu")
    ins = cases.owner_group_pool(dev, bq, num_tiles=3, seed=11)
    own = ins["owner"].reshape(3, bq)
    assert (own > torch.arange(bq)).sum() == 0 and (own < 0).any()
    got = [x.numpy() for x in ops.persist_tiles(
        **ins, bq=bq, fcap=fcap, depth=DEPTH, ring_cap=ring_cap,
        use_spheres=use_spheres)]
    ref = _reference_outputs(ins, tree, 3, bq, fcap, ring_cap, use_spheres)
    for name, g, w in zip(("best", "per_level", "hist", "scalars"), got, ref):
        assert g.shape == w.shape and np.array_equal(g, w), name
    fits = got[3][:, 6] <= ring_cap
    assert np.array_equal(got[4][fits], ref[4][fits])
    # groups share a best cell: some member slot's cell never folds
    best = got[0]
    hit_groups = best[best != ops.PAYLOAD_INF].size
    assert 0 < hit_groups < int((own >= 0).sum())


def test_skewed_pool_puts_the_work_in_one_tile_and_spills_it():
    """One tile holds most of the nodes, its widest level is several
    times a cluster's threads wide, and the returned capacity spills that
    level part way through its children into a ring that holds them."""
    tree = build_octree(np.random.RandomState(3).uniform(
        -1, 1, (20000, 3)).astype(np.float32), depth=5)
    dev = device_octree(tree, device="cpu")
    ins, fcap, ring_cap = cases.skewed_pool(dev, 128, 6, seed=5)
    _, per_level, _, scalars, ring = persist_tiles_ref(
        **ins, bq=128, fcap=fcap, depth=5, ring_cap=ring_cap,
        use_spheres=False)
    nodes = scalars[:, 0]
    assert int(nodes.argmax()) == 1 and 2 * int(nodes[1]) > int(nodes.sum())
    assert int(per_level[1].max()) == fcap > 2048
    assert int(scalars[1, 6]) == ring_cap > 0 and int(scalars[:, 6].sum()) \
        == ring_cap
    assert bool((ring[1] != 0).all(1).any())


def test_persist_tiles_ref_live_prefix_and_pad_tiles():
    """Slots past the live count seed nothing: a padded pool traverses
    like its unpadded prefix, tile by tile."""
    tree, c, h, r = _scene_and_queries(M=48)
    dev = device_octree(octree_from_reference(tree), device="cpu")
    args = [torch.from_numpy(x) for x in (c, h, r)]
    full = ops.pack_kernel_inputs(*args, dev, 16, num_valid=30)
    pre = ops.pack_kernel_inputs(*[x[:30] for x in args], dev, 16)
    kw = dict(bq=16, fcap=256, depth=DEPTH, ring_cap=64, use_spheres=False)
    a = ops.persist_tiles(**full, **kw)
    b = ops.persist_tiles(**pre, **kw)
    assert torch.equal(a[1][:2], b[1][:2]) and int(a[1][2].sum()) == 0
    assert torch.equal(a[0].reshape(-1)[:30], b[0].reshape(-1)[:30])


def test_decode_meta_rows_matches_reference_on_every_format():
    """Every level's rows of a depth-5 scene, in each format: the same
    cell coordinates, flags, pointers, masks and u8 codes as the
    reference's decode, and the same coordinates as the fp32 codes."""
    tree = joct.build_octree(np.random.RandomState(1).uniform(
        -1, 1, (3000, 3)).astype(np.float32), depth=5)
    fp32 = device_octree(octree_from_reference(tree), device="cpu")
    for fmt in ("fp32", "bf16", "u8"):
        jdev = joct.device_octree(tree, meta_format=fmt)
        dev = device_octree(octree_from_reference(tree), meta_format=fmt,
                            device="cpu")
        for level in range(6):
            n = int(dev.counts[level])
            pcode = (dev.codes[level, :n] >> 3) if fmt == "u8" else None
            got = decode_meta_rows(dev.node_meta[level, :n], fmt, level,
                                   pcode)
            with jax.disable_jit():
                want = j_decode_meta_rows(
                    jnp.asarray(dev.node_meta[level, :n].numpy()), fmt,
                    jnp.int32(level), None if pcode is None
                    else jnp.asarray(pcode.numpy()))
            for name, g, w in zip(("xyz", "full", "start", "mask", "code"),
                                  got, want):
                assert np.array_equal(g.numpy(), np.asarray(w)), \
                    (fmt, level, name)
            ref = decode_meta_rows(fp32.node_meta[level, :n], "fp32", level)
            for g, w in zip(got[:4], ref[:4]):
                assert torch.equal(g, w), (fmt, level)
            if fmt == "u8":
                assert torch.equal(got[4], dev.codes[level, :n])


def _jax_stream_ref(tree, fmt, c, h, r, valid, owner, payload, bq, wsub,
                    use_spheres):
    """The reference's global-pool plain arm with the streamed window
    model, on a pool of ``len(c)`` slots cut into tiles of ``bq``."""
    jdev = joct.device_octree(tree, meta_format=fmt)
    L = DEPTH + 1
    Q = c.shape[0]
    cnt = jnp.asarray([len(lv.codes) for lv in tree.levels],
                      jnp.int32).reshape(1, L)
    with jax.disable_jit():
        return traverse_whole_ref(
            *map(jnp.asarray, (c, h, r)), jdev.node_meta, jdev.cell_sizes,
            jdev.scene_lo, DEPTH, 1 << 14, use_spheres,
            owner_of_query=jnp.asarray(owner),
            payload=jnp.asarray(payload), stream_bq=bq, stream_wsub=wsub,
            scene_off=jnp.zeros((1, L), jnp.int32), scene_counts=cnt,
            scene_of_tile=jnp.zeros(Q // bq, jnp.int32),
            valid_of_query=jnp.asarray(valid), meta_format=fmt,
            codes=jdev.codes)


@pytest.mark.parametrize("fmt,wsub,use_spheres", [
    ("fp32", 8, False), ("fp32", 64, True), ("bf16", 8, True),
    ("bf16", 64, False), ("u8", 8, False), ("u8", 64, True)])
@pytest.mark.parametrize("pool", ["identity", "owner groups"])
def test_formats_and_windows_match_reference_plain_arm(fmt, wsub,
                                                       use_spheres, pool):
    """Rows in ``fmt``, resident and streamed at windows of ``wsub``
    rows (both cross windows at every level past the first few), against
    the reference's global-pool plain arm on the same slots: per-slot
    ``best``, every summed counter, ``meta_rows`` with the same window
    model; the resident layout counts no row and changes nothing else."""
    tree, c, h, r = _scene_and_queries()
    dev = device_octree(octree_from_reference(tree), meta_format=fmt,
                        device="cpu")
    bq = 16
    if pool == "identity":
        ins = ops.pack_kernel_inputs(*map(torch.from_numpy, (c, h, r)), dev,
                                     bq)
    else:
        ins = cases.owner_group_pool(dev, bq, num_tiles=3, seed=11)
    T = ins["sot"].shape[0]
    kw = dict(bq=bq, fcap=4096, depth=DEPTH, ring_cap=64,
              use_spheres=use_spheres, meta_format=fmt)
    streamed = ops.persist_tiles(**ins, **kw, streamed=True, wsub=wsub)
    resident = ops.persist_tiles(**ins, **kw)
    # the reference's slots: owner ids global, pads masked
    own = ins["owner"].numpy()
    valid = own >= 0
    tile = np.arange(T * bq) // bq
    owner = np.where(valid, tile * bq + own, 0).astype(np.int32)
    obb = ins["obb"].numpy()
    rot = obb[:, 6:].reshape(-1, 3, 3)
    if pool == "identity":
        valid = np.arange(T * bq) < c.shape[0]
    verdict, st = _jax_stream_ref(tree, fmt, obb[:, :3], obb[:, 3:6], rot,
                                  valid, owner, ins["payload"].numpy(), bq,
                                  wsub, use_spheres)
    best, per_level, hist, scalars, _ = streamed
    assert int(scalars[:, 5].sum()) == 0
    assert np.array_equal(best.reshape(-1).numpy(), np.asarray(verdict))
    tot = scalars.sum(0).tolist()
    names = ("nodes", "leaf", "axis_exec", "axis_dec", "sphere", "overflow")
    assert tot[:6] == [int(st[k]) for k in names]
    assert tot[7] == int(st["meta_rows"]) > 0
    assert per_level.sum(0).tolist() == np.asarray(
        st["per_level"])[:DEPTH + 1].tolist()
    assert np.array_equal(hist.sum(0).numpy(), np.asarray(st["exit_hist"]))
    for g, w in zip(resident[:3], streamed[:3]):
        assert torch.equal(g, w)
    assert torch.equal(resident[3][:, :7], streamed[3][:, :7])
    assert int(resident[3][:, 7].sum()) == 0


@pytest.mark.parametrize("fmt,wsub", [("u8", 128), ("bf16", 256)])
def test_streamed_rows_match_pallas_kernel(fmt, wsub):
    """The reference's interpreted kernel on the streamed layout with
    compressed rows, random (not grazing) OBBs, spilling tiles: every
    output of every tile, ``meta_rows`` included.  (Its window scratch
    must hold one 128-row DMA chunk, so windows are at least 128 rows.)"""
    tree, c, h, r = _scene_and_queries()
    dev = device_octree(octree_from_reference(tree), meta_format=fmt,
                        device="cpu")
    bq, fcap, ring_cap = 16, 32, 1024
    ins = ops.pack_kernel_inputs(*map(torch.from_numpy, (c, h, r)), dev, bq)
    T = ins["sot"].shape[0]
    got = [x.numpy() for x in ops.persist_tiles(
        **ins, bq=bq, fcap=fcap, depth=DEPTH, ring_cap=ring_cap,
        use_spheres=False, meta_format=fmt, streamed=True, wsub=wsub)]
    ref = _reference_outputs(ins, tree, T, bq, fcap, ring_cap, False,
                             stream=True, meta_fmt=fmt, wsub=wsub)
    for name, g, w in zip(("best", "per_level", "hist", "scalars"), got, ref):
        assert g.shape == w.shape and np.array_equal(g, w), name
    assert got[3][:, 6].sum() > 0 and got[3][:, 7].sum() > 0
    fits = got[3][:, 6] <= ring_cap
    assert np.array_equal(got[4][fits], ref[4][fits])


def test_window_count_of_a_single_window_and_of_pads():
    """A window as wide as the table counts each level's occupied rows
    rounded up to 8, once a tile that has a valid lane there; a tile of
    pads counts nothing."""
    tree, c, h, r = _scene_and_queries(M=20)
    dev = device_octree(octree_from_reference(tree), meta_format="bf16",
                        device="cpu")
    args = list(map(torch.from_numpy, (c, h, r)))
    ins = ops.pack_kernel_inputs(*args, dev, 16, num_valid=12)
    n_max = dev.node_meta.shape[1]
    per_level, scalars = ops.persist_tiles(
        **ins, bq=16, fcap=4096, depth=DEPTH, ring_cap=8, use_spheres=False,
        meta_format="bf16", streamed=True, wsub=n_max)[1:4:2]
    assert int(scalars[1, 7]) == 0 and int(per_level[1].sum()) == 0
    rows = [-(-int(n) // 8) * 8 for n, live in zip(dev.counts, per_level[0])
            if int(live) > 0]
    assert int(scalars[0, 7]) == sum(rows)


def test_csr_child_slots_and_popcount_match_reference():
    masks = np.arange(256, dtype=np.int32)
    occ, offs = csr_child_slots(torch.from_numpy(masks))
    jocc, joffs = j_csr_child_slots(jnp.asarray(masks))
    assert np.array_equal(occ.numpy(), np.asarray(jocc))
    assert np.array_equal(offs.numpy(), np.asarray(joffs))
    assert np.array_equal(popcount8(torch.from_numpy(masks)).numpy(),
                          np.asarray(jax.lax.population_count(
                              jnp.asarray(masks))))


def test_choose_meta_layout_rules_match_reference():
    for depth, n_max in ((4, 900), (7, 114047), (7, 29797), (9, 3_000_000)):
        for budget in (1 << 20, 8 << 20, ops.H100_L2_BYTES):
            for fmt in (None, "fp32", "bf16", "u8"):
                for layout in (None, "resident", "streamed"):
                    try:
                        want = jops.choose_meta_layout(depth, n_max, budget,
                                                       fmt=fmt, layout=layout)
                    except ValueError:
                        with pytest.raises(ValueError):
                            ops.choose_meta_layout(depth, n_max, budget,
                                                   fmt=fmt, layout=layout)
                        continue
                    got = ops.choose_meta_layout(depth, n_max, budget,
                                                 fmt=fmt, layout=layout)
                    assert tuple(got) == tuple(want)
    assert ops.META_FORMAT_BYTES == jops.META_FORMAT_BYTES
    assert ops.meta_table_bytes(7, 114047) == jops.meta_table_bytes(7, 114047)


def test_l2_budget_keeps_paper_scale_scenes_resident_fp32():
    """Widest-level rows of the four paper-scale scenes at depth 7: under
    the H100's L2 budget every one runs resident fp32 rows (the reference's
    8 MiB TPU budget would pick bf16 for the two widest)."""
    for n_max in (114047, 100438, 55132, 29797):
        assert ops.choose_meta_layout(7, n_max) == ("resident", "fp32")
    assert jops.choose_meta_layout(7, 114047).fmt == "bf16"


def test_chooser_at_fig_bigscene_widths():
    """``fig_bigscene``'s full-scale scenes (depth 8; widest levels
    516,192 and 2,869,085 rows): under the H100's L2 budget the small one
    is resident bf16 and the big one streamed bf16; u8 pinned on the big
    one is ineligible (past its 2**20 pointer) in both packages."""
    small, big = 516192, 2869085
    assert ops.choose_meta_layout(8, small) == ("resident", "bf16")
    assert ops.choose_meta_layout(8, big) == ("streamed", "bf16")
    fp32 = ops.meta_table_bytes(8, small)
    assert ops.choose_meta_layout(8, small, fp32, fmt="fp32") \
        == ("resident", "fp32")
    assert ops.choose_meta_layout(8, big, fp32, fmt="fp32") \
        == ("streamed", "fp32")
    for budget in (ops.H100_L2_BYTES, fp32):
        for layout in (None, "streamed"):
            for mod in (ops, jops):
                with pytest.raises(ValueError, match="u8"):
                    mod.choose_meta_layout(8, big, budget, fmt="u8",
                                           layout=layout)
    assert ops.choose_meta_layout(8, small, fp32, fmt="u8",
                                  layout="streamed") == ("streamed", "u8")
    assert ops.sub_window_rows(big) == jops.sub_window_rows(big) == 1024
    for n in (100, 1000, big):
        for fmt in ("fp32", "bf16", "u8"):
            assert ops.meta_stream_bytes(n, fmt) \
                == jops.meta_stream_bytes(n, fmt)


def test_traverse_whole_unported_options_raise():
    pts = np.random.RandomState(0).uniform(-1, 1, (500, 3)).astype(np.float32)
    tree = build_octree(pts, depth=3)
    dev = device_octree(tree, device="cpu")
    x = torch.zeros(4, 3)
    r = torch.eye(3).expand(4, 3, 3)
    # an owner group past the largest tile: the reference's plain arm,
    # which the port does not fall back to
    n = ops.MAX_TILE_BQ + 1
    xn = torch.zeros(n, 3)
    with pytest.raises(NotImplementedError, match="B.2.5") as err:
        ops.tile_pool(xn, xn + 1, torch.eye(3).expand(n, 3, 3),
                      torch.zeros(n, dtype=torch.int32))
    assert jops.persist_kernel_unsupported(np.zeros(n, np.int32)) \
        in str(err.value)
    # a scene lane needs the flat table of a ragged batch, as in the
    # reference
    with pytest.raises(ValueError, match="MultiSceneOctree"):
        ops.traverse_whole(x, x + 1, r, dev, 64, use_spheres=False,
                           scene_of_query=torch.zeros(4, dtype=torch.int32))
    # the streamed layout and bf16 rows run, and agree
    # with the reference's plain arm on the same scene
    rs = np.random.RandomState(4)
    xs = torch.from_numpy(rs.uniform(-1, 1, (4, 3)).astype(np.float32))
    hs = torch.from_numpy(rs.uniform(0.05, 0.2, (4, 3)).astype(np.float32))
    jtree = joct.build_octree(pts, depth=3)
    for fmt, streamed in (("fp32", True), ("bf16", False), ("bf16", True)):
        tdev = device_octree(octree_from_reference(jtree), meta_format=fmt,
                             device="cpu")
        v, st = ops.traverse_whole(xs, hs, r, tdev, 64, use_spheres=False,
                                   streamed=streamed)
        with jax.disable_jit():
            wv, wst = jops.traverse_whole(
                jnp.asarray(xs.numpy()), jnp.asarray(hs.numpy()),
                jnp.asarray(r.numpy()),
                joct.device_octree(jtree, meta_format=fmt), 64,
                use_spheres=False, use_pallas=False, streamed=streamed)
        assert np.array_equal(v.numpy(), np.asarray(wv))
        for k in ("nodes", "leaf", "axis_exec", "overflow", "meta_rows"):
            assert int(st[k]) == int(wst[k]), (fmt, streamed, k)
        assert (int(st["meta_rows"]) > 0) == streamed


def _owner_lanes(seed, sizes):
    """Compact owner ids of groups of the given sizes, in a shuffled slot
    order (the front ends emit sorted pools; the map must not rely on
    it)."""
    rs = np.random.RandomState(seed)
    own = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    return own[rs.permutation(own.size)]


@pytest.mark.parametrize("case", ["sweep", "past128", "past512", "empty",
                                  "identity", "bq16"])
def test_build_tile_map_matches_reference(case):
    """Every field of the tile map equals the reference's: groups of 1-14
    slots (a sweep round's), one past 128 and one past 512 slots (bq
    grows to the next power of two), an empty pool, the identity owner
    lane, and a small starting bq."""
    rs = np.random.RandomState(7)
    bq = 16 if case == "bq16" else 128
    if case == "empty":
        own = np.zeros(0, np.int32)
    elif case == "identity":
        own = None
    else:
        sizes = list(rs.randint(1, 15, 60))
        if case == "past128":
            sizes[17] = 130
        elif case == "past512":
            sizes[3] = 600
        own = _owner_lanes(5, sizes)
    Q = 300 if own is None else own.size
    got = ops.build_tile_map(Q, bq, None, own)
    want = jops.build_tile_map(Q, bq, None, own)
    assert got.bq == want.bq and got.num_tiles == want.num_tiles
    assert np.array_equal(got.perm, want.perm)
    # each query sits at the reference's slot
    slot = np.asarray(want.tiles.slot_of_query)
    assert np.array_equal(got.perm[slot], np.arange(Q))
    for name in ops.Tiling._fields:
        g, w = getattr(got.tiles, name), np.asarray(getattr(want.tiles, name))
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert ops.persist_kernel_unsupported(own) \
        == jops.persist_kernel_unsupported(own) is None
    if case == "past512":
        assert got.bq == 1024
    if own is not None and own.size:
        # pads at each tile's tail, every group whole in one tile
        ol = got.tiles.owner_local.reshape(got.num_tiles, got.bq)
        live = ol >= 0
        assert (live[:, :-1] | ~live[:, 1:]).all()
        assert (slot // got.bq == got.tiles.group_slot[own] // got.bq).all()


def test_tile_map_past_the_largest_tile_raises_like_reference():
    own = _owner_lanes(3, [4, 1025, 9])
    reason = ops.persist_kernel_unsupported(own)
    assert reason == jops.persist_kernel_unsupported(own) is not None
    with pytest.raises(ValueError) as a:
        ops.build_tile_map(own.size, 128, None, own)
    with pytest.raises(ValueError) as b:
        jops.build_tile_map(own.size, 128, None, own)
    assert str(a.value) == str(b.value)


def test_tiled_pool_of_a_sweep_round_matches_the_engine():
    """``cases.tiled_pool`` packs a recorded sweep round as the engine
    does: the plain version's per-slot words, read at each group's fold
    slot, are the engine's verdicts for that round, and pads lie at each
    tile's tail."""
    from repro_torch.core.pipeline import check_edges
    from repro_torch.data.robotics import (PANDA_JOINT_HI, PANDA_JOINT_LO,
                                           make_scene)
    from repro_torch.engine.executor import CollisionEngine, EngineConfig
    sc = make_scene("cubby", num_points=3000)
    tree = build_octree(sc.points, depth=DEPTH)
    dev = device_octree(tree, device="cpu")
    rs = np.random.RandomState(2)
    qf = rs.uniform(PANDA_JOINT_LO, PANDA_JOINT_HI, (8, 7)).astype(np.float32)
    qt = np.clip(qf + rs.uniform(-0.35, 0.35, (8, 7)).astype(np.float32),
                 PANDA_JOINT_LO, PANDA_JOINT_HI)
    eng = CollisionEngine(tree, EngineConfig(mode="wavefront_persistent"),
                          device="cpu")
    plans = cases.sweep_round_plans(eng, qf, qt, 8, base_pos=sc.robot_base)
    assert "execute" not in vars(eng)
    want = check_edges(eng, qf, qt, 8, base_pos=sc.robot_base)
    assert plans[0].shape_tag == "edges[Q=56 S=1 G=8 lanes=owner]"
    assert any(p.payload is not None for p in plans) == want.collide.any()
    for plan in plans:
        ins, bq = cases.tiled_pool(dev, plan)
        own = ins["owner"].reshape(-1, bq)
        assert bool(((own[:, 1:] < 0) | (own[:, :-1] >= 0)).all())
        best = persist_tiles_ref(**ins, bq=bq, fcap=4096, depth=DEPTH,
                                 ring_cap=64, use_spheres=False)[0]
        tm = ops.build_tile_map(plan.num_queries, ops.DEFAULT_BQ, None,
                                plan.owner_of_query.numpy())
        gs = torch.from_numpy(tm.tiles.group_slot[:plan.groups]).long()
        v, _ = eng.execute(plan)
        assert np.array_equal(best.reshape(-1)[gs].numpy(), v)
