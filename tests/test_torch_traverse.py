"""Port parity: the fused traversal step (``kernels/traverse``) and the
octree helpers the per-level arms use.

``traverse_test_ref`` is held bitwise against the reference kernel two
ways.  Through its own dispatch, ``repro.kernels.traverse.ops.
_test_pallas(..., interpret=True)``, on random OBBs against real cells:
``pallas_call`` jit-compiles the interpreted kernel even inside
``jax.disable_jit()``, and XLA:CPU then contracts ``a*b+c`` into fused
multiply-adds, which flips lanes that graze a separating plane.  So on
frontiers of real cells with grazing OBBs
(:mod:`repro_torch.kernels.traverse.cases`) it is held against the
kernel's body evaluated op by op, and a third test shows that the
compiled kernel departs from it only on lanes that graze.  One whole
``traverse_step`` is held against the reference step with its Pallas test
and Pallas compaction, for fp32, bf16 and u8 rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import octree as joct
from repro.core.octree import jnp_morton_decode
from repro.core.sact import SactResult as JSactResult
from repro.data import robotics as jrob
from repro.kernels.sact.kernel import _EPS as J_EPS
from repro.kernels.sact.kernel import sact_tile as j_sact_tile
from repro.kernels.traverse import ops as jops
from repro.kernels.traverse import ref as jref
from repro_torch.convert import octree_from_reference
from repro_torch.core import octree as toct
from repro_torch.core.geometry import rotation_from_euler
from repro_torch.core import sact as ops_sact
from repro_torch.core.sact import SactResult
from repro_torch.kernels import _build
from repro_torch.kernels.sact.ops import pack_obbs
from repro_torch.kernels.traverse import ops
from repro_torch.kernels.traverse.cases import grazing_frontier
from repro_torch.kernels.traverse.ref import (pack_verdicts,
                                              traverse_test_ref,
                                              unpack_verdicts)

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

LEVEL = 3


@pytest.fixture(scope="module")
def scene():
    sc = jrob.make_scene("cubby", num_points=8192)
    tree = joct.build_octree(sc.points, depth=4)
    return tree, octree_from_reference(tree)


def _jax_test(obb, q_idx, codes, full, n_live, cell, lo, is_leaf,
              use_spheres):
    """The reference kernel through its own dispatch (``pallas_call``
    jit-compiles an interpreted kernel even inside ``disable_jit``)."""
    o = jnp.asarray(obb.numpy())
    with jax.disable_jit():
        out = jops._test_pallas(
            o[:, :3], o[:, 3:6], o[:, 6:].reshape(-1, 3, 3),
            jnp.asarray(q_idx.numpy()),
            jnp.asarray(codes.numpy().view(np.uint32)),
            jnp.asarray(full.numpy() != 0), jnp.float32(cell),
            jnp.asarray(np.asarray(lo, np.float32)), is_leaf, n_live,
            use_spheres, 256, True)
    return np.asarray(out)


def _jax_kernel_body(obb, q_idx, codes, full, n_live, cell, lo, is_leaf,
                     use_spheres):
    """``traverse_kernel``'s body (reference ``kernel.py:63-93``) over all
    lanes at once, op by op: the one-hot gather, the Morton decode, the
    node box and the reference ``sact_tile``, without XLA's fusion."""
    with jax.disable_jit():
        o = jnp.asarray(obb.numpy())
        q = jnp.asarray(q_idx.numpy())
        onehot = (q[:, None] == jnp.arange(o.shape[0])[None, :]).astype(
            jnp.float32)
        rows = jnp.dot(onehot, o, preferred_element_type=jnp.float32)
        oc = [rows[:, i] for i in range(3)]
        oh = [rows[:, 3 + i] for i in range(3)]
        R = [[rows[:, 6 + 3 * i + k] for k in range(3)] for i in range(3)]
        xyz = jnp_morton_decode(jnp.asarray(codes.numpy().view(
            np.uint32))).astype(jnp.float32)
        c = jnp.float32(cell)
        node_c = [jnp.float32(lo[i]) + (xyz[:, i] + 0.5) * c
                  for i in range(3)]
        t = [oc[i] - node_c[i] for i in range(3)]
        A = [[jnp.abs(R[i][k]) + J_EPS for k in range(3)] for i in range(3)]
        collide, exit_code = j_sact_tile(t, R, A, [c * 0.5] * 3, oh,
                                         use_spheres=use_spheres)
        is_term = (jnp.asarray(full.numpy()) != 0) | is_leaf
        packed = (collide.astype(jnp.int32) | (is_term.astype(jnp.int32) << 1)
                  | (exit_code << 2))
        lane = jnp.arange(q.shape[0])
        return np.asarray(jnp.where(lane < n_live, packed, 0))


def _frontier_with_retired_lanes(dev, use_spheres, grazing=True):
    """512 lanes (grazing, or random OBBs against real cells), then 256
    lanes with random, partly out-of-range queries; the live prefix (600)
    ends inside the second 256-lane block, so the third is retired."""
    f = grazing_frontier(dev, LEVEL, 64, seed=5, use_spheres=use_spheres)
    rs = np.random.RandomState(1)
    m = f["obb"].shape[0]
    n_l = int(dev.counts[LEVEL])
    if not grazing:     # each OBB near the cell it would graze
        cell = dev.host_cells[LEVEL]
        c, _ = toct.node_centers_from_codes(f["codes"][::4], dev.scene_lo,
                                            cell)
        c = c + torch.from_numpy(rs.uniform(-cell, cell, (m, 3)).astype(
            np.float32))
        h = torch.from_numpy(rs.uniform(0.2, 1.5, (m, 3)).astype(np.float32))
        r = rotation_from_euler(torch.from_numpy(
            rs.uniform(-3, 3, (m, 3)).astype(np.float32)))
        f["obb"] = pack_obbs(c, h * cell, r)
    extra_i = torch.from_numpy(rs.randint(0, n_l, 256))
    return (f["obb"],
            torch.cat([f["q_idx"], torch.from_numpy(
                rs.randint(-3, m + 3, 256).astype(np.int32))]),
            torch.cat([f["codes"], dev.codes[LEVEL][extra_i]]),
            torch.cat([f["full"], dev.full[LEVEL][extra_i].to(torch.int32)]),
            600)


@pytest.mark.parametrize("use_spheres", [False, True])
def test_traverse_test_ref_matches_reference_kernel_body(scene, use_spheres):
    """Grazing lanes, bitwise, against the reference kernel's formulas."""
    _, ttree = scene
    dev = toct.device_octree(ttree, device="cpu")
    obb, q_idx, codes, full, n_live = _frontier_with_retired_lanes(
        dev, use_spheres)
    kw = dict(cell=dev.host_cells[LEVEL], lo=dev.host_lo, is_leaf=False,
              use_spheres=use_spheres)
    got = traverse_test_ref(obb, q_idx, codes, full, torch.tensor(n_live),
                            **kw)
    want = _jax_kernel_body(obb, q_idx, codes, full, n_live, kw["cell"],
                            kw["lo"], False, use_spheres)
    assert np.array_equal(got.numpy(), want)
    assert not got[n_live:].any()
    _, _, exit_code = unpack_verdicts(got[:512])
    graze = exit_code.reshape(-1, 4)[:, 0]     # the grazed cell of each OBB
    assert (graze[0::2] != graze[1::2]).all()


@pytest.mark.parametrize("use_spheres", [False, True])
def test_traverse_test_ref_matches_pallas_kernel(scene, use_spheres):
    """Random OBBs against real cells, bitwise, against the reference
    kernel through ``_test_pallas(..., interpret=True)``."""
    _, ttree = scene
    dev = toct.device_octree(ttree, device="cpu")
    obb, q_idx, codes, full, n_live = _frontier_with_retired_lanes(
        dev, use_spheres, grazing=False)
    kw = dict(cell=dev.host_cells[LEVEL], lo=dev.host_lo, is_leaf=False,
              use_spheres=use_spheres)
    got = traverse_test_ref(obb, q_idx, codes, full, torch.tensor(n_live),
                            **kw)
    want = _jax_test(obb, q_idx, codes, full, n_live, kw["cell"], kw["lo"],
                     False, use_spheres)
    assert np.array_equal(got.numpy(), want)
    collide, _, exit_code = unpack_verdicts(got[:n_live])
    assert 0 < int(collide.sum()) < n_live
    assert len(set(exit_code.tolist())) >= (3 if use_spheres else 10)


def test_pallas_interpret_differs_only_where_a_pair_grazes(scene):
    """The compiled reference kernel contracts ``a*b+c`` into fused
    multiply-adds, so on grazing lanes it may disagree with the kernel's
    formulas evaluated op by op; every lane where it does has a
    separating-axis margin within float32 rounding of zero (in float64)."""
    _, ttree = scene
    dev = toct.device_octree(ttree, device="cpu")
    obb, q_idx, codes, full, n_live = _frontier_with_retired_lanes(
        dev, False)
    args = (obb, q_idx, codes, full, n_live, dev.host_cells[LEVEL],
            dev.host_lo, False, False)
    body, compiled = _jax_kernel_body(*args), _jax_test(*args)
    lanes = np.nonzero(body != compiled)[0]
    assert lanes.size < 16 and (lanes % 4 == 0).all()   # grazed cells only
    o = obb.numpy().astype(np.float64)[q_idx.numpy()[lanes]]
    xyz = toct.morton_decode(codes[lanes]).numpy().astype(np.float32)
    cell = np.float32(dev.host_cells[LEVEL])
    node_c = np.asarray(dev.host_lo, np.float32) + (xyz + np.float32(0.5)) \
        * cell
    t = o[:, :3] - node_c.astype(np.float64)
    R = o[:, 6:].reshape(-1, 3, 3)
    A = np.abs(R) + np.float32(J_EPS)
    oh, ah = o[:, 3:6], np.float64(cell * np.float32(0.5))
    for k in range(len(lanes)):
        margins = []
        for i in range(3):
            i1, i2 = (i + 1) % 3, (i + 2) % 3
            for j in range(3):
                j1, j2 = (j + 1) % 3, (j + 2) % 3
                lhs = abs(t[k, i2] * R[k, i1, j] - t[k, i1] * R[k, i2, j])
                rad = (ah * (A[k, i2, j] + A[k, i1, j])
                       + oh[k, j1] * A[k, i, j2] + oh[k, j2] * A[k, i, j1])
                margins.append(abs(lhs - rad) / rad)
        assert min(margins) < 1e-6


def test_grazing_frontiers_cover_all_exit_codes(scene):
    _, ttree = scene
    dev = toct.device_octree(ttree, device="cpu")
    seen = set()
    for sph in (False, True):
        f = grazing_frontier(dev, LEVEL, 64, seed=5, use_spheres=sph)
        packed = ops.traverse_test(
            f["obb"], f["q_idx"], f["codes"], f["full"],
            torch.tensor(f["q_idx"].shape[0], dtype=torch.int32),
            cell=dev.host_cells[LEVEL], lo=dev.host_lo, is_leaf=True,
            use_spheres=sph)
        collide, is_term, exit_code = unpack_verdicts(packed)
        assert is_term.all()
        seen |= set(exit_code.tolist())
    assert seen == set(range(18))


def test_pack_unpack_verdicts_match_reference():
    rs = np.random.RandomState(0)
    collide = rs.rand(300) < 0.5
    is_term = rs.rand(300) < 0.5
    code = rs.randint(0, 18, 300).astype(np.int32)
    res = SactResult(torch.from_numpy(collide), torch.from_numpy(code),
                     None, None)
    got = pack_verdicts(res, torch.from_numpy(is_term))
    want = jref.pack_verdicts(
        JSactResult(jnp.asarray(collide), jnp.asarray(code), None, None),
        jnp.asarray(is_term))
    assert np.array_equal(got.numpy(), np.asarray(want))
    for g, w in zip(unpack_verdicts(got), jref.unpack_verdicts(want)):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_host_level_scalars_equal_device_tables(scene):
    """The kernel's cell and scene_lo arguments (host copies) are the
    device tables' float32 values, bit for bit."""
    _, ttree = scene
    dev = toct.device_octree(ttree, device="cpu")
    host = np.asarray(dev.host_cells, np.float32)
    assert np.array_equal(host.view(np.int32),
                          dev.cell_sizes.numpy().view(np.int32))
    assert np.array_equal(np.asarray(dev.host_lo, np.float32).view(np.int32),
                          dev.scene_lo.numpy().view(np.int32))
    for level in range(ttree.depth + 1):
        assert np.float32(ttree.cell_size(level)) == dev.host_cells[level]


def test_codes_unsigned_sorted_and_searchsorted_matches_reference(scene):
    """The int32 code rows are unsorted in their pad (PAD_CODE reads -1);
    the unsigned view sorts, and searchsorted on it equals the reference's
    uint32 searchsorted, pad slots included."""
    tree, ttree = scene
    dev = toct.device_octree(ttree, device="cpu")
    jdev = joct.device_octree(tree)
    u = dev.codes_unsigned
    assert u.dtype == torch.int64
    assert (u[:, 1:] >= u[:, :-1]).all()
    assert int(u[0, -1]) == 0xFFFFFFFF and int(dev.codes[0, -1]) == -1
    rs = np.random.RandomState(2)
    for level in range(ttree.depth + 1):
        row = np.asarray(jdev.codes[level])
        probe = np.concatenate([row[:40], rs.randint(0, 2**30, 200),
                                [0xFFFFFFFF]]).astype(np.uint32)
        got = torch.searchsorted(u[level], torch.from_numpy(
            probe.astype(np.int64)))
        want = np.asarray(jnp.searchsorted(jnp.asarray(row),
                                           jnp.asarray(probe)))
        assert np.array_equal(got.numpy(), want)


def test_node_centers_from_codes_matches_reference(scene):
    tree, ttree = scene
    dev = toct.device_octree(ttree, device="cpu")
    for level in (1, 4):
        codes = dev.codes[level][:int(dev.counts[level])]
        c, h = toct.node_centers_from_codes(codes, dev.scene_lo,
                                            dev.cell_sizes[level])
        jc, jh = joct.node_centers_from_codes(
            jnp.asarray(codes.numpy().view(np.uint32)),
            jnp.asarray(tree.scene_lo),
            jnp.float32(tree.cell_size(level)))
        assert np.array_equal(c.numpy(), np.asarray(jc))
        assert np.array_equal(h.numpy(), np.asarray(jh))


def _frontier(tree, level, capacity, n_live, M, seed):
    rs = np.random.RandomState(seed)
    n_l = len(tree.levels[level].codes)
    c = rs.uniform(-1, 1, (M, 3)).astype(np.float32)
    h = rs.uniform(0.05, 0.4, (M, 3)).astype(np.float32)
    r = rotation_from_euler(torch.from_numpy(
        rs.uniform(-3, 3, (M, 3)).astype(np.float32))).numpy()
    q = rs.randint(0, M, capacity).astype(np.int32)
    idx = rs.randint(0, n_l, capacity).astype(np.int32)
    q[n_live:] = 0
    idx[n_live:] = 0
    verdict = rs.rand(M) < 0.2
    return (c, h, r), q, idx, verdict


@pytest.mark.parametrize("fmt,level", [("fp32", 2), ("bf16", 3),
                                       ("u8", 4)])
def test_traverse_step_matches_reference(scene, fmt, level):
    """One fused level (mid-tree, and the leaf level for u8) against the
    reference step with its Pallas test and Pallas compaction."""
    tree, ttree = scene
    capacity, n_live, M = 256, 200, 48
    boxes, q, idx, verdict = _frontier(tree, level, capacity, n_live, M,
                                       seed=level)
    dev = toct.device_octree(ttree, meta_format=fmt, device="cpu")
    jdev = joct.device_octree(tree, meta_format=fmt)
    for use_spheres in (False, True):
        tv = torch.from_numpy(verdict.astype(np.int32))
        cnt, q_next, idx_next, tv, info = ops.traverse_step(
            pack_obbs(*map(torch.from_numpy, boxes)), dev, level,
            torch.tensor(n_live, dtype=torch.int32), torch.from_numpy(q),
            torch.from_numpy(idx), tv, use_spheres=use_spheres)
        with jax.disable_jit():
            jcnt, jq, jidx, jv, jinfo = jops.traverse_step(
                *map(jnp.asarray, boxes), jdev, level, jnp.int32(n_live),
                jnp.asarray(q), jnp.asarray(idx), jnp.asarray(verdict),
                use_spheres=use_spheres, use_pallas=True,
                use_pallas_compact=True, interpret=True)
        k = int(jcnt)
        assert int(cnt) == k and int(info["n_new"]) == int(jinfo["n_new"])
        assert np.array_equal(q_next.numpy()[:k], np.asarray(jq)[:k])
        assert np.array_equal(idx_next.numpy()[:k], np.asarray(jidx)[:k])
        assert not q_next[k:].any() and not idx_next[k:].any()
        assert np.array_equal(tv.numpy() != 0, np.asarray(jv))
        for name in ("valid", "is_term"):
            assert np.array_equal(info[name].numpy(),
                                  np.asarray(jinfo[name])), name
        assert np.array_equal(info["codes"].numpy().view(np.uint32),
                              np.asarray(jinfo["codes"]))
        for f in SactResult._fields:
            assert np.array_equal(getattr(info["res"], f).numpy(),
                                  np.asarray(getattr(jinfo["res"], f))), f
        if level < ttree.depth:
            assert k > 0


def test_traverse_cpu_launches_no_kernel_and_validates(scene):
    _, ttree = scene
    dev = toct.device_octree(ttree, device="cpu")
    f = grazing_frontier(dev, LEVEL, 8, seed=1, use_spheres=False)
    before = _build.launch_counts()
    kw = dict(cell=dev.host_cells[LEVEL], lo=dev.host_lo, is_leaf=False,
              use_spheres=False)
    ops.traverse_test(f["obb"], f["q_idx"], f["codes"], f["full"],
                      torch.tensor(10), **kw)
    assert _build.launch_counts() == before
    with pytest.raises(ValueError, match="obb"):
        ops.traverse_test(f["obb"][:, :14], f["q_idx"], f["codes"],
                          f["full"], torch.tensor(10), **kw)
    with pytest.raises(ValueError, match="shapes"):
        ops.traverse_test(f["obb"], f["q_idx"], f["codes"][:-1], f["full"],
                          torch.tensor(10), **kw)
    # a grouped step (payload lane) on CPU tensors launches nothing either
    m = f["obb"].shape[0]
    best = torch.full((m,), ops_sact.PAYLOAD_INF, dtype=torch.int32)
    cap = f["q_idx"].shape[0]
    ops.traverse_step(f["obb"], dev, 0, torch.tensor(1, dtype=torch.int32),
                      f["q_idx"], torch.zeros(cap, dtype=torch.int32), best,
                      use_spheres=False,
                      payload=torch.zeros(m, dtype=torch.int32))
    assert _build.launch_counts() == before


@pytest.mark.parametrize("n_live", [0, 1, 13, 64])
def test_traverse_cpu_takes_strided_lanes_and_any_live_prefix(scene, n_live):
    """Strided lane columns give the words of contiguous ones, and lanes
    past ``n_live`` (0, 1, some, all 64) are 0, on the dispatcher's CPU
    arm: the checks the card's call makes in one pass send these inputs
    on rather than refusing them."""
    _, ttree = scene
    dev = toct.device_octree(ttree, device="cpu")
    f = grazing_frontier(dev, LEVEL, 8, seed=2, use_spheres=True)
    kw = dict(cell=dev.host_cells[LEVEL], lo=dev.host_lo, is_leaf=False,
              use_spheres=True)
    lanes = [f[k] for k in ("q_idx", "codes", "full")]
    strided = [torch.stack([x, x], 1)[:, 0] for x in lanes]
    assert not strided[0].is_contiguous()
    n = torch.tensor([n_live], dtype=torch.int32)
    want = traverse_test_ref(f["obb"], *lanes, n, **kw)
    got = ops.traverse_test(f["obb"], *strided, n, **kw)
    assert torch.equal(got, want)
    assert not got[n_live:].any()


@pytest.mark.parametrize("level", [2, 4])
@pytest.mark.parametrize("lanes", ["owner", "owner+payload", "payload"])
def test_traverse_step_grouped_matches_reference(scene, lanes, level):
    """One fused level with owner and payload lanes against the reference
    step (its Pallas test and compaction): the gate ``payload <
    best[owner]`` that retires the lanes of decided groups (mid-tree) and
    the payload fold into the groups' ``best`` cells (the leaf level)."""
    tree, ttree = scene
    capacity, n_live, M = 256, 200, 48
    boxes, q, idx, _ = _frontier(tree, level, capacity, n_live, M, seed=9)
    rs = np.random.RandomState(4)
    G = 12
    owner = (rs.randint(0, G, M).astype(np.int32)
             if "owner" in lanes else None)
    payload = (rs.randint(0, 5, M).astype(np.int32)
               if "payload" in lanes else None)
    best = np.full(M, ops_sact.PAYLOAD_INF, np.int32)
    if level < ttree.depth:   # some groups decided: the gate retires lanes
        best[rs.rand(M) < 0.2] = 2
    dev = toct.device_octree(ttree, device="cpu")
    jdev = joct.device_octree(tree)

    def t(x):
        return None if x is None else torch.from_numpy(x)

    cnt, q_next, idx_next, tv, info = ops.traverse_step(
        pack_obbs(*map(torch.from_numpy, boxes)), dev, level,
        torch.tensor(n_live, dtype=torch.int32), torch.from_numpy(q),
        torch.from_numpy(idx), torch.from_numpy(best.copy()),
        use_spheres=False, owner=t(owner), payload=t(payload))
    with jax.disable_jit():
        jcnt, jq, jidx, jv, jinfo = jops.traverse_step(
            *map(jnp.asarray, boxes), jdev, level, jnp.int32(n_live),
            jnp.asarray(q), jnp.asarray(idx), jnp.asarray(best),
            use_spheres=False, use_pallas=True, use_pallas_compact=True,
            interpret=True,
            owner=None if owner is None else jnp.asarray(owner),
            payload=None if payload is None else jnp.asarray(payload))
    k = int(jcnt)
    assert int(cnt) == k and int(info["n_new"]) == int(jinfo["n_new"])
    assert np.array_equal(q_next.numpy()[:k], np.asarray(jq)[:k])
    assert np.array_equal(idx_next.numpy()[:k], np.asarray(jidx)[:k])
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert tv.dtype == torch.int32
    if level == ttree.depth:
        assert (tv.numpy() != best).any()
    else:
        assert k > 0
