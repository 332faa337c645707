"""Port parity: the ball query as tree traversal (Table IV, Fig. 17).

``repro_torch.core.ballquery``'s P-Sphere and P-Ray forms, their descent
``_traverse_to_leaves`` and merge ``_merge_candidates``, and the helpers
they and Fig. 14 need (``point_aabb_sq_distance``, ``random_aabbs``,
``make_mpaccel_scenario``) against the reference on the same numpy
inputs: indices in order, counts and every counter but the wall time,
exact.  The reference's calls compile every eager operation once a shape
(tens of seconds a call on a fresh process), so the module shares them
through one fixture at the smallest shapes that still take several
rounds.

The reference orders each query's leaves with ``jnp.lexsort``, which is
not stable; the port sorts stably.  The two can order leaves that lie at
the same distance from a query differently, and for a query with more
than ``k`` hits choose other neighbours.  A test counts such ties; the
cases here have none, so ``idx`` is held in order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ballquery as jbq
from repro.core import counters as jcounters
from repro.core import geometry as jgeo
from repro.core import octree as joct
from repro.data import robotics as jrob
from repro_torch import convert
from repro_torch.core import ballquery as tbq
from repro_torch.core import counters as tcounters
from repro_torch.core import geometry as tgeo
from repro_torch.core import octree as toct
from repro_torch.data import robotics as trob

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

# About 500 points, 8 queries, depth 4 (the reference's own property
# test's shapes); P-Ray on a depth-3 tree; chunks of 2 ranks.  At r 0.3
# and k 8 three queries fill up and five do not; at k 2 all fill.
N_PTS, N_Q, DEPTH, PRAY_DEPTH, CHUNK, RADIUS = 500, 8, 4, 3, 2, 0.3


def _cloud():
    rs = np.random.RandomState(0)
    pts = rs.uniform(-1, 1, (N_PTS, 3)).astype(np.float32)
    qs = rs.uniform(-1, 1, (N_Q, 3)).astype(np.float32)
    return pts, qs


def _counters(c):
    d = c.as_dict()
    d.pop("wall_time_s")
    return d


def _leaf_ties(tree, qs, radius):
    """Pairs of a query's reachable leaves at the same float32 squared
    distance from it (where an unstable sort may reorder them)."""
    c = tcounters.Counters()
    q_idx, codes = tbq._traverse_to_leaves(tree, torch.from_numpy(qs),
                                           radius, c)
    leaf_c, _ = toct.node_centers_from_codes(
        codes, torch.from_numpy(tree.scene_lo), tree.cell_size(tree.depth))
    d2 = tbq.sq_dist(leaf_c, torch.from_numpy(qs)[q_idx.long()]).numpy()
    keys = list(zip(q_idx.numpy().tolist(), d2.tolist()))
    return len(keys) - len(set(keys))


@pytest.fixture(scope="module")
def tree_cases():
    """Each case run once through the reference (eager, as its own tests
    run it) and kept as numpy; the port's tree is built from the same
    points."""
    pts, qs = _cloud()
    jtree = joct.build_octree(pts, depth=DEPTH)
    ttree = toct.build_octree(pts, depth=DEPTH)
    out = {}
    for k, arms in ((8, ("ee", "noexit", "pray")), (2, ("ee", "pray"))):
        for arm in arms:
            if arm == "pray":
                ri, rc, cc = jbq.ball_query_pray(jnp.asarray(pts),
                                                 jnp.asarray(qs), RADIUS, k,
                                                 depth=PRAY_DEPTH)
            else:
                ri, rc, cc = jbq.ball_query_psphere(
                    jtree, jnp.asarray(qs), RADIUS, k, chunk=CHUNK,
                    early_exit=arm == "ee")
            out[(k, arm)] = (np.asarray(ri), np.asarray(rc), _counters(cc))
    return pts, qs, ttree, out


def test_point_aabb_sq_distance_matches_reference():
    rs = np.random.RandomState(1)
    p = rs.uniform(-2, 2, (4000, 3)).astype(np.float32)
    c = rs.uniform(-1, 1, (4000, 3)).astype(np.float32)
    h = rs.uniform(0.0, 1.5, (4000, 3)).astype(np.float32)
    p[:500] = c[:500]                                 # inside: 0
    want = np.asarray(jgeo.point_aabb_sq_distance(
        jnp.asarray(p), jnp.asarray(c), jnp.asarray(h)))
    got = tgeo.point_aabb_sq_distance(torch.from_numpy(p),
                                      torch.from_numpy(c),
                                      torch.from_numpy(h)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (got[:500] == 0).all() and (got[500:] > 0).any()
    # broadcast: one point against every box
    got_b = tgeo.point_aabb_sq_distance(torch.from_numpy(p[:1]),
                                        torch.from_numpy(c),
                                        torch.from_numpy(h)).numpy()
    want_b = np.asarray(jgeo.point_aabb_sq_distance(
        jnp.asarray(p[:1]), jnp.asarray(c), jnp.asarray(h)))
    assert np.array_equal(got_b, want_b)


def test_random_aabbs_shapes_and_seeding():
    a = tgeo.random_aabbs(torch.Generator().manual_seed(4), 257)
    b = tgeo.random_aabbs(torch.Generator().manual_seed(4), 257)
    o = tgeo.random_aabbs(torch.Generator().manual_seed(5), 257)
    ref = jgeo.random_aabbs(jax.random.PRNGKey(4), 257)
    assert a.center.shape == a.half.shape == ref.center.shape == (257, 3)
    assert a.center.dtype == torch.float32 and a.n == 257
    assert torch.equal(a.center, b.center) and torch.equal(a.half, b.half)
    assert not torch.equal(a.center, o.center)
    assert bool((a.center >= -1).all() and (a.center < 1).all())
    assert bool((a.half >= 0.02).all() and (a.half < 0.25).all())
    # the same first draws as random_obbs on the same seed
    obbs = tgeo.random_obbs(torch.Generator().manual_seed(4), 257)
    assert torch.equal(obbs.center, a.center)
    assert torch.equal(obbs.half, a.half)


@pytest.mark.parametrize("idx,n", [(0, 3000), (3, 3000), (9, 20000)])
def test_make_mpaccel_scenario_matches_reference(idx, n):
    """Both point-sampling routes (per point below 20,000 points,
    vectorised from 20,000 on) and the seed ``1000 + idx``."""
    got, want = trob.make_mpaccel_scenario(idx, n), \
        jrob.make_mpaccel_scenario(idx, n)
    assert got.name == want.name == f"mpaccel_{idx}"
    assert got.points.shape == (n, 3) and got.points.dtype == np.float32
    for f in ("points", "boxes_lo", "boxes_hi", "robot_base"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert 3 <= len(got.boxes_lo) <= 6
    other = trob.make_mpaccel_scenario(idx + 1, n)
    assert not np.array_equal(other.points, got.points)


def test_merge_candidates_matches_reference():
    """Queries with earlier hits, queries that fill up within the batch,
    misses, and a full query whose hits are dropped."""
    rs = np.random.RandomState(2)
    M, K, E = 7, 5, 300
    out0 = np.full((M, K), -1, np.int32)
    cnt0 = np.asarray([0, 2, 5, 4, 0, 1, 3], np.int32)
    for m in range(M):
        out0[m, :cnt0[m]] = rs.randint(0, 1000, cnt0[m])
    q = rs.randint(-1, M, E).astype(np.int32)
    p = rs.randint(0, 1000, E).astype(np.int32)
    hit = (rs.uniform(size=E) < 0.15) & (q >= 0)
    want_i, want_c = jbq._merge_candidates(
        jnp.asarray(out0), jnp.asarray(cnt0), jnp.asarray(q),
        jnp.asarray(p), jnp.asarray(hit))
    got_i, got_c = tbq._merge_candidates(
        torch.from_numpy(out0), torch.from_numpy(cnt0), torch.from_numpy(q),
        torch.from_numpy(p), torch.from_numpy(hit))
    assert got_i.dtype == got_c.dtype == torch.int32
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))
    assert (got_c.numpy() == K).sum() >= 3          # several filled up


def test_traverse_to_leaves_cut_at_max_frontier(tree_cases):
    """A frontier past ``max_frontier`` keeps its first pairs, as the
    reference does (a cut it does not report).  The cut falls on the
    deepest level that is wider than every level above it, so the levels
    above keep the fixture's shapes (and the reference's compiled ops)."""
    pts, qs, ttree, _ = tree_cases
    jtree = joct.build_octree(pts, depth=DEPTH)
    full = tcounters.Counters()
    tbq._traverse_to_leaves(ttree, torch.from_numpy(qs), RADIUS, full)
    widths = full.nodes_per_level
    lvl = max(lv for lv in range(1, len(widths))
              if widths[lv] > max(widths[:lv]))
    cap = (max(widths[:lvl]) + widths[lvl]) // 2
    cj, ct = jcounters.Counters(), tcounters.Counters()
    jq, jc = jbq._traverse_to_leaves(jtree, jnp.asarray(qs), RADIUS, cj,
                                     max_frontier=cap)
    tq, tc = tbq._traverse_to_leaves(ttree, torch.from_numpy(qs), RADIUS,
                                     ct, max_frontier=cap)
    assert ct.nodes_per_level[:lvl + 1] == widths[:lvl] + [cap]
    assert tq.dtype == tc.dtype == torch.int32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(tc.numpy().view(np.uint32), np.asarray(jc))
    assert _counters(ct) == _counters(cj)


@pytest.mark.parametrize("k,arm", [(8, "ee"), (8, "noexit"), (8, "pray"),
                                   (2, "ee"), (2, "pray")])
def test_tree_forms_match_reference(tree_cases, k, arm):
    pts, qs, ttree, ref = tree_cases
    if arm == "pray":
        idx, cnt, c = tbq.ball_query_pray(torch.from_numpy(pts),
                                          torch.from_numpy(qs), RADIUS, k,
                                          depth=PRAY_DEPTH)
    else:
        idx, cnt, c = tbq.ball_query_psphere(
            ttree, torch.from_numpy(qs), RADIUS, k, chunk=CHUNK,
            early_exit=arm == "ee")
    want_i, want_c, want_counters = ref[(k, arm)]
    assert idx.dtype == cnt.dtype == torch.int32
    assert idx.shape == (N_Q, k) and cnt.shape == (N_Q,)
    assert np.array_equal(cnt.numpy(), want_c)
    assert np.array_equal(idx.numpy(), want_i)
    assert _counters(c) == want_counters
    assert c.wall_time_s > 0


def test_cases_take_several_rounds_and_no_ties(tree_cases):
    pts, qs, ttree, ref = tree_cases
    assert _leaf_ties(ttree, qs, RADIUS) == 0
    ee, ne = ref[(8, "ee")], ref[(8, "noexit")]
    full = ee[1] == 8
    assert 0 < full.sum() < N_Q                      # some fill, some not
    assert (ref[(2, "ee")][1] == 2).all()            # every query fills
    # the early exit saves nodes and keeps counts; leaves of several ranks
    assert ee[2]["nodes_traversed"] < ne[2]["nodes_traversed"]
    assert np.array_equal(ee[1], ne[1])
    c = tcounters.Counters()
    tbq._traverse_to_leaves(ttree, torch.from_numpy(qs), RADIUS, c)
    assert c.nodes_per_level[-1] > 2 * CHUNK * N_Q


def test_three_ways_agree_on_counts(tree_cases):
    """P-Sphere, P-Ray and the brute force count alike; P-Ray lists the
    brute force's first k by index, P-Sphere k of the ball's points."""
    pts, qs, ttree, _ = tree_cases
    P, Q = torch.from_numpy(pts), torch.from_numpy(qs)
    ball, n_ball = tbq.ball_query_ref(P, Q, RADIUS, N_PTS)
    for k in (2, 8, 64):
        bi, bc = tbq.ball_query_ref(P, Q, RADIUS, k)
        si, sc, _ = tbq.ball_query_psphere(ttree, Q, RADIUS, k, chunk=CHUNK)
        ri, rc, _ = tbq.ball_query_pray(P, Q, RADIUS, k, depth=PRAY_DEPTH)
        assert torch.equal(sc, bc) and torch.equal(rc, bc)
        assert torch.equal(ri, bi)
        for m in range(N_Q):
            n = int(bc[m])
            assert set(si[m, :n].tolist()) <= set(
                ball[m, :int(n_ball[m])].tolist())
            assert len(set(si[m, :n].tolist())) == n
            assert (si[m, n:] == -1).all()


def test_converted_tree_answers_alike(tree_cases):
    """A tree carried across from the reference, point storage included,
    gives the port's own tree's answers."""
    pts, qs, ttree, _ = tree_cases
    conv = convert.octree_from_reference(joct.build_octree(pts,
                                                           depth=DEPTH))
    a = tbq.ball_query_psphere(conv, torch.from_numpy(qs), RADIUS, 8,
                               chunk=CHUNK)
    b = tbq.ball_query_psphere(ttree, torch.from_numpy(qs), RADIUS, 8,
                               chunk=CHUNK)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert _counters(a[2]) == _counters(b[2])


def test_psphere_needs_point_storage():
    pts, qs = _cloud()
    t = toct.build_octree(pts, depth=3)
    bare = convert.octree_from_arrays(
        t.scene_lo, t.scene_size, t.depth,
        [dict(codes=lv.codes, full=lv.full, child_start=lv.child_start,
              child_mask=lv.child_mask) for lv in t.levels])
    with pytest.raises(ValueError, match="point storage"):
        tbq.ball_query_psphere(bare, torch.from_numpy(qs), RADIUS, 4)
