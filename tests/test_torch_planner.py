"""Port parity: the neural-planner path (PointNet++ encoder, MpiNet-lite
policy, collision gate) against the JAX reference.

Weights come from the reference's ``init_planner`` and are carried across
by :func:`repro_torch.convert.planner_from_reference`; clouds, goals and
scenes come from numpy seeds.  The JAX side runs under
``jax.disable_jit()`` (XLA:CPU's jit may contract the squared distances
into fused multiply-adds, ROADMAP C.5).

Sampling and grouping indices must be exactly equal.  Features and
waypoints are held to a tolerance: the MLPs are fp32 matrix products that
the two libraries sum in another order (and XLA's dot may fuse its
multiply-adds), so each layer moves the last bits; at these widths
features agree to rtol 1e-5 / atol 1e-6 and 20-step waypoints to
rtol 1e-5 / atol 1e-5.  The gate's verdicts and every ``Counters`` field
must be bitwise equal on the same OBB arrays; forward kinematics (another
library's sin/cos and matmul order) only to a tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipe
from repro.core.ballquery import ball_query_ref as jball
from repro.data import robotics as jrob
from repro.core import octree as joct
from repro.engine import executor as jexe
from repro.engine import plan as jplan
from repro.models import planner as jplanner
from repro.models import pointnet as jpointnet
from repro_torch.convert import octree_from_reference, planner_from_reference
from repro_torch.core import pipeline as tpipe
from repro_torch.engine import plan as tplan
from repro_torch.engine.executor import CollisionEngine, EngineConfig
from repro_torch.kernels import _build
from repro_torch.models.common import dense_init
from repro_torch.models.planner import Planner

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

FEAT, HIDDEN = 32, 64
SIZES = dict(n1=64, n2=16, n3=8)
FEAT_TOL = dict(rtol=1e-5, atol=1e-6)
WAYPOINT_TOL = dict(rtol=1e-5, atol=1e-5)
PERSIST = "wavefront_persistent"


@pytest.fixture(scope="module")
def planners():
    params = jplanner.init_planner(jax.random.PRNGKey(0), feat_dim=FEAT,
                                   hidden=HIDDEN)
    params = jax.tree_util.tree_map(np.asarray, params)
    port = Planner(feat_dim=FEAT, hidden=HIDDEN, device="cpu")
    port.load_state_dict(planner_from_reference(params), strict=True)
    return params, port.eval()


@pytest.fixture(scope="module")
def clouds():
    rs = np.random.RandomState(11)
    return rs.uniform(-0.2, 0.2, (2, 256, 3)).astype(np.float32)


def _index_of(pts, centers):
    """Each centre's row index in ``pts`` (the points are distinct)."""
    eq = (centers[:, None, :] == pts[None, :, :]).all(-1)
    assert (eq.sum(-1) == 1).all()
    return eq.argmax(-1).astype(np.int32)


def _jax_layers(params, xyz):
    """The reference's three set-abstraction layers, with the sampling and
    grouping indices each one used (per cloud, as its ``vmap`` does)."""
    out = []
    pts, feats = jnp.asarray(xyz), None
    for name, n, r, k in (("sa1", SIZES["n1"], 0.1, 16),
                          ("sa2", SIZES["n2"], 0.25, 16),
                          ("sa3", SIZES["n3"], 0.6, 8)):
        centers, f = jpointnet.set_abstraction(params["pointnet"][name], pts,
                                               feats, n, r, k, "fps")
        cidx = np.stack([_index_of(np.asarray(p), np.asarray(c))
                         for p, c in zip(pts, centers)])
        groups = [jball(p, c, r, k) for p, c in zip(pts, centers)]
        out.append(dict(center_idx=cidx, centers=np.asarray(centers),
                        neighbor_idx=np.stack([np.asarray(g[0])
                                               for g in groups]),
                        count=np.stack([np.asarray(g[1]) for g in groups]),
                        feats=np.asarray(f)))
        pts, feats = centers, f
    return out


def test_dense_init_is_a_two_sigma_truncated_normal():
    w = dense_init(torch.Generator().manual_seed(0), (400, 300))
    std = (1 / 400) ** 0.5
    assert w.shape == (400, 300) and w.dtype == torch.float32
    assert float(w.abs().max()) <= 2 * std
    # a normal cut at +-2 sigma keeps 0.774 of its variance
    assert float(w.std()) == pytest.approx(std * 0.774 ** 0.5, rel=0.02)
    assert torch.equal(w, dense_init(torch.Generator().manual_seed(0),
                                     (400, 300)))


def test_planner_from_reference_loads_every_weight(planners):
    params, port = planners
    state = planner_from_reference(params)
    assert state.keys() == port.state_dict().keys()
    assert np.array_equal(port.fc1.weight.detach().numpy(),
                          params["fc1"]["w"].T)
    assert np.array_equal(port.pointnet.sa2.mlp1.weight.detach().numpy(),
                          params["pointnet"]["sa2"]["w1"].T)


def test_encoder_layers_match_reference(planners, clouds):
    params, port = planners
    with jax.disable_jit():
        want = _jax_layers(params, clouds)
    want_feat = want[-1]["feats"].max(1)        # pointnet_encode's last step
    with torch.no_grad():
        got = port.pointnet.encode_layers(torch.from_numpy(clouds), **SIZES)
        feat = port.pointnet(torch.from_numpy(clouds), **SIZES)
    for layer, w in zip(got, want):
        assert layer.center_idx.dtype == layer.neighbor_idx.dtype \
            == torch.int32
        for key in ("center_idx", "centers", "neighbor_idx", "count"):
            assert np.array_equal(getattr(layer, key).numpy(), w[key]), key
        np.testing.assert_allclose(layer.feats.numpy(), w["feats"],
                                   **FEAT_TOL)
    # some balls are short of k, some full: masking and padding both run
    counts = got[0].count
    assert (counts < 16).any() and (counts == 16).any()
    assert feat.shape == (2, FEAT)
    np.testing.assert_allclose(feat.numpy(), want_feat, **FEAT_TOL)


def test_policy_and_rollout_match_reference(planners, clouds):
    params, port = planners
    rs = np.random.RandomState(4)
    q0 = rs.uniform(-1, 1, (2, 7)).astype(np.float32)
    goal = rs.uniform(-1, 1, (2, 7)).astype(np.float32)
    goal[1] = q0[1] + 0.05          # the second plan snaps onto its goal
    feat = rs.normal(size=(2, FEAT)).astype(np.float32)
    with jax.disable_jit():
        want_dq = np.asarray(jplanner.planner_apply(
            params, jnp.asarray(feat), jnp.asarray(q0), jnp.asarray(goal)))
    # jit: op-by-op, the reference's 256-step FPS takes tens of seconds; its
    # sampling indices are held exactly above, its waypoints to a tolerance
    want = np.asarray(jax.jit(jplanner.rollout, static_argnums=(4, 5))(
        params, jnp.asarray(clouds), jnp.asarray(q0), jnp.asarray(goal), 20,
        "fps"))
    with torch.no_grad():
        dq = port(torch.from_numpy(feat), torch.from_numpy(q0),
                  torch.from_numpy(goal))
        got = port.rollout(torch.from_numpy(clouds), torch.from_numpy(q0),
                           torch.from_numpy(goal), 20)
    np.testing.assert_allclose(dq.numpy(), want_dq, **FEAT_TOL)
    assert got.shape == want.shape == (2, 21, 7)
    np.testing.assert_allclose(got.numpy(), want, **WAYPOINT_TOL)
    assert np.array_equal(got[1, -1].numpy(), goal[1])


def test_plan_trajectory_shape_matches_reference():
    rs = np.random.RandomState(1)
    wp = rs.uniform(-1, 1, (3, 5, 7)).astype(np.float32)
    want = jplan.plan_trajectory(jnp.asarray(wp))
    got = tplan.plan_trajectory(torch.from_numpy(wp))
    assert got.kind == want.kind == "trajectory"
    assert got.out_shape == tuple(want.out_shape) == (3, 5, 7)
    assert got.reduce_last and want.reduce_last
    for g, w in ((got.obb_c, want.obb_c), (got.obb_h, want.obb_h),
                 (got.obb_r, want.obb_r)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    flags = got.unflatten(np.arange(3 * 5 * 7) % 11 == 0)
    assert flags.shape == (3, 5)


@pytest.fixture(scope="module")
def scene():
    sc = jrob.make_scene("tabletop", num_points=8192)
    tree = joct.build_octree(sc.points, depth=4)
    return sc, tree, octree_from_reference(tree)


def _jax_engine(tree):
    cfg = jexe.EngineConfig(mode=PERSIST, stream_meta=False,
                            meta_format="fp32", use_pallas_traverse=True)
    return jexe.CollisionEngine(tree, cfg)


def _trajectories(sc, n=3, steps=12, seed=8):
    """Straight joint-space paths between random configurations (some
    collide with the table-top scene, some do not)."""
    rs = np.random.RandomState(seed)
    lo, hi = jrob.PANDA_JOINT_LO, jrob.PANDA_JOINT_HI
    a = rs.uniform(lo, hi, (n, 7)).astype(np.float32)
    b = rs.uniform(lo, hi, (n, 7)).astype(np.float32)
    t = np.linspace(0, 1, steps, dtype=np.float32)[None, :, None]
    return ((1 - t) * a[:, None] + t * b[:, None]).astype(np.float32)


def _same_counters(got, want):
    a, b = got.as_dict(), want.as_dict()
    assert a.keys() == b.keys()
    for k in a:
        if k != "wall_time_s":
            assert a[k] == b[k], k


@pytest.mark.parametrize("batched", [False, True])
def test_gate_on_reference_obbs_matches_reference(scene, batched):
    sc, tree, ttree = scene
    wp = _trajectories(sc)
    if not batched:
        wp = wp[0]
    with jax.disable_jit():
        jp = jplan.plan_trajectory(jnp.asarray(wp))
        check = jpipe.check_trajectories if batched else \
            jpipe.check_trajectory
        want_flags, want_c = check(_jax_engine(tree), jnp.asarray(wp))
    plan = tplan.QueryPlan(
        kind="trajectory", out_shape=tuple(jp.out_shape), reduce_last=True,
        **{f: torch.from_numpy(np.asarray(getattr(jp, f)).copy())
           for f in ("obb_c", "obb_h", "obb_r")})
    flags, c = CollisionEngine(ttree, EngineConfig(mode=PERSIST),
                               device="cpu").execute(plan)
    assert flags.shape == wp.shape[:-1]
    assert np.array_equal(flags, np.asarray(want_flags))
    _same_counters(c, want_c)
    assert flags.any() and not flags.all()


def test_gate_on_streamed_bf16_rows_matches_reference(planners, scene):
    """The gate on a persistent engine with streamed bf16 rows: on the
    reference's OBBs its flags and every counter equal the reference's;
    ``plan_with_collision_gate`` on that engine gates its own trajectory
    as ``check_trajectory`` does."""
    sc, tree, ttree = scene
    wp = _trajectories(sc)[0]
    cfg = dict(mode=PERSIST, stream_meta=True, meta_format="bf16")
    with jax.disable_jit():
        jp = jplan.plan_trajectory(jnp.asarray(wp))
        want_flags, want_c = jpipe.check_trajectory(
            jexe.CollisionEngine(tree, jexe.EngineConfig(**cfg)),
            jnp.asarray(wp))
    plan = tplan.QueryPlan(
        kind="trajectory", out_shape=tuple(jp.out_shape), reduce_last=True,
        **{f: torch.from_numpy(np.asarray(getattr(jp, f)).copy())
           for f in ("obb_c", "obb_h", "obb_r")})
    engine = CollisionEngine(ttree, EngineConfig(**cfg), device="cpu")
    flags, c = engine.execute(plan)
    assert np.array_equal(flags, np.asarray(want_flags))
    _same_counters(c, want_c)
    assert flags.any() and c.meta_rows_streamed > 0
    _, port = planners
    rs = np.random.RandomState(2)
    cloud = sc.points[rs.choice(len(sc.points), 256, replace=False)]
    q0, goal = rs.uniform(-1, 1, (2, 7)).astype(np.float32)
    res = tpipe.plan_with_collision_gate(port, engine, cloud, q0, goal,
                                         num_steps=6, sampling="fps")
    fresh = CollisionEngine(ttree, EngineConfig(**cfg), device="cpu")
    flags, counters = tpipe.check_trajectory(fresh, res.trajectory)
    assert np.array_equal(res.colliding_waypoints, flags)
    _same_counters(res.counters, counters)
    assert counters.meta_rows_streamed > 0


def test_plan_with_collision_gate_end_to_end(planners, scene):
    _, port = planners
    sc, tree, ttree = scene
    rs = np.random.RandomState(2)
    cloud = sc.points[rs.choice(len(sc.points), 256, replace=False)]
    q0 = rs.uniform(-1, 1, 7).astype(np.float32)
    goal = rs.uniform(-1, 1, 7).astype(np.float32)
    engine = CollisionEngine(ttree, EngineConfig(mode="wavefront_fused"),
                             device="cpu")
    before = _build.launch_counts()
    res = tpipe.plan_with_collision_gate(port, engine, cloud, q0, goal,
                                         num_steps=10, sampling="fps")
    assert _build.launch_counts() == before          # CPU: no kernel
    with torch.no_grad():
        want = port.rollout(torch.from_numpy(cloud)[None],
                            torch.from_numpy(q0)[None],
                            torch.from_numpy(goal)[None], 10)[0]
    assert np.array_equal(res.trajectory, want.numpy())
    # a fresh engine: `engine` remembers the gate's clean capacity, so a
    # gate that escalated would be checked against a run that need not
    fresh = CollisionEngine(ttree, EngineConfig(mode="wavefront_fused"),
                            device="cpu")
    flags, counters = tpipe.check_trajectory(fresh, res.trajectory)
    assert np.array_equal(res.colliding_waypoints, flags)
    assert res.collision_free == (not flags.any())
    assert flags.shape == (11,) and counters.num_queries == 11 * 7
    _same_counters(res.counters, counters)
    assert set(res.timings) == {"encode_s", "rollout_s", "plan_s",
                                "collision_s"}
    assert res.timings["plan_s"] == pytest.approx(
        res.timings["encode_s"] + res.timings["rollout_s"])
    # random sampling: a seeded CPU generator gives a repeatable plan
    runs = [tpipe.plan_with_collision_gate(
        port, engine, cloud, q0, goal, num_steps=4, sampling="random",
        generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert np.array_equal(runs[0].trajectory, runs[1].trajectory)


def test_unknown_sampling_raises(planners, clouds):
    _, port = planners
    with pytest.raises(ValueError, match="sampling"):
        port.encode_cloud(torch.from_numpy(clouds), sampling="grid")
