"""Port parity: Monte Carlo Localization (Fig. 19) and its ray march.

``repro_torch.core.mcl`` against ``repro.core.mcl`` on the same inputs.
The reference runs under ``jax.disable_jit()`` (its jitted march may
contract ``pos + dirv * step`` into a fused multiply-add; ROADMAP C.5).
cos and sin differ in the last bit between XLA and torch on ~5 % of
float32 angles, and a ray whose direction differs by an ulp can step into
another cell, so the port's ``ray_directions`` is swapped for the
reference's ``jnp.cos`` / ``jnp.sin`` of the same angles: ranges and cells
are then held bit for bit.  The filter's mean, softmax and cumulative sum
run in another order in XLA than in torch: weights are held to rtol 1e-5,
resampling indices exactly, and the test asserts that no step of the
systematic resampling lies within 1e-6 of a cumulative weight.  The
reference's march is slow to run eagerly (~2 s a dense cast, ~6 s a
compacted one at grid 96), so the module casts three times in all (a
dense and a compacted cast, and the filter step's).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mcl as jmcl
from repro.core import octree as joct
from repro.engine import executor as jexe
from repro_torch import convert
from repro_torch.core import mcl as tmcl
from repro_torch.core.geometry import OBBs
from repro_torch.engine.executor import CollisionEngine, EngineConfig
from repro_torch.kernels.march.cases import (FIG19_GRID_SEED, ray_cases,
                                             wall_points)
from repro_torch.kernels.march.ref import march_ref

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

GRID, RANGE = 96, 4.0
P, A, SIGMA = 24, 8, 0.5
# a footprint small enough that some particles of the grid-96 world are
# free and some collide
FOOTPRINT = (0.1, 0.1, 0.4)


def _key_seed(key) -> int:
    return int(jax.random.randint(key, (), 0, 2**31 - 1))


def _ref_dirs(angles: torch.Tensor) -> torch.Tensor:
    a = jnp.asarray(angles.detach().numpy())
    return torch.from_numpy(np.stack([np.asarray(jnp.cos(a)),
                                      np.asarray(jnp.sin(a))], -1))


@pytest.fixture
def ref_dirs(monkeypatch):
    monkeypatch.setattr(tmcl, "ray_directions", _ref_dirs)


@pytest.fixture(scope="module")
def world():
    key = jax.random.PRNGKey(0)
    jgrid = jmcl.make_corridor_world(key, size=GRID)
    return key, jgrid, convert.grid_from_reference(jgrid, device="cpu")


@pytest.mark.parametrize("key,size,boxes", [(0, 96, 24), (3, 64, 5),
                                            (7, 256, 24)])
def test_make_corridor_world_from_the_reference_key(key, size, boxes):
    k = jax.random.PRNGKey(key)
    want = np.asarray(jmcl.make_corridor_world(k, size=size,
                                               n_boxes=boxes).occ)
    got = tmcl.make_corridor_world(_key_seed(k), size=size, n_boxes=boxes,
                                   device="cpu")
    assert got.occ.dtype == torch.bool and got.shape == (size, size)
    assert np.array_equal(got.occ.numpy(), want)
    assert got.cell == 0.05 and got.origin == (0.0, 0.0)


def test_fig19_grid_seed_is_the_reference_key_draw():
    assert _key_seed(jax.random.PRNGKey(0)) == FIG19_GRID_SEED


def test_march_ref_matches_reference_steps(world):
    """Rays on cell corners and edges along the axes and diagonals, rays
    that leave the grid: 12 steps of the reference's ``_march_step``."""
    _, jgrid, tgrid = world
    cases = ray_cases(tgrid.shape, tgrid.cell, seed=1)
    org = np.concatenate([cases["grazing"][0], cases["leaving"][0]])
    ang = np.concatenate([cases["grazing"][1], cases["leaving"][1]])
    dirv = _ref_dirs(torch.from_numpy(ang))
    R = len(ang)
    jp, jd = jnp.asarray(org), jnp.zeros((R,))
    ja = jnp.ones((R,), bool)
    with jax.disable_jit():
        for _ in range(12):
            jp, jd, ja = jmcl._march_step(jgrid, jp, jnp.asarray(
                dirv.numpy()), jd, ja, RANGE)
    pos, dist = torch.from_numpy(org.copy()), torch.zeros(R)
    active = torch.ones(R, dtype=torch.bool)
    march_ref(tgrid.occ, tgrid.origin, tgrid.cell, pos, dirv, dist, active,
              RANGE, 12)
    assert np.array_equal(pos.numpy(), np.asarray(jp))
    assert np.array_equal(dist.numpy(), np.asarray(jd))
    assert np.array_equal(active.numpy(), np.asarray(ja))
    assert 0 < int(active.sum()) < R       # some rays ended, some did not


def test_ray_casts_match_reference(world, ref_dirs):
    _, jgrid, tgrid = world
    rs = np.random.RandomState(2)              # test_substrate.py's rays
    org = rs.uniform(0.5, 4.0, (50, 2)).astype(np.float32)
    ang = rs.uniform(-np.pi, np.pi, 50).astype(np.float32)
    with jax.disable_jit():
        r1, c1 = jmcl.ray_cast_dense(jgrid, jnp.asarray(org),
                                     jnp.asarray(ang), RANGE)
        r2, c2 = jmcl.ray_cast_compacted(jgrid, jnp.asarray(org),
                                         jnp.asarray(ang), RANGE)
    t1, d1 = tmcl.ray_cast_dense(tgrid, torch.from_numpy(org),
                                 torch.from_numpy(ang), RANGE)
    t2, d2 = tmcl.ray_cast_compacted(tgrid, torch.from_numpy(org),
                                     torch.from_numpy(ang), RANGE)
    assert t1.dtype == t2.dtype == torch.float32
    assert np.array_equal(t1.numpy(), np.asarray(r1)) and d1 == c1
    assert np.array_equal(t2.numpy(), np.asarray(r2)) and d2 == c2
    assert torch.equal(t1, t2) and d2 < d1     # compaction retired rays
    assert (t1 > 0).all() and (t1 <= RANGE + tgrid.cell).all()


class _Recording:
    """An engine whose queries are kept (the OBBs and the verdicts)."""

    def __init__(self, engine):
        self.engine, self.calls = engine, []

    def query(self, obbs):
        v, c = self.engine.query(obbs)
        self.calls.append((obbs, np.asarray(v)))
        return v, c


@pytest.fixture(scope="module")
def gated_step(world):
    """One gated reference step (dense cast; the reference's own draws),
    with its softmax weights and footprint OBBs kept, and the gate scene
    (the grid's walls, 0.8 m tall, depth 5)."""
    key, jgrid, tgrid = world
    tree = joct.build_octree(wall_points(np.asarray(jgrid.occ), jgrid.cell),
                             depth=5)
    angles = jnp.linspace(-np.pi, np.pi, A, endpoint=False)
    # the scan from the true pose (2, 2, 0.4), an input to both filters
    obs = tmcl.ray_cast_dense(tgrid, torch.full((A, 2), 2.0),
                              0.4 + torch.from_numpy(np.array(angles)),
                              RANGE)[0].numpy()
    seen = []
    orig = jax.nn.softmax

    def softmax(x, *a, **k):
        out = orig(x, *a, **k)
        seen.append(np.asarray(out))
        return out
    jeng = _Recording(jexe.CollisionEngine(tree, jexe.EngineConfig()))
    step_key = jax.random.PRNGKey(10)
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jax.nn, "softmax", softmax)
        st = jmcl.init_particles(jax.random.PRNGKey(1), jgrid, P)
        new, stats = jmcl.mcl_step(step_key, st, jgrid, jnp.asarray(obs),
                                   angles, jnp.zeros(3), "dense",
                                   max_range=RANGE,
                                   sigma=SIGMA, collision_engine=jeng,
                                   footprint_half=FOOTPRINT)
    k1, k2 = jax.random.split(step_key)
    noise = np.array(jax.random.normal(k1, (P, 3))
                     * jnp.asarray([0.02, 0.02, 0.02]))
    u = np.asarray(jax.random.uniform(k2, ()))
    return dict(tree=convert.octree_from_reference(tree), obs=obs,
                angles=np.array(angles), parts=np.array(st.particles),
                new=np.array(new.particles), stats=stats, w=seen[-1],
                noise=noise, u=u, obbs=jeng.calls[0][0],
                verdicts=jeng.calls[0][1])


def _torch_obbs(obbs) -> OBBs:
    return OBBs(*(torch.from_numpy(np.array(getattr(obbs, f)))
                  for f in ("center", "half", "rot")))


def test_particle_collision_mask_matches_reference(gated_step):
    """The gate on the reference's footprint OBBs, carried across: verdicts
    exact; the port's own OBBs within float32 rounding of them."""
    g = gated_step
    parts = torch.from_numpy(g["parts"] + g["noise"])
    mine = tmcl.footprint_obbs(parts, FOOTPRINT)
    ref = _torch_obbs(g["obbs"])
    for f in ("center", "half", "rot"):
        torch.testing.assert_close(getattr(mine, f), getattr(ref, f),
                                   rtol=0, atol=1e-6)
    for mode in ("wavefront_persistent", "wavefront"):
        eng = CollisionEngine(g["tree"], EngineConfig(mode=mode),
                              device="cpu")
        v, _ = eng.query(ref)
        assert np.array_equal(v, g["verdicts"]), mode
    assert 0 < g["verdicts"].sum() < P          # some collide, some not


def test_mcl_update_matches_reference(world, gated_step, ref_dirs,
                                     monkeypatch):
    """One gated step on the reference's draws: cells and the collision
    count exact, weights to rtol 1e-5, resampled particles exact (no step
    of the resampling lies within 1e-6 of a cumulative weight)."""
    g = gated_step
    ref_obbs = _torch_obbs(g["obbs"])
    monkeypatch.setattr(tmcl, "footprint_obbs", lambda *a, **k: ref_obbs)
    seen = []
    weights = tmcl.particle_weights
    monkeypatch.setattr(tmcl, "particle_weights",
                        lambda *a: seen.append(weights(*a)) or seen[-1])
    tgrid = world[2]
    eng = CollisionEngine(g["tree"], EngineConfig(mode="wavefront_persistent"),
                          device="cpu")
    state = tmcl.MCLState(torch.from_numpy(g["parts"].copy()),
                          torch.full((P,), 1.0 / P))
    new, stats = tmcl.mcl_update(
        state, tgrid, torch.from_numpy(g["obs"]),
        torch.from_numpy(g["angles"]), torch.zeros(3),
        torch.from_numpy(g["noise"]), float(g["u"]), "dense",
        max_range=RANGE, sigma=SIGMA, collision_engine=eng,
        footprint_half=FOOTPRINT)
    want = g["stats"]
    assert {k: v for k, v in stats.items() if k != "time_s"} == {
        k: v for k, v in want.items() if k != "time_s"}
    assert 0 < stats["colliding_particles"] < P
    np.testing.assert_allclose(seen[0].numpy(), g["w"], rtol=1e-5, atol=0)
    cum = np.cumsum(g["w"].astype(np.float64))
    steps = (np.float64(g["u"]) + np.arange(P)) / P
    near = np.abs(steps[:, None] - cum[None, :]).min(1) < 1e-6
    assert near.sum() == 0
    assert np.array_equal(new.particles.numpy(), g["new"])
    assert torch.equal(new.weights, torch.full((P,), 1.0 / P))


def test_filter_policies_agree_and_localise(world):
    """The port's own filter (Fig. 19's loop at a small size): dense,
    compacted and dynamic casts give the same particles step for step on
    the same draws, and the estimate moves towards the true pose."""
    _, _, tgrid = world
    angles = torch.linspace(-np.pi, np.pi, A + 1)[:-1]
    pose = torch.tensor([2.0, 2.0, 0.4])
    obs, _ = tmcl.ray_cast_dense(tgrid, pose[None, :2].repeat(A, 1),
                                 pose[2] + angles, RANGE)
    runs = {}
    for policy in ("dense", "compacted", "dynamic"):
        gen = torch.Generator().manual_seed(0)
        st = tmcl.init_particles(gen, tgrid, 96)
        hist, cells = 1e9, []
        for _ in range(4):
            eng = (policy if policy != "dynamic"
                   else tmcl.choose_engine(hist, threshold=30.0))
            st, stats = tmcl.mcl_step(gen, st, tgrid, obs, angles,
                                      torch.zeros(3), eng, max_range=RANGE,
                                      sigma=SIGMA)
            hist = stats["cells_per_ray"]
            cells.append(stats["cells"])
        runs[policy] = (st.particles, cells)
    assert torch.equal(runs["dense"][0], runs["compacted"][0])
    assert torch.equal(runs["dense"][0], runs["dynamic"][0])
    assert all(c < d for c, d in zip(runs["compacted"][1],
                                     runs["dense"][1]))
    assert runs["dynamic"][1][0] == runs["compacted"][1][0]


def test_choose_engine():
    assert tmcl.choose_engine(1e9, 60.0) == "compacted"
    assert tmcl.choose_engine(60.0, 60.0) == "compacted"
    assert tmcl.choose_engine(59.9, 60.0) == "dense"
    for v, t in ((0.0, 1.0), (80.0, 60.0), (12.5, 12.5)):
        assert tmcl.choose_engine(v, t) == jmcl.choose_engine(v, t)


def test_entry_points_on_cuda_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmcl.make_corridor_world(0, size=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.grid_from_reference(
            jmcl.make_corridor_world(jax.random.PRNGKey(0), size=32))
    grid = tmcl.make_corridor_world(0, size=32, device="cpu")
    gpu_gen = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError, match="CPU generator"):
        tmcl.init_particles(gpu_gen, grid, 4)
