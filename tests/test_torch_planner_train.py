"""Port parity: planner training (behaviour cloning) against the reference.

Weights come from the reference's ``init_planner`` and are carried across
by :func:`repro_torch.convert.planner_from_reference`, optimizer states by
:func:`repro_torch.convert.opt_state_from_reference`; clouds and expert
tuples come from numpy seeds.  The reference's loss and gradients are
``jax.jit(jax.value_and_grad(planner_loss))``, as the reference's
example runs it, with ``sampling="fps"`` (the reference's random sampling
cannot be matched, C.11); XLA:CPU may contract FPS's and the ball query's
squared distances into fused multiply-adds (ROADMAP C.5), which on these
random clouds flips no sampling or grouping index (the port's indices are
held to the reference's op by op in ``test_torch_planner.py``).  The loss and
every gradient are fp32 products and sums in another order at widths of
64: held to rtol 1e-5 (atol 1e-7 for entries near 0).  The expert data is
gated by each package's engine on the reference's forward-kinematics
arrays (the port's FK agrees only to a tolerance, C.15), so the arrays,
which every later draw of the ``RandomState`` depends on, are equal bit
for bit.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import geometry as jgeo
from repro.core.octree import build_octree as jbuild_octree
from repro.core.wavefront import CollisionEngine as JEngine
from repro.core.wavefront import EngineConfig as JEngineConfig
from repro.data.robotics import make_scene as jmake_scene
from repro.models import planner as jplanner
from repro.train import optimizer as jopt
from repro_torch.convert import (octree_from_reference,
                                 opt_state_from_reference,
                                 planner_from_reference)
from repro_torch.core.geometry import OBBs
from repro_torch.engine import plan as tplan
from repro_torch.engine.executor import CollisionEngine, EngineConfig
from repro_torch.launch import train_planner as tp
from repro_torch.models.planner import Planner, planner_loss
from repro_torch.train import optimizer as topt

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

FEAT = HIDDEN = 64
B, N = 4, 256
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)
EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "train_planner.py"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def planners():
    params = _np(jplanner.init_planner(jax.random.PRNGKey(3), feat_dim=FEAT,
                                       hidden=HIDDEN))
    port = Planner(feat_dim=FEAT, hidden=HIDDEN, device="cpu")
    port.load_state_dict(planner_from_reference(params), strict=True)
    return params, port


def _batch(seed: int, tie: bool):
    """B clouds of N points; with ``tie`` every cloud holds one point twice
    (a ball that holds both ties with itself in the max-pool)."""
    rs = np.random.RandomState(seed)
    cloud = rs.uniform(-0.3, 0.3, (B, N, 3)).astype(np.float32)
    if tie:
        cloud[:, 7] = cloud[:, 3]
    return {"cloud": cloud,
            "q": rs.uniform(-1, 1, (B, 7)).astype(np.float32),
            "goal": rs.uniform(-1, 1, (B, 7)).astype(np.float32),
            "expert_delta": rs.uniform(-0.3, 0.3, (B, 7)).astype(np.float32)}


_REF_LOSS_GRAD = jax.jit(jax.value_and_grad(
    lambda p, c, b: jplanner.planner_loss(p, dict(b, cloud=c), "fps")[0],
    argnums=(0, 1)))


def _reference_loss_and_grads(params, batch):
    """The loss and its gradients to the parameters and to the cloud."""
    loss, (grads, dcloud) = _REF_LOSS_GRAD(
        jax.tree_util.tree_map(jnp.asarray, params),
        jnp.asarray(batch["cloud"]),
        {k: jnp.asarray(v) for k, v in batch.items() if k != "cloud"})
    return float(loss), _np(grads), np.asarray(dcloud)


@pytest.fixture(scope="module")
def references(planners):
    params, _ = planners
    out = {}
    for tie in (False, True):
        batch = _batch(5, tie)
        out[tie] = (batch,) + _reference_loss_and_grads(params, batch)
    return out


@pytest.mark.parametrize("tie", [False, True], ids=["plain", "tied"])
def test_planner_loss_and_every_gradient_match_reference(planners,
                                                         references, tie,
                                                         monkeypatch):
    """The loss, its gradient to every parameter and to the cloud.  In the
    tied batch a ball holds both copies of a point, and the max-pool ties
    between them: the reference splits the gradient evenly between the
    copies (so do the port's ``torch.amax`` pools; ``Tensor.max(dim)``
    would send it all to one), which the parameters' gradients cannot see
    (the copies compute alike) but the cloud's does."""
    _, port = planners
    batch, want_loss, want_grads, want_dcloud = references[tie]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["cloud"].requires_grad_()
    params = dict(port.named_parameters())
    loss, _ = planner_loss(port, tb, "fps")
    *grads, dcloud = torch.autograd.grad(loss, [*params.values(),
                                                tb["cloud"]])
    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-5)
    want = planner_from_reference(want_grads)
    assert params.keys() == want.keys()
    for name, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    np.testing.assert_allclose(dcloud.numpy(), want_dcloud, **GRAD_TOL)
    if tie:
        # the case tells the pools apart: one that sends a tie's gradient
        # to one index puts the cloud's gradient elsewhere
        with monkeypatch.context() as mp:
            mp.setattr(torch, "amax",
                       lambda x, dim: x.max(dim=dim).values)
            loss, _ = planner_loss(port, tb, "fps")
            one_index = torch.autograd.grad(loss, tb["cloud"])[0]
        assert not np.allclose(one_index.numpy(), want_dcloud, **GRAD_TOL)


def test_tied_neighbourhood_splits_the_max_gradient(planners):
    """The pools split a tie's gradient evenly, as ``jnp.max`` does, and
    the tied batch does hold a ball with both copies of its point."""
    _, port = planners
    h = torch.tensor([[[1.0, 2.0], [3.0, 2.0], [3.0, 0.5]]],
                     requires_grad=True)
    torch.amax(h, dim=1).sum().backward()
    assert h.grad.tolist() == [[[0.0, 0.5], [0.5, 0.5], [0.5, 0.0]]]
    batch = {k: torch.from_numpy(v) for k, v in _batch(5, True).items()}
    with torch.no_grad():
        layers = port.pointnet.encode_layers(batch["cloud"])
    nb = layers[0].neighbor_idx
    assert bool(((nb == 3).any(-1) & (nb == 7).any(-1)).any())


def test_adamw_steps_on_planner_match_reference(planners, references):
    """Three AdamW steps of the example's optimizer from the reference's
    gradients: parameters and moments within 1e-6 relative; the planner's
    tree is not stacked, so matrices are decayed and biases not."""
    params, port = planners
    _, _, grads, _ = references[False]
    cfg = jopt.OptConfig(lr=3e-4, warmup_steps=1, total_steps=5,
                         weight_decay=0.01)
    tcfg = topt.OptConfig(**dataclasses.asdict(cfg))
    jp, js = params, jopt.init_opt_state(params, cfg)
    tparams = {k: v.detach().clone() for k, v in port.state_dict().items()}
    ts = topt.init_opt_state(tparams, tcfg)
    tg = planner_from_reference(grads)
    update = jax.jit(jopt.adamw_update, static_argnums=3)
    for _ in range(3):
        jp, js, jm = update(jp, grads, js, cfg)
        _, ts, tm = topt.adamw_update(tparams, tg, ts, tcfg)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    want = planner_from_reference(_np(jp))
    want_state = opt_state_from_reference(_np(js), planner_from_reference)
    assert int(ts["step"]) == int(want_state["step"]) == 3
    for name in want:
        np.testing.assert_allclose(tparams[name].numpy(),
                                   want[name].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=name)
        for key in ("m", "v"):
            np.testing.assert_allclose(ts[key][name].numpy(),
                                       want_state[key][name].numpy(),
                                       rtol=1e-6, atol=1e-12,
                                       err_msg=f"{key} {name}")


def _load_example():
    spec = importlib.util.spec_from_file_location("_train_planner_example",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_make_expert_data_matches_reference_example(monkeypatch):
    """The example's expert on a small cubby scene (both packages' scenes
    built in this process: the seed mixes in ``hash(name)``, C.4), the
    port's engine on the reference's octree and FK arrays: every array and
    the ``RandomState`` after it equal."""
    example = _load_example()
    sc = jmake_scene("cubby", num_points=6000)
    jtree = jbuild_octree(sc.points, depth=5)
    jengine = JEngine(jtree, JEngineConfig(mode="wavefront_fused"))
    engine = CollisionEngine(octree_from_reference(jtree),
                             EngineConfig(mode="wavefront_fused"),
                             device="cpu")

    def reference_fk(waypoints, base_pos=None):
        ob = jgeo.arm_link_obbs(jnp.asarray(np.asarray(waypoints.cpu())),
                                base_pos=base_pos)
        return OBBs(*(torch.from_numpy(np.array(x)).to(waypoints.device)
                      for x in (ob.center, ob.half, ob.rot)))
    monkeypatch.setattr(tplan, "arm_link_obbs", reference_fk)
    rs_j, rs_t = np.random.RandomState(0), np.random.RandomState(0)
    want = example.make_expert_data(jengine, sc, 2, 8, rs_j)
    got = tp.make_expert_data(engine, sc, 2, 8, rs_t)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    # the gate took the detour branch at least once
    assert (np.abs(got[2]) < 0.4 - 1e-6).any()
    assert rs_t.randint(0, 1 << 30) == rs_j.randint(0, 1 << 30)


def test_planner_bc_loss_decreases():
    """The twin of ``test_substrate.py::test_planner_bc_loss_decreases``
    (its batch, widths, optimizer and 15 steps; FPS sampling): the loss
    falls below 0.8x its first value."""
    rs = np.random.RandomState(0)
    n = 16
    batch = {
        "cloud": torch.from_numpy(rs.uniform(-1, 1, (n, 256, 3))
                                  .astype(np.float32)),
        "q": torch.from_numpy(rs.uniform(-1, 1, (n, 7)).astype(np.float32)),
        "goal": torch.from_numpy(rs.uniform(-1, 1, (n, 7))
                                 .astype(np.float32)),
        "expert_delta": torch.from_numpy(
            rs.uniform(-0.3, 0.3, (n, 7)).astype(np.float32))}
    planner = Planner(feat_dim=64, hidden=64, device="cpu")
    cfg = topt.OptConfig(lr=3e-3, warmup_steps=0, total_steps=30)
    params = dict(planner.named_parameters())
    state = topt.init_opt_state(params, cfg)
    losses = []
    for _ in range(15):
        loss, grads = tp.loss_and_grads(planner, batch, "fps", None)
        topt.adamw_update(params, grads, state, cfg)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.8, losses


def test_train_planner_stages_run_on_cpu():
    """The example's three stages at a small size: setup, a few steps of
    the loop (random sampling), the gated evaluation."""
    data = tp.setup(device="cpu", num_points=4000, depth=4, episodes=1)
    assert data.qs.shape == (tp.EPISODE_STEPS, 7)
    assert data.cloud.shape == (tp.CLOUD_POINTS, 3)
    planner = Planner(feat_dim=32, hidden=32, device="cpu")
    losses, walls = tp.train(planner, data, 2, "random", batch=4, log=None)
    assert len(losses) == len(walls) == 2 and np.isfinite(losses).all()
    evals = tp.evaluate(planner, data, "random", episodes=2, log=None)
    assert len(evals) == 2
    assert all(e["result"].trajectory.shape == (tp.EVAL_STEPS + 1, 7)
               for e in evals)
