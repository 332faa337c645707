"""Port parity: the LM training substrate against the reference.

The optimizer (``train/optimizer.py``), the loss (``models/api.py::
make_loss_fn``, ``models/common.py::softmax_cross_entropy``), the train
step with microbatches (``train/train_loop.py``), the data pipeline
(``data/pipeline.py``), checkpoints (``train/checkpoint.py``), fault
tolerance (``train/ft.py``) and the CLI trainer (``lm/train.py``).  The
LM fixture runs over three smoke configs (2 layers, fp32): ``rwkv6_smoke``
(the WKV6 backward), ``glm4_smoke`` and ``starcoder2_smoke`` (the flash
attention's backward, through ``FlashAttentionFunction``'s plain versions
on the CPU; groups of 4 and 3 query heads a KV head; RMSNorm and SwiGLU,
LayerNorm and gelu), with the reference's weights carried across by
:func:`repro_torch.convert.lm_from_reference`; batches are the
pipeline's, which both packages draw from numpy alike.  The loss and
gradients are fp32 products and sums in another order (the WKV6
recurrence's backward a reverse walk against ``jax.grad`` of a scan, the
attention's the flash formulas against ``jax.grad`` of the reference's
dense softmax): rtol 1e-4, as the LM's forward is held.  The optimizer's
arithmetic is the reference's, in fp32: 1e-6 relative.  Every wait on a
thread here is bounded.
"""
import dataclasses
import functools
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.data import pipeline as jpipeline
from repro.models import api as japi
from repro.models.common import softmax_cross_entropy as jxent
from repro.train import optimizer as jopt
from repro.train import train_loop as jtrain_loop
from repro_torch.configs.base import ShapeSpec, get_smoke_config
from repro_torch.convert import lm_from_reference, opt_state_from_reference
from repro_torch.data import pipeline as pipeline
from repro_torch.lm import train as lm_train
from repro_torch.models import api
from repro_torch.models.common import softmax_cross_entropy
from repro_torch.models.transformer import LM
from repro_torch.train import checkpoint as ck
from repro_torch.train import ft
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_loop

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ARCHS = ("rwkv6_1_6b", "glm4_9b", "starcoder2_7b")
#: Per-layer 1-D parameters of each arch (the reference decays them: it
#: stacks them to rank 2): RWKV-6's mixes, decays and norms; the two
#: RMSNorm scales; the two LayerNorms' scales and biases.
LAYER_VECTORS = {"rwkv6_1_6b": 9, "glm4_9b": 2, "starcoder2_7b": 4}
TOL = dict(rtol=1e-4, atol=1e-6)
OPT_TOL = dict(rtol=1e-6, atol=1e-9)
SHAPE = dict(seq_len=32, global_batch=4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    cfg, jcfg = get_smoke_config(request.param), jget_smoke_config(
        request.param)
    params = _np(japi.init_params(jcfg, jax.random.PRNGKey(1)))
    return cfg, jcfg, params


def _port_model(cfg, params):
    model = LM(cfg, device="cpu")
    model.load_state_dict(lm_from_reference(cfg, params), strict=True)
    return model


def _batch(cfg, step=0):
    shape = ShapeSpec("t", SHAPE["seq_len"], SHAPE["global_batch"], "train")
    return pipeline.synth_batch(cfg, shape, step)


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---- the optimizer: the reference's four tests, case for case ---------

def test_adamw_matches_reference_update():
    cfg = opt_mod.OptConfig(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8,
                            weight_decay=0.0, clip_norm=1e9,
                            warmup_steps=0, total_steps=1, min_lr_frac=1.0)
    params = {"w": torch.tensor([1.0, -2.0, 3.0])}
    grads = {"w": torch.tensor([0.1, 0.2, -0.3])}
    state = opt_mod.init_opt_state(params, cfg)
    new_p, new_s, m = opt_mod.adamw_update(params, grads, state, cfg)
    g = np.asarray([0.1, 0.2, -0.3])
    expect = np.asarray([1.0, -2.0, 3.0]) - 1e-2 * g / (np.abs(g) + 1e-8)
    np.testing.assert_allclose(new_p["w"].numpy(), expect, rtol=1e-5)
    assert int(new_s["step"]) == 1


def test_grad_clipping():
    g = {"w": torch.full((10,), 100.0)}
    clipped, norm = opt_mod.clip_by_global_norm(g, 1.0)
    assert float(norm) > 100
    assert abs(float(opt_mod.global_norm(clipped)) - 1.0) < 1e-5


def test_schedule_warmup_and_cosine():
    cfg = opt_mod.OptConfig(lr=1.0, warmup_steps=10, total_steps=110,
                            min_lr_frac=0.1)
    assert float(opt_mod.schedule(0, cfg)) == 0.0
    assert abs(float(opt_mod.schedule(10, cfg)) - 1.0) < 1e-6
    assert abs(float(opt_mod.schedule(110, cfg)) - 0.1) < 1e-6
    for step in (0, 3, 10, 57, 110, 200):
        jcfg = jopt.OptConfig(lr=1.0, warmup_steps=10, total_steps=110,
                              min_lr_frac=0.1)
        assert float(opt_mod.schedule(step, cfg)) == float(
            jopt.schedule(jnp.asarray(step), jcfg))


def test_bf16_optimizer_states():
    cfg = opt_mod.OptConfig(state_dtype="bfloat16")
    params = {"w": torch.ones((4, 4))}
    st = opt_mod.init_opt_state(params, cfg)
    assert st["m"]["w"].dtype == torch.bfloat16
    new_p, new_s, _ = opt_mod.adamw_update(
        params, {"w": torch.ones((4, 4)) * 0.1}, st, cfg)
    assert new_s["v"]["w"].dtype == torch.bfloat16
    assert bool(new_p["w"].isfinite().all())


# ---- the optimizer on the LM: decay by the reference's rank ------------

@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_steps_on_lm_match_reference(lm, state_dtype):
    """Three AdamW steps on the smoke LM from numpy gradients, the
    reference on its stacked tree, the port on its per-layer tensors with
    :func:`stacked_decay`: parameters and moments within 1e-6 relative
    (moments in bf16 to one bf16 rounding).  Decaying by the port's own
    rank (:func:`matrix_decay`) leaves the per-layer vectors undecayed
    (nine a layer in RWKV-6, the norms' in the dense models), which the
    reference decays: that differs."""
    cfg, _, params = lm
    rs = np.random.RandomState(2)
    grads = jax.tree_util.tree_map(
        lambda p: (rs.normal(size=p.shape) * 0.01).astype(np.float32),
        params)
    ocfg = jopt.OptConfig(lr=1e-2, weight_decay=0.5, warmup_steps=1,
                          total_steps=10, clip_norm=0.5,
                          state_dtype=state_dtype)
    tcfg = opt_mod.OptConfig(**dataclasses.asdict(ocfg))
    to_port = functools.partial(lm_from_reference, cfg)
    update = jax.jit(jopt.adamw_update, static_argnums=3)
    jp, js = params, jopt.init_opt_state(params, ocfg)
    tg = to_port(grads)
    runs = {}
    for rule in (opt_mod.stacked_decay, opt_mod.matrix_decay):
        tp = to_port(params)
        ts = opt_mod.init_opt_state(tp, tcfg)
        for _ in range(3):
            opt_mod.adamw_update(tp, tg, ts, tcfg, rule)
        runs[rule.__name__] = (tp, ts)
    for _ in range(3):
        jp, js, _ = update(jp, grads, js, ocfg)
    want, want_s = to_port(_np(jp)), opt_state_from_reference(_np(js),
                                                              to_port)
    tp, ts = runs["stacked_decay"]
    # fp32: the same operations, XLA's possibly fused: a few ulps of each
    # tensor's scale.  bf16 moments: a rounding to bf16 that those ulps may
    # flip moves a moment by 2**-8 of itself, and each step moves a weight
    # by lr times the moments' ratio: 2**-7 of lr a step.
    bf16 = state_dtype == "bfloat16"
    state_tol = dict(rtol=2 ** -7, atol=1e-12) if bf16 else OPT_TOL
    for name in want:
        atol = (3 * ocfg.lr * 2 ** -7 if bf16
                else OPT_TOL["rtol"] * float(want[name].abs().max()))
        np.testing.assert_allclose(tp[name].numpy(), want[name].numpy(),
                                   rtol=OPT_TOL["rtol"], atol=atol,
                                   err_msg=name)
        for key in ("m", "v"):
            assert ts[key][name].dtype == want_s[key][name].dtype
            want_m = want_s[key][name].float()
            np.testing.assert_allclose(
                ts[key][name].float().numpy(), want_m.numpy(),
                rtol=state_tol["rtol"],
                atol=max(state_tol["atol"],
                         OPT_TOL["rtol"] * float(want_m.abs().max())),
                err_msg=f"{key} {name}")
    vectors = [n for n, p in want.items()
               if n.startswith("blocks.") and p.ndim == 1]
    arch = next(a for a in ARCHS if get_smoke_config(a).name == cfg.name)
    assert len(vectors) == LAYER_VECTORS[arch] * cfg.num_layers
    wrong = runs["matrix_decay"][0]
    for name in vectors:
        # Decay moves a weight by lr * weight_decay * itself a step: ~5e-3
        # of a norm's scale (1) in three steps.  A dense model's LayerNorm
        # bias starts at 0 and is ~lr after a step, so its decay moves it
        # by only ~1e-4 in three: it gets the lower threshold, every other
        # vector keeps 1e-3.
        atol = 1e-5 if name.endswith(".bias") else 1e-3
        assert not np.allclose(wrong[name].numpy(), want[name].numpy(),
                               rtol=0, atol=atol), name


# ---- the loss ------------------------------------------------------------

@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_softmax_cross_entropy_matches_reference(z_loss):
    rs = np.random.RandomState(3)
    logits = (rs.normal(size=(3, 5, 50)) * 4).astype(np.float32)
    labels = rs.randint(0, 50, (3, 5)).astype(np.int32)
    want = float(jxent(jnp.asarray(logits), jnp.asarray(labels), z_loss))
    got = softmax_cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels), z_loss)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)


def test_loss_and_every_gradient_match_reference(lm):
    """``make_loss_fn`` under autograd (RWKV-6's time mix through
    ``WKV6Function``, the dense models' attention through
    ``FlashAttentionFunction``, remat through ``torch.utils.checkpoint``)
    against the reference's under ``jax.value_and_grad``."""
    cfg, jcfg, params = lm
    batch = _batch(cfg)
    (want, wm), wgrads = jax.jit(jax.value_and_grad(
        japi.make_loss_fn(jcfg), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port_model(cfg, params)
    loss, metrics = api.make_loss_fn(cfg)(model, _tensors(batch))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    assert float(metrics["moe_aux"]) == float(wm["moe_aux"]) == 0.0
    want_g = lm_from_reference(cfg, _np(wgrads))
    assert set(names) == set(want_g)
    for name, g in zip(names, grads):
        scale = float(want_g[name].abs().max())
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   rtol=TOL["rtol"],
                                   atol=TOL["rtol"] * scale, err_msg=name)


def test_batch_spec_matches_reference(lm):
    cfg, jcfg, _ = lm
    spec = api.batch_spec(cfg, ShapeSpec("t", 16, 2, "train"))
    want = japi.batch_spec(jcfg, JShapeSpec("t", 16, 2, "train"))
    assert set(spec) == set(want) == {"tokens", "labels"}
    for key, t in spec.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == want[key].shape
        assert str(t.dtype)[6:] == str(want[key].dtype)


def test_dense_family_gradient_meets_the_flash_kernels_raise():
    """GLM-4's and StarCoder2's losses have a gradient now: it flows
    through the flash attention's backward (its plain version on the
    CPU) to every parameter, finite, and a card would launch the backward
    kernel where this runs its plain version (the dispatch is by the
    tensors' device).  The name is the one this test had while the kernel
    refused a gradient."""
    for arch in ("glm4_9b", "starcoder2_7b"):
        cfg = get_smoke_config(arch)
        model = api.init_params(cfg, device="cpu")
        batch = _tensors(_batch(cfg))
        loss, _ = api.make_loss_fn(cfg)(model, batch)
        assert bool(loss.isfinite())
        grads = torch.autograd.grad(loss, list(model.parameters()))
        for (name, _), g in zip(model.named_parameters(), grads):
            assert bool(g.isfinite().all()), (arch, name)
        wq = dict(zip([n for n, _ in model.named_parameters()], grads))[
            "blocks.0.attn.wq"]
        assert float(wq.abs().max()) > 0, arch


# ---- the train step --------------------------------------------------------

@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_reference(lm, micro):
    """One step of ``make_train_step`` with 1 and 2 microbatches: loss,
    gradient norm, learning rate and the updated parameters against the
    reference's step.  An AdamW first step moves a weight by lr g / (|g| +
    eps): with the default eps a gradient within rounding of 0 would move
    it by +-lr on either side, so eps is 1e-3 here, which keeps the step a
    smooth function of the gradient; the parameters are then held to 1e-3
    of lr."""
    cfg, jcfg, params = lm
    ocfg = jopt.OptConfig(lr=1e-3, eps=1e-3, warmup_steps=0, total_steps=10)
    jstep = jax.jit(jtrain_loop.make_train_step(jcfg, ocfg, micro))
    batch = _batch(cfg, step=1)
    jp, js, jm = jstep(params, jopt.init_opt_state(params, ocfg),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port_model(cfg, params)
    tcfg = opt_mod.OptConfig(**dataclasses.asdict(ocfg))
    state = opt_mod.init_opt_state(dict(model.named_parameters()), tcfg)
    step = train_loop.make_train_step(cfg, tcfg, micro)
    model, state, metrics = step(model, state, _tensors(batch))
    for key in ("loss", "xent", "grad_norm"):
        assert float(metrics[key]) == pytest.approx(float(jm[key]),
                                                    rel=1e-4), key
    assert float(metrics["lr"]) == float(jm["lr"])
    assert int(state["step"]) == 1
    want = lm_from_reference(cfg, _np(jp))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-3 * ocfg.lr, err_msg=name)


# ---- data ------------------------------------------------------------------

def test_synth_batch_matches_reference(lm):
    cfg, jcfg, _ = lm
    for step, host, count in ((0, 0, 1), (7, 1, 2)):
        got = pipeline.synth_batch(cfg, ShapeSpec("t", 24, 6, "train"), step,
                                   host_index=host, host_count=count)
        want = jpipeline.synth_batch(jcfg, JShapeSpec("t", 24, 6, "train"),
                                     step, host_index=host, host_count=count)
        assert got.keys() == want.keys()
        for key in got:
            assert got[key].dtype == want[key].dtype == np.int32
            np.testing.assert_array_equal(got[key], want[key])
    it = pipeline.batch_iterator(cfg, ShapeSpec("t", 8, 2, "train"),
                                 start_step=3)
    np.testing.assert_array_equal(
        next(it)["tokens"],
        pipeline.synth_batch(cfg, ShapeSpec("t", 8, 2, "train"),
                             3)["tokens"])


# ---- checkpoints ---------------------------------------------------------

def test_checkpoint_commit_protocol_and_gc():
    tree = {"a": torch.ones(4), "nested": {"b": torch.zeros(2, 2)},
            "h": torch.arange(6, dtype=torch.float32).bfloat16()}
    with tempfile.TemporaryDirectory() as d:
        ck.save_checkpoint(d, 1, tree, async_save=False)
        # a partial (uncommitted) checkpoint must be ignored
        os.makedirs(os.path.join(d, "step_00000007"), exist_ok=True)
        os.makedirs(os.path.join(d, "step_00000008.tmp"), exist_ok=True)
        assert ck.latest_steps(d) == [1]
        restored, step = ck.restore_checkpoint(d, tree)
        assert step == 1
        assert torch.equal(restored["a"], tree["a"])
        assert torch.equal(restored["nested"]["b"], tree["nested"]["b"])
        assert restored["h"].dtype == torch.bfloat16
        assert torch.equal(restored["h"], tree["h"])
        # keep-last-k GC, the async writer joined within a bound
        for s in (6, 9, 10, 11):
            t = ck.save_checkpoint(d, s, tree, keep_last_k=2)
            t.join(timeout=30)
            assert not t.is_alive()
        assert ck.latest_steps(d) == [10, 11]
        assert ck.restore_checkpoint(d, tree, step=10)[1] == 10
    with tempfile.TemporaryDirectory() as d:
        assert ck.restore_checkpoint(d, tree) == (None, -1)


def test_checkpoint_files_are_the_reference_layout(lm):
    """One ``.npy`` a leaf named by its key path and ``meta.json`` with the
    step and the sorted keys; each file reads back as the tensor (bf16
    through its bits, as the reference's bfloat16 arrays are read)."""
    cfg, _, params = lm
    model = _port_model(cfg, params)
    state = opt_mod.init_opt_state(dict(model.named_parameters()),
                                   opt_mod.OptConfig(state_dtype="bfloat16"))
    tree = {"params": model.state_dict(), "opt": state}
    with tempfile.TemporaryDirectory() as d:
        ck.save_checkpoint(d, 3, tree, async_save=False)
        sd = os.path.join(d, "step_00000003")
        import json
        with open(os.path.join(sd, "meta.json")) as f:
            meta = json.load(f)
        flat = ck._flatten(tree)
        assert meta["step"] == 3 and meta["keys"] == sorted(flat)
        assert sorted(os.listdir(sd)) == sorted(
            ["COMMITTED", "meta.json"] + [k + ".npy" for k in flat])
        for key, t in flat.items():
            arr = np.load(os.path.join(sd, key + ".npy"))
            if t.dtype == torch.bfloat16:
                assert arr.dtype == np.uint16
                back = torch.from_numpy(arr.view(np.int16)).view(
                    torch.bfloat16)
            else:
                back = torch.from_numpy(arr)
            assert torch.equal(back, t.cpu()), key


def test_resume_equals_the_uninterrupted_run(lm):
    """``lm/train.py`` on the smoke config: five steps with a checkpoint at
    step 2, then a fresh model and optimizer restored from it run steps 3
    and 4; parameters and moments equal the uninterrupted run's bit for
    bit."""
    cfg = lm[0]
    kw = dict(batch=4, seq=16, microbatches=2, device="cpu", log=None)
    with tempfile.TemporaryDirectory() as d:
        full = lm_train.train(cfg, 5, ckpt_dir=d, ckpt_every=3, **kw)
        assert ck.latest_steps(os.path.join(d, cfg.name)) == [2]
        again = lm_train.train(cfg, 5, ckpt_dir=d, ckpt_every=100,
                               resume=True, **kw)
    assert again.start == 3 and again.losses == full.losses[3:]
    for name, p in full.model.state_dict().items():
        assert torch.equal(p, again.model.state_dict()[name]), name
    for key in ("m", "v"):
        for name, m in full.opt_state[key].items():
            assert torch.equal(m, again.opt_state[key][name])
    assert int(again.opt_state["step"]) == 5
    assert all(np.isfinite(full.losses))


# ---- fault tolerance --------------------------------------------------------

def test_straggler_skip_and_preemption():
    def slow_iter():
        yield 1
        yield 2
        time.sleep(1.0)
        yield 3

    loader = ft.PrefetchingLoader(slow_iter(), depth=1)
    assert loader.next_batch(deadline_s=5) == 1
    assert loader.next_batch(deadline_s=5) == 2
    b = loader.next_batch(deadline_s=0.2)      # producer is straggling
    assert b == 2 and loader.skipped == 1      # reused last good batch
    assert loader.next_batch(deadline_s=5) == 3
    loader.close(timeout_s=5)

    guard = ft.PreemptionGuard()
    assert not guard.should_checkpoint
    guard.trigger()
    assert guard.should_checkpoint


def test_loader_waits_are_bounded():
    """A producer that never yields: the cold start raises after its bound
    instead of waiting forever, and ``close`` ends a producer blocked on a
    full queue."""
    def never():
        time.sleep(3.0)
        yield 0

    loader = ft.PrefetchingLoader(never(), cold_start_s=0.2)
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        loader.next_batch(deadline_s=0.1)
    assert time.perf_counter() - t0 < 2.0

    full = ft.PrefetchingLoader(iter(range(100)), depth=1)
    assert full.next_batch(deadline_s=5) == 0
    full.close(timeout_s=5)
    assert not full._thread.is_alive()
