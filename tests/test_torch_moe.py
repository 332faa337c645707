"""Port parity: the capacity-factor MoE and Granite-MoE against the reference.

``models/ffn.py::apply_moe`` on the reference's own ``init_moe`` weights
(``granite_smoke``: 8 experts top-2 on d 128, SwiGLU; a gelu variant;
``arctic_smoke``: d 112 with its dense residual branch) and numpy-seeded
inputs: the routes (each (token, slot)'s expert, buffer position and kept
flag) exactly, the output and the balance term to fp32 rounding; with a
capacity small enough that pairs drop, with tied router columns (the
port's top-k breaks ties to the lower expert id, as ``jax.lax.top_k``),
and as the batch-wide decode group.  The reference's expert ids are
recorded from its ``jax.lax.top_k`` call; its positions and kept flags
are its one-hot cumsum over them, in numpy.  Then the model on
``granite_smoke``, weights from the reference's ``api.init_params(cfg,
PRNGKey(1))`` carried across by :func:`repro_torch.convert.
lm_from_reference`: prefill (where the 48-token prompt drops pairs),
teacher-forced decode, and the loss with its balance term and every
gradient against ``jax.value_and_grad``.  Last, the abstract shapes of the
full ``granite_moe_1b_a400m`` and ``arctic_480b`` against the reference's
``jax.eval_shape``, leaf by leaf, the router in fp32.  The fp32 products
are summed in another order by the two libraries: 1e-5 for one layer,
1e-4 for the model, as ``test_torch_glm4.py`` holds the dense one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.base import get_config as jget_config
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.models import api as japi
from repro.models import ffn as jffn
from repro_torch.configs.base import ShapeSpec, get_config, get_smoke_config
from repro_torch.convert import lm_from_reference
from repro_torch.data import pipeline
from repro_torch.models import api
from repro_torch.models import ffn
from repro_torch.models.transformer import LM

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, STEPS = 2, 48, 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch(tree):
    return {k: (_torch(v) if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in tree.items()}


def _reference_moe(params, x, jcfg, monkeypatch):
    """The reference's ``apply_moe`` under ``jit`` -> (y, aux, expert ids,
    positions, kept); the ids recorded from its ``jax.lax.top_k`` (an
    output of the traced function), positions and kept flags recomputed
    from them by its one-hot cumsum (in the decode group's (1, B) layout
    where it regroups)."""
    top_k = jax.lax.top_k

    def run(p, xs):
        seen = []

        def recording(a, k):
            out = top_k(a, k)
            seen.append(out[1])
            return out
        monkeypatch.setattr(jax.lax, "top_k", recording)
        y, aux = jffn.apply_moe(p, xs, jcfg)
        monkeypatch.setattr(jax.lax, "top_k", top_k)
        (ids,) = seen
        return y, aux, ids
    y, aux, idx = jax.jit(run)(params, jnp.asarray(x))
    idx = np.asarray(idx)
    Bg, Sg, k = idx.shape
    onehot = np.eye(jcfg.num_experts, dtype=np.int64)[idx.reshape(Bg, -1)]
    pos = ((np.cumsum(onehot, 1) - onehot) * onehot).sum(-1).reshape(idx.shape)
    return (np.asarray(y), float(aux), idx, pos,
            pos < jffn.moe_capacity(jcfg, Sg))


def _port_moe(params, x, cfg):
    """The port's ``apply_moe`` and, recorded from its ``moe_route``, the
    routes of the dispatch group it ran."""
    seen = []
    route = ffn.moe_route

    def recording(p, xg, c):
        out = route(p, xg, c)
        seen.append(out)
        return out
    ffn.moe_route = recording
    try:
        y, aux = ffn.apply_moe(params, torch.from_numpy(x), cfg)
    finally:
        ffn.moe_route = route
    (_, _, idx, pos, keep), = seen
    return y.numpy(), float(aux), idx.numpy(), pos.numpy(), keep.numpy()


def _layer_case(arch, seed=3, tied=False, **changes):
    cfg = get_smoke_config(arch).replace(**changes)
    jcfg = jget_smoke_config(arch).replace(**changes)
    params = _np(jax.jit(lambda key: jffn.init_moe(key, jcfg, jnp.float32))(
        jax.random.PRNGKey(seed)))
    if tied:
        # small integers in x and a router of eighths make every logit exact
        # in either library; repeated columns then tie exactly
        cols = np.array([0, 1, 1, 1, 2, 1, 2, 3])[:jcfg.num_experts]
        base = np.random.RandomState(seed).randint(-3, 4, (jcfg.d_model, 4))
        params["router"] = (base[:, cols] / 8).astype(np.float32)
    return cfg, jcfg, params


def _check_layer(cfg, jcfg, params, x, monkeypatch, want_drops=None):
    y, aux, idx, pos, keep = _port_moe(_torch(params), x, cfg)
    wy, waux, widx, wpos, wkeep = _reference_moe(params, x, jcfg, monkeypatch)
    np.testing.assert_array_equal(idx, widx)
    np.testing.assert_array_equal(pos, wpos)
    np.testing.assert_array_equal(keep, wkeep)
    np.testing.assert_allclose(y, wy, **LAYER_TOL)
    assert aux == pytest.approx(waux, rel=1e-6)
    if want_drops is not None:
        assert bool((~keep).any()) == want_drops
    return idx, keep


def _x(shape, seed=4, ints=False):
    rs = np.random.RandomState(seed)
    if ints:
        return rs.randint(-2, 3, shape).astype(np.float32)
    return rs.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("arch,changes", [
    ("granite_moe_1b_a400m", {}),
    ("granite_moe_1b_a400m", {"mlp_act": "gelu"}),
    ("arctic_480b", {})], ids=["granite", "granite_gelu", "arctic_dense"])
def test_apply_moe_matches_reference(arch, changes, monkeypatch):
    """At 24 tokens a row C is the floor of 8 against a mean load of 6:
    the reference's routes, output and balance term."""
    cfg, jcfg, params = _layer_case(arch, **changes)
    if changes.get("mlp_act") == "gelu":
        assert set(params) == {"router", "w_in", "w_out"}
    if cfg.dense_residual:
        assert set(params["dense"]) == {"w_gate", "w_up", "w_down"}
    _check_layer(cfg, jcfg, params, _x((2, 24, cfg.d_model)), monkeypatch)


def test_apply_moe_drops_pairs_past_capacity(monkeypatch):
    """Capacity factor 0.5 at 64 tokens: C 8 against a mean load of 16, so
    pairs drop; the same pairs on both sides, their rows zero in y's
    expert sum."""
    cfg, jcfg, params = _layer_case("granite_moe_1b_a400m",
                                    moe_capacity_factor=0.5)
    _, keep = _check_layer(cfg, jcfg, params, _x((2, 64, cfg.d_model)),
                           monkeypatch, want_drops=True)
    assert 0.2 < float((~keep).mean()) < 0.8


def test_apply_moe_breaks_router_ties_as_lax_top_k(monkeypatch):
    """Tied router columns: ``torch.topk`` may order the tied experts
    otherwise; the port's stable sort picks the lower id first, as the
    reference, slot for slot (and so position for position)."""
    cfg, jcfg, params = _layer_case("granite_moe_1b_a400m", tied=True,
                                    moe_capacity_factor=0.5)
    x = _x((2, 40, cfg.d_model), ints=True)
    logits = torch.from_numpy(x) @ torch.from_numpy(params["router"])
    top2 = logits.sort(-1, descending=True).values[..., :3]
    assert bool((top2[..., 1] == top2[..., 2]).any())     # ties in the top k
    idx, _ = _check_layer(cfg, jcfg, params, x, monkeypatch, want_drops=True)
    assert bool((idx[..., 0] < idx[..., 1]).any())


def test_apply_moe_decode_batch_is_one_group(monkeypatch):
    """S = 1, B = 6: the batch is one dispatch group (1, 6) of capacity 8."""
    cfg, jcfg, params = _layer_case("granite_moe_1b_a400m")
    idx, keep = _check_layer(cfg, jcfg, params, _x((6, 1, cfg.d_model)),
                             monkeypatch, want_drops=False)
    assert idx.shape == (1, 6, cfg.experts_per_token)


# ---- Granite-MoE, the model ----------------------------------------------

@pytest.fixture(scope="module")
def granite():
    cfg = get_smoke_config("granite_moe_1b_a400m")
    jcfg = jget_smoke_config("granite_moe_1b_a400m")
    params = _np(jax.jit(lambda key: japi.init_params(jcfg, key))(
        jax.random.PRNGKey(1)))
    port = LM(cfg, device="cpu")
    port.load_state_dict(lm_from_reference(cfg, params), strict=True)
    return cfg, jcfg, params, port


def test_prefill_and_decode_match_reference(granite):
    cfg, jcfg, params, port = granite
    rs = np.random.RandomState(0)
    prompts = rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    forced = rs.randint(0, cfg.vocab_size, (STEPS, B))
    # the prompt drops pairs in prefill
    assert ffn.moe_capacity(cfg, S) < S * cfg.experts_per_token
    jl, jc = jax.jit(japi.make_prefill_fn(jcfg, S + STEPS))(
        params, {"tokens": jnp.asarray(prompts)})
    logits, caches = api.make_prefill_fn(cfg, S + STEPS)(
        port, {"tokens": torch.from_numpy(prompts).long()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(caches["kv"][key].numpy(),
                                   np.asarray(jc["kv"][key]), **TOL)
    jdecode = jax.jit(japi.make_decode_fn(jcfg))
    decode = api.make_decode_fn(cfg)
    for i, tok in enumerate(forced):
        jl, jc = jdecode(params, jnp.asarray(tok, jnp.int32),
                         jnp.asarray(S + i, jnp.int32), jc)
        logits, caches = decode(port, torch.from_numpy(tok).long(), S + i,
                                caches)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {i}")


def test_loss_aux_and_every_gradient_match_reference(granite):
    """The loss (cross entropy + 0.01 x the balance term summed over the
    layers, through remat) and every gradient, the router's through the
    gate values and the balance term's probabilities."""
    cfg, jcfg, params, _ = granite
    batch = pipeline.synth_batch(cfg, ShapeSpec("t", 32, 4, "train"), 0)
    (want, wm), wgrads = jax.jit(jax.value_and_grad(
        japi.make_loss_fn(jcfg), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = LM(cfg, device="cpu")
    model.load_state_dict(lm_from_reference(cfg, params), strict=True)
    loss, metrics = api.make_loss_fn(cfg)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    assert float(metrics["moe_aux"]) == pytest.approx(float(wm["moe_aux"]),
                                                      rel=1e-5)
    assert float(metrics["moe_aux"]) > 1.0     # two layers of ~1 each
    want_g = lm_from_reference(cfg, _np(wgrads))
    for (name, _), g in zip(model.named_parameters(), grads):
        scale = float(want_g[name].abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   rtol=TOL["rtol"],
                                   atol=TOL["rtol"] * scale, err_msg=name)


def test_prefill_decode_consistency_without_drops(granite):
    """At capacity factor 8 nothing drops, so decoding token S+1 gives the
    last logits of a forward over S+1 tokens (the reference's own test
    runs MoE in this regime: prefill drops pairs that decode keeps)."""
    cfg, _, _, port = granite
    cfg8 = cfg.replace(moe_capacity_factor=8.0)
    port.cfg = cfg8
    try:
        tokens = torch.from_numpy(np.random.RandomState(5).randint(
            0, cfg.vocab_size, (B, 16))).long()
        logits, caches = api.make_prefill_fn(cfg8)(port, {"tokens": tokens})
        nxt = logits.argmax(-1)
        step, _ = api.make_decode_fn(cfg8)(port, nxt, 16, caches)
        with torch.inference_mode():
            full, _ = port.lm_forward(torch.cat([tokens, nxt[:, None]], 1))
    finally:
        port.cfg = cfg
    np.testing.assert_allclose(step.numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


# ---- abstract shapes of the full configs -----------------------------------

def check_abstract(arch):
    """Every parameter and cache leaf of the full config ``arch``: the
    port's ``meta`` tensors against the reference's ``jax.eval_shape``
    (also run by ``test_torch_vlm.py``)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    want = japi.abstract_params(jcfg)
    got = api.abstract_params(cfg).state_dict()
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        keys = [p.key for p in path]
        if keys[0] == "blocks":
            names = [f"blocks.{i}.{'.'.join(keys[1:])}"
                     for i in range(cfg.num_layers)]
            shape = leaf.shape[1:]
        else:
            names, shape = [".".join(keys)], leaf.shape
        for name in names:
            t = got[name]
            assert t.device.type == "meta", name
            assert tuple(t.shape) == shape, name
            assert str(t.dtype)[6:] == str(leaf.dtype), name
            n += 1
    assert n == len(got)
    shape = JShapeSpec("decode_32k", 4096, 8, "decode")
    wc = japi.abstract_caches(jcfg, shape)
    gc = api.abstract_caches(cfg, ShapeSpec("decode_32k", 4096, 8, "decode"))
    for key in ("k", "v"):
        assert tuple(gc["kv"][key].shape) == wc["kv"][key].shape
        assert str(gc["kv"][key].dtype)[6:] == str(wc["kv"][key].dtype)
        assert gc["kv"][key].device.type == "meta"
    return got


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "arctic_480b"])
def test_abstract_params_and_caches_match_reference(arch):
    got = check_abstract(arch)
    assert got["blocks.0.ffn.router"].dtype == torch.float32
    assert got["blocks.0.ffn.w_gate"].dtype == torch.bfloat16
    assert ("blocks.0.ffn.dense.w_down" in got) == (arch == "arctic_480b")
