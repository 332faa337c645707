"""Port parity: RWKV-6 serving (prefill, greedy decode) against the reference.

On ``rwkv6_smoke`` (2 layers, d 128, 2 heads of 64, vocab 512, fp32),
weights from the reference's ``api.init_params(cfg, PRNGKey(1))`` are
carried across by :func:`repro_torch.convert.lm_from_reference`; prompts
come from numpy seeds.  The port's prefill runs the WKV6 recurrence
through ``wkv6_heads`` (its plain version on the CPU), the reference's
``make_prefill_fn`` its scan ``wkv6_ref``; decode is one fp32 step on
both sides.  The fp32 matrix products and dot products are summed in
another order by the two libraries, so logits and caches are held to
``rtol=atol=1e-4`` (they agree to about 1e-6 at these widths); the port's
own prefill/decode consistency to ``atol=rtol=2e-3``, as
``tests/test_archs_smoke.py`` holds the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.kernels.wkv6.ref import wkv6_ref as jwkv6_ref
from repro.models import api as japi
from repro_torch.configs.base import ModelConfig, get_config, get_smoke_config
from repro_torch.convert import lm_from_reference
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.lm.serve import serve
from repro_torch.models import api
from repro_torch.models.rwkv import wkv_step
from repro_torch.models.transformer import LM, init_decode_caches

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
CONSIST_TOL = dict(rtol=2e-3, atol=2e-3)
B, S, STEPS = 2, 48, 4
CACHE_FIELDS = ("wkv", "tm_shift", "cm_shift")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    cfg = get_smoke_config("rwkv6_1_6b")
    jcfg = jget_smoke_config("rwkv6_1_6b")
    params = _np(japi.init_params(jcfg, jax.random.PRNGKey(1)))
    port = LM(cfg, device="cpu")
    port.load_state_dict(lm_from_reference(cfg, params), strict=True)
    return cfg, jcfg, params, port


@pytest.fixture(scope="module")
def prompts():
    rs = np.random.RandomState(0)
    cfg = get_smoke_config("rwkv6_1_6b")
    return rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def prefilled(models, prompts):
    cfg, jcfg, params, port = models
    want_logits, want_caches = japi.make_prefill_fn(jcfg)(
        params, {"tokens": jnp.asarray(prompts)})
    logits, caches = api.make_prefill_fn(cfg)(
        port, {"tokens": torch.from_numpy(prompts).long()})
    return (np.asarray(want_logits), _np(want_caches)), (logits, caches)


def test_prefill_matches_reference(prefilled, models):
    cfg = models[0]
    (want_logits, want_caches), (logits, caches) = prefilled
    assert logits.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    assert set(caches) == set(want_caches) == set(CACHE_FIELDS)
    for key in CACHE_FIELDS:
        assert caches[key].shape == want_caches[key].shape, key
        assert str(caches[key].dtype).endswith(str(want_caches[key].dtype))
        np.testing.assert_allclose(caches[key].numpy(), want_caches[key],
                                   **TOL, err_msg=key)


def test_teacher_forced_decode_matches_reference(prefilled, models):
    cfg, jcfg, params, port = models
    (_, jcaches), (_, caches) = prefilled
    jcaches = jax.tree_util.tree_map(jnp.asarray, jcaches)
    jdecode, decode = japi.make_decode_fn(jcfg), api.make_decode_fn(cfg)
    forced = np.random.RandomState(1).randint(0, cfg.vocab_size, (STEPS, B))
    for i, tok in enumerate(forced):
        pos = S + i
        jlogits, jcaches = jdecode(params, jnp.asarray(tok, jnp.int32),
                                   jnp.asarray(pos, jnp.int32), jcaches)
        logits, caches = decode(port, torch.from_numpy(tok).long(), pos,
                                caches)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL,
                                   err_msg=f"step {i}")
        for key in CACHE_FIELDS:
            np.testing.assert_allclose(caches[key].numpy(),
                                       np.asarray(jcaches[key]), **TOL,
                                       err_msg=f"step {i} {key}")


def test_prefill_decode_consistency(models, prompts):
    """Decoding token S+1 after prefilling S tokens gives the last logits
    of a forward pass over the S+1 tokens."""
    cfg, _, _, port = models
    tokens = torch.from_numpy(prompts).long()
    logits, caches = api.make_prefill_fn(cfg)(port, {"tokens": tokens})
    nxt = logits.argmax(-1)
    step_logits, _ = api.make_decode_fn(cfg)(port, nxt, S, caches)
    with torch.inference_mode():
        full, _ = port.lm_forward(torch.cat([tokens, nxt[:, None]], 1))
    np.testing.assert_allclose(step_logits.numpy(), full[:, -1].numpy(),
                               **CONSIST_TOL)


def test_serve_matches_reference_greedy_loop(models, prompts):
    """The slice end to end on the CPU: ``serve``'s greedy tokens are the
    reference's prefill + decode loop's (``examples/serve_lm.py``)."""
    cfg, jcfg, params, port = models
    n = 5
    res = serve(port, prompts, n, device="cpu")
    assert res.tokens.shape == (B, n) and len(res.decode_s) == n - 1
    logits, caches = japi.make_prefill_fn(jcfg)(
        params, {"tokens": jnp.asarray(prompts)})
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for i in range(n - 1):
        logits, caches = japi.make_decode_fn(jcfg)(
            params, tok, jnp.asarray(S + i, jnp.int32), caches)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
    assert np.array_equal(res.tokens.numpy(), np.stack(want, 1))
    np.testing.assert_allclose(res.logits.numpy(), np.asarray(logits), **TOL)


def test_prefill_runs_wkv6_heads_once_per_layer(models, prompts, monkeypatch):
    cfg, _, _, port = models
    calls = []
    orig = wkv6_ops.wkv6_heads

    def counting(*a, **k):
        calls.append(a[0].shape)
        return orig(*a, **k)
    monkeypatch.setattr(wkv6_ops, "wkv6_heads", counting)
    tokens = torch.from_numpy(prompts).long()
    api.make_prefill_fn(cfg)(port, {"tokens": tokens})
    H = cfg.num_heads
    assert calls == [(B, H, S, cfg.d_model // H)] * cfg.num_layers


def test_wkv_step_matches_reference_scan_step():
    rs = np.random.RandomState(3)
    Bq, H, D = 2, 3, 16
    r, k, v = (rs.normal(size=(Bq, H, D)).astype(np.float32) for _ in range(3))
    logw = -rs.uniform(0.01, 3, (Bq, H, D)).astype(np.float32)
    u = (rs.normal(size=(H, D)) * 0.3).astype(np.float32)
    S0 = rs.normal(size=(Bq, H, D, D)).astype(np.float32)
    o, S1 = wkv_step(*(torch.from_numpy(x) for x in (r, k, v)),
                     torch.exp(torch.from_numpy(logw)), torch.from_numpy(u),
                     torch.from_numpy(S0))

    def fold(x):
        return jnp.asarray(x.reshape(Bq * H, 1, D))
    jo, jS = jwkv6_ref(fold(r), fold(k), fold(v), fold(logw),
                       jnp.asarray(np.tile(u, (Bq, 1))),
                       jnp.asarray(S0.reshape(Bq * H, D, D)))
    np.testing.assert_allclose(o.numpy().reshape(-1, D),
                               np.asarray(jo).reshape(-1, D), atol=2e-5)
    np.testing.assert_allclose(S1.numpy().reshape(-1, D, D), np.asarray(jS),
                               atol=2e-5)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_lm_from_reference_fills_every_weight(param_dtype):
    cfg = get_smoke_config("rwkv6_1_6b").replace(num_layers=3,
                                                  param_dtype=param_dtype)
    jcfg = jget_smoke_config("rwkv6_1_6b").replace(num_layers=3,
                                                    param_dtype=param_dtype)
    params = _np(japi.init_params(jcfg, jax.random.PRNGKey(2)))
    state = lm_from_reference(cfg, params)
    port = LM(cfg, device="cpu")
    want = port.state_dict()
    assert set(state) == set(want)
    for key, t in state.items():
        assert t.shape == want[key].shape and t.dtype == want[key].dtype, key
    port.load_state_dict(state, strict=True)
    got = port.state_dict()
    bits = np.uint16 if param_dtype == "bfloat16" else np.float32
    wr = np.asarray(params["blocks"]["wr"][2]).view(bits)
    head = np.asarray(params["lm_head"]).view(bits)
    view = torch.int16 if param_dtype == "bfloat16" else torch.float32
    assert np.array_equal(got["blocks.2.wr"].view(view).numpy().view(bits),
                          wr)
    assert np.array_equal(got["lm_head"].view(view).numpy().view(bits), head)


def test_full_model_shapes_match_reference_on_meta():
    cfg = get_config("rwkv6_1_6b")
    model = LM(cfg, device="meta")
    got = {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()}
    ref = jax.tree_util.tree_flatten_with_path(
        japi.abstract_params(jget_config("rwkv6_1_6b")))[0]
    L = cfg.num_layers
    assert len(got) == (len(ref) - 3) * L + 3
    for path, leaf in ref:
        name = ".".join(str(getattr(p, "key", p)) for p in path)
        dtype = getattr(torch, str(leaf.dtype))
        if name.startswith("blocks."):
            assert leaf.shape[0] == L
            for layer in range(L):
                key = f"blocks.{layer}.{name[len('blocks.'):]}"
                assert got[key] == (tuple(leaf.shape[1:]), dtype), key
        else:
            assert got[name] == (tuple(leaf.shape), dtype), name
    n = sum(v.numel() for v in model.parameters())
    assert 1.5e9 < n < 1.7e9


def test_caches_are_stacked_layer_leading():
    cfg = get_smoke_config("rwkv6_1_6b")
    caches = init_decode_caches(cfg, batch=3, device="cpu")
    H = cfg.num_heads
    D = cfg.d_model // H
    assert {k: tuple(v.shape) for k, v in caches.items()} == {
        "wkv": (2, 3, H, D, D), "tm_shift": (2, 3, 128),
        "cm_shift": (2, 3, 128)}
    assert caches["wkv"].dtype == torch.float32


def test_unported_architectures_raise_naming_roadmap():
    with pytest.raises(NotImplementedError, match="A.11"):
        get_config("qwen1_5_110b")
    with pytest.raises(NotImplementedError, match="A.11"):
        get_smoke_config("nemotron_4_340b")
    with pytest.raises(KeyError):
        get_config("no_such_model")
    tied = ModelConfig(name="tiny", family="dense", num_layers=1,
                       d_model=16, num_heads=2, num_kv_heads=2, d_ff=32,
                       vocab_size=8, tie_embeddings=True)
    with pytest.raises(NotImplementedError, match="A.11"):
        api.init_params(tied, device="cpu")
    with pytest.raises(NotImplementedError, match="A.11"):
        LM(tied, device="cpu")


def test_serve_on_cuda_raises_without_a_card(models, prompts):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(models[3], prompts, 2, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_params(get_smoke_config("rwkv6_1_6b"))
