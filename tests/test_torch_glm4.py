"""Port parity: dense-model serving (prefill, greedy decode) against the
reference: GLM-4 and StarCoder2.

On ``glm4_smoke`` (2 layers, d 128, 8 query heads on 2 KV heads of 16,
SwiGLU d_ff 384, vocab 512, fp32) and ``starcoder2_smoke`` (2 layers, d
144, 9 query heads on 3 KV heads of 16, LayerNorm with bias, gelu d_ff
576, vocab 512, fp32), the ``models`` fixture's two cases, weights from
the reference's
``api.init_params(cfg, PRNGKey(1))`` are carried across by
:func:`repro_torch.convert.lm_from_reference`; prompts come from numpy
seeds.  The port's prefill runs every layer's attention through
``flash_attention`` (its plain version on the CPU), the reference's
``make_prefill_fn`` its ``dense_attention`` at these sizes (the same
function); decode attends over the KV cache on both sides.  The fp32
matrix products are summed in another order by the two libraries, so
logits and caches are held to ``rtol=atol=1e-4``; the port's own
prefill/decode consistency to ``atol=rtol=2e-3``, as
``tests/test_archs_smoke.py`` holds the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.models import api as japi
from repro.models import ffn as jffn
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.convert import lm_from_reference
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.lm.serve import serve
from repro_torch.models import api
from repro_torch.models.ffn import apply_mlp
from repro_torch.models.transformer import LM, init_decode_caches

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
CONSIST_TOL = dict(rtol=2e-3, atol=2e-3)
B, S, STEPS = 2, 48, 4
MAX_LEN = S + 8
ARCH = "glm4_9b"
ARCHS = ("glm4_9b", "starcoder2_7b")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    cfg = get_smoke_config(request.param)
    jcfg = jget_smoke_config(request.param)
    params = _np(japi.init_params(jcfg, jax.random.PRNGKey(1)))
    port = LM(cfg, device="cpu")
    port.load_state_dict(lm_from_reference(cfg, params), strict=True)
    return cfg, jcfg, params, port


@pytest.fixture(scope="module")
def prompts():
    rs = np.random.RandomState(0)
    return rs.randint(0, get_smoke_config(ARCH).vocab_size,
                      (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def prefilled(models, prompts):
    cfg, jcfg, params, port = models
    want_logits, want_caches = japi.make_prefill_fn(jcfg, MAX_LEN)(
        params, {"tokens": jnp.asarray(prompts)})
    logits, caches = api.make_prefill_fn(cfg, MAX_LEN)(
        port, {"tokens": torch.from_numpy(prompts).long()})
    return (np.asarray(want_logits), _np(want_caches)), (logits, caches)


def test_prefill_matches_reference(prefilled, models):
    cfg = models[0]
    (want_logits, want_caches), (logits, caches) = prefilled
    assert logits.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    assert set(caches) == set(want_caches) == {"kv"}
    for key in ("k", "v"):
        got, want = caches["kv"][key], want_caches["kv"][key]
        assert tuple(got.shape) == want.shape == (
            cfg.num_layers, B, MAX_LEN, cfg.num_kv_heads, cfg.hd), key
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=key)


def test_teacher_forced_decode_matches_reference(prefilled, models):
    cfg, jcfg, params, port = models
    (_, jcaches), (_, caches) = prefilled
    jcaches = jax.tree_util.tree_map(jnp.asarray, jcaches)
    # the port's decode writes its KV slots in place: work on a copy
    caches = {"kv": {key: a.clone() for key, a in caches["kv"].items()}}
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
        for key in ("k", "v"):
            np.testing.assert_allclose(caches["kv"][key].numpy(),
                                       np.asarray(jcaches["kv"][key]), **TOL,
                                       err_msg=f"step {i} {key}")


def test_prefill_decode_consistency(models, prompts):
    """Decoding token S+1 after prefilling S tokens gives the last logits
    of a forward pass over the S+1 tokens."""
    cfg, _, _, port = models
    tokens = torch.from_numpy(prompts).long()
    logits, caches = api.make_prefill_fn(cfg)(port, {"tokens": tokens})
    assert caches["kv"]["k"].shape[2] == S + 128     # the default horizon
    nxt = logits.argmax(-1)
    step_logits, _ = api.make_decode_fn(cfg)(port, nxt, S, caches)
    with torch.inference_mode():
        full, _ = port.lm_forward(torch.cat([tokens, nxt[:, None]], 1))
    np.testing.assert_allclose(step_logits.numpy(), full[:, -1].numpy(),
                               **CONSIST_TOL)


def test_serve_matches_reference_greedy_loop(models, prompts):
    """The slice end to end on the CPU: ``serve``'s greedy tokens are the
    reference's prefill + decode loop's, with caches sized S + n."""
    cfg, jcfg, params, port = models
    n = 4
    res = serve(port, prompts, n, device="cpu")
    assert res.tokens.shape == (B, n) and len(res.decode_s) == n - 1
    assert res.caches["kv"]["k"].shape[2] == S + n
    logits, caches = japi.make_prefill_fn(jcfg, S + n)(
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


def test_prefill_runs_flash_attention_once_per_layer(models, prompts,
                                                     monkeypatch):
    cfg, _, _, port = models
    calls = []
    orig = flash_ops.flash_attention

    def counting(q, k, v, causal=True, window=0):
        calls.append((tuple(q.shape), tuple(k.shape), v.stride(), causal,
                      window))
        return orig(q, k, v, causal, window)
    monkeypatch.setattr(flash_ops, "flash_attention", counting)
    tokens = torch.from_numpy(prompts).long()
    api.make_prefill_fn(cfg)(port, {"tokens": tokens})
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    assert [c[:2] for c in calls] == [((B, H, S, hd), (B, K, S, hd))] * 2
    assert all(c[3] and c[4] == 0 for c in calls)
    # v goes in as the (B, H, S, hd) view of its (B, S, K, hd) projection
    assert calls[0][2] == (S * K * hd, hd, K * hd, 1)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_lm_from_reference_fills_every_weight(models, param_dtype):
    cfg = models[0].replace(param_dtype=param_dtype)
    params = models[2]
    if param_dtype == "bfloat16":
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), params)
    state = lm_from_reference(cfg, params)
    port = LM(cfg, device="cpu")
    want = port.state_dict()
    assert set(state) == set(want)
    for key, t in state.items():
        assert t.shape == want[key].shape and t.dtype == want[key].dtype, key
    port.load_state_dict(state, strict=True)
    got = port.state_dict()
    bits = np.uint16 if param_dtype == "bfloat16" else np.float32
    view = torch.int16 if param_dtype == "bfloat16" else torch.float32
    down = "w_down" if cfg.mlp_act == "swiglu" else "w_out"
    pairs = [("blocks.1.attn.wq", params["blocks"]["attn"]["wq"][1]),
             (f"blocks.1.ffn.{down}", params["blocks"]["ffn"][down][1])]
    if cfg.norm == "layernorm":           # the bias the reference carries
        pairs.append(("blocks.1.ln2.bias", params["blocks"]["ln2"]["bias"][1]))
    for key, leaf in pairs:
        assert np.array_equal(got[key].view(view).numpy().view(bits),
                              np.asarray(leaf).view(bits)), key


@pytest.mark.parametrize("arch,count,shapes", [
    ("glm4_9b", 9_399_767_040,
     {"blocks.39.attn.wq": (4096, 32, 128), "blocks.0.attn.wk": (4096, 2, 128),
      "blocks.0.attn.wo": (32, 128, 4096),
      "blocks.0.ffn.w_gate": (4096, 13696), "lm_head": (4096, 151552)}),
    ("starcoder2_7b", 7_399_351_296,
     {"blocks.31.attn.wq": (4608, 36, 128), "blocks.0.attn.wk": (4608, 4, 128),
      "blocks.0.attn.wo": (36, 128, 4608), "blocks.0.ffn.w_in": (4608, 18432),
      "blocks.0.ln1.bias": (4608,), "lm_head": (4608, 49152)})])
def test_full_model_weight_count_and_shapes_on_meta(arch, count, shapes):
    cfg = get_config(arch)
    model = LM(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == count
    state = model.state_dict()
    for key, shape in shapes.items():
        assert tuple(state[key].shape) == shape, key
    assert state["embed"].dtype == torch.bfloat16


def test_attention_caches_are_stacked_layer_leading():
    cfg = get_smoke_config(ARCH)
    caches = init_decode_caches(cfg, batch=3, max_len=20, device="cpu")
    assert {k: tuple(v.shape) for k, v in caches["kv"].items()} == {
        "k": (2, 3, 20, 2, 16), "v": (2, 3, 20, 2, 16)}
    with pytest.raises(ValueError, match="max_len"):
        init_decode_caches(cfg, batch=3, device="cpu")


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu2"])
def test_apply_mlp_matches_reference(act):
    """The dense FFN's three activations (gelu in jax.nn.gelu's default
    tanh form) on the reference's own weights."""
    jcfg = jget_smoke_config(ARCH).replace(mlp_act=act)
    params = _np(jffn.init_mlp(jax.random.PRNGKey(3), jcfg, jnp.float32))
    x = np.random.RandomState(4).normal(size=(2, 5, 128)).astype(np.float32)
    want = jffn.apply_mlp(params, jnp.asarray(x), jcfg)
    got = apply_mlp({k: torch.from_numpy(v) for k, v in params.items()},
                    torch.from_numpy(x), get_smoke_config(ARCH).replace(
                        mlp_act=act))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_unported_attention_options_raise_naming_roadmap():
    """Tied embeddings are not ported; a hybrid model (sliding window and
    SSM) serves but does not train yet."""
    cfg = get_smoke_config(ARCH)
    with pytest.raises(NotImplementedError, match="A.11"):
        LM(cfg.replace(tie_embeddings=True), device="cpu")
    with pytest.raises(NotImplementedError, match="A.11"):
        api.make_loss_fn(get_smoke_config("hymba_1_5b"))


def test_serve_on_cuda_raises_without_a_card(models, prompts):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(models[3], prompts, 2, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_params(models[0])
