"""Port parity: the ``vlm`` family (Pixtral's prefix embeddings) against the
reference.

On ``pixtral_smoke`` (2 layers, d 128, 8 query heads of 16 on 2 KV heads,
so ``num_heads x hd`` = 128 on d 128 as the full config's 4,096 on 5,120
is not; 8 patch embeddings; fp32), weights from the reference's
``api.init_params(cfg, PRNGKey(1))`` are carried across by
:func:`repro_torch.convert.lm_from_reference`; prompts and patch
embeddings come from numpy seeds.  The patches sit at positions 0-7, the
prompt after them, and decode continues at ``num_patches + S + i``: the
prefill's logits and caches, teacher-forced decode, ``serve``'s greedy
loop, the loss (the prefix's logits dropped) and every gradient against
the reference's; the port's own prefill/decode consistency at the shifted
position; the batch spec; ``serve``'s refusals; the abstract shapes of the
full ``pixtral_12b`` against ``jax.eval_shape``.  The fp32 products are
summed in another order by the two libraries: rtol = atol = 1e-4, as
``test_torch_glm4.py`` holds the dense family.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.models import api as japi
from repro_torch.configs.base import ShapeSpec, get_smoke_config
from repro_torch.convert import lm_from_reference
from repro_torch.data import pipeline
from repro_torch.lm.serve import serve
from repro_torch.models import api
from repro_torch.models.transformer import LM
from test_torch_moe import check_abstract

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
CONSIST_TOL = dict(rtol=2e-3, atol=2e-3)
B, S, STEPS = 2, 24, 3
ARCH = "pixtral_12b"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pixtral():
    cfg, jcfg = get_smoke_config(ARCH), jget_smoke_config(ARCH)
    params = _np(jax.jit(lambda key: japi.init_params(jcfg, key))(
        jax.random.PRNGKey(1)))
    port = LM(cfg, device="cpu")
    port.load_state_dict(lm_from_reference(cfg, params), strict=True)
    rs = np.random.RandomState(0)
    prompts = rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    patches = rs.normal(size=(B, cfg.num_patches, cfg.d_model)
                        ).astype(np.float32)
    return cfg, jcfg, params, port, prompts, patches


def test_prefill_and_shifted_decode_match_reference(pixtral):
    cfg, jcfg, params, port, prompts, patches = pixtral
    P = cfg.num_patches
    horizon = P + S + STEPS
    jl, jc = jax.jit(japi.make_prefill_fn(jcfg, horizon))(
        params, {"tokens": jnp.asarray(prompts),
                 "patch_embeds": jnp.asarray(patches)})
    logits, caches = api.make_prefill_fn(cfg, horizon)(
        port, {"tokens": torch.from_numpy(prompts).long(),
               "patch_embeds": torch.from_numpy(patches)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    for key in ("k", "v"):
        assert tuple(caches["kv"][key].shape) == (
            cfg.num_layers, B, horizon, cfg.num_kv_heads, cfg.hd)
        np.testing.assert_allclose(caches["kv"][key].numpy(),
                                   np.asarray(jc["kv"][key]), **TOL)
    jdecode = jax.jit(japi.make_decode_fn(jcfg))
    decode = api.make_decode_fn(cfg)
    forced = np.random.RandomState(1).randint(0, cfg.vocab_size, (STEPS, B))
    for i, tok in enumerate(forced):
        jl, jc = jdecode(params, jnp.asarray(tok, jnp.int32),
                         jnp.asarray(P + S + i, jnp.int32), jc)
        logits, caches = decode(port, torch.from_numpy(tok).long(),
                                P + S + i, caches)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(caches["kv"]["k"].numpy(),
                                   np.asarray(jc["kv"]["k"]), **TOL,
                                   err_msg=f"step {i}")


def test_serve_matches_reference_greedy_loop(pixtral):
    """``serve(..., patch_embeds=)`` end to end: greedy tokens equal the
    reference's prefill + decode loop at positions ``P + S + i``, caches
    sized to prefix + prompt + tokens."""
    cfg, jcfg, params, port, prompts, patches = pixtral
    n, P = 4, cfg.num_patches
    res = serve(port, prompts, n, device="cpu",
                patch_embeds=torch.from_numpy(patches))
    assert res.caches["kv"]["k"].shape[2] == P + S + n
    logits, caches = jax.jit(japi.make_prefill_fn(jcfg, P + S + n))(
        params, {"tokens": jnp.asarray(prompts),
                 "patch_embeds": jnp.asarray(patches)})
    jdecode = jax.jit(japi.make_decode_fn(jcfg))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for i in range(n - 1):
        logits, caches = jdecode(params, tok,
                                 jnp.asarray(P + S + i, jnp.int32), caches)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
    assert np.array_equal(res.tokens.numpy(), np.stack(want, 1))
    np.testing.assert_allclose(res.logits.numpy(), np.asarray(logits), **TOL)


def test_loss_and_every_gradient_match_reference(pixtral):
    """The pipeline's ``vlm`` batch (its ``patch_embeds`` included): the
    loss over the token positions only, and every gradient."""
    cfg, jcfg, params, port = pixtral[:4]
    batch = pipeline.synth_batch(cfg, ShapeSpec("t", 16, 2, "train"), 0)
    assert batch["patch_embeds"].shape == (2, cfg.num_patches, cfg.d_model)
    (want, wm), wgrads = jax.jit(jax.value_and_grad(
        japi.make_loss_fn(jcfg), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics = api.make_loss_fn(cfg)(
        port, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(port.parameters()))
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    assert float(metrics["moe_aux"]) == float(wm["moe_aux"]) == 0.0
    want_g = lm_from_reference(cfg, _np(wgrads))
    for (name, _), g in zip(port.named_parameters(), grads):
        scale = float(want_g[name].abs().max())
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   rtol=TOL["rtol"],
                                   atol=TOL["rtol"] * scale, err_msg=name)


def test_prefill_decode_consistency_after_the_prefix(pixtral):
    """Decoding token S+1 at position P + S gives the last logits of a
    forward over the prefix and S+1 tokens."""
    cfg, _, _, port, prompts, patches = pixtral
    tokens = torch.from_numpy(prompts).long()
    pe = torch.from_numpy(patches)
    logits, caches = api.make_prefill_fn(cfg)(
        port, {"tokens": tokens, "patch_embeds": pe})
    assert caches["kv"]["k"].shape[2] == cfg.num_patches + S + 128
    nxt = logits.argmax(-1)
    step, _ = api.make_decode_fn(cfg)(port, nxt, cfg.num_patches + S, caches)
    with torch.inference_mode():
        full, _ = port.lm_forward(torch.cat([tokens, nxt[:, None]], 1), pe)
    assert full.shape[1] == cfg.num_patches + S + 1
    np.testing.assert_allclose(step.numpy(), full[:, -1].numpy(),
                               **CONSIST_TOL)


def test_batch_spec_matches_reference(pixtral):
    cfg, jcfg = pixtral[:2]
    for kind in ("train", "prefill"):
        spec = api.batch_spec(cfg, ShapeSpec("t", 16, 2, kind))
        want = japi.batch_spec(jcfg, JShapeSpec("t", 16, 2, kind))
        assert set(spec) == set(want)
        for key, t in spec.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[key].shape, key
            assert str(t.dtype)[6:] == str(want[key].dtype), key


def test_serve_requires_patch_embeds_on_vlm_only(pixtral):
    cfg, _, _, port, prompts, patches = pixtral
    with pytest.raises(ValueError, match="patch_embeds"):
        serve(port, prompts, 2, device="cpu")
    with pytest.raises(ValueError, match="patch_embeds"):
        serve(port, prompts, 2, device="cpu",
              patch_embeds=torch.from_numpy(patches[:, :3]))
    dense = LM(get_smoke_config("glm4_9b"), device="cpu")
    with pytest.raises(ValueError, match="no patch_embeds"):
        serve(dense, prompts, 2, device="cpu",
              patch_embeds=torch.from_numpy(patches))


def test_abstract_params_and_caches_match_reference():
    """The full config on ``meta``, leaf by leaf: 32 heads of 128 on d
    5,120 (wq (5120, 32, 128), wo (32, 128, 5120))."""
    got = check_abstract(ARCH)
    assert tuple(got["blocks.0.attn.wo"].shape) == (32, 128, 5120)
