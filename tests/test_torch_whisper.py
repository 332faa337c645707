"""Port parity: the ``encdec`` family (Whisper-medium) against the reference.

On ``whisper_smoke`` (2 encoder and 2 decoder layers, d 128, 8 heads of
16, vocab 512, LayerNorm and gelu, no RoPE; fp32), weights from the
reference's ``api.init_params(cfg, PRNGKey(1))`` are carried across by
:func:`repro_torch.convert.encdec_from_reference`; frames and prompts come
from numpy seeds, 40 frames against 24 tokens (and 24 against 24, as
``batch_spec`` has it).  The encoder, the prefill's last logits and every
cache field (``kv`` padded to the horizon, ``xk``, ``xv``), teacher-forced
decode at ``S + i``, ``serve``'s greedy loop, the loss and every gradient,
one train step (parameters and moments, the stacked decay rule on
``enc_blocks`` and ``dec_blocks``), the batch spec, ``serve``'s refusals
and the abstract shapes of the full ``whisper_medium`` against
``jax.eval_shape``.  The reference side runs under ``jax.jit``.  The fp32
products are summed in another order by the two libraries: rtol = atol =
1e-4, as ``test_torch_vlm.py`` holds its family.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.base import get_config as jget_config
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.models import api as japi
from repro.models import encdec as jencdec
from repro.train import optimizer as jopt
from repro.train import train_loop as jtrain_loop
from repro_torch.configs.base import ShapeSpec, get_config, get_smoke_config
from repro_torch.convert import (encdec_from_reference,
                                 opt_state_from_reference)
from repro_torch.data import pipeline
from repro_torch.lm.serve import serve
from repro_torch.models import api
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import LM
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_loop

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
B, S, S_ENC, STEPS = 2, 24, 40, 3
ARCH = "whisper_medium"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def whisper():
    cfg, jcfg = get_smoke_config(ARCH), jget_smoke_config(ARCH)
    params = _np(jax.jit(lambda key: japi.init_params(jcfg, key))(
        jax.random.PRNGKey(1)))
    port = EncDec(cfg, device="cpu")
    port.load_state_dict(encdec_from_reference(cfg, params), strict=True)
    rs = np.random.RandomState(0)
    prompts = rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rs.normal(size=(B, S_ENC, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, params, port, prompts, frames


def test_encode_matches_reference(whisper):
    cfg, jcfg, params, port, _, frames = whisper
    want = jax.jit(lambda p, f: jencdec.encode(p, f, jcfg))(
        params, jnp.asarray(frames))
    with torch.inference_mode():
        got = port.encode(torch.from_numpy(frames))
    assert tuple(got.shape) == (B, S_ENC, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s_enc", [S_ENC, S])
def test_prefill_and_decode_match_reference(whisper, s_enc):
    """The prefill's last logits and caches (``kv`` padded to the horizon,
    ``xk`` and ``xv`` over the frames), then teacher-forced decode steps
    at ``S + i``: logits and every cache field."""
    cfg, jcfg, params, port, prompts, frames = whisper
    frames = frames[:, :s_enc]
    horizon = S + STEPS
    jl, jc = jax.jit(japi.make_prefill_fn(jcfg, horizon))(
        params, {"tokens": jnp.asarray(prompts),
                 "frames": jnp.asarray(frames)})
    logits, caches = api.make_prefill_fn(cfg, horizon)(
        port, {"tokens": torch.from_numpy(prompts).long(),
               "frames": torch.from_numpy(frames)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd
    want_shapes = {"k": (L, B, horizon, K, hd), "xk": (L, B, s_enc, K, hd)}

    def check(caches, jc, msg):
        pairs = [(f"kv.{key}", caches["kv"][key], jc["kv"][key])
                 for key in "kv"]
        pairs += [(key, caches[key], jc[key]) for key in ("xk", "xv")]
        for name, got, want in pairs:
            assert tuple(got.shape) == np.asarray(want).shape, name
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                       err_msg=f"{msg} {name}")
    assert tuple(caches["kv"]["k"].shape) == want_shapes["k"]
    assert tuple(caches["xk"].shape) == want_shapes["xk"]
    check(caches, jc, "prefill")
    jdecode = jax.jit(japi.make_decode_fn(jcfg))
    decode = api.make_decode_fn(cfg)
    forced = np.random.RandomState(1).randint(0, cfg.vocab_size, (STEPS, B))
    for i, tok in enumerate(forced):
        jl, jc = jdecode(params, jnp.asarray(tok, jnp.int32),
                         jnp.asarray(S + i, jnp.int32), jc)
        logits, caches = decode(port, torch.from_numpy(tok).long(), S + i,
                                caches)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {i}")
        check(caches, jc, f"step {i}")


def test_serve_matches_reference_greedy_loop(whisper):
    """``serve(..., frames=)`` end to end: greedy tokens equal the
    reference's prefill + decode loop at positions ``S + i``, the
    self-attention caches sized to prompt + tokens."""
    cfg, jcfg, params, port, prompts, frames = whisper
    n = 4
    res = serve(port, prompts, n, device="cpu",
                frames=torch.from_numpy(frames))
    assert res.caches["kv"]["k"].shape[2] == S + n
    assert res.caches["xk"].shape[2] == S_ENC
    logits, caches = jax.jit(japi.make_prefill_fn(jcfg, S + n))(
        params, {"tokens": jnp.asarray(prompts),
                 "frames": jnp.asarray(frames)})
    jdecode = jax.jit(japi.make_decode_fn(jcfg))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for i in range(n - 1):
        logits, caches = jdecode(params, tok, jnp.asarray(S + i, jnp.int32),
                                 caches)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
    assert np.array_equal(res.tokens.numpy(), np.stack(want, 1))
    np.testing.assert_allclose(res.logits.numpy(), np.asarray(logits), **TOL)


def test_loss_and_every_gradient_match_reference(whisper):
    """The pipeline's ``encdec`` batch (frames as long as the tokens): the
    loss, its one term and every gradient."""
    cfg, jcfg, params, port = whisper[:4]
    batch = pipeline.synth_batch(cfg, ShapeSpec("t", 16, 2, "train"), 0)
    assert batch["frames"].shape == (2, 16, cfg.d_model)
    (want, wm), wgrads = jax.jit(jax.value_and_grad(
        japi.make_loss_fn(jcfg), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics = api.make_loss_fn(cfg)(
        port, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(port.parameters()))
    assert set(metrics) == set(wm) == {"xent"}
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    want_g = encdec_from_reference(cfg, _np(wgrads))
    names = [name for name, _ in port.named_parameters()]
    assert set(names) == set(want_g)
    for name, g in zip(names, grads):
        scale = float(want_g[name].abs().max())
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   rtol=TOL["rtol"],
                                   atol=TOL["rtol"] * scale, err_msg=name)


def test_stacked_decay_follows_the_reference_rank_rule(whisper):
    """The reference decays ``p.ndim >= 2`` of its tree, whose encoder and
    decoder blocks are stacked: every per-layer LayerNorm vector of both
    stacks, not ``ln_enc`` or ``ln_f``.  :func:`stacked_decay` on the
    port's unstacked names gives the same mask, leaf for leaf."""
    cfg, _, params, port = whisper[:4]
    want = {}
    for name, leaf in encdec_from_reference(cfg, params).items():
        stack = name.split(".")[0]
        ndim = leaf.ndim + int(stack in ("enc_blocks", "dec_blocks"))
        want[name] = ndim >= 2
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [p.key for p in path]
        if keys[0] in ("enc_blocks", "dec_blocks"):
            layers = leaf.shape[0]
            assert all(want[f"{keys[0]}.{i}.{'.'.join(keys[1:])}"]
                       == (leaf.ndim >= 2) for i in range(layers))
        else:
            assert want[".".join(keys)] == (leaf.ndim >= 2)
    got = {n: opt_mod.stacked_decay(n, p)
           for n, p in port.named_parameters()}
    assert got == want
    vectors = [n for n, p in port.named_parameters()
               if p.ndim == 1 and got[n]]
    # ln1, ln2 (scale, bias) a encoder block; ln1, ln_x, ln2 a decoder one
    assert len(vectors) == 4 * cfg.encoder_layers + 6 * cfg.num_layers
    assert not got["ln_enc.scale"] and not got["ln_f.bias"]
    assert not any(opt_mod.matrix_decay(n, port.get_parameter(n))
                   for n in vectors)


def test_train_step_matches_reference(whisper):
    """One step of ``make_train_step`` in 2 microbatches (each slicing
    ``frames`` with the tokens): loss, gradient norm, learning rate, the
    updated parameters and both moments against the reference's step.  As
    ``test_torch_train.py``: eps 1e-3 keeps a first AdamW step a smooth
    function of the gradient; the parameters are held to 1e-3 of lr."""
    cfg, jcfg, params = whisper[:3]
    ocfg = jopt.OptConfig(lr=1e-3, eps=1e-3, warmup_steps=0, total_steps=10)
    jstep = jax.jit(jtrain_loop.make_train_step(jcfg, ocfg, 2))
    batch = pipeline.synth_batch(cfg, ShapeSpec("t", 16, 4, "train"), 1)
    jp, js, jm = jstep(params, jopt.init_opt_state(params, ocfg),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    model = EncDec(cfg, device="cpu")
    model.load_state_dict(encdec_from_reference(cfg, params), strict=True)
    tcfg = opt_mod.OptConfig(**dataclasses.asdict(ocfg))
    state = opt_mod.init_opt_state(dict(model.named_parameters()), tcfg)
    step = train_loop.make_train_step(cfg, tcfg, 2)
    model, state, metrics = step(
        model, state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "xent", "grad_norm"):
        assert float(metrics[key]) == pytest.approx(float(jm[key]),
                                                    rel=1e-4), key
    assert float(metrics["lr"]) == float(jm["lr"])
    assert int(state["step"]) == 1
    to_port = functools.partial(encdec_from_reference, cfg)
    want = to_port(_np(jp))
    want_s = opt_state_from_reference(_np(js), to_port)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-3 * ocfg.lr, err_msg=name)
        for key in ("m", "v"):
            w = want_s[key][name]
            np.testing.assert_allclose(
                state[key][name].numpy(), w.numpy(), rtol=TOL["rtol"],
                atol=TOL["rtol"] * float(w.abs().max()),
                err_msg=f"{key} {name}")


def test_batch_spec_matches_reference(whisper):
    cfg, jcfg = whisper[:2]
    for kind in ("train", "prefill"):
        spec = api.batch_spec(cfg, ShapeSpec("t", 16, 2, kind))
        want = japi.batch_spec(jcfg, JShapeSpec("t", 16, 2, kind))
        assert set(spec) == set(want)
        for key, t in spec.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[key].shape, key
            assert str(t.dtype)[6:] == str(want[key].dtype), key


def test_serve_requires_frames_on_encdec_only(whisper):
    cfg, _, _, port, prompts, frames = whisper
    with pytest.raises(ValueError, match="frames"):
        serve(port, prompts, 2, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        serve(port, prompts, 2, device="cpu",
              frames=torch.from_numpy(frames[:1]))
    with pytest.raises(ValueError, match="frames"):
        serve(port, prompts, 2, device="cpu",
              frames=torch.from_numpy(frames[..., :64]))
    dense = LM(get_smoke_config("glm4_9b"), device="cpu")
    with pytest.raises(ValueError, match="no frames"):
        serve(dense, prompts, 2, device="cpu",
              frames=torch.from_numpy(frames))


def test_lm_refuses_encdec_and_names_encdec_module():
    cfg = get_smoke_config(ARCH)
    with pytest.raises(NotImplementedError, match="encdec.py::EncDec"):
        LM(cfg, device="cpu")
    with pytest.raises(ValueError, match="encdec"):
        EncDec(get_smoke_config("glm4_9b"), device="cpu")
    with pytest.raises(NotImplementedError, match="A.11"):
        EncDec(cfg.replace(sliding_window=8), device="cpu")


def test_encdec_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_params(get_smoke_config(ARCH))


def test_abstract_params_and_caches_match_reference():
    """The full config on ``meta``, leaf by leaf against ``jax.eval_shape``
    (24 encoder and 24 decoder blocks unstacked; 16 heads of 64 on d
    1,024), and its decode caches (the cross caches over as many frames as
    the horizon, as the reference's)."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    want = japi.abstract_params(jcfg)
    got = api.abstract_params(cfg).state_dict()
    stacks = {"enc_blocks": cfg.encoder_layers, "dec_blocks": cfg.num_layers}
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        keys = [p.key for p in path]
        if keys[0] in stacks:
            names = [f"{keys[0]}.{i}.{'.'.join(keys[1:])}"
                     for i in range(stacks[keys[0]])]
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
    assert tuple(got["dec_blocks.0.cross_attn.wq"].shape) == (1024, 16, 64)
    shape = ShapeSpec("decode_32k", 4096, 8, "decode")
    wc = japi.abstract_caches(jcfg, JShapeSpec("decode_32k", 4096, 8,
                                               "decode"))
    gc = api.abstract_caches(cfg, shape)
    pairs = [(gc["kv"][k], wc["kv"][k]) for k in "kv"]
    pairs += [(gc[k], wc[k]) for k in ("xk", "xv")]
    for g, w in pairs:
        assert tuple(g.shape) == w.shape
        assert str(g.dtype)[6:] == str(w.dtype)
        assert g.device.type == "meta"
