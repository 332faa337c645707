"""Port parity: the ``hybrid`` family (Hymba) served against the reference.

On ``hymba_smoke`` (2 layers, d 160, 5 query heads on 1 KV head of 32,
SwiGLU d_ff 384, vocab 512, SSM state 8, a sliding window of 64; fp32),
weights from the reference's ``api.init_params(cfg, PRNGKey(1))`` are
carried across by :func:`repro_torch.convert.lm_from_reference`; prompts
come from numpy seeds.  Each layer runs attention (through the flash
attention with the window; the reference's ``dense_attention`` with its
``_mask`` at these sizes) and the selective scan side by side.  The
prefill's last logits, its ring caches (padded to the window under it, at
S 40; the last 64 keys rolled by S % 64 past it, at S 100) and SSM states;
teacher-forced decode across ring slot 64 and at positions past 10 x the
window; ``serve``'s greedy loop; the flash plain version's windows
against the reference's ``dense_attention`` and ``flash_attention_train``;
the full config's abstract shapes against ``jax.eval_shape``; and the
refusals (hybrid training, a window in grad mode or without causal).
The reference runs under ``jax.jit``.  fp32 products summed in another
order by the two libraries: rtol = atol = 1e-4.
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
from repro.models import attention as jattn
from repro.models.flash_jnp import flash_attention_train
from repro_torch.configs.base import ShapeSpec, get_config, get_smoke_config
from repro_torch.convert import lm_from_reference
from repro_torch.kernels.flash_attention import cases as flash_cases
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                     attention_ref)
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.lm import train as lm_train
from repro_torch.lm.serve import serve
from repro_torch.models import api
from repro_torch.models.transformer import LM

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
CONSIST_TOL = dict(rtol=2e-3, atol=2e-3)
ARCH = "hymba_1_5b"
B, W = 2, 64
LENGTHS = (40, 60, 100)        # under the window, to cross slot 64, past it


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def hymba():
    cfg, jcfg = get_smoke_config(ARCH), jget_smoke_config(ARCH)
    assert cfg.sliding_window == jcfg.sliding_window == W
    params = _np(jax.jit(lambda key: japi.init_params(jcfg, key))(
        jax.random.PRNGKey(1)))
    port = LM(cfg, device="cpu")
    port.load_state_dict(lm_from_reference(cfg, params), strict=True)
    jprefill = jax.jit(japi.make_prefill_fn(jcfg))
    jdecode = jax.jit(japi.make_decode_fn(jcfg))
    return cfg, jcfg, params, port, jprefill, jdecode


@pytest.fixture(scope="module")
def prompts():
    rs = np.random.RandomState(0)
    return {S: rs.randint(0, 512, (B, S)).astype(np.int32) for S in LENGTHS}


@pytest.fixture(scope="module")
def prefilled(hymba, prompts):
    cfg, _, params, port, jprefill, _ = hymba
    out = {}
    for S in LENGTHS:
        want_logits, want_caches = jprefill(
            params, {"tokens": jnp.asarray(prompts[S])})
        logits, caches = api.make_prefill_fn(cfg)(
            port, {"tokens": torch.from_numpy(prompts[S]).long()})
        out[S] = (np.asarray(want_logits), _np(want_caches)), (logits,
                                                               caches)
    return out


def _check_caches(caches, want, msg):
    assert set(caches) == set(want) == {"kv", "ssm"}
    for key in "kv":
        np.testing.assert_allclose(caches["kv"][key].numpy(),
                                   np.asarray(want["kv"][key]), **TOL,
                                   err_msg=f"{msg} {key}")
    np.testing.assert_allclose(caches["ssm"].numpy(), np.asarray(want["ssm"]),
                               **TOL, err_msg=f"{msg} ssm")


@pytest.mark.parametrize("S", [40, 100])
def test_prefill_matches_reference(hymba, prefilled, S):
    """The last logits, the KV rings (S 40: padded to the window; S 100:
    the last 64 keys rolled by 36, position p at slot p % 64) and the fp32
    SSM states."""
    cfg = hymba[0]
    (want_logits, want_caches), (logits, caches) = prefilled[S]
    assert logits.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    assert tuple(caches["kv"]["k"].shape) == (cfg.num_layers, B, W,
                                              cfg.num_kv_heads, cfg.hd)
    assert caches["ssm"].shape == (cfg.num_layers, B, cfg.d_model,
                                   cfg.ssm_state)
    assert caches["ssm"].dtype == torch.float32
    _check_caches(caches, want_caches, f"S {S}")


def _forced_steps(hymba, prefilled, S, positions, seed):
    cfg, _, params, port, _, jdecode = hymba
    (_, jcaches), (_, caches) = prefilled[S]
    jcaches = jax.tree_util.tree_map(jnp.asarray, jcaches)
    # the port's decode writes its slots and states in place: a copy
    caches = {"kv": {k: a.clone() for k, a in caches["kv"].items()},
              "ssm": caches["ssm"].clone()}
    decode = api.make_decode_fn(cfg)
    forced = np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                 (len(positions), B))
    for tok, pos in zip(forced, positions):
        jlogits, jcaches = jdecode(params, jnp.asarray(tok, jnp.int32),
                                   jnp.asarray(pos, jnp.int32), jcaches)
        logits, caches = decode(port, torch.from_numpy(tok).long(), pos,
                                caches)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL, err_msg=f"pos {pos}")
        _check_caches(caches, jcaches, f"pos {pos}")


def test_teacher_forced_decode_across_slot_64(hymba, prefilled):
    """From a 60-token prefill, positions 60-65: slots 60-63, then the ring
    wraps to slots 0 and 1 (the first positions fall out of the window)."""
    _forced_steps(hymba, prefilled, 60, range(60, 66), 1)


def test_decode_far_past_the_window(hymba, prefilled):
    """From the 100-token prefill, positions 700-705 (past 10 x the window;
    slots 60-63, 0, 1): every slot valid, RoPE at the far positions."""
    _forced_steps(hymba, prefilled, 100, range(10 * W + 60, 10 * W + 66), 2)


def test_prefill_decode_consistency(hymba, prompts):
    """Decoding token S+1 after prefilling S tokens (past the window) gives
    the last logits of a forward over the S+1 tokens."""
    cfg, port = hymba[0], hymba[3]
    tokens = torch.from_numpy(prompts[100]).long()
    logits, caches = api.make_prefill_fn(cfg)(port, {"tokens": tokens})
    nxt = logits.argmax(-1)
    step, _ = api.make_decode_fn(cfg)(port, nxt, 100, caches)
    with torch.inference_mode():
        full, _ = port.lm_forward(torch.cat([tokens, nxt[:, None]], 1))
    np.testing.assert_allclose(step.numpy(), full[:, -1].numpy(),
                               **CONSIST_TOL)


def test_serve_matches_reference_greedy_loop(hymba, prompts):
    cfg, jcfg, params, port, _, jdecode = hymba
    S, n = 100, 5
    res = serve(port, prompts[S], n, device="cpu")
    assert res.tokens.shape == (B, n) and len(res.decode_s) == n - 1
    assert res.caches["kv"]["k"].shape[2] == W          # the ring
    logits, caches = jax.jit(japi.make_prefill_fn(jcfg, S + n))(
        params, {"tokens": jnp.asarray(prompts[S])})
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for i in range(n - 1):
        logits, caches = jdecode(params, tok, jnp.asarray(S + i, jnp.int32),
                                 caches)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
    assert np.array_equal(res.tokens.numpy(), np.stack(want, 1))
    np.testing.assert_allclose(res.logits.numpy(), np.asarray(logits), **TOL)
    _check_caches(res.caches, caches, "serve")


def test_prefill_runs_the_windowed_flash_and_the_scan_once_per_layer(
        hymba, prompts, monkeypatch):
    """Each layer: one flash-attention call with the window, and one
    selective scan on the gates as the model makes them (B and C the two
    halves of one tensor)."""
    cfg, port = hymba[0], hymba[3]
    flash, scans = [], []
    f0, s0 = flash_ops.flash_attention, scan_ops.ssm_scan

    def flash_counting(q, k, v, causal=True, window=0):
        flash.append((tuple(q.shape), causal, window))
        return f0(q, k, v, causal, window)

    def scan_counting(xi, Bm, Cm, dt, A, h0=None):
        scans.append((tuple(xi.shape), Bm.stride(), h0))
        return s0(xi, Bm, Cm, dt, A, h0)
    monkeypatch.setattr(flash_ops, "flash_attention", flash_counting)
    monkeypatch.setattr(scan_ops, "ssm_scan", scan_counting)
    api.make_prefill_fn(cfg)(port,
                             {"tokens": torch.from_numpy(prompts[100]).long()})
    H, hd, n = cfg.num_heads, cfg.hd, cfg.ssm_state
    assert flash == [((B, H, 100, hd), True, W)] * cfg.num_layers
    assert [s[0] for s in scans] == [(B, 100, cfg.d_model)] * cfg.num_layers
    assert scans[0][1] == (100 * 2 * n, 2 * n, 1) and scans[0][2] is None


@pytest.mark.parametrize("window", [1, 7, 64, 128])
def test_attention_ref_windows_match_reference(window):
    """The plain version of the windowed flash forward against the
    reference's ``dense_attention`` (``_mask``) and its ``flash_jnp``
    (``flash_attention_train``, chunks of 32) at T 128, group 5; a window
    of T masks nothing."""
    T, hd = 128, 32
    case = flash_cases.make_case(B, 1, 5, T, T, hd, True, "bthd", seed=window,
                                 window=window)
    q, k, v = flash_cases.tensors(case, "cpu")
    got = attention_ref(q, k, v, True, window)
    jcfg = jget_smoke_config(ARCH).replace(sliding_window=window)
    jq, jk, jv = (jnp.asarray(case[n].transpose(0, 2, 1, 3)) for n in "qkv")
    dense = jattn.dense_attention(jq, jk, jv, jcfg, True)
    with jax.disable_jit():
        flash = flash_attention_train(jq, jk, jv, causal=True, window=window,
                                      q_chunk=32, k_chunk=32)
    for want in (dense, flash):
        want = torch.from_numpy(np.asarray(want).transpose(0, 2, 1, 3)
                                .copy())
        assert flash_cases.within_tol(got, want, "float32") <= 0
    if window >= T:
        assert torch.equal(got, attention_ref(q, k, v, True))


def test_flash_plain_version_gives_rows_without_keys_zero():
    """Tq > Tk + window - 1: the last rows see no key; they get o = 0 and
    lse NEG_INF (the kernels' rule), the others their window."""
    case = [c for c in flash_cases.window_cases()
            if c["q"].shape[2] != c["k"].shape[2]][0]
    q, k, v = flash_cases.tensors(case, "cpu")
    w, Tk = case["window"], k.shape[2]
    o, lse = attention_lse_ref(q, k, v, True, w)
    dead = Tk + w - 1
    assert bool((o[:, :, dead:] == 0).all()) and bool(o.isfinite().all())
    assert bool((lse[:, :, dead:] == -1e30).all())
    live = attention_ref(q[:, :, :dead], k, v, True, w)
    assert torch.equal(o[:, :, :dead], live)


def test_abstract_params_and_caches_match_reference():
    """The full config on ``meta``, leaf by leaf against ``jax.eval_shape``
    (32 blocks unstacked; ``a_log`` fp32 among bf16 weights), and its
    decode caches: the ring of 4,096 slots (not the horizon) and the fp32
    SSM state, at decode_32k and long_500k."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
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
    assert got["blocks.0.ssm.a_log"].dtype == torch.float32
    assert tuple(got["blocks.31.ssm.w_bc"].shape) == (1600, 32)
    for name, (Bq, Sq) in (("decode_32k", (128, 32768)),
                           ("long_500k", (1, 524288))):
        wc = japi.abstract_caches(jcfg, JShapeSpec(name, Sq, Bq, "decode"))
        gc = api.abstract_caches(cfg, ShapeSpec(name, Sq, Bq, "decode"))
        for g, w in [(gc["kv"][k], wc["kv"][k]) for k in "kv"] + [
                (gc["ssm"], wc["ssm"])]:
            assert tuple(g.shape) == w.shape, name
            assert str(g.dtype)[6:] == str(w.dtype), name
            assert g.device.type == "meta"
    assert tuple(gc["kv"]["k"].shape) == (32, 1, 4096, 5, 64)
    assert tuple(gc["ssm"].shape) == (32, 1, 1600, 16)


def test_hybrid_training_and_windowed_gradients_raise():
    """Hymba serves only: its loss, the trainer and a windowed flash call
    in grad mode name ROADMAP A.11 step 2b; a window needs causal and must
    not be negative."""
    cfg = get_smoke_config(ARCH)
    with pytest.raises(NotImplementedError, match="A.11 step 2b"):
        api.make_loss_fn(cfg)
    with pytest.raises(NotImplementedError, match="A.11 step 2b"):
        lm_train.train(cfg, 1, device="cpu", log=None)
    case = flash_cases.make_case(1, 1, 5, 8, 8, 16, True, window=4)
    q, k, v = flash_cases.tensors(case, "cpu")
    with pytest.raises(NotImplementedError, match="A.11 step 2b"):
        flash_ops.flash_attention(q.requires_grad_(), k, v, True, 4)
    q = q.detach()
    with pytest.raises(ValueError, match="causal"):
        flash_ops.flash_attention(q, k, v, False, 4)
    with pytest.raises(ValueError, match=">= 0"):
        flash_ops.flash_attention(q, k, v, True, -1)
    with torch.no_grad():                    # serving takes the window
        o = flash_ops.flash_attention(q.requires_grad_(), k, v, True, 4)
    assert torch.equal(o, attention_ref(q, k, v, True, 4))
