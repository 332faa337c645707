"""Port parity: flash attention, RoPE and cached decode attention.

The port's ``flash_attention`` runs its plain version on the CPU
(``kernels/flash_attention/ref.py::attention_ref``); it is held against
the reference's Pallas kernel run in interpret mode (``bq = bk = 32``, as
``tests/test_kernels.py`` runs it) and against the reference's own
``attention_ref``, on the same numpy inputs, within
``kernels/flash_attention/cases.py::TOL`` (fp32 1e-5; bf16 two bf16 ulps,
because the Pallas kernel rounds ``q * scale`` and ``q @ k.T`` to bf16
where the port keeps fp32).  The port's ``attention_ctx``, which sends
every size through ``flash_attention``, is held against the reference's
on its dense branch (S = 48) and its ``flash_jnp`` branch (S = 2304).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro.models import attention as jattn
from repro.models.common import apply_rope as japply_rope
from repro_torch.configs.base import get_smoke_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.cases import (bwd_within_tol,
                                                       hard_cases, make_case,
                                                       tensors, within_tol)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import attention as attn
from repro_torch.models.common import apply_rope

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ARCH = "glm4_9b"
# The hard cases at the smoke config's and glm4's head widths (16, 128),
# short of the 1024-token ones; the card holds the kernel on all of them.
CASES = [c for c in hard_cases()
         if c["q"].shape[2] < 1024 and c["q"].shape[3] != 64]


def _jnp(x, dtype=jnp.float32):
    return jnp.asarray(x).astype(dtype)


def _port(case, dtype):
    q, k, v = tensors(case, "cpu", dtype)
    return flash_ops.flash_attention(q, k, v, case["causal"])


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,d,causal,dtype", [
    (2, 4, 2, 64, 64, 32, True, "float32"),       # tests/test_kernels.py
    (1, 8, 8, 100, 100, 16, True, "float32"),
    (2, 4, 1, 40, 72, 32, False, "float32"),
    (1, 4, 2, 97, 97, 16, True, "float32"),       # ragged causal
    (2, 8, 2, 40, 72, 16, True, "float32"),       # causal, Tq != Tk
    (1, 4, 2, 97, 97, 16, True, "bfloat16"),
])
def test_plain_matches_interpreted_pallas_kernel(B, Hq, Hkv, Tq, Tk, d,
                                                 causal, dtype):
    case = make_case(B, Hkv, Hq // Hkv, Tq, Tk, d, causal, seed=B * Tq)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jflash(*(_jnp(case[n], jdt) for n in "qkv"), causal=causal,
                  bq=32, bk=32, interpret=True)
    got = _port(case, getattr(torch, dtype))
    assert got.shape == (B, Hq, Tq, d) and str(got.dtype) == f"torch.{dtype}"
    assert within_tol(got, torch.from_numpy(
        np.asarray(want.astype(jnp.float32))), dtype) <= 0


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_plain_matches_reference_attention_ref_fp32(case):
    want = jattention_ref(*(_jnp(case[n]) for n in "qkv"),
                          causal=case["causal"])
    got = _port(case, torch.float32)
    assert within_tol(got, torch.from_numpy(np.asarray(want)), "float32",
                      case["score_scale"]) <= 0


@pytest.mark.parametrize("case", [c for c in CASES[1::4]
                                  if c["score_scale"] == 1.0],
                         ids=lambda c: c["name"])
def test_plain_matches_reference_attention_ref_bf16(case):
    """In bf16 the reference rounds the scores and the softmax to bf16;
    the port keeps both in fp32: two bf16 ulps at scores of order 1.  (At
    large scores a bf16 rounding of a score moves the softmax itself, so
    the large-magnitude cases are held in fp32 here, and kernel against
    plain version in bf16 on the card.)"""
    want = jattention_ref(*(_jnp(case[n], jnp.bfloat16) for n in "qkv"),
                          causal=case["causal"])
    got = _port(case, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert within_tol(got, torch.from_numpy(
        np.asarray(want.astype(jnp.float32))), "bfloat16") <= 0


@pytest.mark.parametrize("S,Hq,Hkv", [(48, 8, 2), (2304, 8, 2)])
def test_attention_ctx_matches_reference(S, Hq, Hkv):
    """S = 48 takes the reference's dense branch, S = 2304 (S * S > 2**22,
    chunks dividing S) its ``flash_jnp`` custom-VJP branch."""
    rs = np.random.RandomState(S)
    q = rs.normal(size=(1, S, Hq, 16)).astype(np.float32)
    k = rs.normal(size=(1, S, Hkv, 16)).astype(np.float32)
    v = rs.normal(size=(1, S, Hkv, 16)).astype(np.float32)
    want = jattn.attention_ctx(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jget_smoke_config(ARCH), causal=True)
    got = attn.attention_ctx(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), get_smoke_config(ARCH))
    assert got.shape == (1, S, Hq, 16)
    assert within_tol(got, torch.from_numpy(np.asarray(want)),
                      "float32") <= 0


@pytest.mark.parametrize("positions", ["prefill", "decode"])
def test_apply_rope_matches_reference(positions):
    rs = np.random.RandomState(5)
    x = rs.normal(size=(2, 4, 9, 16)).astype(np.float32)
    pos = (np.arange(9) if positions == "prefill"
           else np.array([1000]) + np.zeros(9, np.int64))
    want = japply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if positions == "prefill":            # position 0 is the identity
        np.testing.assert_array_equal(got[:, :, 0].numpy(), x[:, :, 0])


def test_decode_attention_and_cache_update_match_reference():
    cfg, jcfg = get_smoke_config(ARCH), jget_smoke_config(ARCH)
    rs = np.random.RandomState(7)
    Bq, L, H, K, hd = 2, 12, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    kc = rs.normal(size=(Bq, L, K, hd)).astype(np.float32)
    vc = rs.normal(size=(Bq, L, K, hd)).astype(np.float32)
    k_new = rs.normal(size=(Bq, 1, K, hd)).astype(np.float32)
    v_new = rs.normal(size=(Bq, 1, K, hd)).astype(np.float32)
    q = rs.normal(size=(Bq, 1, H, hd)).astype(np.float32)
    pos = 7
    jcache = jattn.cache_update({"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                                jnp.asarray(k_new), jnp.asarray(v_new),
                                jnp.asarray(pos), jcfg)
    cache = {"k": torch.from_numpy(kc.copy()),
             "v": torch.from_numpy(vc.copy())}
    out = attn.cache_update(cache, torch.from_numpy(k_new),
                            torch.from_numpy(v_new), pos)
    assert out is cache                                  # in place
    for key in ("k", "v"):
        np.testing.assert_array_equal(cache[key].numpy(),
                                      np.asarray(jcache[key]))
    want = jattn.decode_attention(jnp.asarray(q), jcache, jnp.asarray(pos),
                                  jcfg)
    got = attn.decode_attention(torch.from_numpy(q), cache, pos)
    assert got.shape == (Bq, 1, H, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_flash_attention_rejects_what_the_kernel_cannot_run():
    """The refusals, and what is no longer one: an input that needs a
    gradient now gets it (``FlashAttentionFunction``; on the CPU the plain
    backward), equal to ``autograd`` through the plain forward within
    ``cases.BWD_TOL``."""
    case = make_case(1, 1, 2, 8, 8, 16, True)
    q, k, v = tensors(case, "cpu")
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_ops.flash_attention(*xs)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out.sum(), xs)
    ys = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*ys).sum(), ys)
    for g, w in zip(got, want):
        assert bool(g.isfinite().all())
        assert bwd_within_tol(g, w, "float32") <= 0
    odd = torch.zeros((1, 2, 8, 24))
    with pytest.raises(ValueError, match="head width"):
        flash_ops.flash_attention(odd, odd[:, :1], odd[:, :1])
    with pytest.raises(ValueError, match="share a dtype"):
        flash_ops.flash_attention(q.detach(), k.bfloat16(), v)
    with pytest.raises(ValueError, match="unit stride"):
        flash_ops.flash_attention(q.detach().transpose(2, 3).contiguous()
                                  .transpose(2, 3), k, v)
