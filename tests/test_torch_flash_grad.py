"""Port parity: training attention and its backward against the reference.

The plain backward (``kernels/flash_attention/ref.py::
flash_attention_bwd_ref``, the formulas of ``csrc/flash_attn_bwd.cu``) and
the port's ``models/flash_train.py::flash_mha`` are held against
``jax.vjp`` of the reference's ``models/flash_jnp.py::flash_mha`` (its
custom VJP, ``_flash_bwd``) on the same numpy inputs: B 2, S 64, chunks of
16 queries and 32 keys, groups of 1, 3 and 4 query heads a KV head, causal
and not, fp32.  ``flash_attention``'s gradient on the CPU
(``FlashAttentionFunction`` over the plain versions) is held against
``jax.grad`` of the reference's ``dense_attention`` and
``flash_attention_train``; ``dense_attention``, ``chunked_attention`` and
``_mask`` (windows included) against the reference's.  Tolerances: the
gradients ``1e-5 * max|ref| + 1e-6`` (``cases.BWD_TOL``: the same fp32
formulas, summed in another order); the forwards ``cases.TOL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.models import attention as jattn
from repro.models import flash_jnp as jflash
from repro_torch.configs.base import get_smoke_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.cases import (bwd_cases,
                                                       bwd_tensors,
                                                       bwd_within_tol,
                                                       lse_within_tol,
                                                       within_tol)
from repro_torch.kernels.flash_attention.ref import (
    NEG_INF, attention_bwd_f32, attention_lse_ref, attention_ref,
    flash_attention_bwd_ref, flash_attention_bwd_split_ref)
from repro_torch.models import attention as attn
from repro_torch.models import flash_train

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ARCH = "glm4_9b"
B, S, HD, QC, KC = 2, 64, 16, 16, 32


def _inputs(K, g, seed, T=S):
    rs = np.random.RandomState(seed)
    return (rs.normal(size=(B, K, g, S, HD)).astype(np.float32),
            rs.normal(size=(B, K, T, HD)).astype(np.float32),
            rs.normal(size=(B, K, T, HD)).astype(np.float32),
            rs.normal(size=(B, K, g, S, HD)).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _close(got, want, what=""):
    assert got.shape == want.shape, what
    assert bwd_within_tol(got, want, "float32") <= 0, what


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 3, 4])
def test_bwd_ref_and_flash_mha_match_reference_vjp(group, causal):
    """The reference's forward (o, lse) and ``jax.vjp`` of its ``flash_mha``
    against the port's ``flash_mha`` (forward, lse and ``autograd``) and
    against ``flash_attention_bwd_ref`` on the heads laid out (B, H, S,
    hd), fed the port's own plain forward."""
    K = 2
    q, k, v, do = _inputs(K, group, seed=10 * group + causal)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jo, jlse = jflash._flash_fwd_impl(jq, jk, jv, causal, 0, QC, KC)
    _, vjp = jax.vjp(lambda a, b, c: jflash.flash_mha(a, b, c, causal, 0,
                                                      QC, KC), jq, jk, jv)
    want = [torch.from_numpy(np.array(x)) for x in vjp(jnp.asarray(do))]

    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = flash_train._flash_fwd_impl(tq, tk, tv, causal, 0, QC, KC)
    assert within_tol(o, torch.from_numpy(np.array(jo)), "float32") <= 0
    assert lse_within_tol(lse, torch.from_numpy(np.array(jlse))) <= 0
    xs = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    got = torch.autograd.grad(flash_train.flash_mha(*xs, causal, 0, QC, KC),
                              xs, tdo)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, f"flash_mha {name}")

    H = K * group
    qh, doh = tq.reshape(B, H, S, HD), tdo.reshape(B, H, S, HD)
    oh, lseh = attention_lse_ref(qh, tk, tv, causal)
    got = flash_attention_bwd_ref(qh, tk, tv, oh, lseh, doh, causal)
    _close(got[0], want[0].reshape(B, H, S, HD), "bwd_ref dq")
    _close(got[1], want[1], "bwd_ref dk")
    _close(got[2], want[2], "bwd_ref dv")


@pytest.mark.parametrize("path,S_,group", [("dense", 48, 4), ("dense", 48, 3),
                                           ("flash", 64, 4), ("flash", 64, 3)])
def test_flash_attention_gradient_matches_reference(path, S_, group):
    """``attention_ctx`` in grad mode (``FlashAttentionFunction`` over the
    plain versions on the CPU) against ``jax.grad`` of the reference's
    ``dense_attention`` and of its ``flash_attention_train`` (chunks of 16
    and 32), causal, on (B, S, H, hd) inputs."""
    K, H = 2, 2 * group
    rs = np.random.RandomState(S_ + group)
    q = rs.normal(size=(B, S_, H, HD)).astype(np.float32)
    k = rs.normal(size=(B, S_, K, HD)).astype(np.float32)
    v = rs.normal(size=(B, S_, K, HD)).astype(np.float32)
    w = rs.normal(size=(B, S_, H, HD)).astype(np.float32)
    jcfg = jget_smoke_config(ARCH)
    if path == "dense":
        def jf(a, b, c):
            return jattn.dense_attention(a, b, c, jcfg, True)
    else:
        def jf(a, b, c):
            return jflash.flash_attention_train(a, b, c, True, 0, QC, KC)
    want = jax.grad(lambda a, b, c: jnp.sum(jf(a, b, c) * w),
                    argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = attn.attention_ctx(*xs, get_smoke_config(ARCH))
    got = torch.autograd.grad(out, xs, torch.from_numpy(w))
    for name, g, jw in zip(("dq", "dk", "dv"), got, want):
        _close(g, torch.from_numpy(np.array(jw)), name)


def test_flash_attention_gradient_under_checkpoint_and_on_its_cases():
    """On every backward case (fp32): ``flash_attention``'s CPU gradient
    equals the plain backward's on the plain forward, and ``autograd``
    through ``attention_ref`` within the tolerance; under non-reentrant
    checkpointing (the forward run again in the backward) the gradients
    are the same bits."""
    for case in bwd_cases():
        q, k, v, do = bwd_tensors(case, "cpu")
        causal = case["causal"]
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        got = torch.autograd.grad(flash_ops.flash_attention(*xs, causal),
                                  xs, do)
        o, lse = attention_lse_ref(q, k, v, causal)
        want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
        xs2 = [x.clone().requires_grad_() for x in (q, k, v)]
        auto = torch.autograd.grad(attention_ref(*xs2, causal), xs2, do)
        xs3 = [x.clone().requires_grad_() for x in (q, k, v)]
        remat = torch.autograd.grad(checkpoint(
            flash_ops.flash_attention, *xs3, causal, use_reentrant=False),
            xs3, do)
        for g, w, a, r in zip(got, want, auto, remat):
            assert torch.equal(g, w) and torch.equal(g, r), case["name"]
            assert bwd_within_tol(g, a, "float32",
                                  case["score_scale"]) <= 0, case["name"]


@pytest.mark.parametrize("heads", [1, 6])
@pytest.mark.parametrize("case", bwd_cases(), ids=lambda c: c["name"])
def test_split_bwd_ref_matches_bwd_ref(case, heads):
    """The bf16 kernels' split of each group's query heads (chunks of
    ``heads``, dk and dv the partials added in chunk order) against the
    whole-group plain version: the same fp32 formulas summed in another
    order, within ``BWD_TOL``; dq is computed a head at a time either way,
    so it is the same bits."""
    q, k, v, do = bwd_tensors(case, "cpu")
    causal = case["causal"]
    o, lse = attention_lse_ref(q, k, v, causal)
    got = flash_attention_bwd_split_ref(q, k, v, o, lse, do, causal, heads)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    assert torch.equal(got[0], want[0])
    for name, g, w in zip(("dk", "dv"), got[1:], want[1:]):
        assert g.shape == w.shape, name
        assert bwd_within_tol(g, w, "float32", case["score_scale"]) <= 0, name


def test_bwd_ref_gives_zero_to_rows_that_saw_no_key():
    """A row whose lse is the finite NEG_INF (no key visible: a window
    past its keys) gets weights 0 and gradients 0, not exp of a rounding
    residual; the other rows are untouched."""
    rs = np.random.RandomState(3)
    q, k, v, do = (torch.from_numpy(rs.normal(size=(1, 2, 6, 16)).astype(
        np.float32)) for _ in range(4))
    mask = torch.ones((6, 6), dtype=torch.bool)
    mask[2] = False
    o, lse = attention_lse_ref(q, k, v, False)
    lse[:, :, 2] = NEG_INF
    dq, dk, dv = attention_bwd_f32(q, k, v, o, lse, do, mask)
    assert bool(dq.isfinite().all() & dk.isfinite().all()
                & dv.isfinite().all())
    assert bool((dq[:, :, 2] == 0).all())
    keep = [0, 1, 3, 4, 5]
    ref = attention_bwd_f32(q[:, :, keep], k, v, o[:, :, keep],
                            lse[:, :, keep], do[:, :, keep], None)
    assert torch.equal(dq[:, :, keep], ref[0])
    _close(dk, ref[1])
    _close(dv, ref[2])


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8), (False, 0),
                                           (False, 8)])
def test_dense_chunked_and_mask_match_reference(causal, window):
    """``dense_attention`` (with a query offset), ``chunked_attention``
    (chunks of 16 and 32) and ``_mask`` against the reference's, windows
    included; ``_pick_chunk`` on the sizes ``attention_ctx`` meets."""
    cfg = get_smoke_config(ARCH).replace(sliding_window=window)
    jcfg = jget_smoke_config(ARCH).replace(sliding_window=window)
    rs = np.random.RandomState(7 + window + causal)
    q = rs.normal(size=(B, S, 8, HD)).astype(np.float32)
    k = rs.normal(size=(B, S, 2, HD)).astype(np.float32)
    v = rs.normal(size=(B, S, 2, HD)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = _t(q, k, v)
    for got, want in (
            (attn.dense_attention(tq, tk, tv, cfg, causal, q_offset=3),
             jattn.dense_attention(jq, jk, jv, jcfg, causal, q_offset=3)),
            (attn.chunked_attention(tq, tk, tv, cfg, causal, QC, KC),
             jattn.chunked_attention(jq, jk, jv, jcfg, causal, QC, KC))):
        assert within_tol(got, torch.from_numpy(np.array(want)),
                          "float32") <= 0
    qpos, kpos = np.arange(S)[:, None] + 5, np.arange(S)[None, :]
    np.testing.assert_array_equal(
        attn._mask(torch.from_numpy(qpos), torch.from_numpy(kpos), causal,
                   window).numpy(),
        np.asarray(jattn._mask(jnp.asarray(qpos), jnp.asarray(kpos), causal,
                               window)))
    for n in (48, 64, 96, 2304, 4096, 100):
        assert attn._pick_chunk(n, 512) == jattn._pick_chunk(n, 512)


def test_fp32_backward_at_x8_scores_needs_the_score_scale():
    """Why ``cases.BWD_TOL`` scales the fp32 bound by the score scale: on
    the x8 case at d 128 (scores of std ~64) the fp32 plain backward itself
    misses ``1e-5 * max|grad| + 1e-6`` against a float64 computation of the
    same gradients, and meets the bound times the score scale."""
    case = next(c for c in bwd_cases()
                if c["score_scale"] > 1 and c["q"].shape[3] == 128)
    q, k, v, do = bwd_tensors(case, "cpu")
    o, lse = attention_lse_ref(q, k, v, case["causal"])
    got = flash_attention_bwd_ref(q, k, v, o, lse, do, case["causal"])
    xs = [x.double().requires_grad_() for x in (q, k, v)]
    g = q.shape[1] // k.shape[1]
    s = xs[0] @ xs[1].repeat_interleave(g, 1).transpose(-1, -2)
    s = s / q.shape[3] ** 0.5
    s = s.masked_fill(~torch.ones(s.shape[-2:], dtype=torch.bool).tril(),
                      float("-inf"))
    out = torch.softmax(s, -1) @ xs[2].repeat_interleave(g, 1)
    exact = torch.autograd.grad(out, xs, do.double())
    scale = case["score_scale"]
    assert max(bwd_within_tol(a, b, "float32") for a, b in zip(got, exact)) > 0
    for a, b in zip(got, exact):
        assert bwd_within_tol(a, b, "float32", scale) <= 0


@pytest.mark.parametrize("grad", ["dk", "dv"])
def test_bf16_bound_holds_each_key_row_to_its_own_scale(grad):
    """``cases.BWD_TOL``'s bf16 bound is per row: in causal attention the
    first keys' dk and dv are many times the last keys', so a bound of 2e-2
    of the whole tensor's max would pass gradients whose last quarter of
    keys is 10 % off.  The per-row bound refuses them, and passes the plain
    version's gradients moved by 2**-8 of themselves (a bf16 rounding of P
    or dS, and of the result)."""
    case = next(c for c in bwd_cases() if c["causal"]
                and c["score_scale"] == 1 and c["q"].shape[2] >= 200)
    q, k, v, do = bwd_tensors(case, "cpu", torch.bfloat16)
    o, lse = attention_lse_ref(q, k, v, True)
    want = dict(zip(("dq", "dk", "dv"), flash_attention_bwd_ref(
        q, k, v, o.to(q.dtype), lse, do, True)))[grad].float()
    sign = torch.from_numpy(np.random.RandomState(3).choice(
        [-1.0, 1.0], size=want.shape).astype(np.float32))
    assert bwd_within_tol(want * (1 + sign * 2 ** -8), want, "bfloat16") <= 0
    T = want.shape[2]
    mangled = want.clone()
    mangled[:, :, 3 * T // 4:] *= 0.9
    assert float((mangled - want).abs().max()) <= 2e-2 * float(
        want.abs().max())
    assert bwd_within_tol(mangled, want, "bfloat16") > 0
