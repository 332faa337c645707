"""Port parity: the WKV6 recurrence (plain version and dispatch).

The port's plain WKV6 (:func:`repro_torch.kernels.wkv6.ref.wkv6_ref`, also
the CPU arm of :func:`repro_torch.kernels.wkv6.ops.wkv6` and
:func:`~repro_torch.kernels.wkv6.ops.wkv6_heads`) is held against the
reference's step-by-step ``wkv6_ref`` and its interpreted chunked Pallas
kernel ``wkv6`` on the same numpy inputs.  Both sides compute in fp32 and
sum their dot products in another order (XLA's einsum against torch's),
so fp32 outputs are held to ``atol=2e-5`` as in
``tests/test_kernels.py``, and bf16 inputs to ``atol=0.15, rtol=0.1`` as
there.  The reference's ``wkv6`` keeps one bonus row (ROADMAP C.3) and its
``wkv6_heads`` fails for H >= 2 (ROADMAP C.12), so per-row bonuses are
held against ``wkv6_ref`` only.

The chunked form that the CUDA kernel computes, in PyTorch
(:func:`~repro_torch.kernels.wkv6.ref.wkv6_chunked_ref`), is held to the
kernel's own tolerance (``cases.TOL``) against the step-by-step
recurrence on every case of ``cases.py`` at 16, 32 and 64 steps a chunk,
and against the reference's interpreted kernel at one bonus row.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6.ops import wkv6 as jwkv6
from repro.kernels.wkv6.ops import wkv6_heads as jwkv6_heads
from repro.kernels.wkv6.ref import wkv6_ref as jwkv6_ref
from repro_torch.kernels import _build
from repro_torch.kernels.wkv6 import ops
from repro_torch.kernels.wkv6.cases import (edge_cases, hard_cases,
                                            make_case, within_tol)
from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref, wkv6_ref

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ATOL = 2e-5


def _jax(case, u=None):
    o, s = jwkv6_ref(*(jnp.asarray(case[n]) for n in ("r", "k", "v", "logw")),
                     jnp.asarray(case["u"] if u is None else u))
    return np.array(o), np.array(s)


def _torch(case):
    return [torch.from_numpy(case[n]) for n in ("r", "k", "v", "logw", "u")]


@pytest.mark.parametrize("BH,T,D", [(3, 70, 16), (2, 64, 32), (4, 33, 64),
                                    (2, 1, 64)])
def test_ref_matches_reference_per_row_u(BH, T, D):
    case = make_case(BH, T, D, per_row_u=True, seed=T)
    o, s = wkv6_ref(*_torch(case))
    want_o, want_s = _jax(case)
    assert o.dtype == torch.float32 and s.shape == (BH, D, D)
    np.testing.assert_allclose(o.numpy(), want_o, atol=ATOL)
    np.testing.assert_allclose(s.numpy(), want_s, atol=ATOL)
    # the dispatcher's CPU arm is the plain version, and launches nothing
    before = _build.launch_counts()["wkv6"]
    o2, s2 = ops.wkv6(*_torch(case))
    assert torch.equal(o2, o) and torch.equal(s2, s)
    assert _build.launch_counts()["wkv6"] == before


@pytest.mark.parametrize("BH,T,D,chunk", [(3, 70, 16, 16), (2, 64, 32, 32),
                                          (1, 33, 8, 8)])
def test_matches_interpreted_kernel_shared_u(BH, T, D, chunk):
    case = make_case(BH, T, D, per_row_u=False, seed=BH * T)
    o, s = ops.wkv6(*_torch(case))
    want_o, want_s = jwkv6(*(jnp.asarray(case[n])
                             for n in ("r", "k", "v", "logw", "u")),
                           chunk=chunk)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=ATOL)


def _heads(B, H, T, D, seed):
    case = make_case(B * H, T, D, per_row_u=False, seed=seed)
    rs = np.random.RandomState(seed + 1)
    u = (rs.normal(size=(H, D)) * 0.3).astype(np.float32)
    args = [torch.from_numpy(case[n]).reshape(B, H, T, D)
            for n in ("r", "k", "v", "logw")]
    return case, u, args


def test_heads_give_each_head_its_own_bonus():
    B, H, T, D = 2, 4, 40, 16
    case, u, args = _heads(B, H, T, D, seed=5)
    o, s = ops.wkv6_heads(*args, torch.from_numpy(u))
    assert o.shape == (B, H, T, D) and s.shape == (B, H, D, D)
    want_o, want_s = _jax(case, u=np.tile(u, (B, 1)))
    np.testing.assert_allclose(o.reshape(B * H, T, D).numpy(), want_o,
                               atol=ATOL)
    np.testing.assert_allclose(s.reshape(B * H, D, D).numpy(), want_s,
                               atol=ATOL)


def test_one_head_matches_reference_heads():
    B, H, T, D = 3, 1, 48, 32
    case, u, args = _heads(B, H, T, D, seed=9)
    o, s = ops.wkv6_heads(*args, torch.from_numpy(u))
    want_o, want_s = jwkv6_heads(*(jnp.asarray(a.numpy()) for a in args),
                                 jnp.asarray(u), chunk=16)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=ATOL)


def test_heads_read_a_strided_view():
    """(B, H, T, D) as a transposed view of (B, T, H, D) projections, the
    model's layout: the same result as the contiguous copy."""
    B, H, T, D = 2, 3, 17, 16
    case, u, args = _heads(B, H, T, D, seed=13)
    views = [a.transpose(1, 2).contiguous().transpose(1, 2) for a in args]
    assert not views[0].is_contiguous()
    o, s = ops.wkv6_heads(*views, torch.from_numpy(u))
    o2, s2 = ops.wkv6_heads(*args, torch.from_numpy(u))
    assert torch.equal(o, o2) and torch.equal(s, s2)


def test_bf16_inputs_keep_dtype():
    case = make_case(2, 32, 16, per_row_u=False, seed=9)
    bf = {n: torch.from_numpy(case[n]).to(torch.bfloat16)
          for n in ("r", "k", "v", "logw", "u")}
    o, s = ops.wkv6(bf["r"], bf["k"], bf["v"], bf["logw"].float(),
                    bf["u"].float())
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    want_o, _ = jwkv6_ref(*(jnp.asarray(bf[n].float().numpy())
                            for n in ("r", "k", "v", "logw", "u")))
    np.testing.assert_allclose(o.float().numpy(), np.asarray(want_o),
                               atol=0.15, rtol=0.1)


@pytest.mark.parametrize("case", hard_cases(), ids=lambda c: c["name"])
def test_hard_cases_finite_and_equal_to_reference(case):
    o, s = ops.wkv6(*_torch(case))
    assert bool(o.isfinite().all()) and bool(s.isfinite().all())
    want_o, want_s = _jax(case)
    assert within_tol(o, torch.from_numpy(want_o), "float32") <= 0
    assert within_tol(s, torch.from_numpy(want_s), "float32") <= 0


def test_dispatch_rejects_bad_inputs():
    case = make_case(2, 8, 16, seed=1)
    r, k, v, logw, u = _torch(case)
    with pytest.raises(ValueError, match="shape"):
        ops.wkv6(r, k[:, :4], v, logw, u)
    with pytest.raises(ValueError, match="u has shape"):
        ops.wkv6(r, k, v, logw, u[:, :8])
    with pytest.raises(ValueError, match="share a dtype"):
        ops.wkv6(r, k.to(torch.bfloat16), v, logw, u)
    with pytest.raises(ValueError, match="fp32 logw"):
        ops.wkv6(r, k, v, logw.double(), u)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        ops.wkv6(r.half(), k.half(), v.half(), logw, u)
    meta = [x.to("meta") for x in (r, k, v, logw, u)]
    with pytest.raises(ValueError, match="unsupported device"):
        ops.wkv6(*meta)
    with pytest.raises(ValueError, match=r"want \(1, 16\)"):
        ops.wkv6_heads(*(x.reshape(2, 1, 8, 16) for x in (r, k, v, logw)),
                       u[:1].expand(3, 16))


@pytest.mark.parametrize("case", hard_cases() + edge_cases(),
                         ids=lambda c: c["name"])
def test_chunked_ref_matches_step_ref(case):
    """Every length, width and decay regime, at 16, 32 and 64 steps a chunk
    (the kernel runs 32, and 16 above D = 64): finite, and within the
    kernel's tolerance."""
    ins = _torch(case)
    want_o, want_s = wkv6_ref(*ins)
    for chunk in (16, 32, 64):
        o, s = wkv6_chunked_ref(*ins, chunk=chunk)
        assert bool(o.isfinite().all()) and bool(s.isfinite().all())
        assert within_tol(o, want_o, "float32") <= 0, chunk
        assert within_tol(s, want_s, "float32") <= 0, chunk


_SHARED_U = [c for c in hard_cases() + edge_cases()
             if c["u"].ndim == 1 and (c["r"].shape[1] in (1, 33)
                                      and c["r"].shape[2] in (16, 64)
                                      or c["r"].shape[1:] == (65, 33))]


@pytest.mark.parametrize("case", _SHARED_U, ids=lambda c: c["name"])
def test_chunked_ref_matches_interpreted_kernel(case):
    """One bonus row (ROADMAP C.3), one step, T = 33 and 65 (no multiple
    of the chunk), every decay regime: the reference's interpreted chunked
    kernel at 32 steps a chunk.

    Under strong decays the reference's kernel is the less exact of the
    two (ROADMAP C.14): it takes the exclusive cumsum as ``lc - logw``,
    which differs from the cumsum one step earlier by up to an ulp of
    ``|lc|`` (2**-12 below 4096 = 32 steps x 128), so its decay between
    neighbouring steps is ``exp(±2**-12)`` where the recurrence has 1; the
    terms it scales sum to about the output, so it is held to 2**-12 of
    the output's scale there (the port's chunked form, with the exact
    exclusive cumsum, stays within ``cases.TOL`` of both step-by-step
    recurrences: test_chunked_ref_matches_step_ref)."""
    o, s = wkv6_chunked_ref(*_torch(case), chunk=32)
    want_o, want_s = (torch.from_numpy(np.array(x)) for x in jwkv6(
        *(jnp.asarray(case[n]) for n in ("r", "k", "v", "logw", "u")),
        chunk=32))
    assert within_tol(s, want_s, "float32") <= 0
    if "strong" in case["name"]:
        scale = max(1.0, float(want_o.abs().max()))
        assert float((o - want_o).abs().max()) <= 2.0 ** -12 * scale
        jo, _ = _jax(case)
        assert within_tol(o, torch.from_numpy(jo), "float32") <= 0
    else:
        assert within_tol(o, want_o, "float32") <= 0


def test_chunked_ref_keeps_dtype_and_rejects_a_ragged_sub_block():
    case = make_case(2, 20, 16, seed=3)
    bf = [torch.from_numpy(case[n]).to(torch.bfloat16) for n in "rkv"]
    o, s = wkv6_chunked_ref(*bf, torch.from_numpy(case["logw"]),
                            torch.from_numpy(case["u"]))
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert o.shape == (2, 20, 16) and s.shape == (2, 16, 16)
    with pytest.raises(ValueError, match="multiple"):
        wkv6_chunked_ref(*_torch(case), chunk=20)
