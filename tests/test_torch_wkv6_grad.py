"""Port parity: the WKV6 backward's plain version against the reference.

``kernels/wkv6/ref.py::wkv6_bwd_ref`` (the reverse recurrence that
``csrc/wkv6_bwd.cu`` computes) against ``jax.grad`` of the reference's
``wkv6_ref`` scan, the same numpy inputs on both sides: the gradients of
``sum(o * do) + sum(S_T * dS)`` to r, k, v, logw and u, on every decay
regime of ``kernels/wkv6/cases.py`` (ordinary; strong, where w underflows
and dlogw must vanish; weak) with and without the final state's gradient,
per-row and shared u.  Both walk the recurrence in fp32, summing in
another order: held to ``cases.TOL``.  Then the port's own wrappers:
:class:`repro_torch.kernels.wkv6.ops.WKV6Function` (which ``wkv6`` and
``wkv6_heads`` take in grad mode) gives the plain version's gradients on
the CPU, and autograd through the chunked form (``wkv6_chunked_ref``,
what the forward kernel computes) agrees with it within the same
tolerance (ROADMAP C.14: the chunked forms are held to the cases'
tolerance, not to the reference's interpreted kernel).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6.ref import wkv6_ref as jwkv6_ref
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.kernels.wkv6.cases import (bwd_cases, make_bwd_case,
                                            within_tol)
from repro_torch.kernels.wkv6.ref import wkv6_bwd_ref, wkv6_chunked_ref

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

NAMES = ("dr", "dk", "dv", "dlogw", "du")
CASES = bwd_cases(BH=4, D=16, lengths=(33,))


def _inputs(case):
    return [torch.from_numpy(case[n]) for n in ("r", "k", "v", "logw", "u")]


@jax.jit
def _jax_grads(r, k, v, logw, u, do, ds):
    def loss(r, k, v, logw, u):
        o, s = jwkv6_ref(r, k, v, logw, u)
        return jnp.sum(o * do) + jnp.sum(s * ds)
    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(r, k, v, logw, u)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_bwd_ref_matches_reference_grad(case):
    ds = case["dstate"]
    BH, T, D = case["r"].shape
    want = _jax_grads(*(jnp.asarray(case[n]) for n in
                        ("r", "k", "v", "logw", "u", "do")),
                      jnp.zeros((BH, D, D), jnp.float32) if ds is None
                      else jnp.asarray(ds))
    got = wkv6_bwd_ref(*_inputs(case), torch.from_numpy(case["do"]),
                       None if ds is None else torch.from_numpy(ds))
    for name, g, w in zip(NAMES, got, want):
        w = torch.from_numpy(np.array(w))
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert within_tol(g, w, "float32") <= 0, name
    if "strong" in case["name"]:
        # w underflows: dlogw = w * (...) is 0 or subnormal, never blown up
        assert float(got[3].abs().max()) < 1e-30


@pytest.mark.parametrize("heads", [False, True], ids=["rows", "heads"])
@pytest.mark.parametrize("with_dstate", [True, False],
                         ids=["dS", "no-dS"])
def test_wrappers_take_the_autograd_function(heads, with_dstate):
    """In grad mode ``wkv6`` / ``wkv6_heads`` return outputs of
    ``WKV6Function``, whose backward is the plain version's gradients (on
    the CPU; the kernel's on the card); ``du`` of ``wkv6_heads`` is the sum
    over the batch rows that share a head."""
    B, H, T, D = 2, 3, 21, 16
    case = make_bwd_case(B * H, T, D, "ordinary", per_row_u=True,
                         with_dstate=with_dstate, seed=3)
    r, k, v, logw, u_rows = _inputs(case)
    do = torch.from_numpy(case["do"])
    ds = None if case["dstate"] is None else torch.from_numpy(case["dstate"])
    if heads:
        u = u_rows[:H].clone()
        xs = [x.reshape(B, H, T, D).clone().requires_grad_()
              for x in (r, k, v, logw)] + [u.requires_grad_()]
        o, s = wkv6_ops.wkv6_heads(*xs)
        outs = [o.reshape(B * H, T, D)] + ([s.reshape(B * H, D, D)]
                                           if ds is not None else [])
        u_fold = u.detach()[None].expand(B, H, D).reshape(B * H, D)
    else:
        xs = [x.clone().requires_grad_() for x in (r, k, v, logw, u_rows)]
        o, s = wkv6_ops.wkv6(*xs)
        outs = [o] + ([s] if ds is not None else [])
        u_fold = u_rows
    assert "WKV6Function" in type(o.grad_fn).__name__
    got = torch.autograd.grad(outs, xs, [do] + ([ds] if ds is not None
                                                else []))
    want = wkv6_bwd_ref(r, k, v, logw, u_fold, do, ds)
    for i, name in enumerate(NAMES[:4]):
        assert torch.equal(got[i].reshape(B * H, T, D), want[i]), name
    want_du = want[4].reshape(B, H, D).sum(0) if heads else want[4]
    assert torch.equal(got[4], want_du)


def test_wrappers_without_grad_take_no_function():
    case = make_bwd_case(2, 5, 16, seed=4)
    xs = [x.requires_grad_() for x in _inputs(case)]
    with torch.no_grad():
        o, _ = wkv6_ops.wkv6(*xs)
    assert o.grad_fn is None


@pytest.mark.parametrize("case", CASES[::3], ids=lambda c: c["name"])
def test_chunked_form_gradient_matches_bwd_ref(case):
    """Autograd through the chunked form (exponentials of cumsum
    differences, each <= 0) against the reverse recurrence: the two forms
    of the same gradient within ``TOL``, strong decays included."""
    ins = [x.clone().requires_grad_() for x in _inputs(case)]
    do = torch.from_numpy(case["do"])
    ds = None if case["dstate"] is None else torch.from_numpy(case["dstate"])
    o, s = wkv6_chunked_ref(*ins)
    got = torch.autograd.grad([o] + ([s] if ds is not None else []), ins,
                              [do] + ([ds] if ds is not None else []))
    want = wkv6_bwd_ref(*_inputs(case), do, ds)
    for name, g, w in zip(NAMES, got, want):
        assert bool(g.isfinite().all()), name
        assert within_tol(g, w, "float32") <= 0, name
