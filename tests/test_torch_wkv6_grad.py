"""Port parity: the WKV6 backward's plain versions against the reference.

``kernels/wkv6/ref.py::wkv6_bwd_chunked_ref`` (the chunked backward that
``csrc/wkv6_bwd.cu`` computes: the chunk-start states, the reverse carry
of the state's gradient, every chunk on its own) and ``wkv6_bwd_ref`` (the
reverse recurrence, the wrapper's CPU path and the card check's
yardstick) against ``jax.vjp`` of the reference's ``wkv6_ref`` scan, run
op by op under ``jax.disable_jit()`` (ROADMAP C.5), the same numpy inputs
on both sides: the gradients of ``sum(o * do) + sum(S_T * dS)`` to r, k,
v, logw and u, on every decay regime of ``kernels/wkv6/cases.py``
(ordinary; strong, where w underflows and dlogw must vanish; weak) with
and without the final state's gradient, per-row and shared u, at T 33 and
256.  All sum in fp32 in other orders: held to ``cases.TOL``.  Then the
chunked form against the recurrence at the chunk edges, and the port's
own wrappers: :class:`repro_torch.kernels.wkv6.ops.WKV6Function` (which
``wkv6`` and ``wkv6_heads`` take in grad mode) gives the plain version's
gradients on the CPU, and autograd through the forward's chunked form
(``wkv6_chunked_ref``, what the forward kernel computes) agrees with it
within the same tolerance (ROADMAP C.14: the chunked forms are held to
the cases' tolerance, not to the reference's interpreted kernel).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6.ref import wkv6_ref as jwkv6_ref
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.kernels.wkv6.cases import (DECAYS, bwd_cases, make_bwd_case,
                                            within_tol)
from repro_torch.kernels.wkv6.ref import (wkv6_bwd_chunked_ref, wkv6_bwd_ref,
                                          wkv6_chunked_ref)

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

NAMES = ("dr", "dk", "dv", "dlogw", "du")
CASES = {c["name"]: c for c in bwd_cases(BH=2, D=16)}
BWD_FORMS = {"chunked": wkv6_bwd_chunked_ref, "step": wkv6_bwd_ref}


def _inputs(case):
    return [torch.from_numpy(case[n]) for n in ("r", "k", "v", "logw", "u")]


@functools.lru_cache(maxsize=None)
def _reference_grads(name):
    """``jax.vjp`` of the reference's scan, op by op, once a case."""
    case = CASES[name]
    with jax.disable_jit():
        args = [jnp.asarray(case[n]) for n in ("r", "k", "v", "logw", "u")]
        (_, s), vjp = jax.vjp(jwkv6_ref, *args)
        ds = (jnp.zeros_like(s) if case["dstate"] is None
              else jnp.asarray(case["dstate"]))
        grads = vjp((jnp.asarray(case["do"]), ds))
    return [torch.from_numpy(np.array(g)) for g in grads]


@pytest.mark.parametrize("form", list(BWD_FORMS))
@pytest.mark.parametrize("name", list(CASES))
def test_bwd_ref_matches_reference_grad(name, form):
    case = CASES[name]
    ds = case["dstate"]
    want = _reference_grads(name)
    got = BWD_FORMS[form](*_inputs(case), torch.from_numpy(case["do"]),
                          None if ds is None else torch.from_numpy(ds))
    for gname, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, gname
        assert bool(g.isfinite().all()), gname
        assert within_tol(g, w, "float32") <= 0, gname
    if "strong" in name:
        # w underflows: dlogw = w * (...) is 0 or subnormal, never blown up
        # (the chunked form's every term carries the decays it spans)
        assert float(got[3].abs().max()) < 1e-30


@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("T,D,chunk", [(1, 16, 32), (31, 33, 32),
                                       (32, 16, 32), (33, 33, 16),
                                       (65, 16, 16), (40, 32, 32)])
def test_chunked_bwd_matches_step_bwd_at_chunk_edges(T, D, chunk, decay):
    """The chunked backward at the kernel's chunk edges (chunks of 32, and
    of 16 as at D > 64), widths that are no multiple of a sub-block's
    channels, every decay, with the final state's gradient: the reverse
    recurrence's gradients within ``TOL``."""
    case = make_bwd_case(3, T, D, decay, per_row_u=T % 2 == 0,
                         with_dstate=True, seed=T + D)
    ins = _inputs(case)
    do = torch.from_numpy(case["do"])
    ds = torch.from_numpy(case["dstate"])
    got = wkv6_bwd_chunked_ref(*ins, do, ds, chunk=chunk)
    want = wkv6_bwd_ref(*ins, do, ds)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        assert within_tol(g, w, "float32") <= 0, name


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


@pytest.mark.parametrize("case", list(CASES.values())[:6:2],
                         ids=lambda c: c["name"])
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
