"""Port parity: the selective scan of the hybrid (Hymba) layers.

``kernels/ssm_scan/ref.py::ssm_scan_ref`` (the plain version of the CUDA
kernel ``csrc/ssm_scan.cu``) and ``models/ssm.py``'s ``ssm_scan`` and
``ssm_step`` against the reference's ``repro.models.ssm`` at
``hymba_smoke``'s widths (d 160, di 160, n 8), with and without an initial
state, on the reference's own weights and numpy inputs from a seed.  The
reference runs under ``jax.disable_jit()``, op by op (ROADMAP C.5); its
``lax.scan`` is recorded to hold the plain version against the very
inputs and outputs of the reference's recurrence.  fp32 on both sides,
the y sums in another order: rtol = atol = 1e-5.  Also the dispatcher's
contract on CPU tensors (the kernel runs only on the card; its card tests
are in ``tests/test_torch_kernels_gpu.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.models import ssm as jssm
from repro_torch.configs.base import get_smoke_config
from repro_torch.kernels.ssm_scan import cases, ops
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.models import ssm

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "hymba_1_5b"
B, S = 2, 37


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_smoke_config(ARCH)
    params = jax.tree_util.tree_map(
        np.asarray, jssm.init_ssm(jax.random.PRNGKey(5), jcfg, jnp.float32))
    return get_smoke_config(ARCH), jcfg, params


def _inputs(cfg, seed, with_state):
    rs = np.random.RandomState(seed)
    x = rs.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    h0 = (rs.normal(size=(B, ssm.inner_width(cfg), cfg.ssm_state))
          .astype(np.float32) if with_state else None)
    return x, h0


def _t(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


@pytest.mark.parametrize("with_state", [False, True])
def test_plain_scan_matches_reference_recurrence(weights, with_state,
                                                 monkeypatch):
    """The reference's ``lax.scan`` recorded: ``ssm_scan_ref`` on its
    inputs (the fp32 gates, time-major) and initial state gives its ys and
    final state."""
    cfg, jcfg, params = weights
    x, h0 = _inputs(cfg, 1 + with_state, with_state)
    seen = []
    orig = jax.lax.scan

    def recording(f, init, xs, *a, **k):
        out = orig(f, init, xs, *a, **k)
        seen.append((init, xs, out))
        return out
    monkeypatch.setattr(jax.lax, "scan", recording)
    with jax.disable_jit():
        jssm.ssm_scan(params, jnp.asarray(x), jcfg,
                      None if h0 is None else jnp.asarray(h0))
    (init, (xt, bt, ct, dtt), (h, ys)), = seen
    mv = lambda a: torch.from_numpy(np.moveaxis(np.asarray(a), 0, 1).copy())
    A = -torch.exp(torch.from_numpy(params["a_log"]))
    y, hT = ssm_scan_ref(mv(xt), mv(bt), mv(ct), mv(dtt), A,
                         torch.from_numpy(np.asarray(init)))
    np.testing.assert_allclose(y.numpy(), np.moveaxis(np.asarray(ys), 0, 1),
                               **TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(h), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_scan_matches_reference(weights, with_state):
    cfg, jcfg, params = weights
    x, h0 = _inputs(cfg, 3 + with_state, with_state)
    with jax.disable_jit():
        want_y, want_h = jssm.ssm_scan(
            params, jnp.asarray(x), jcfg,
            None if h0 is None else jnp.asarray(h0))
    y, h = ssm.ssm_scan(_t(params), torch.from_numpy(x), cfg,
                        None if h0 is None else torch.from_numpy(h0))
    assert y.shape == (B, S, cfg.d_model) and h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)


def test_ssm_step_matches_reference(weights):
    """Five decode steps from a random state, each step's output and
    state."""
    cfg, jcfg, params = weights
    rs = np.random.RandomState(6)
    state = rs.normal(size=(B, ssm.inner_width(cfg), cfg.ssm_state)
                      ).astype(np.float32)
    jstate, tstate = jnp.asarray(state), torch.from_numpy(state)
    tp = _t(params)
    for i in range(5):
        x = rs.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        with jax.disable_jit():
            want_y, jstate = jssm.ssm_step(params, jnp.asarray(x), jstate,
                                           jcfg)
        y, tstate = ssm.ssm_step(tp, torch.from_numpy(x), tstate, cfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate),
                                   **TOL, err_msg=f"step {i}")


def test_scan_then_steps_continue_the_sequence(weights):
    """The scan over S tokens and then one step give the scan over S + 1
    tokens' last output and state (the decode form continues the sequence
    form)."""
    cfg, _, params = weights
    tp = _t(params)
    x = torch.from_numpy(np.random.RandomState(8).normal(
        size=(B, S + 1, cfg.d_model)).astype(np.float32))
    y_all, h_all = ssm.ssm_scan(tp, x, cfg)
    _, h = ssm.ssm_scan(tp, x[:, :S], cfg)
    y, h = ssm.ssm_step(tp, x[:, S:], h, cfg)
    np.testing.assert_allclose(y[:, 0].numpy(), y_all[:, -1].numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), h_all.numpy(), **TOL)


def test_init_ssm_matches_reference_layout():
    """Names, shapes and dtypes of the reference's ``init_ssm``; ``a_log``
    fp32 (its values equal) and ``d_skip`` ones whatever ``param_dtype``
    is (``a_log`` is log(1 .. n) rounded once from float64; the reference's
    fp32 log is within an ulp of it); ``w_out`` scaled by 1/sqrt(2L)
    against ``w_in`` of the same fan-in (d = di = 160)."""
    jcfg = jget_smoke_config(ARCH)
    cfg = get_smoke_config(ARCH)
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float32, jnp.float32)):
        want = jssm.init_ssm(jax.random.PRNGKey(0), jcfg, jdtype)
        got = ssm.init_ssm(cfg, torch.Generator().manual_seed(0), dtype)
        assert set(got) == set(want)
        for key, leaf in want.items():
            assert tuple(got[key].shape) == leaf.shape, key
            assert str(got[key].dtype)[6:] == str(leaf.dtype), key
        np.testing.assert_allclose(got["a_log"].detach().numpy(),
                                   np.asarray(want["a_log"]), rtol=2.5e-7,
                                   atol=0)
        assert bool((got["d_skip"] == 1).all())
    ratio = float(got["w_out"].std() / got["w_in"].std())
    assert abs(ratio - (2 * cfg.num_layers) ** -0.5) < 0.02


@pytest.mark.parametrize("case", [c for c in cases.hard_cases()
                                  if c["xi"].shape[1] <= 33],
                         ids=lambda c: c["name"])
def test_dispatcher_on_cpu_is_the_plain_version(case):
    """On CPU tensors ``ops.ssm_scan`` is ``ssm_scan_ref``, bit for bit,
    with B and C the strided halves of one ``bc`` tensor; bf16 gates give
    the bits of the same gates cast to fp32 first."""
    ins = cases.tensors(case, "cpu")
    assert ins[1].stride(1) == 2 * ins[1].shape[2]      # a view of bc
    y, h = ops.ssm_scan(*ins)
    wy, wh = ssm_scan_ref(*(x if x is None else x.contiguous()
                            for x in ins))
    assert torch.equal(y, wy) and torch.equal(h, wh)
    assert cases.within_tol(y, wy) <= 0
    bf = cases.tensors(case, "cpu", torch.bfloat16)
    y16, h16 = ops.ssm_scan(*bf)
    y32, h32 = ssm_scan_ref(*(x.float() if x is not None and i < 4 else x
                              for i, x in enumerate(bf)))
    assert torch.equal(y16, y32) and torch.equal(h16, h32)


@pytest.mark.parametrize("case", [c for c in cases.hard_cases()
                                  if c["xi"].shape[1] <= 33
                                  and c["xi"].shape[2] <= 200],
                         ids=lambda c: c["name"])
def test_plain_scan_against_float64_recurrence(case):
    """``ssm_scan_ref`` on the cases (the strong decays, whose exp(dt A)
    reach subnormals and 0, included) against the recurrence in float64."""
    xi, Bm, Cm, dt, A = (case[k].astype(np.float64)
                         for k in ("xi", "Bm", "Cm", "dt", "A"))
    Bb, S_, di = xi.shape
    h = (np.zeros((Bb, di, A.shape[1])) if case["h0"] is None
         else case["h0"].astype(np.float64))
    ys = []
    for t in range(S_):
        h = (np.exp(dt[:, t, None, None] * A[None]) * h
             + (dt[:, t, None] * xi[:, t])[..., None] * Bm[:, t, None, :])
        ys.append(np.einsum("ben,bn->be", h, Cm[:, t]))
    y, hT = ssm_scan_ref(*cases.tensors(case, "cpu"))
    assert cases.within_tol(y, torch.from_numpy(np.stack(ys, 1))) <= 0
    np.testing.assert_allclose(hT.numpy(), h, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(h).max()))


def test_dispatcher_refuses_what_the_kernel_cannot_run():
    case = cases.make_case(1, 4, 8, 8, seed=2)
    xi, Bm, Cm, dt, A, _ = cases.tensors(case, "cpu")
    with pytest.raises(ValueError, match="state width"):
        ops.ssm_scan(xi, Bm[..., :3], Cm[..., :3], dt, A[:, :3])
    with pytest.raises(ValueError, match="share a dtype"):
        ops.ssm_scan(xi, Bm.bfloat16(), Cm, dt, A)
    with pytest.raises(ValueError, match="fp32 A"):
        ops.ssm_scan(xi, Bm, Cm, dt, A.double())
    with pytest.raises(ValueError, match="unit stride"):
        ops.ssm_scan(xi.transpose(1, 2).contiguous().transpose(1, 2), Bm,
                     Cm, dt, A)
    with pytest.raises(ValueError, match="dt"):
        ops.ssm_scan(xi, Bm, Cm, dt[:, :2], A)
    with pytest.raises(ValueError, match="h0"):
        ops.ssm_scan(xi, Bm, Cm, dt, A, torch.zeros(1, 8, 4))
