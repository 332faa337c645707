"""Port parity: the stream-compaction kernel's plain version and dispatch.

``compact_ref`` is held against the reference Pallas kernel
(``stream_compact(..., use_pallas=True, interpret=True)``, run eagerly
inside ``jax.disable_jit()``) on the same numpy masks and rows: ``count``
and the first ``count`` rows are equal (the reference leaves the rows past
``count`` unspecified; the port's are zero).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.compact import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels.compact import ops
from repro_torch.kernels.compact.ref import compact_ref

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)


def _inputs(n, density, channels=2, seed=0):
    rs = np.random.RandomState(seed)
    mask = rs.uniform(size=n) < density
    vals = rs.randint(-2**31, 2**31 - 1, size=(n, channels)).astype(np.int32)
    return mask, vals


def _reference(mask, vals, n_out):
    with jax.disable_jit():
        count, out = jops.stream_compact(jnp.asarray(mask), jnp.asarray(vals),
                                         n_out, use_pallas=True,
                                         interpret=True)
    return int(count), np.asarray(out)


@pytest.mark.parametrize("n,density,n_out", [
    (1000, 0.5, 1000),      # not a multiple of the 256-lane block
    (777, 1e-3, 777),
    (512, 0.0, 512),
    (600, 1.0, 600),
    (1000, 0.5, 300),       # n_out below the total: survivors dropped
    (300, 0.9, 2048),       # n_out above the lane count
])
def test_compact_ref_matches_pallas_kernel(n, density, n_out):
    mask, vals = _inputs(n, density, seed=n)
    count, out = compact_ref(torch.from_numpy(mask), torch.from_numpy(vals),
                             n_out)
    want_count, want = _reference(mask, vals, n_out)
    assert count.dtype == torch.int32 and count.ndim == 0
    assert int(count) == want_count == min(int(mask.sum()), n_out)
    assert out.shape == (n_out, 2)
    assert np.array_equal(out.numpy()[:want_count], want[:want_count])
    assert not out[want_count:].any()
    # stable: the survivors in lane order
    assert np.array_equal(out.numpy()[:want_count], vals[mask][:n_out])


def test_compact_pairs_and_channels_match_stream_compact():
    """The channel-major entry point and the frontier pair wrapper give
    the rows of the row-major contract, one channel per row."""
    mask, vals = _inputs(2000, 0.3, seed=7)
    m, v = torch.from_numpy(mask), torch.from_numpy(vals)
    count, rows = ops.stream_compact(m, v, 1500)
    c2, chans = ops.compact_channels(m, v.t().contiguous(), 1500)
    c3, q, codes = ops.compact_pairs(m, v[:, 0], v[:, 1], 1500)
    assert int(count) == int(c2) == int(c3)
    assert torch.equal(chans, rows.t()) and chans.is_contiguous()
    assert torch.equal(q, rows[:, 0]) and torch.equal(codes, rows[:, 1])
    with jax.disable_jit():
        jc, jq, jcodes = jops.compact_pairs(
            jnp.asarray(mask), jnp.asarray(vals[:, 0]),
            jax.lax.bitcast_convert_type(jnp.asarray(vals[:, 1]), jnp.uint32),
            1500, use_pallas=True)
    k = int(jc)
    assert k == int(count)
    assert np.array_equal(q.numpy()[:k], np.asarray(jq)[:k])
    assert np.array_equal(codes.numpy()[:k],
                          np.asarray(jcodes).view(np.int32)[:k])


def test_cpu_compaction_launches_no_kernel_and_validates():
    mask, vals = _inputs(300, 0.5)
    before = _build.launch_counts()
    ops.compact_pairs(torch.from_numpy(mask), torch.from_numpy(vals[:, 0]),
                      torch.from_numpy(vals[:, 1]), 300)
    assert _build.launch_counts() == before
    with pytest.raises(ValueError, match="want mask"):
        ops.compact_channels(torch.from_numpy(mask),
                             torch.from_numpy(vals), 300)
    with pytest.raises(ValueError, match="n_out"):
        ops.compact_channels(torch.from_numpy(mask),
                             torch.from_numpy(vals.T.copy()), -1)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_compact_columns_matches_pallas_kernel(channels):
    """The by-pointer entry point (one tensor a channel) on the CPU: the
    reference kernel's rows, one channel a row, zero past the count."""
    mask, vals = _inputs(1500, 0.4, channels=channels, seed=channels)
    count, out = ops.compact_columns(
        torch.from_numpy(mask),
        [torch.from_numpy(vals[:, c].copy()) for c in range(channels)], 700)
    want_count, want = _reference(mask, vals, 700)
    assert int(count) == want_count == min(int(mask.sum()), 700)
    assert out.shape == (channels, 700) and out.dtype == torch.int32
    assert np.array_equal(out.numpy().T[:want_count], want[:want_count])
    assert not out[:, want_count:].any()
