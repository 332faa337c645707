"""Port parity: ball query (plain version and dispatch).

The port's plain ball query (:func:`repro_torch.core.ballquery.
ball_query_ref`, also the CPU arm of :func:`repro_torch.kernels.ballquery.
ops.ball_query`) is held exactly -- counts and every index, in order --
against the reference's ``ball_query_ref`` (eager) and its interpreted
Pallas kernel ``ball_query_tiled`` on the same numpy inputs.  The
threshold is the reference's: ``radius * radius`` in double precision,
rounded once to float32, so a point at ``d2 = 0.1f * 0.1f`` is outside a
ball of radius 0.1.  The CUDA kernel's query blocks
(``ops.query_block``) and the shared check inputs
(``kernels/ballquery/cases.py``) are tested here too; the kernel itself
runs only on the card (``tests/test_torch_kernels_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ballquery import ball_query_ref as jref
from repro.kernels.ballquery.ops import ball_query_tiled
from repro_torch.core.ballquery import ball_query_ref, radius_sq
from repro_torch.kernels import _build
from repro_torch.kernels.ballquery import ops
from repro_torch.kernels.ballquery.cases import (TILE, cloud_cases,
                                                 radius_shell)

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)


def _port(qs, pts, r, k):
    idx, cnt = ops.ball_query(torch.from_numpy(qs), torch.from_numpy(pts), r,
                              k)
    assert idx.dtype == cnt.dtype == torch.int32
    return idx.numpy(), cnt.numpy()


def _reference(qs, pts, r, k):
    idx, cnt = jref(jnp.asarray(pts), jnp.asarray(qs), r, k)
    return np.asarray(idx), np.asarray(cnt)


@pytest.mark.parametrize("M,N,r,k", [(70, 1000, 0.3, 16), (33, 500, 0.5, 4),
                                     (16, 128, 0.2, 8)])
def test_ball_query_matches_reference_and_pallas_kernel(M, N, r, k):
    rs = np.random.RandomState(M)            # test_kernels.py's inputs
    pts = rs.uniform(-1, 1, (N, 3)).astype(np.float32)
    qs = rs.uniform(-1, 1, (M, 3)).astype(np.float32)
    idx, cnt = _port(qs, pts, r, k)
    want_idx, want_cnt = _reference(qs, pts, r, k)
    assert np.array_equal(cnt, want_cnt) and np.array_equal(idx, want_idx)
    ki, kc = ball_query_tiled(jnp.asarray(qs), jnp.asarray(pts), r, k,
                              bm=32, bn=64)
    assert np.array_equal(cnt, np.asarray(kc))
    assert np.array_equal(idx, np.asarray(ki))
    # slots past the count are -1; the others ascend
    for m in range(M):
        assert (idx[m, cnt[m]:] == -1).all()
        assert (np.diff(idx[m, :cnt[m]]) > 0).all()
    assert cnt.sum() > 0


@pytest.mark.parametrize("r", [0.5, 0.25, 0.1, 0.2, 0.4, 0.05, 0.6])
def test_points_at_the_radius(r):
    pts = radius_shell(r)
    qs = np.zeros((1, 3), np.float32)
    k = len(pts)
    idx, cnt = _port(qs, pts, r, k)
    want_idx, want_cnt = _reference(qs, pts, r, k)
    assert np.array_equal(cnt, want_cnt) and np.array_equal(idx, want_idx)
    d2 = (pts.astype(np.float32) ** 2).sum(-1, dtype=np.float32)
    assert 0 < cnt[0] < k          # some points are in, some out
    assert cnt[0] == int((d2 <= np.float32(r * r)).sum())


def test_radius_rounds_in_double_precision():
    """r = 0.1: the threshold is float32(0.01) = 0.01f; ``0.1f * 0.1f`` is
    one ulp above it, so the point at 0.1f lies outside the ball."""
    assert radius_sq(0.1) == float(np.float32(0.01))
    x = np.float32(0.1)
    assert np.float32(x * x) > np.float32(radius_sq(0.1))
    pts = np.array([[x, 0, 0], [0, 0, 0]], np.float32)
    qs = np.zeros((1, 3), np.float32)
    idx, cnt = _port(qs, pts, 0.1, 2)
    assert cnt.tolist() == [1] and idx.tolist() == [[1, -1]]
    want_idx, want_cnt = _reference(qs, pts, 0.1, 2)
    assert np.array_equal(idx, want_idx) and np.array_equal(cnt, want_cnt)


def test_batched_equals_per_cloud():
    rs = np.random.RandomState(5)
    pts = rs.uniform(-1, 1, (3, 257, 3)).astype(np.float32)
    qs = pts[:, :33] + rs.normal(0, 0.05, (3, 33, 3)).astype(np.float32)
    idx, cnt = ops.ball_query(torch.from_numpy(qs), torch.from_numpy(pts),
                              0.2, 16)
    assert idx.shape == (3, 33, 16) and cnt.shape == (3, 33)
    for b in range(3):
        i1, c1 = ball_query_ref(torch.from_numpy(pts[b]),
                                torch.from_numpy(qs[b]), 0.2, 16)
        assert torch.equal(idx[b], i1) and torch.equal(cnt[b], c1)


def test_ball_query_rejects_bad_arguments():
    q, p = torch.zeros(4, 3), torch.zeros(9, 3)
    with pytest.raises(ValueError, match="k must"):
        ops.ball_query(q, p, 0.1, 0)
    with pytest.raises(ValueError, match="want queries"):
        ops.ball_query(q[None], p, 0.1, 4)
    with pytest.raises(ValueError, match="want queries"):
        ops.ball_query(q[None], torch.zeros(2, 9, 3), 0.1, 4)


def test_cpu_ball_query_launches_no_kernel():
    before = _build.launch_counts()
    ops.ball_query(torch.zeros(4, 3), torch.ones(9, 3), 0.1, 4)
    assert _build.launch_counts() == before
    assert "ballquery" in before


_CASES = {c[0]: c for c in cloud_cases()}


def test_plain_version_matches_pallas_kernel_on_a_long_cloud():
    """A cloud over one of the CUDA kernel's staged tiles (N = 2049), its
    first 64 queries, against the interpreted Pallas kernel (17 point
    tiles, so its tile skip runs) and the reference's brute force."""
    _, qs, pts, r, k = _CASES[f"long N={TILE + 1}"]
    qs, pts = qs[0, :64], pts[0]
    assert pts.shape[0] > TILE
    idx, cnt = _port(qs, pts, r, k)
    ki, kc = ball_query_tiled(jnp.asarray(qs), jnp.asarray(pts), r, k)
    assert np.array_equal(cnt, np.asarray(kc))
    assert np.array_equal(idx, np.asarray(ki))
    want_idx, want_cnt = _reference(qs, pts, r, k)
    assert np.array_equal(cnt, want_cnt) and np.array_equal(idx, want_idx)
    assert 0 < (cnt == k).sum() < len(cnt)       # some balls fill, some not


@pytest.mark.parametrize("name", [n for n in _CASES
                                  if _CASES[n][2].shape[1] <= 1000])
def test_plain_version_matches_reference_on_small_cloud_cases(name):
    _, qs, pts, r, k = _CASES[name]
    idx, cnt = ops.ball_query(torch.from_numpy(qs), torch.from_numpy(pts),
                              r, k)
    for b in range(qs.shape[0]):
        want_idx, want_cnt = _reference(qs[b], pts[b], r, k)
        assert np.array_equal(cnt[b].numpy(), want_cnt)
        assert np.array_equal(idx[b].numpy(), want_idx)


def test_cloud_cases_reach_the_kernels_edges():
    """The long clouds span several staged tiles; the skip case fills
    every ball inside the first tile; in the no-fill case no ball fills."""
    ns = {c[2].shape[1] for c in _CASES.values()}
    assert {1, 31, 33, TILE + 1, 5000, 8 * TILE} <= ns
    for name, want_full in (("every ball full in the first tile (queries "
                             "off the cloud)", True), ("no ball fills",
                                                       False)):
        _, qs, pts, r, k = _CASES[name]
        idx, cnt = ball_query_ref(torch.from_numpy(pts),
                                  torch.from_numpy(qs), r, k)
        if want_full:
            assert bool((cnt == k).all()) and int(idx.max()) < TILE
        else:
            assert not bool((cnt == k).any()) and pts.shape[1] > TILE
    long16 = _CASES[f"long N={8 * TILE}"]
    idx, cnt = ball_query_ref(torch.from_numpy(long16[2]),
                              torch.from_numpy(long16[1]), *long16[3:])
    assert int(idx.max()) >= 7 * TILE     # a ball reaches the last tile


@pytest.mark.parametrize("B,M,sms", [
    (32, 256, 132), (1, 256, 132), (1, 64, 132), (1, 16, 132),
    (3, 255, 132), (5, 67, 132), (1, 997, 132), (2, 1, 132), (4, 5, 8),
    (1000, 3, 132), (7, 4096, 114)])
def test_query_block_covers_every_query_once_and_fills_the_sms(B, M, sms):
    qb = ops.query_block(B, M, sms)
    assert 1 <= qb <= ops.MAX_QUERY_BLOCK and qb & (qb - 1) == 0
    per_cloud = -(-M // qb)
    ctas = B * per_cloud
    seen = np.zeros((B, M), np.int64)
    for i in range(ctas):                  # the kernel's block -> queries
        b, m0 = i // per_cloud, (i % per_cloud) * qb
        seen[b, m0:min(m0 + qb, M)] += 1
    assert (seen == 1).all()
    if B * M >= sms:
        assert ctas >= sms                 # every SM gets a block
    if qb < ops.MAX_QUERY_BLOCK:           # and no larger block would
        assert B * -(-M // (2 * qb)) < sms
