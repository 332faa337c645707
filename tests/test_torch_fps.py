"""Port parity: furthest point sampling (plain version, dispatch, sampling).

The port's plain FPS (:func:`repro_torch.core.fps.farthest_point_sampling`,
also the CPU arm of :func:`repro_torch.kernels.fps.ops.fps`) is held
exactly against the reference's ``farthest_point_sampling`` run op by op
under ``jax.disable_jit()`` (under ``jit`` XLA:CPU may contract the
squared distance into fused multiply-adds, ROADMAP C.5) and against the
interpreted Pallas loop ``fps_pallas``, on the same numpy clouds.  Ties
(duplicates and lattice points, where many distances are equal) must go
to the first index, as ``jnp.argmax`` does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fps as jfps
from repro.kernels.fps.ops import fps_pallas
from repro_torch.core import fps as tfps
from repro_torch.kernels import _build
from repro_torch.kernels.fps import ops
from repro_torch.kernels.fps.cases import tie_cloud
from repro_torch.models.planner import Planner

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)


def _cloud(n, seed):
    return np.random.RandomState(seed).uniform(-1, 1, (n, 3)).astype(
        np.float32)


def _jax_fps(pts, m, first=0):
    with jax.disable_jit():
        return np.asarray(jfps.farthest_point_sampling(jnp.asarray(pts), m,
                                                       first))


@pytest.mark.parametrize("N,m,bn", [(1000, 33, 128), (513, 16, 64)])
def test_fps_matches_reference_and_pallas_loop(N, m, bn):
    pts = _cloud(N, seed=N)                  # test_kernels.py's clouds
    got = ops.fps(torch.from_numpy(pts), m)
    assert got.dtype == torch.int32 and got.shape == (m,)
    assert np.array_equal(got.numpy(), _jax_fps(pts, m))
    assert np.array_equal(got.numpy(),
                          np.asarray(fps_pallas(jnp.asarray(pts), m, bn=bn)))


def test_fps_ties_go_to_the_first_index():
    pts = tie_cloud()
    got = ops.fps(torch.from_numpy(pts), 80).numpy()
    assert np.array_equal(got, _jax_fps(pts, 80))
    # exact coordinates: the interpreted Pallas loop has no rounding to fuse
    assert np.array_equal(got, np.asarray(fps_pallas(jnp.asarray(pts), 80,
                                                     bn=64)))
    # past the 64 distinct points every distance is 0: index 0 wins
    assert len(np.unique(pts[got[:64]], axis=0)) == 64
    assert (got[64:] == 0).all()


def test_fps_first_index():
    pts = _cloud(300, seed=2)
    got = ops.fps(torch.from_numpy(pts), 20, first=117).numpy()
    assert got[0] == 117
    assert np.array_equal(got, _jax_fps(pts, 20, first=117))


def test_fps_batched_equals_per_cloud():
    clouds = np.stack([_cloud(114, seed=s) for s in range(3)]
                      + [tie_cloud()])
    got = ops.fps(torch.from_numpy(clouds), 24)
    assert got.shape == (4, 24)
    for b in range(4):
        assert torch.equal(got[b], ops.fps(torch.from_numpy(clouds[b]), 24))


def test_fps_rejects_bad_arguments():
    pts = torch.zeros(10, 3)
    for m, first in ((0, 0), (5, 10), (5, -1)):
        with pytest.raises(ValueError):
            ops.fps(pts, m, first)
    with pytest.raises(ValueError):
        ops.fps(torch.zeros(10, 2), 3)


def test_fps_shared_memory_limit():
    """The largest cloud is 1,024 threads of 16 points a thread, and its
    coordinate planes (12 B a point) fit the block's shared memory."""
    assert ops.MAX_POINTS == ops.MAX_THREADS * ops.MAX_POINTS_A_THREAD
    assert ops.MAX_POINTS >= 14511   # clouds of 16 B a point in shared memory
    assert ops.smem_bytes(ops.MAX_POINTS) <= ops.MAX_SMEM_BYTES
    assert ops.smem_bytes(2048) == 2048 * 12 + 512          # 24 KB of planes
    assert [ops.threads_for(n) for n in (16, 256, 2048, 5000, 10**5)] == [
        32, 32, 256, 640, 1024]
    for n in (1, 33, 2048, 5000, 8193, ops.MAX_POINTS):
        assert -(-n // ops.threads_for(n)) <= ops.MAX_POINTS_A_THREAD


def test_random_sampling_distinct_in_range_and_spread():
    pts = _cloud(2000, seed=0)
    tp = torch.from_numpy(pts)
    idx = tfps.random_sampling(torch.Generator().manual_seed(1), 2000, 64,
                               device="cpu")
    assert idx.dtype == torch.int32 and idx.shape == (64,)
    assert len(set(idx.tolist())) == 64
    assert int(idx.min()) >= 0 and int(idx.max()) < 2000
    # as tests/test_ballquery_fps.py: FPS covers the cloud better
    fps_spread = float(tfps.sampling_spread(tp, ops.fps(tp, 64)))
    rnd = [float(tfps.sampling_spread(tp, tfps.random_sampling(
        torch.Generator().manual_seed(s), 2000, 64, device="cpu")))
        for s in range(5)]
    assert fps_spread < np.mean(rnd)
    # the port's spread metric is the reference's (a mean of 2000 fp32
    # square roots, summed in another order: relative 1e-6)
    want = float(jfps.sampling_spread(jnp.asarray(pts),
                                      jnp.asarray(idx.numpy())))
    assert float(tfps.sampling_spread(tp, idx)) == pytest.approx(want,
                                                                 rel=1e-6)


def test_cuda_default_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfps.random_sampling(g, 10, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfps.random_sampling(g, 10, 3, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        Planner(feat_dim=8, hidden=8)


def test_cpu_fps_launches_no_kernel():
    before = _build.launch_counts()
    ops.fps(torch.from_numpy(_cloud(100, seed=1)), 8)
    assert _build.launch_counts() == before
    assert "fps" in before
