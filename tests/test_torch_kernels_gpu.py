"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device (an H100: the kernels build for sm_90a) and
skip elsewhere; they import neither JAX nor the reference package, so they
also run on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Every comparison is exact: the kernels are built with ``--fmad=false`` and
keep the plain versions' operation order, and the SACT planes put pairs
that graze a separating plane on their diagonal.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.geometry import OBBs, rotation_from_euler
from repro_torch.core.octree import build_octree, device_octree
from repro_torch.engine.executor import CollisionEngine, EngineConfig
from repro_torch.kernels import _build
from repro_torch.kernels.compact import ops as compact_ops
from repro_torch.kernels.compact.ref import compact_ref
from repro_torch.kernels.persist import ops as persist_ops
from repro_torch.kernels.persist.ref import persist_tiles_ref
from repro_torch.kernels.sact import ops as sact_ops
from repro_torch.kernels.sact.cases import grazing_plane
from repro_torch.kernels.sact.ref import sact_ref
from repro_torch.kernels.traverse import ops as traverse_ops
from repro_torch.kernels.traverse.cases import grazing_frontier
from repro_torch.kernels.traverse.ref import traverse_test_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an H100): torch sees none")
    return torch.device("cuda")


def _scene_and_queries(M, seed=3, depth=4):
    rs = np.random.RandomState(seed)
    tree = build_octree(rs.uniform(-1, 1, (4000, 3)).astype(np.float32),
                        depth=depth)
    c = rs.uniform(-1, 1, (M, 3)).astype(np.float32)
    h = rs.uniform(0.05, 0.3, (M, 3)).astype(np.float32)
    r = rotation_from_euler(torch.from_numpy(
        rs.uniform(-3, 3, (M, 3)).astype(np.float32)))
    return tree, OBBs(torch.from_numpy(c), torch.from_numpy(h), r)


@pytest.mark.parametrize("use_spheres", [False, True])
def test_sact_dense_kernel_matches_plain(cuda, use_spheres):
    obb, aabb = grazing_plane(512, seed=11, use_spheres=use_spheres)
    o, a = torch.from_numpy(obb).to(cuda), torch.from_numpy(aabb).to(cuda)
    before = _build.launch_counts()["sact_dense"]
    c, e = sact_ops.sact_dense(o, a, use_spheres=use_spheres)
    torch.cuda.synchronize()
    assert _build.launch_counts()["sact_dense"] == before + 1
    pc, pe = sact_ref(o, a, use_spheres)
    assert torch.equal(c, pc) and torch.equal(e, pe)


@pytest.mark.parametrize("bq,fcap,ring_cap,use_spheres", [
    (16, 32, 4096, False), (16, 32, 16, True), (128, 4096, 256, False)])
def test_persist_kernel_matches_plain(cuda, bq, fcap, ring_cap, use_spheres):
    tree, obbs = _scene_and_queries(M=300)
    dev = device_octree(tree, device=cuda)
    ins = persist_ops.pack_kernel_inputs(obbs.center.to(cuda),
                                         obbs.half.to(cuda),
                                         obbs.rot.to(cuda), dev, bq)
    kw = dict(bq=bq, fcap=fcap, depth=tree.depth, ring_cap=ring_cap,
              use_spheres=use_spheres)
    before = _build.launch_counts()["persist"]
    got = persist_ops.persist_tiles(**ins, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts()["persist"] == before + 1
    want = persist_tiles_ref(**ins, **kw)
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g, w)
    fits = got[3][:, 6] <= ring_cap
    assert torch.equal(got[4][fits], want[4][fits])


def test_cuda_engine_matches_cpu_engine(cuda):
    tree, obbs = _scene_and_queries(M=300, seed=5, depth=5)
    cfg = EngineConfig(mode="wavefront_persistent", min_bucket=64)
    before = _build.launch_counts()["persist"]
    v, c = CollisionEngine(tree, cfg, device=cuda).query(obbs)
    assert _build.launch_counts()["persist"] > before
    vc, cc = CollisionEngine(tree, cfg, device="cpu").query(obbs)
    assert np.array_equal(v, vc)
    a, b = c.as_dict(), cc.as_dict()
    for k in a:
        if k != "wall_time_s":
            assert a[k] == b[k], k


@pytest.mark.parametrize("n,density,n_out", [
    (1000, 0.0, 1000), (100_003, 1e-3, 100_003), (100_003, 0.5, 100_003),
    (70_000, 1.0, 70_000), (100_003, 0.5, 20_000)])
def test_compact_kernel_matches_plain(cuda, n, density, n_out):
    rs = np.random.RandomState(n)
    mask = torch.from_numpy(rs.uniform(size=n) < density).to(cuda)
    chans = torch.from_numpy(rs.randint(-2**31, 2**31 - 1, (2, n)).astype(
        np.int32)).to(cuda)
    before = _build.launch_counts()["compact"]
    count, out = compact_ops.compact_channels(mask, chans, n_out)
    torch.cuda.synchronize()
    assert _build.launch_counts()["compact"] == before + 1
    want_count, want = compact_ref(mask, chans.t(), n_out)
    assert int(count) == int(want_count) == min(int(mask.sum()), n_out)
    assert torch.equal(out, want.t())


@pytest.mark.parametrize("use_spheres", [False, True])
def test_traverse_kernel_matches_plain(cuda, use_spheres):
    tree, _ = _scene_and_queries(M=8, depth=5)
    dev = device_octree(tree, device=cuda)
    f = grazing_frontier(dev, 4, 2048, seed=9, use_spheres=use_spheres)
    f = {k: v.to(cuda) for k, v in f.items()}
    kw = dict(cell=dev.host_cells[4], lo=dev.host_lo, is_leaf=False,
              use_spheres=use_spheres)
    n_live = torch.tensor(f["q_idx"].shape[0] - 300, dtype=torch.int32,
                          device=cuda)
    before = _build.launch_counts()["traverse"]
    got = traverse_ops.traverse_test(f["obb"], f["q_idx"], f["codes"],
                                     f["full"], n_live, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts()["traverse"] == before + 1
    want = traverse_test_ref(f["obb"], f["q_idx"], f["codes"], f["full"],
                             n_live, **kw)
    assert torch.equal(got, want)
    assert not got[-300:].any()


@pytest.mark.parametrize("mode", ["wavefront", "wavefront_fused"])
def test_cuda_level_modes_match_cpu_engine(cuda, mode):
    tree, obbs = _scene_and_queries(M=300, seed=5, depth=5)
    cfg = EngineConfig(mode=mode, min_bucket=64)
    before = _build.launch_counts()
    v, c = CollisionEngine(tree, cfg, device=cuda).query(obbs)
    after = _build.launch_counts()
    assert after["compact"] > before["compact"]
    assert (after["traverse"] > before["traverse"]) == (
        mode == "wavefront_fused")
    vc, cc = CollisionEngine(tree, cfg, device="cpu").query(obbs)
    assert np.array_equal(v, vc)
    a, b = c.as_dict(), cc.as_dict()
    for k in a:
        if k != "wall_time_s":
            assert a[k] == b[k], k
