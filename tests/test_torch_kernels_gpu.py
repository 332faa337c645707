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
from repro_torch.kernels.persist import ops as persist_ops
from repro_torch.kernels.persist.ref import persist_tiles_ref
from repro_torch.kernels.sact import ops as sact_ops
from repro_torch.kernels.sact.cases import grazing_plane
from repro_torch.kernels.sact.ref import sact_ref

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
