"""Port parity: host data model (octree, packed rows, geometry, copies).

The same numpy inputs go through ``repro`` (JAX, the reference) and
``repro_torch``; tables and codes must be bitwise-equal.  Forward
kinematics is compared with ``atol=1e-5``: it is a float formula on the
host, upstream of the kernels, and the two libraries' sin/cos and matmul
orders differ in the last bits (the engine tests feed both sides the same
OBB arrays instead).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import counters as jcounters
from repro.core import geometry as jgeo
from repro.core import mcl as jmcl
from repro.core import octree as joct
from repro.core import quantize as jquant
from repro.data import robotics as jrob
from repro_torch import convert
from repro_torch.core import counters as tcounters
from repro_torch.core import geometry as tgeo
from repro_torch.core import octree as toct
from repro_torch.core import quantize as tquant
from repro_torch.data import robotics as trob

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"


def _points(seed=0, n=6000):
    rs = np.random.RandomState(seed)
    return rs.uniform(-1, 1, (n, 3)).astype(np.float32)


def _levels_equal(a, b):
    assert a.depth == b.depth and a.scene_size == b.scene_size
    assert np.array_equal(np.asarray(a.scene_lo), np.asarray(b.scene_lo))
    for la, lb in zip(a.levels, b.levels):
        for f in ("codes", "full", "child_start", "child_mask"):
            x, y = np.asarray(getattr(la, f)), np.asarray(getattr(lb, f))
            assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("depth", [3, 5])
def test_build_octree_levels_match_reference(depth):
    pts = _points(depth)
    ref = joct.build_octree(pts, depth=depth)
    got = toct.build_octree(pts, depth=depth)
    _levels_equal(got, ref)
    _levels_equal(convert.octree_from_reference(ref), ref)
    for f in ("points_sorted", "point_index", "leaf_point_start",
              "leaf_point_count"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f


@pytest.mark.parametrize("fmt", ["fp32", "bf16", "u8"])
def test_device_octree_node_meta_matches_reference(fmt):
    sc = jrob.make_scene("dresser", num_points=8192)
    ref_tree = joct.build_octree(sc.points, depth=5)
    ref = joct.device_octree(ref_tree, meta_format=fmt)
    got = toct.device_octree(convert.octree_from_reference(ref_tree),
                             meta_format=fmt, device="cpu")
    assert got.meta_format == fmt and got.depth == ref.depth
    assert np.array_equal(got.node_meta.numpy(), np.asarray(ref.node_meta))
    assert np.array_equal(got.codes.numpy(),
                          np.asarray(ref.codes).view(np.int32))
    for f in ("full", "counts", "cell_sizes", "scene_lo", "child_start",
              "child_mask"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(ref, f))), f


def test_morton_decode_and_node_centers_match_reference():
    rs = np.random.RandomState(1)
    codes = np.concatenate([rs.randint(0, 2**30, 5000).astype(np.uint32),
                            np.asarray([0, 2**30 - 1, 0xFFFFFFFF],
                                       np.uint32)])
    want = np.asarray(joct.jnp_morton_decode(jnp.asarray(codes)))
    got = toct.morton_decode(torch.from_numpy(codes.view(np.int32)))
    assert np.array_equal(got.numpy(), want)
    np_xyz = np.stack(toct.morton_decode_np(codes), -1).astype(np.int32)
    assert np.array_equal(np_xyz, want)
    lo = np.asarray([-0.3, 0.1, -1.25], np.float32)
    with jax.disable_jit():
        jc, jh = joct.node_centers_from_xyz(jnp.asarray(want), jnp.asarray(lo),
                                            np.float32(0.0371))
    tc, th = toct.node_centers_from_xyz(got, torch.from_numpy(lo),
                                        np.float32(0.0371))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(th.numpy(), np.asarray(jh))


def test_align_rows_and_constants_match_reference():
    for n in (0, 1, 127, 128, 129, 114047):
        assert toct.align_rows(n) == joct.align_rows(n)
    assert toct.META_ROW_ALIGN == joct.META_ROW_ALIGN
    assert toct.MAX_DEPTH == joct.MAX_DEPTH
    assert toct.PAD_CODE == joct.PAD_CODE


def test_counters_and_quantize_copies_match_reference():
    jf = [f.name for f in dataclasses.fields(jcounters.Counters)]
    tf = [f.name for f in dataclasses.fields(tcounters.Counters)]
    assert tf == jf
    for name in dir(jcounters):
        if name.startswith("BYTES_") or name == "NUM_EXIT_CODES":
            assert getattr(tcounters, name) == getattr(jcounters, name), name
    a, b = jcounters.Counters(), tcounters.Counters()
    assert a.as_dict() == b.as_dict()
    assert tquant.META_FORMATS == jquant.META_FORMATS
    assert tquant.META_FORMAT_WORDS == jquant.META_FORMAT_WORDS
    rs = np.random.RandomState(2)
    full = rs.rand(300) < 0.3
    start = rs.randint(0, 1 << 20, 300)
    mask = rs.randint(0, 256, 300)
    octant = rs.randint(0, 8, 300)
    assert np.array_equal(tquant.pack_topo_u8(full, octant, start, mask),
                          jquant.pack_topo_u8(full, octant, start, mask))
    assert np.array_equal(tquant.pack_topo_bf16(full, start, mask),
                          jquant.pack_topo_bf16(full, start, mask))


def test_convert_rejects_malformed_levels():
    ref = joct.build_octree(_points(4, 500), depth=3)
    lv = [dict(codes=np.asarray(x.codes), full=np.asarray(x.full),
               child_start=np.asarray(x.child_start),
               child_mask=np.asarray(x.child_mask)) for x in ref.levels]
    with pytest.raises(ValueError, match="levels"):
        convert.octree_from_arrays(ref.scene_lo, ref.scene_size, 4, lv)
    bad = [dict(d) for d in lv]
    bad[3]["full"] = bad[3]["full"][:-1]
    with pytest.raises(ValueError, match="full"):
        convert.octree_from_arrays(ref.scene_lo, ref.scene_size, 3, bad)
    bad = [dict(d) for d in lv]
    bad[3]["codes"] = bad[3]["codes"][::-1].copy()
    with pytest.raises(ValueError, match="sorted"):
        convert.octree_from_arrays(ref.scene_lo, ref.scene_size, 3, bad)


_POINT_FIELDS = ("points_sorted", "point_index", "leaf_point_start",
                 "leaf_point_count")


def test_convert_carries_point_storage():
    """The ball query's point storage comes across with the levels, and a
    storage whose runs do not cover the points in order is refused."""
    ref = joct.build_octree(_points(7, 800), depth=4)
    got = convert.octree_from_reference(ref)
    _levels_equal(got, ref)
    for f in _POINT_FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    lv = [dict(codes=np.asarray(x.codes), full=np.asarray(x.full),
               child_start=np.asarray(x.child_start),
               child_mask=np.asarray(x.child_mask)) for x in ref.levels]
    pts = {f: np.asarray(getattr(ref, f)) for f in _POINT_FIELDS}
    bare = convert.octree_from_arrays(ref.scene_lo, ref.scene_size, 4, lv)
    assert bare.points_sorted.shape == (0, 3)
    assert bare.leaf_point_count.shape == (0,)
    bad = dict(pts, point_index=pts["point_index"][:-1])
    with pytest.raises(ValueError, match="shape"):
        convert.octree_from_arrays(ref.scene_lo, ref.scene_size, 4, lv,
                                   points=bad)
    bad = dict(pts, leaf_point_start=pts["leaf_point_start"][:-1])
    with pytest.raises(ValueError, match="shape"):
        convert.octree_from_arrays(ref.scene_lo, ref.scene_size, 4, lv,
                                   points=bad)
    counts = pts["leaf_point_count"].copy()
    counts[[0, 1]] += [1, -1]
    with pytest.raises(ValueError, match="cover"):
        convert.octree_from_arrays(ref.scene_lo, ref.scene_size, 4, lv,
                                   points=dict(pts, leaf_point_count=counts))


def test_grid_from_reference():
    jgrid = jmcl.make_corridor_world(jax.random.PRNGKey(2), size=40)
    got = convert.grid_from_reference(jgrid, device="cpu")
    assert got.occ.dtype == torch.bool and got.shape == (40, 40)
    assert np.array_equal(got.occ.numpy(), np.asarray(jgrid.occ))
    assert got.cell == jgrid.cell and got.origin == (0.0, 0.0)
    moved = dataclasses.replace(jgrid, origin=(-1.5, 0.25), cell=0.1)
    got = convert.grid_from_reference(moved, device="cpu")
    assert got.origin == (-1.5, 0.25) and got.cell == 0.1


def test_forward_kinematics_close_to_reference():
    """atol=1e-5: host float formula, see the module docstring."""
    rs = np.random.RandomState(5)
    q = rs.uniform(-2.5, 2.5, (13, 7)).astype(np.float32)
    base = np.asarray([0.1, -0.2, 0.05], np.float32)
    ref = jgeo.arm_link_obbs(jnp.asarray(q), base_pos=jnp.asarray(base))
    got = tgeo.arm_link_obbs(torch.from_numpy(q), base_pos=base)
    for f in ("center", "half", "rot"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), atol=1e-5)
    rpy = rs.uniform(-3, 3, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.rotation_from_euler(torch.from_numpy(rpy)).numpy(),
        np.asarray(jgeo.rotation_from_euler(jnp.asarray(rpy))), atol=1e-5)
    np.testing.assert_allclose(tgeo.obb_corners(got).numpy(),
                               np.asarray(jgeo.obb_corners(ref)), atol=1e-5)


def test_scene_and_trajectories_match_reference():
    """Same process => same ``hash(name)`` seed: identical scenes."""
    for env in trob.ENVIRONMENTS:
        a = trob.make_scene(env, num_points=3000)
        b = jrob.make_scene(env, num_points=3000)
        assert np.array_equal(a.points, b.points), env
        assert np.array_equal(a.boxes_lo, b.boxes_lo), env
    sc = trob.make_scene("cubby", num_points=1000)
    got = trob.scene_trajectories(sc, num_trajectories=3, waypoints=5)
    ref = jrob.scene_trajectories(jrob.make_scene("cubby", num_points=1000),
                                  num_trajectories=3, waypoints=5)
    assert got.center.shape == (3 * 5 * 7, 3)
    for f in ("center", "half", "rot"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), atol=1e-5)


def test_random_obbs_from_generator():
    g = torch.Generator().manual_seed(3)
    o = tgeo.random_obbs(g, 64)
    assert o.center.shape == (64, 3) and o.rot.shape == (64, 3, 3)
    assert bool((o.half >= 0.02).all() and (o.half <= 0.25).all())
    eye = torch.einsum("mij,mik->mjk", o.rot, o.rot)
    assert torch.allclose(eye, torch.eye(3).expand(64, 3, 3), atol=1e-5)


def test_device_octree_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    tree = toct.build_octree(_points(6, 500), depth=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        toct.device_octree(tree)


def test_import_leaves_jax_and_repro_out():
    """A fresh process importing every port module loads neither JAX nor
    the reference package."""
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(SRC / "repro_torch")
                                  .with_suffix("").parts)
        for p in (SRC / "repro_torch").rglob("*.py")
        if p.name != "__init__.py") + ["repro_torch"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print('BAD', bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(mods) >= 15
    assert {"repro_torch.core.pipeline", "repro_torch.kernels.fps.ops",
            "repro_torch.kernels.ballquery.ops",
            "repro_torch.models.planner",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.models.attention", "repro_torch.models.ssm",
            "repro_torch.kernels.ssm_scan.ops",
            "repro_torch.kernels.ssm_scan.ref",
            "repro_torch.kernels.ssm_scan.cases",
            "repro_torch.configs.hymba_1_5b"} <= set(mods)


def test_card_scripts_import_neither_jax_nor_repro():
    """chip_smoke.py and the profiling tool run where JAX is absent."""
    import ast
    root = SRC.parent
    for path in (root / "chip_smoke.py",
                 root / "tools" / "profile_torch_query.py"):
        tree = ast.parse(path.read_text())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
        mods += [n.module or "" for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)]
        roots = {m.split(".")[0] for m in mods}
        assert "repro_torch" in roots, path
        assert not roots & {"jax", "repro", "jaxlib"}, (path, roots)
