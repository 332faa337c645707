"""Port parity: the staged SACT (plain versions and the dense kernel).

Exit codes and verdicts must be bitwise-equal to the JAX reference.  The
JAX side runs under ``jax.disable_jit()``: XLA:CPU's ``jit`` contracts
``a*b+c`` into a fused multiply-add, which eager PyTorch (and the CUDA
kernels, built with ``--fmad=false``) never do.

Two input families:

* planes whose diagonal pairs graze a test of ``sact_tile`` (found by
  bisection, :mod:`repro_torch.kernels.sact.cases`), held against the
  reference ``sact_tile``, whose per-lane arithmetic is elementwise;
* random planes plus exactly-touching axis-aligned boxes, held against
  the reference ``core/sact.py``, whose 3-term dot products go through
  ``einsum`` (a fused multiply-add chain on XLA:CPU even without jit).
  The touching boxes use power-of-two extents and signed-permutation
  rotations, so every product is exact and both orders agree.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sact as jsact
from repro.kernels.sact.kernel import _EPS as J_EPS
from repro.kernels.sact.kernel import sact_tile as j_sact_tile
from repro_torch.core import sact as tsact
from repro_torch.kernels import _build
from repro_torch.kernels.sact import ops as sact_ops
from repro_torch.kernels.sact.cases import grazing_plane
from repro_torch.kernels.sact.ref import _EPS, sact_ref

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)


def _jax_plane(obb, aabb, use_spheres):
    """The reference kernel body over a dense plane, as sact_kernel
    builds it, run eagerly."""
    o, a = jnp.asarray(obb), jnp.asarray(aabb)
    M, N = o.shape[0], a.shape[0]

    def bm(x):
        return jnp.broadcast_to(x[:, None], (M, N))

    def bn(x):
        return jnp.broadcast_to(x[None, :], (M, N))
    t = [bm(o[:, i]) - bn(a[:, i]) for i in range(3)]
    Rb = [[bm(o[:, 6 + 3 * i + j]) for j in range(3)] for i in range(3)]
    A = [[jnp.abs(Rb[i][j]) + J_EPS for j in range(3)] for i in range(3)]
    with jax.disable_jit():
        c, e = j_sact_tile(t, Rb, A, [bn(a[:, 3 + i]) for i in range(3)],
                           [bm(o[:, 3 + i]) for i in range(3)],
                           use_spheres=use_spheres)
    return np.asarray(c), np.asarray(e)


@pytest.mark.parametrize("use_spheres", [False, True])
def test_sact_tile_matches_reference_on_grazing_planes(use_spheres):
    obb, aabb = grazing_plane(96, seed=3, use_spheres=use_spheres)
    c, e = sact_ops.sact_dense(torch.from_numpy(obb), torch.from_numpy(aabb),
                               use_spheres=use_spheres)
    jc, je = _jax_plane(obb, aabb, use_spheres)
    assert np.array_equal(c.numpy(), jc)
    assert np.array_equal(e.numpy(), je)
    # the diagonal pairs sit on both sides of an exit-code change
    d = np.diagonal(e.numpy())
    assert (d[0::2] != d[1::2]).all()
    assert _EPS == J_EPS


def test_grazing_planes_cover_all_exit_codes():
    seen = set()
    for sph in (False, True):
        obb, aabb = grazing_plane(96, seed=4, use_spheres=sph)
        _, e = sact_ref(torch.from_numpy(obb), torch.from_numpy(aabb), sph)
        seen |= set(np.unique(e.numpy()).tolist())
    assert seen == set(range(18))


def test_grazing_planes_catch_fused_multiply_add():
    """On the grazing diagonal, a contracted ``a*b+c`` (emulated exactly in
    float64, then rounded once) decides some box-normal axis differently
    from the two-rounding formula the kernels must keep."""
    obb, aabb = grazing_plane(256, seed=1, use_spheres=False)
    t = obb[:, :3] - aabb[:, :3]
    oh, ah = obb[:, 3:6], aabb[:, 3:]
    A = np.abs(obb[:, 6:].reshape(-1, 3, 3)) + np.float32(_EPS)

    def fma(a, b, c):
        return (a.astype(np.float64) * b + c).astype(np.float32)
    flips = 0
    for i in range(3):
        rb = oh[:, 0] * A[:, i, 0] + oh[:, 1] * A[:, i, 1] \
            + oh[:, 2] * A[:, i, 2]
        rb_fma = fma(oh[:, 2], A[:, i, 2],
                     fma(oh[:, 1], A[:, i, 1], oh[:, 0] * A[:, i, 0]))
        flips += int(((np.abs(t[:, i]) > ah[:, i] + rb)
                      != (np.abs(t[:, i]) > ah[:, i] + rb_fma)).sum())
    assert flips > 0


def _touching_boxes(n, seed):
    """Axis-aligned OBBs (signed-permutation rotations) with power-of-two
    extents on a dyadic grid: many pairs touch exactly, every product is
    exact."""
    rs = np.random.RandomState(seed)
    perms = np.asarray([np.eye(3)[list(p)] for p in
                        ((0, 1, 2), (1, 2, 0), (2, 0, 1), (0, 2, 1),
                         (2, 1, 0), (1, 0, 2))], np.float32)
    rot = perms[rs.randint(0, 6, n)] * rs.choice([-1.0, 1.0], (n, 1, 3))
    oh = (2.0 ** -rs.randint(1, 5, (n, 3))).astype(np.float32)
    ah = (2.0 ** -rs.randint(1, 5, (n, 3))).astype(np.float32)
    ac = (rs.randint(-8, 8, (n, 3)) / 8.0).astype(np.float32)
    oc = (rs.randint(-8, 8, (n, 3)) / 8.0).astype(np.float32)
    return oc, oh, rot.astype(np.float32), ac, ah


def _random_pairs(n, seed):
    rs = np.random.RandomState(seed)
    from repro_torch.core.geometry import rotation_from_euler
    rot = rotation_from_euler(torch.from_numpy(
        rs.uniform(-np.pi, np.pi, (n, 3)).astype(np.float32))).numpy()
    return (rs.uniform(-1, 1, (n, 3)).astype(np.float32),
            rs.uniform(0.02, 0.4, (n, 3)).astype(np.float32), rot,
            rs.uniform(-1, 1, (n, 3)).astype(np.float32),
            rs.uniform(0.02, 0.4, (n, 3)).astype(np.float32))


def _plane(boxes, m):
    """Split pair lists into an (m, n) OBB x AABB plane (broadcast)."""
    oc, oh, rot, ac, ah = boxes
    return (oc[:m, None], oh[:m, None], rot[:m, None], ac[None, :],
            ah[None, :])


@pytest.mark.parametrize("use_spheres", [False, True])
def test_core_sact_matches_reference(use_spheres):
    """300 random OBBs x 80 AABBs, and 100 x 60 touching boxes."""
    for boxes, m in ((_random_pairs(300, seed=6), 300),
                     (_touching_boxes(100, seed=5), 100)):
        plane = _plane(boxes, m)
        n = plane[3].shape[1] if m == 300 else 60
        plane = plane[:3] + (plane[3][:, :n], plane[4][:, :n])
        valid = np.random.RandomState(7).rand(m, n) < 0.9
        with jax.disable_jit():
            ref = jsact.sact_frontier_staged(*map(jnp.asarray, plane),
                                             jnp.asarray(valid),
                                             use_spheres=use_spheres)
            ref_full = jsact.sact(*map(jnp.asarray, plane),
                                  use_spheres=use_spheres)
        tb = [torch.from_numpy(np.ascontiguousarray(x)) for x in plane]
        got = tsact.sact_frontier_staged(*tb, torch.from_numpy(valid),
                                         use_spheres=use_spheres)
        got_full = tsact.sact(*tb, use_spheres=use_spheres)
        for r, g in ((ref, got), (ref_full, got_full)):
            for f in r._fields:
                assert np.array_equal(getattr(g, f).numpy(),
                                      np.asarray(getattr(r, f))), f
        if m == 300:
            codes = set(np.unique(got_full.exit_code.numpy()).tolist())
            assert codes >= (set(range(2, 18)) if not use_spheres
                             else {0, 1, 17})
        else:   # faces that touch: margins within the eps terms of zero
            p = tsact.make_pair_terms(*tb)
            assert int((tsact.box_normal_margins(p).abs() < 1e-5).sum()) > 0


@pytest.mark.parametrize("use_spheres", [False, True])
def test_sact_frontier_matches_reference(use_spheres):
    """The unstaged frontier test of ``mode="wavefront"``: random pairs and
    exactly touching boxes, invalid lanes cleared."""
    for boxes in (_random_pairs(400, seed=8), _touching_boxes(400, seed=9)):
        valid = np.random.RandomState(3).rand(400) < 0.8
        with jax.disable_jit():
            ref = jsact.sact_frontier(*map(jnp.asarray, boxes),
                                      jnp.asarray(valid),
                                      use_spheres=use_spheres)
        got = tsact.sact_frontier(*map(torch.from_numpy, boxes),
                                  torch.from_numpy(valid),
                                  use_spheres=use_spheres)
        for f in ref._fields:
            assert np.array_equal(getattr(got, f).numpy(),
                                  np.asarray(getattr(ref, f))), f
        assert not got.collide[~torch.from_numpy(valid)].any()


def test_plain_sact_tile_agrees_with_core_sact_on_random_planes():
    rand = _random_pairs(400, seed=8)
    obb = sact_ops.pack_obbs(*[torch.from_numpy(x) for x in rand[:3]])
    aabb = sact_ops.pack_aabbs(*[torch.from_numpy(x) for x in rand[3:]])
    for sph in (False, True):
        c, e = sact_ops.sact_dense(obb, aabb, use_spheres=sph)
        r = tsact.sact(obb[:, None, :3], obb[:, None, 3:6],
                       obb[:, None, 6:].reshape(-1, 1, 3, 3),
                       aabb[None, :, :3], aabb[None, :, 3:],
                       use_spheres=sph)
        assert torch.equal(c, r.collide) and torch.equal(e, r.exit_code)


def test_payload_min_update_and_axis_tests_match_reference():
    rs = np.random.RandomState(9)
    best = rs.randint(0, 50, 20).astype(np.int32)
    best[:5] = tsact.PAYLOAD_INF
    own = rs.randint(0, 20, 300).astype(np.int32)
    pay = rs.randint(0, 60, 300).astype(np.int32)
    hit = rs.rand(300) < 0.4
    ref = jsact.payload_min_update(jnp.asarray(best), jnp.asarray(own),
                                   jnp.asarray(pay), jnp.asarray(hit))
    got = tsact.payload_min_update(torch.from_numpy(best),
                                   torch.from_numpy(own),
                                   torch.from_numpy(pay),
                                   torch.from_numpy(hit))
    assert np.array_equal(got.numpy(), np.asarray(ref))
    codes = np.arange(18, dtype=np.int32)
    assert np.array_equal(
        tsact.axis_tests_from_exit(torch.from_numpy(codes)).numpy(),
        np.asarray(jsact.axis_tests_from_exit(jnp.asarray(codes))))
    assert tsact.PAYLOAD_INF == jsact.PAYLOAD_INF


def test_sact_dense_validates_inputs():
    with pytest.raises(ValueError, match="15"):
        sact_ops.sact_dense(torch.zeros(4, 14), torch.zeros(3, 6))
    before = _build.launch_counts()["sact_dense"]
    sact_ops.sact_dense(torch.zeros(4, 15), torch.zeros(3, 6))
    # the plain version is no kernel launch
    assert _build.launch_counts()["sact_dense"] == before


_CSRC = Path(sact_ops.__file__).resolve().parents[1]   # .../kernels


def test_sact_tile_cuh_holds_the_only_copy_of_the_tests():
    """One SACT body: no other source under ``kernels/*/csrc`` spells out a
    separating-axis test, and the three kernels that run the SACT include
    ``sact_tile.cuh`` and call its ``sact_tile``."""
    # the B_j face test's radius and the edge tests' projection, as any
    # copy of the tests must write them
    face = re.compile(r"ah\[0\]\s*\*\s*\w*\.?A\[0\]\[j\]")
    edge = re.compile(r"t\[i2\]\s*\*\s*\w*\.?R\[i1\]\[j\]")
    spelled = sorted(str(p.relative_to(_CSRC))
                     for p in _CSRC.glob("*/csrc/*")
                     if p.suffix in (".cu", ".cuh", ".h")
                     and (face.search(p.read_text())
                          or edge.search(p.read_text())))
    assert spelled == ["sact/csrc/sact_tile.cuh"]
    for src in ("persist/csrc/persist.cu", "traverse/csrc/traverse.cu",
                "sact/csrc/sact_dense.cu"):
        text = (_CSRC / src).read_text()
        assert re.search(r'#include "[./]*(sact/csrc/)?sact_tile\.cuh"', text)
        assert "sact_tile<" in text, src
    assert "sact_flat" not in (_CSRC / "persist/csrc/persist.cu").read_text()


def test_sact_dense_every_stage_mode_is_the_plain_version_on_the_cpu():
    assert sact_ops.STAGE_MODE in sact_ops.STAGE_MODES
    obb, aabb = grazing_plane(24, seed=5, use_spheres=True)
    o, a = torch.from_numpy(obb), torch.from_numpy(aabb)
    want = sact_ref(o, a, True)
    for mode in sact_ops.STAGE_MODES:
        c, e = sact_ops.sact_dense_in_mode(o, a, True, mode)
        assert torch.equal(c, want[0]) and torch.equal(e, want[1])
    with pytest.raises(ValueError, match="mode must be"):
        sact_ops.sact_dense_in_mode(o, a, True, "branchy")
