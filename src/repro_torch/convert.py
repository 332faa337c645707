"""Carry a scene, planner weights and LM weights across from the reference.

The reference's ``Octree`` is handed over as plain numpy arrays
(``scene_lo``, ``scene_size``, ``depth``, per level ``codes``, ``full``,
``child_start``, ``child_mask``, and the ball query's point storage) and
becomes this package's :class:`repro_torch.core.octree.Octree`; its
``OccupancyGrid`` becomes a :class:`repro_torch.core.mcl.OccupancyGrid`;
the reference planner's parameter
tree becomes a :class:`repro_torch.models.planner.Planner` state dict, the
reference LM's a :class:`repro_torch.models.transformer.LM` state dict, its
encoder-decoder's an :class:`repro_torch.models.encdec.EncDec` one,
and an optimizer state of either (``m``, ``v``, ``step``) the port's
(:func:`opt_state_from_reference`).  So both packages can run on one
scene, one planner and one LM, and train them, without this package
importing the other.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.mcl import OccupancyGrid
from repro_torch.core.octree import MAX_DEPTH, Octree, OctreeLevel

#: The ball query's point storage of an :class:`Octree`.
_POINT_FIELDS = ("points_sorted", "point_index", "leaf_point_start",
                 "leaf_point_count")


def _point_storage(points: Optional[Mapping[str, np.ndarray]],
                   n_leaf: int) -> Dict[str, np.ndarray]:
    """The ball query's point storage, checked: ``points_sorted (P, 3)``,
    ``point_index (P,)`` and ``leaf_point_start`` / ``leaf_point_count``
    ``(n_leaf,)``, whose runs cover the P points in order, none empty.
    ``None`` gives empty storage (a tree that answers collision queries
    only)."""
    if points is None:
        empty_i = np.zeros(0, np.int32)
        return dict(points_sorted=np.zeros((0, 3), np.float32),
                    point_index=empty_i, leaf_point_start=empty_i,
                    leaf_point_count=empty_i)
    out = dict(points_sorted=np.asarray(points["points_sorted"], np.float32),
               point_index=np.asarray(points["point_index"], np.int32),
               leaf_point_start=np.asarray(points["leaf_point_start"],
                                           np.int32),
               leaf_point_count=np.asarray(points["leaf_point_count"],
                                           np.int32))
    P = out["point_index"].shape[0]
    want = dict(points_sorted=(P, 3), point_index=(P,),
                leaf_point_start=(n_leaf,), leaf_point_count=(n_leaf,))
    for name, shape in want.items():
        if out[name].shape != shape:
            raise ValueError(f"point storage: {name} has shape "
                             f"{out[name].shape}, want {shape}")
    start, count = out["leaf_point_start"], out["leaf_point_count"]
    runs_ok = (int(count.sum()) == P and bool((count >= 1).all())
               and (n_leaf == 0 or start[0] == 0)
               and bool((start[1:] == start[:-1] + count[:-1]).all()))
    if not runs_ok:
        raise ValueError("point storage: leaf_point_start and "
                         "leaf_point_count must cover the points in order, "
                         "one run a leaf, none empty")
    return out


def octree_from_arrays(scene_lo, scene_size: float, depth: int,
                       levels: Sequence[Mapping[str, np.ndarray]],
                       points: Optional[Mapping[str, np.ndarray]] = None
                       ) -> Octree:
    """Build an :class:`Octree` from the reference's level arrays.

    ``levels[l]`` maps ``codes`` (uint32, sorted), ``full`` (bool),
    ``child_start`` (int32) and ``child_mask`` (uint8) of level ``l``.
    ``points``, where given, maps the ball query's point storage
    (``points_sorted``, ``point_index``, ``leaf_point_start``,
    ``leaf_point_count``); without it the storage is left empty.
    """
    depth = int(depth)
    if not 1 <= depth <= MAX_DEPTH or len(levels) != depth + 1:
        raise ValueError(f"need depth in [1, {MAX_DEPTH}] and depth + 1 "
                         f"levels, got depth {depth} and {len(levels)}")
    out = []
    for lv_i, lv in enumerate(levels):
        codes = np.asarray(lv["codes"], np.uint32)
        n = codes.shape[0]
        fields = dict(full=np.asarray(lv["full"], bool),
                      child_start=np.asarray(lv["child_start"], np.int32),
                      child_mask=np.asarray(lv["child_mask"], np.uint8))
        for name, arr in fields.items():
            if arr.shape != (n,):
                raise ValueError(f"level {lv_i}: {name} has shape "
                                 f"{arr.shape}, want ({n},)")
        if n > 1 and not (codes[1:] > codes[:-1]).all():
            raise ValueError(f"level {lv_i}: codes must be strictly sorted")
        out.append(OctreeLevel(codes=codes, **fields))
    return Octree(scene_lo=np.asarray(scene_lo, np.float32),
                  scene_size=float(scene_size), depth=depth, levels=out,
                  **_point_storage(points, len(out[-1].codes)))


def octree_from_reference(tree) -> Octree:
    """Convert any object with the reference ``Octree``'s attributes
    (``scene_lo``, ``scene_size``, ``depth``, ``levels[l].codes`` ... and,
    where it has them, the point storage's)."""
    points = ({f: np.asarray(getattr(tree, f)) for f in _POINT_FIELDS}
              if all(hasattr(tree, f) for f in _POINT_FIELDS) else None)
    return octree_from_arrays(
        np.asarray(tree.scene_lo), tree.scene_size, tree.depth,
        [dict(codes=np.asarray(lv.codes), full=np.asarray(lv.full),
              child_start=np.asarray(lv.child_start),
              child_mask=np.asarray(lv.child_mask)) for lv in tree.levels],
        points=points)


def grid_from_reference(grid, device=DEFAULT_DEVICE) -> OccupancyGrid:
    """The reference's ``OccupancyGrid`` (``occ`` (H, W) bool, ``cell``,
    ``origin``) as this package's, its cells on ``device``."""
    occ = torch.from_numpy(np.array(grid.occ, dtype=bool))
    return OccupancyGrid(occ=occ.to(resolve_device(device)),
                         cell=float(grid.cell),
                         origin=tuple(float(x) for x in grid.origin))


def planner_from_reference(params: Mapping) -> Dict[str, torch.Tensor]:
    """The reference planner's parameters (nested dicts of arrays:
    ``pointnet/sa{1,2,3}/{w1,b1,w2,b2}`` and ``fc1``, ``fc2``, ``fc3``,
    ``out`` each ``{w, b}``, weights stored ``(in, out)``) as a
    :class:`Planner` state dict (``nn.Linear`` weights, ``(out, in)``)."""
    def linear(prefix, w, b):
        return {f"{prefix}.weight": torch.from_numpy(
                    np.array(w, np.float32).T.copy()),
                f"{prefix}.bias": torch.from_numpy(np.array(b, np.float32))}

    state = {}
    for sa in ("sa1", "sa2", "sa3"):
        p = params["pointnet"][sa]
        state.update(linear(f"pointnet.{sa}.mlp1", p["w1"], p["b1"]))
        state.update(linear(f"pointnet.{sa}.mlp2", p["w2"], p["b2"]))
    for name in ("fc1", "fc2", "fc3", "out"):
        state.update(linear(name, params[name]["w"], params[name]["b"]))
    return state


def _tensor(a) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype; bfloat16 arrays (the
    ``ml_dtypes`` type, which torch cannot read) go through their bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, path + "."))
        else:
            out[path] = val
    return out


def _unstacked(params: Mapping, stacks: Mapping[str, int]
               ) -> Dict[str, torch.Tensor]:
    """A reference tree as a state dict: each leaf under a stack named in
    ``stacks`` (its leading axis of that many layers) split into
    ``<stack>.<l>.<name>``, the other leaves as they are; the same
    layouts and dtypes."""
    state = {}
    for path, leaf in _flatten(params).items():
        stack, _, name = path.partition(".")
        if stack not in stacks or not name:
            state[path] = _tensor(leaf)
            continue
        stacked = np.asarray(leaf)
        if stacked.shape[0] != stacks[stack]:
            raise ValueError(f"{path}: leading axis {stacked.shape[0]}, "
                             f"want {stacks[stack]} layers")
        for layer in range(stacks[stack]):
            state[f"{stack}.{layer}.{name}"] = _tensor(stacked[layer])
    return state


def lm_from_reference(cfg, params: Mapping) -> Dict[str, torch.Tensor]:
    """The reference LM's parameters (``init_lm``'s tree of numpy arrays:
    ``embed``, ``ln_f``, ``lm_head`` and ``blocks``, each block leaf
    stacked on a leading L axis; projections ``(in, out)``) as an
    :class:`LM` state dict (``blocks.<l>.<name>``, the same layouts and
    dtypes: a hybrid block's ``ssm`` leaves too, ``a_log`` fp32 whatever
    ``param_dtype`` is, as the reference keeps it)."""
    return _unstacked(params, {"blocks": cfg.num_layers})


def encdec_from_reference(cfg, params: Mapping) -> Dict[str, torch.Tensor]:
    """The reference encoder-decoder's parameters (``init_encdec``'s tree:
    ``embed``, ``ln_enc``, ``ln_f``, ``lm_head``, and ``enc_blocks`` and
    ``dec_blocks``, stacked on ``encoder_layers`` and ``num_layers``) as an
    :class:`repro_torch.models.encdec.EncDec` state dict
    (``enc_blocks.<l>.<name>``, ``dec_blocks.<l>.<name>``; the same
    layouts and dtypes)."""
    return _unstacked(params, {"enc_blocks": cfg.encoder_layers,
                               "dec_blocks": cfg.num_layers})


def opt_state_from_reference(state: Mapping,
                             params_to_state: Callable[[Mapping], Dict]
                             ) -> Dict:
    """The reference's ``init_opt_state`` / ``adamw_update`` state (``m``
    and ``v`` trees of numpy arrays shaped as the parameters, ``step``) as
    the port's (:func:`repro_torch.train.optimizer.init_opt_state`'s
    layout).  ``params_to_state`` converts a parameter-shaped tree:
    :func:`planner_from_reference` (its transposes),
    ``functools.partial(lm_from_reference, cfg)`` or
    ``functools.partial(encdec_from_reference, cfg)`` (their unstacking).  The
    moments keep their dtype (fp32, or bf16 for ``state_dtype=
    "bfloat16"``); the tensors lie on the CPU."""
    out = {}
    for key in ("m", "v"):
        bf16 = any(np.asarray(x).dtype.name == "bfloat16"
                   for x in _flatten(state[key]).values())
        conv = params_to_state(state[key])
        out[key] = {name: (t.to(torch.bfloat16) if bf16 else t)
                    for name, t in conv.items()}
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32)
    return out
