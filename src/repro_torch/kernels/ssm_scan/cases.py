"""Inputs that stress the selective-scan kernel, and its tolerance.

Shared by the CPU tests and the card checks (``chip_smoke.py``,
``tests/test_torch_kernels_gpu.py``).  Each case is a dict of numpy
float32 arrays ``xi`` (B, S, di), ``Bm``, ``Cm`` (B, S, n), ``dt`` (B, S),
``A`` (di, n) and ``h0`` (B, di, n) or None, with its ``name``; the gates
come as the model makes them: ``dt`` a softplus (positive), ``A`` the
reference's ``-exp(a_log)`` with ``a_log = log(1 .. n)`` along n.
:func:`tensors` turns a case into torch tensors, the gates in fp32 or
bf16, ``Bm`` and ``Cm`` as the two halves of one (B, S, 2 n) tensor (the
model's ``bc``: strided views).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

#: Sequence lengths: one step, a length that is no multiple of the
#: kernel's block of 16 steps, past two blocks, and a long one.
LENGTHS = (1, 7, 33, 1000)
#: dt ranges: the softplus of the smoke model's gates (~0.5-1), and a
#: strong decay (exp(dt A) down to e^-480: the state forgets each step).
DT = {"ordinary": (0.05, 1.5), "strong": (10.0, 30.0)}


def make_case(B: int, S: int, di: int, n: int, dt: str = "ordinary",
              with_h0: bool = False, seed: int = 0) -> Dict:
    rs = np.random.RandomState(seed)
    f32 = np.float32
    lo, hi = DT[dt]
    a_log = np.log(np.linspace(1.0, float(n), n))[None, :] * np.ones((di, 1))
    return dict(
        name=f"B={B} S={S} di={di} n={n} {dt}"
             + (" h0" if with_h0 else ""),
        xi=rs.normal(size=(B, S, di)).astype(f32),
        Bm=rs.normal(size=(B, S, n)).astype(f32),
        Cm=rs.normal(size=(B, S, n)).astype(f32),
        dt=rs.uniform(lo, hi, (B, S)).astype(f32),
        A=(-np.exp(a_log)).astype(f32),
        h0=(rs.normal(size=(B, di, n)).astype(f32) if with_h0 else None))


def hard_cases() -> List[Dict]:
    """Every length at n 8 and 16, B 1, 3 and 8 in turn, di up to Hymba's
    1,600 (an odd 200 and a di whose lanes end inside a warp), with and
    without an initial state; strong decays."""
    out, seed = [], 0
    shapes = [(1, 1, 160, 8), (3, 7, 200, 16), (8, 33, 1600, 16),
              (1, 1000, 1600, 16), (3, 33, 37, 8), (8, 7, 160, 8),
              (1, 1000, 200, 8), (3, 1, 1600, 16)]
    for B, S, di, n in shapes:
        for with_h0 in (False, True):
            seed += 1
            out.append(make_case(B, S, di, n, "ordinary", with_h0, seed))
    for B, S, di, n in ((3, 33, 200, 16), (1, 1000, 160, 8)):
        seed += 1
        out.append(make_case(B, S, di, n, "strong", True, seed))
    return out


def tensors(case: Dict, device, dtype=torch.float32):
    """(xi, Bm, Cm, dt, A, h0) on ``device``: the gates in ``dtype``, ``Bm``
    and ``Cm`` views of one (B, S, 2 n) tensor, A and h0 fp32."""
    gate = lambda a: torch.from_numpy(a).to(device, dtype)
    bc = gate(np.concatenate([case["Bm"], case["Cm"]], -1))
    n = case["Bm"].shape[-1]
    h0 = case["h0"]
    return (gate(case["xi"]), bc[..., :n], bc[..., n:], gate(case["dt"]),
            torch.from_numpy(case["A"]).to(device),
            None if h0 is None else torch.from_numpy(h0).to(device))


#: The kernel's y against its plain version's: ``|got - want| <= atol *
#: max(1, max|want|) + rtol * |want|``.  Both compute each state element
#: with the same operations in the same order (the state is held bit for
#: bit); y's n-term sum runs as a tree over the lanes on the card and in the
#: einsum's order in the plain version, a few roundings of 2**-24 of the
#: terms, which may cancel (hence the absolute part, scaled by the output).
TOL = dict(atol=1e-5, rtol=1e-5)


def within_tol(got, want) -> float:
    """The largest excess of y over :data:`TOL` (<= 0 passes), a float."""
    got, want = got.float(), want.float()
    if not want.numel():
        return 0.0
    scale = max(1.0, float(want.abs().max()))
    bound = TOL["atol"] * scale + TOL["rtol"] * want.abs()
    return float(((got - want).abs() - bound).max())
