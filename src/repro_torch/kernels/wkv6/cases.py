"""Inputs that stress the WKV6 kernels, and the tolerances they are held to.

Shared by the CPU tests and the card checks (``chip_smoke.py``,
``tests/test_torch_kernels_gpu.py``).  Each case is a dict of numpy
arrays ``r``, ``k``, ``v``, ``logw`` (BH, T, D) float32 and ``u`` (BH, D)
or (D,) float32, plus its ``name``; a backward case
(:func:`make_bwd_case`) adds ``do`` (BH, T, D) and ``dstate`` (BH, D, D)
or None, the gradients of the output and of the final state.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

#: Sequence lengths: one step, a length that is no multiple of any chunk
#: or block, and the full-width prefill's 1024.
LENGTHS = (1, 33, 1024)
#: Key/value widths: narrower than a warp, and the model's 64.
WIDTHS = (16, 64)
#: Decay regimes as ranges of ``logw``: ordinary, strong (``w`` underflows
#: to subnormals and 0), weak (``w`` within 1e-6 of 1, so the state keeps
#: growing over the whole sequence).
DECAYS = {"ordinary": (-3.0, -0.01), "strong": (-120.0, -90.0),
          "weak": (-2e-6, -1e-7)}


def make_case(BH: int, T: int, D: int, decay: str = "ordinary",
              per_row_u: bool = True, seed: int = 0) -> Dict:
    rs = np.random.RandomState(seed)
    f32 = np.float32

    def normal(scale):
        return (rs.normal(size=(BH, T, D)) * scale).astype(f32)

    lo, hi = DECAYS[decay]
    u_shape = (BH, D) if per_row_u else (D,)
    return dict(
        name=f"BH={BH} T={T} D={D} {decay} "
             f"u={'per-row' if per_row_u else 'shared'}",
        r=normal(0.5), k=normal(0.5), v=normal(1.0),
        logw=rs.uniform(lo, hi, (BH, T, D)).astype(f32),
        u=(rs.normal(size=u_shape) * 0.3).astype(f32))


#: The kernel's chunk edges (chunks of 16, 32 and 64 steps) ...
EDGE_LENGTHS = (31, 32, 33, 64, 65)
#: ... at each width it is built for (16, 32, 64 and 128 channels), and at
#: 33, which rows of bf16 or fp32 cannot copy 16 bytes at a time.
EDGE_WIDTHS = (16, 32, 33, 64, 128)


def _cases(BH: int, shapes, seed: int) -> List[Dict]:
    out = []
    for T, D in shapes:
        for decay in DECAYS:
            for per_row in (True, False):
                seed += 1
                out.append(make_case(BH, T, D, decay, per_row, seed))
    return out


def hard_cases(BH: int = 3) -> List[Dict]:
    """Every length, width and decay regime, per-row and shared ``u``."""
    return _cases(BH, [(T, D) for T in LENGTHS for D in WIDTHS], 0)


def edge_cases(BH: int = 3) -> List[Dict]:
    """The chunk edges at every width, and the widths that
    :func:`hard_cases` lacks (32, 128) at one step and at 1024, in every
    decay regime, per-row and shared ``u``; no shape of :func:`hard_cases`
    again."""
    shapes = ([(T, D) for T in EDGE_LENGTHS for D in EDGE_WIDTHS
               if (T, D) not in ((33, 16), (33, 64))]
              + [(T, D) for T in (1, 1024) for D in (32, 128)])
    return _cases(BH, shapes, 1000)


#: Kernel against its plain version on the card, as ``|got - want| <=
#: ATOL * max(1, max|want|) + RTOL * |want|``.  fp32: the kernel computes
#: the chunked form (products in 3xTF32, about 2**-22 relative a product,
#: summed in fp32 in another order; decays as exponentials of cumsum
#: differences), the plain version the step-by-step recurrence in einsum
#: order: the two differ by a few roundings of 2**-24 relative to the
#: largest terms.  bf16 outputs: the same, and a rounding to bf16 that the
#: fp32 difference may flip, one bf16 ulp (2**-7 relative).  The backward
#: kernel is held to the same values: it and its plain version (the reverse
#: recurrence) walk the same recurrence in fp32, the kernel summing each
#: row's terms by columns and shuffles, the plain version in einsum order,
#: so they too differ by a few roundings relative to the largest terms,
#: which the state's gradient makes up to T times an output's gradient
#: under weak decay (hence atol against max|want|).
TOL = {"float32": dict(atol=2e-5, rtol=0.0),
       "bfloat16": dict(atol=2e-5, rtol=2.0 ** -7)}


def within_tol(got, want, dtype_name: str) -> float:
    """The largest excess over the tolerance (<= 0 passes), as a float."""
    tol = TOL[dtype_name]
    got, want = got.float(), want.float()
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    bound = tol["atol"] * scale + tol["rtol"] * want.abs()
    return float(((got - want).abs() - bound).max()) if want.numel() else 0.0


def make_bwd_case(BH: int, T: int, D: int, decay: str = "ordinary",
                  per_row_u: bool = True, with_dstate: bool = True,
                  seed: int = 0) -> Dict:
    """A forward case and the gradients that flow into it: ``do`` of the
    output's scale and, with ``with_dstate``, ``dstate`` of the final
    state's."""
    case = make_case(BH, T, D, decay, per_row_u, seed)
    rs = np.random.RandomState(seed + 7919)
    case["do"] = rs.normal(size=(BH, T, D)).astype(np.float32)
    case["dstate"] = ((rs.normal(size=(BH, D, D)) * 0.5).astype(np.float32)
                      if with_dstate else None)
    case["name"] += f" dS={'given' if with_dstate else 'none'}"
    return case


#: The backward kernel's lengths: past one chunk of any width's, and the
#: model's training steps a few chunks deep; D the model's 64.
BWD_LENGTHS = (33, 256)


def bwd_cases(BH: int = 3, D: int = 64, lengths=BWD_LENGTHS) -> List[Dict]:
    """Every decay regime (ordinary; strong, where ``w`` underflows and a
    gradient that multiplies it must vanish, not blow up; weak, where the
    state's gradient keeps growing over the whole sequence) at each length,
    with and without the final state's gradient, per-row and shared
    ``u`` in turn."""
    out, seed = [], 2000
    for T in lengths:
        for decay in DECAYS:
            for with_dstate in (True, False):
                seed += 1
                out.append(make_bwd_case(BH, T, D, decay, seed % 2 == 0,
                                         with_dstate, seed))
    return out

