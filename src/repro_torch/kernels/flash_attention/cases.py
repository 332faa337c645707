"""Inputs that stress the flash-attention kernel, and its tolerance.

Shared by the CPU tests and the card checks (``chip_smoke.py``,
``tests/test_torch_kernels_gpu.py``).  Each case is a dict of numpy
float32 arrays ``q`` (B, Hq, Tq, d), ``k`` and ``v`` (B, Hkv, Tk, d), with
its ``name``, ``causal``, ``layout``, ``score_scale`` and ``window`` (0:
none); :func:`tensors` turns one into torch tensors in the layout it
names.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

#: Head widths: the smoke config's 16, 64, glm4's 128, and 32, the one
#: other width the wrapper admits.
WIDTHS = (16, 64, 128, 32)
#: Causal lengths (Tq = Tk): one token, around the fp32 kernel's 64-row
#: tile, the full-width prefill's 1024 and one past it (the consistency
#: check's), then around the bf16 kernel's 128-row and 128-key tiles (one
#: tile, one past, two, two and one past).
CAUSAL_LENGTHS = (1, 63, 64, 65, 1024, 1025, 127, 128, 129, 255, 257)
#: Query heads per KV head: plain multi-head, the smoke config's 4,
#: glm4's 16.
GROUPS = (1, 4, 16)
#: Non-causal Tq != Tk pairs: ragged on both axes, a single query, and two
#: query tiles over two key tiles with Tk no multiple of 8 (the TMA loads'
#: zero fill past Tk, the TMA store's clipping past Tq).
CROSS_LENGTHS = ((40, 72), (100, 37), (1, 130), (200, 203))
#: q and k times this in the large-magnitude cases: scores with a standard
#: deviation of ~64, so the running max moves by large steps and the
#: rescale ``exp(m_prev - m_new)`` matters.
LARGE = 8.0


def make_case(B: int, Hkv: int, group: int, Tq: int, Tk: int, d: int,
              causal: bool, layout: str = "bhtd", scale: float = 1.0,
              seed: int = 0, window: int = 0) -> Dict:
    """``layout`` ``"bthd"`` asks :func:`tensors` for (B, H, T, d) views of
    (B, T, H, d) tensors, as the model hands over its projections."""
    rs = np.random.RandomState(seed)
    f32 = np.float32
    Hq = Hkv * group
    return dict(
        name=f"B={B} Hq={Hq} Hkv={Hkv} Tq={Tq} Tk={Tk} d={d} "
             f"{'causal' if causal else 'full'} {layout}"
             + (f" x{scale:g}" if scale != 1.0 else "")
             + (f" window={window}" if window else ""),
        q=(rs.normal(size=(B, Hq, Tq, d)) * scale).astype(f32),
        k=(rs.normal(size=(B, Hkv, Tk, d)) * scale).astype(f32),
        v=rs.normal(size=(B, Hkv, Tk, d)).astype(f32),
        causal=causal, layout=layout, score_scale=scale * scale,
        window=window)


def hard_cases() -> List[Dict]:
    """Every width with every causal length (the group and the layout
    cycling), ragged non-causal pairs, and large-magnitude scores.  The
    cases of d 16, 64 and 128 at the first six lengths and three pairs
    come first, in their own order and with their own seeds; the rest
    (the tile edges, the last pair, d 32) follow."""
    out = []
    seed = 0

    def causal(d, i, T):
        group = GROUPS[(i + d // 16) % len(GROUPS)]
        B, Hkv = (1, 1) if T >= 1024 else (2, 2)
        return make_case(B, Hkv, group, T, T, d, True,
                         ("bhtd", "bthd")[i % 2], seed=seed)

    def cross(d, Tq, Tk):
        return make_case(2, 1, 4, Tq, Tk, d, False, "bthd", seed=seed)

    for d in WIDTHS[:3]:
        for i, T in enumerate(CAUSAL_LENGTHS[:6]):
            seed += 1
            out.append(causal(d, i, T))
        for Tq, Tk in CROSS_LENGTHS[:3]:
            seed += 1
            out.append(cross(d, Tq, Tk))
        seed += 1
        out.append(make_case(1, 2, 16, 200, 200, d, True, "bthd",
                             scale=LARGE, seed=seed))
    for d in WIDTHS:
        first = 6 if d in WIDTHS[:3] else 0
        for i, T in enumerate(CAUSAL_LENGTHS):
            if i >= first:
                seed += 1
                out.append(causal(d, i, T))
        for Tq, Tk in CROSS_LENGTHS[3 if first else 0:]:
            seed += 1
            out.append(cross(d, Tq, Tk))
        if not first:
            seed += 1
            out.append(make_case(1, 2, 16, 200, 200, d, True, "bthd",
                                 scale=LARGE, seed=seed))
    return out


#: Sliding windows: one key, a few, the smoke config's 64, around the bf16
#: kernel's 128-key tile, and Hymba's 4,096.
WINDOWS = (1, 7, 64, 127, 128, 129, 4096)


def window_cases() -> List[Dict]:
    """Hymba's attention shape (5 query heads on one KV head, the model's
    layout) at d 32 and 64, causal with every window of :data:`WINDOWS` at
    Tq = Tk no multiple of 128 (past the window for 4,096); windows of Tk
    and more, which mask nothing (``same_as_none``: the kernel must give
    the bits of no window); and Tq > Tk + window - 1, whose last rows see
    no key (o = 0)."""
    out, seed = [], 300
    for d in (32, 64):
        for w in WINDOWS:
            seed += 1
            T = 4200 if w > 1000 else 333
            out.append(make_case(1 if T > 1000 else 2, 1, 5, T, T, d, True,
                                 "bthd", seed=seed, window=w))
        for w in (333, 1000):
            seed += 1
            case = make_case(2, 1, 5, 333, 333, d, True, "bthd", seed=seed,
                             window=w)
            case["same_as_none"] = True
            out.append(case)
        seed += 1
        out.append(make_case(2, 1, 5, 300, 100, d, True, "bthd", seed=seed,
                             window=64))
    return out


def tensors(case: Dict, device, dtype=torch.float32):
    """(q, k, v) as (B, H, T, d) tensors on ``device`` in ``dtype``; for the
    ``bthd`` layout, views of (B, T, H, d) tensors."""
    out = []
    for n in "qkv":
        x = torch.from_numpy(case[n]).to(device, dtype)
        if case["layout"] == "bthd":
            x = x.transpose(1, 2).contiguous().transpose(1, 2)
        out.append(x)
    return tuple(out)


#: Kernel against its plain version, as ``|got - want| <= atol * scale +
#: rtol * |want|`` with ``scale = max(1, score_scale)``.  fp32: the kernel
#: sums each score's d products and each output's Tk terms in another order
#: than the plain version's matrix products, a few roundings of 2**-24
#: relative to the largest score, which the softmax carries to the output
#: (hence the score scale).  bf16: the kernel rounds the softmax weights to
#: bf16 for the tensor-core product (2**-9 relative each), and the output
#: to bf16, which that difference may flip: two bf16 ulps at |o| <= 1.
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=1.6e-2, rtol=1.6e-2)}


def within_tol(got, want, dtype_name: str, score_scale: float = 1.0
               ) -> float:
    """The largest excess over the tolerance (<= 0 passes), as a float."""
    tol = TOL[dtype_name]
    got, want = got.float(), want.float()
    if not want.numel():
        return 0.0
    bound = tol["atol"] * max(1.0, score_scale) + tol["rtol"] * want.abs()
    return float(((got - want).abs() - bound).max())


# ---- the backward ----------------------------------------------------------

#: Query heads per KV head in the backward's cases: plain multi-head,
#: starcoder2's smoke config's 3 and its full config's 9 (groups that are
#: no power of two), glm4's 16.
BWD_GROUPS = (1, 3, 9, 16)


def bwd_cases() -> List[Dict]:
    """Inputs of the backward: :func:`make_case`'s arrays plus ``do``, the
    output's gradient.  Every width; every group of :data:`BWD_GROUPS`;
    causal with Tq = Tk (three tokens, past one and two of the bf16
    kernels' 64-row tiles, 256), with Tq < Tk and Tq > Tk (causal from 0
    on both);
    non-causal Tq != Tk with Tk no multiple of a key tile (32 or 64); both
    layouts; and large-magnitude scores (x8), which the tests hold in fp32
    only (a bf16 rounding of a score of ~64 moves its softmax weight
    itself, ROADMAP C.13).  No case has one token: the gradient of a
    softmax over one key is 0, and what both sides compute is the rounding
    of dP - delta (it is row 0 of every causal case, beside rows whose
    gradients set the scale)."""
    specs = [  # B, Hkv, group, Tq, Tk, d, causal, layout, scale
        (2, 2, 1, 100, 100, 16, True, "bhtd", 1.0),
        (1, 2, 3, 130, 130, 32, True, "bthd", 1.0),
        (1, 1, 9, 65, 65, 128, True, "bthd", 1.0),
        (1, 2, 16, 200, 200, 64, True, "bthd", 1.0),
        (1, 2, 16, 256, 256, 128, True, "bthd", 1.0),
        (1, 1, 16, 3, 3, 128, True, "bhtd", 1.0),
        (1, 1, 9, 64, 129, 64, True, "bthd", 1.0),
        (1, 2, 1, 150, 70, 32, True, "bhtd", 1.0),
        (2, 1, 4, 40, 72, 16, False, "bthd", 1.0),
        (1, 2, 3, 97, 33, 128, False, "bhtd", 1.0),
        (1, 1, 9, 33, 200, 32, False, "bthd", 1.0),
        (1, 2, 16, 200, 200, 128, True, "bthd", LARGE),
        (1, 1, 3, 100, 100, 16, False, "bhtd", LARGE),
    ]
    out = []
    for i, (B, Hkv, g, Tq, Tk, d, causal, layout, scale) in enumerate(specs):
        case = make_case(B, Hkv, g, Tq, Tk, d, causal, layout, scale,
                         seed=100 + i)
        case["do"] = np.random.RandomState(200 + i).normal(
            size=case["q"].shape).astype(np.float32)
        out.append(case)
    return out


def bwd_tensors(case: Dict, device, dtype=torch.float32):
    """(q, k, v, do) on ``device`` in ``dtype``, ``do`` in q's layout."""
    q, k, v = tensors(case, device, dtype)
    do = torch.from_numpy(case["do"]).to(device, dtype)
    if case["layout"] == "bthd":
        do = do.transpose(1, 2).contiguous().transpose(1, 2)
    return q, k, v, do


#: A gradient against the plain version.  fp32: ``|got - want| <= rtol *
#: max|want| * scale + atol`` with ``scale = max(1, score_scale)``.  The
#: kernels sum each score's d products, each dP and each gradient's terms in
#: another order than the plain version's matrix products; the error grows
#: with the scores (a score s carries 2**-24 |s| into its weight exp(s -
#: lse)): at x8 scores (std ~64) the fp32 plain version itself misses 1e-5
#: of max|grad| against a float64 computation at d 128
#: (``tests/test_torch_flash_grad.py::
#: test_fp32_backward_at_x8_scores_needs_the_score_scale``), hence the score
#: scale, as in :data:`TOL`.  bf16 against the fp32 plain version on the
#: same bf16 inputs: the kernels round P and dS to bf16 (2**-9 relative)
#: before the tensor-core products, and each gradient to bf16.  So each row
#: (a query's dq, a key's dk or dv, along d) is held to ``rtol`` of its own
#: max|want|: in causal attention the first keys' dk and dv are tens of
#: times the last keys', and a bound from the whole tensor's max would pass
#: a kernel that mangled the last keys.  ``floor``, of the whole tensor's
#: max|want|, is for rows whose exact gradient is 0 (a causal case's first
#: query, whose softmax has one key): they carry only the fp32 rounding of
#: dP - delta, which both sides compute in fp32, held as fp32 holds a
#: gradient.
BWD_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
           "bfloat16": dict(rtol=2e-2, floor=1e-5)}
#: The forward's row log-sum-exp against the plain version's, absolute:
#: a few fp32 roundings of the largest scaled score (~1e-6 at scores of
#: order 1), times the score scale; bf16 inputs are exact in fp32 and their
#: scores summed in fp32, so the same bound holds.
LSE_ATOL = 1e-5


def bwd_within_tol(got, want, dtype_name: str, score_scale: float = 1.0
                   ) -> float:
    """The largest excess over :data:`BWD_TOL` (<= 0 passes): of the
    tensor's largest error over its bound in fp32, of any element's error
    over its row's bound in bf16."""
    tol = BWD_TOL[dtype_name]
    got, want = got.float(), want.float()
    if not want.numel():
        return 0.0
    if dtype_name == "float32":
        bound = (tol["rtol"] * float(want.abs().max()) * max(1.0, score_scale)
                 + tol["atol"])
        return float((got - want).abs().max()) - bound
    row = want.abs().amax(-1, keepdim=True)
    bound = tol["rtol"] * row + tol["floor"] * float(row.max())
    return float(((got - want).abs() - bound).max())


def lse_within_tol(got, want, score_scale: float = 1.0) -> float:
    """The largest excess of a row log-sum-exp over :data:`LSE_ATOL`."""
    if not want.numel():
        return 0.0
    return (float((got.float() - want.float()).abs().max())
            - LSE_ATOL * max(1.0, score_scale))
