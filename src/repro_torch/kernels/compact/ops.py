"""Dispatch for the stream-compaction kernel.

:func:`compact_columns` runs the CUDA kernel (``csrc/compact.cu``) on CUDA
tensors and its plain PyTorch version (:func:`repro_torch.kernels.compact.
ref.compact_ref`) on CPU tensors; a build or launch failure raises.  It
takes up to :data:`MAX_CHANNELS` int32 columns of N lanes as separate
tensors, by pointer, and returns them compacted channel-major, ``(C,
n_out)``, so each channel comes out as one contiguous row:
:func:`compact_pairs`, the frontier compaction of both per-level arms,
hands its two columns in as they are and its two rows straight to the
next level.  :func:`compact_channels` takes a ``(C, N)`` tensor and
:func:`stream_compact` keeps the reference's row-major ``(N, C)``
interface.

Replaces the reference's ``compact/kernel.py::compact_kernel`` and its
count-and-scan pass (``compact/ops.py::_compact_pallas``).  Bound on the
H100: bytes (the mask read once, the kept values read once, ``n_out``
slots a channel written once).  A call is one launch of a single-pass
kernel (decoupled look-back over 8192-lane tiles; the tiles after the last
lane tile write the zero tail), one allocation (``out`` and ``count`` in
one buffer) and one ctypes call: no count, scan or scatter launches, no
``torch.zeros``, no ``torch.stack``.  The kernel's status words and ticket
are scratch kept per device and stream and reused; each call carries a new
generation tag, so they need no reset (see the source note).

Both versions zero-fill the output past ``count``, so a retired frontier
lane holds query 0 and node 0, in range for every later gather.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.compact.ref import compact_ref

#: Lanes a tile of the kernel (``kTile`` in the source).
TILE = 8192
#: Channels the kernel takes by pointer (``MAX_CH`` in the source).
MAX_CHANNELS = 4
#: Status words allocated at least, so that the scratch rarely grows.
_MIN_STATUS = 1024

#: (device index, stream) -> (status words (int64), ticket (int32)).
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
#: The last generation tag handed to the kernel, in [1, 2**30), and the
#: lock it is drawn under: two host threads (a service's worker and a
#: launch thread it abandoned) may launch on one stream, and two launches
#: with one tag would read each other's status words as their own.
_gen = 0
_GEN_LOCK = threading.Lock()
_launch = None
#: The raw current stream of a device, without building a Stream object
#: (a call is paced by the host: a few microseconds matter here).
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _lib():
    global _launch
    if _launch is None:
        fn = _build.load("compact").compact_launch
        fn.argtypes = ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                       + [ctypes.c_uint, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _scratch(dev: torch.device, stream: int, n_tiles: int):
    """Status words for ``n_tiles`` tiles and the ticket of this device and
    stream; a new buffer starts at zero (generation 0, never handed out)."""
    key = (dev.index, stream)
    held = _SCRATCH.get(key)
    if held is None or held[0].numel() < n_tiles:
        size = _MIN_STATUS
        while size < n_tiles:
            size *= 2
        ticket = (held[1] if held is not None
                  else torch.zeros(1, dtype=torch.int32, device=dev))
        held = _SCRATCH[key] = (
            torch.zeros(size, dtype=torch.int64, device=dev), ticket)
    return held


def _next_gen() -> int:
    global _gen
    with _GEN_LOCK:
        _gen = _gen % (2**30 - 1) + 1
        return _gen


def _refuse(mask, columns, n_out) -> None:
    """Raise for what neither version takes (the checks, spelled out)."""
    dev = mask.device
    if mask.ndim != 1 or any(c.shape != mask.shape for c in columns):
        raise ValueError(f"want mask (N,) and columns (N,), got "
                         f"{tuple(mask.shape)} and "
                         f"{[tuple(c.shape) for c in columns]}")
    if any(c.device != dev for c in columns):
        raise ValueError("mask and columns must share a device")
    if n_out < 0:
        raise ValueError(f"n_out must be >= 0, got {n_out}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cpu":
        return
    if mask.dtype != torch.bool or any(c.dtype != torch.int32
                                       for c in columns):
        raise ValueError(f"compact takes a bool mask and int32 channels, got "
                         f"{mask.dtype} and "
                         f"{sorted({str(c.dtype) for c in columns})}")
    if len(columns) > MAX_CHANNELS:
        raise ValueError(f"compact takes at most {MAX_CHANNELS} channels, "
                         f"got {len(columns)}")
    if max(mask.shape[0], n_out) >= 2**31 - TILE:
        raise ValueError(f"compact takes fewer than 2**31 lanes and slots, "
                         f"got {mask.shape[0]} and {n_out}")
    raise ValueError("compact: inputs the kernel does not take")


def compact_columns(mask: torch.Tensor, columns: Sequence[torch.Tensor],
                    n_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact the int32 ``columns`` (each ``(N,)``) by ``mask (N,)`` bool
    into ``(C, n_out)``; returns ``(count () int32, out (C, n_out)
    int32)``, both on the input's device."""
    dev = mask.device
    C = len(columns)
    # The checks of _refuse in as few host operations as the happy path
    # allows: each of these calls is paced by the host.
    ok = (dev.type == "cuda" and mask.ndim == 1 and mask.dtype is torch.bool
          and 0 <= n_out < 2**31 - TILE and C <= MAX_CHANNELS
          and mask.shape[0] < 2**31 - TILE)
    for c in columns:
        ok = (ok and c.shape == mask.shape and c.dtype is torch.int32
              and c.device == dev)
    if not ok:
        _refuse(mask, columns, n_out)       # returns for CPU tensors only
        vals = (torch.stack(list(columns), 1) if C
                else torch.zeros((mask.shape[0], 0), dtype=torch.int32))
        count, out = compact_ref(mask, vals, n_out)
        return count, out.t().contiguous()
    N = mask.shape[0]
    mask = mask.contiguous()
    columns = [c.contiguous() for c in columns]
    # one allocation: the C output rows, then the count
    buf = torch.empty(C * n_out + 1, dtype=torch.int32, device=dev)
    out = buf.as_strided((C, n_out), (n_out, 1))
    count = buf.as_strided((), (), C * n_out)
    ptrs = (ctypes.c_void_p * MAX_CHANNELS)(*[c.data_ptr() for c in columns])
    launch = _lib()
    idx = dev.index
    stream = (_raw_stream(idx) if _raw_stream is not None
              else torch.cuda.current_stream(dev).cuda_stream)
    status, ticket = _scratch(dev, stream, -(-N // TILE))
    args = (mask.data_ptr(), ptrs, C, N, n_out, out.data_ptr(),
            count.data_ptr(), status.data_ptr(), ticket.data_ptr(),
            _next_gen(), stream)
    if idx == torch.cuda.current_device():
        err = launch(*args)
    else:
        with torch.cuda.device(dev):
            err = launch(*args)
    _build.check(err, "compact")
    _build.count_launch("compact")
    return count, out


def compact_channels(mask: torch.Tensor, chans: torch.Tensor, n_out: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact ``chans (C, N)`` int32 by ``mask (N,)`` bool into ``(C,
    n_out)``; returns ``(count () int32, out (C, n_out) int32)``, both on
    the input's device."""
    if mask.ndim != 1 or chans.ndim != 2 or chans.shape[1] != mask.shape[0]:
        raise ValueError(f"want mask (N,) and chans (C, N), got "
                         f"{tuple(mask.shape)} and {tuple(chans.shape)}")
    return compact_columns(mask, chans.contiguous().unbind(0), n_out)


def stream_compact(mask: torch.Tensor, vals: torch.Tensor, n_out: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack rows of ``vals (N, C)`` where ``mask`` holds into an ``(n_out,
    C)`` buffer; returns ``(count () int32, packed (n_out, C))``.  Rows past
    ``count`` are zero; survivors that would land past ``n_out`` are
    dropped."""
    if vals.device.type == "cpu":
        return compact_ref(mask, vals.to(torch.int32), n_out)
    count, out = compact_channels(mask, vals.to(torch.int32).t(), n_out)
    return count, out.t()


def compact_pairs(mask: torch.Tensor, q_idx: torch.Tensor,
                  codes: torch.Tensor, n_out: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frontier compaction of (query, node) int32 pairs in one pass: node
    Morton codes (as int32 bit patterns) for ``mode="wavefront"``, CSR node
    indices for ``mode="wavefront_fused"``.  Returns ``(count, q_idx
    (n_out,), codes (n_out,))``."""
    i32 = torch.int32
    count, out = compact_columns(
        mask, (q_idx if q_idx.dtype is i32 else q_idx.to(i32),
               codes if codes.dtype is i32 else codes.to(i32)), n_out)
    return count, out[0], out[1]
