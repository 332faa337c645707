#!/usr/bin/env python3
"""The ``persist`` kernel with one rank of each cluster held back, on the card.

The kernel's ranks meet only at cluster barriers and through atomics, so
its outputs must not depend on how far one rank runs ahead of another.
Timing alone rarely opens the windows between them, so this script builds
copies of ``persist.cu`` whose phase marks (``PERSIST_MARK``) make every
thread of one rank spin for ``--cycles`` SM cycles at one mark of every
level, and holds each copy's outputs to ``persist_tiles_ref``'s over
``--reps`` launches on four pools of ``kernels/persist/cases.py``:

- ``light``: the owner-group tiles of
  ``tests/test_torch_kernels_gpu.py::test_persist_kernel_light_last_level_back_to_back``,
  whose last expanding level ends with no cluster barrier;
- ``owner groups``: five tiles of 128 slots, whose wide levels go through
  the workspace;
- both again on u8 rows under the streamed layout at windows of 64 rows,
  whose window bitmap (one a tile, in its workspace slice) every rank
  marks, and rank 0 sums and clears after each fold barrier and after
  the final one.

Marks (see ``persist.cu``): 1 phase A done, 2 past the fold barrier (the
gate next), 4 the block scan done, 5 the children written, 6 past the
level's last barrier.  Holding rank 0 at mark 2 keeps it in the gate
while the other ranks finish the walk.  Prints one line a (rank, mark)
and pool, and exits 1 if any launch differs.  ``--src`` names another
tree's ``src`` (e.g. an older commit unpacked under ``build/``).  Needs
a CUDA device and ``nvcc``; run from the root of a checkout:

    python3 tools/persist_race_check.py
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (rank held, mark) pairs.
HOLDS = [(0, 2), (0, 4), (0, 6), (3, 2), (7, 1), (7, 5)]

HOLD_SOURCE = """\
#include <cuda_runtime.h>
__device__ __forceinline__ void persist_hold(int rank, int k) {{
  if (rank != {rank} || k != {mark}) return;
  const long long t0 = clock64();
  while (clock64() - t0 < {cycles}) {{}}
}}
// `rank` is the kernel's own: the mark sites lie in its scope
#define PERSIST_MARK(level, k) persist_hold(rank, k)
#include "{source}"
"""


def build(src: Path, cycles: int):
    """One copy of ``persist.cu`` a hold, built in parallel; returns
    {(rank, mark): CDLL}."""
    from repro_torch.kernels import _build
    out = ROOT / "build" / "tools" / _build._source_hash() / "race"
    out.mkdir(parents=True, exist_ok=True)
    cu = (src / "repro_torch" / _build.SOURCES["persist"]).resolve()

    def one(hold):
        rank, mark = hold
        wrapper = out / f"persist_hold_r{rank}_m{mark}.cu"
        wrapper.write_text(HOLD_SOURCE.format(rank=rank, mark=mark,
                                              cycles=cycles, source=cu))
        lib = out / f"libpersist_hold_r{rank}_m{mark}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
               str(wrapper)]
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if p.returncode:
            raise SystemExit(f"FAIL: nvcc {hold}:\n{p.stdout}{p.stderr}")
        return ctypes.CDLL(str(lib))
    with ThreadPoolExecutor(len(HOLDS)) as ex:
        return dict(zip(HOLDS, ex.map(one, HOLDS)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cycles", type=int, default=40000)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch sees no CUDA device")
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import numpy as np
    from repro_torch.core.octree import build_octree, device_octree
    from repro_torch.kernels import _build
    from repro_torch.kernels.persist import ops as persist_ops
    from repro_torch.kernels.persist.cases import owner_group_pool
    from repro_torch.kernels.persist.ref import persist_tiles_ref

    cuda = torch.device("cuda", 0)
    tree = build_octree(np.random.RandomState(3).uniform(
        -1, 1, (4000, 3)).astype(np.float32), depth=4)
    pools = []
    for fmt, streamed in (("fp32", False), ("u8", True)):
        dev = device_octree(tree, meta_format=fmt, device=cuda)
        kw = dict(meta_format=fmt, streamed=streamed, wsub=64)
        tag = " (u8, streamed)" if streamed else ""
        pools += [
            ("light" + tag, owner_group_pool(dev, 16, 64, seed=21,
                                             half=(0.003, 0.01)),
             dict(bq=16, fcap=4096, ring_cap=256, **kw)),
            ("owner groups" + tag, owner_group_pool(dev, 128, 5, seed=128),
             dict(bq=128, fcap=4096, ring_cap=256, **kw))]
    libs = build(src, args.cycles)
    bad = 0
    for (rank, mark), lib in libs.items():
        _build._LIBS["persist"] = lib
        for name, ins, kw in pools:
            kw = dict(kw, depth=tree.depth, use_spheres=False)
            want = persist_tiles_ref(**ins, **kw)
            outs = [persist_ops.persist_tiles(**ins, **kw)
                    for _ in range(args.reps)]
            torch.cuda.synchronize()
            differ = sum(any(not torch.equal(g, w)
                             for g, w in zip(got[:4], want[:4]))
                         for got in outs)
            lost = max(int(((got[0] != want[0])).sum()) for got in outs)
            bad += differ
            print(f"[race] rank {rank} held {args.cycles} cycles at mark "
                  f"{mark}, {name} pool: {differ} of {args.reps} launches "
                  f"differ from the plain version (at most {lost} best "
                  f"words)", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
