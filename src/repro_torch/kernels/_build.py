"""Build, load and count the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file of the package is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds).  All
sources build in parallel, one ``nvcc`` each, at first use; the output
directory is keyed by a hash of every source and header plus the flags, so
an edited kernel never loads a stale library.  Libraries land in
``build/repro_torch/<hash>/`` at the root of the checkout (or under
``$REPRO_TORCH_BUILD_DIR``).

Every kernel builds with the same flags.  ``--fmad=false`` keeps every
``a*b+c`` two roundings, as in the plain PyTorch versions: the collision,
sampling and ray-march kernels must agree with them bit for bit; ``wkv6`` and
``flash_attention``, which sum their dot products in another order (and
their products on the tensor cores, which the flag does not touch; each
writes the few ``fmaf`` its CUDA-core sums want), to the tolerances stated
in ``kernels/wkv6/cases.py`` and ``kernels/flash_attention/cases.py``.

Each wrapper counts its launches here (:func:`count_launch`), so a run can
show that its main path really went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parents[1]          # .../src/repro_torch

#: Kernel name -> its source, relative to the package.
SOURCES: Dict[str, str] = {
    "sact_dense": "kernels/sact/csrc/sact_dense.cu",
    "persist": "kernels/persist/csrc/persist.cu",
    "traverse": "kernels/traverse/csrc/traverse.cu",
    "compact": "kernels/compact/csrc/compact.cu",
    "fps": "kernels/fps/csrc/fps.cu",
    "ballquery": "kernels/ballquery/csrc/ballquery.cu",
    "wkv6": "kernels/wkv6/csrc/wkv6.cu",
    "flash_attention": "kernels/flash_attention/csrc/flash_attn.cu",
    "march": "kernels/march/csrc/march.cu",
}

NVCC_FLAGS: List[str] = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
#: Guards the counts: the collision service launches from several threads.
_COUNT_LOCK = threading.Lock()
#: Compiler output of the last build (``-Xptxas -v`` register reports).
last_build_log: Dict[str, str] = {}


def count_launch(name: str) -> None:
    with _COUNT_LOCK:
        _LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    with _COUNT_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build only on a machine with the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_PKG.rglob("csrc/*")):
        if path.suffix in (".cu", ".cuh", ".h"):
            h.update(str(path.relative_to(_PKG)).encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    root = os.environ.get("REPRO_TORCH_BUILD_DIR")
    base = Path(root) if root else _PKG.parents[1] / "build" / "repro_torch"
    return base / _source_hash()


def build_all(verbose: bool = False) -> float:
    """Compile every kernel that has no library yet, all in parallel.

    Returns the seconds spent; raises with the compiler's output if any
    build fails.  ``verbose`` adds ``-Xptxas -v`` and keeps the compiler
    output in :data:`last_build_log`.
    """
    t0 = time.perf_counter()
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, src in SOURCES.items():
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(_PKG / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        last_build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, lib)   # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_dir() / f"lib{name}.so"
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch: "
                           f"cudaError {status}")
