"""Build the CUDA kernels from ``kernels/csrc/*.cu`` and load them with ctypes.

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).  All
sources are compiled at once, in parallel, at the first call of
:func:`library`; the libraries go under ``build/repro_torch/`` at the root of
the checkout, named by a hash of their source and flags, so an edited source
is rebuilt and an unchanged one is loaded as it is.  Nothing is built when the
package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "build_all", "library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of each source's entry points: [(name, argtypes)]; every one returns a cudaError_t
_ENTRY = {
    "flash_attention": [(
        "flash_attention_fwd",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_int64), _I, _I, _F, _I, _P],
    )],
    "moe_dispatch": [
        ("moe_dispatch_fwd", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
        ("moe_dispatch_bwd", [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_int64), _P]),
    ],
    "paged_attention": [(
        "paged_attention_fwd",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    )],
    "rwkv6_scan": [(
        "rwkv6_scan_fwd",
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_int64), _P],
    )],
    "weighted_accum": [("weighted_accum_tree_fwd", [_P, _I, _I, _P])],
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}  # one load per process


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA kernels cannot be built")
    return found


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library, one ``nvcc``
    per source, all started together.  Returns {kernel name: library path}."""
    sources = sorted(CSRC.glob("*.cu"))
    targets = {src.stem: _target(src) for src in sources}
    todo = [src for src in sources if not targets[src.stem].exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for src in todo:
            # write to a private name and rename, so a concurrent build never loads a half-written file
            tmp = targets[src.stem].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for src, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out.decode(errors='replace')}")
            else:
                os.replace(tmp, targets[src.stem])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (building all kernels first if needed)."""
    with _lock:
        if name not in _libs:
            paths = build_all()
            for stem, path in paths.items():
                lib = ctypes.CDLL(str(path))
                for fn_name, argtypes in _ENTRY[stem]:
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _libs[stem] = lib
        return _libs[name]
