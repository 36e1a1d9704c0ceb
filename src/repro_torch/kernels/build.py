"""Build the CUDA kernels with ``nvcc`` at first use and bind them by ctypes.

The sources under ``csrc/`` have a plain C interface, so ``nvcc`` compiles
them in seconds into a shared library under ``build/repro_torch_kernels/``
at the repository root, named by a hash of the source; a later process
reuses it.  Nothing builds at import: ``load()`` is called by the kernel
wrappers on their first CUDA launch.

Flags: ``sm_90a`` (Hopper) and no fast math — the Hyft arithmetic relies on
IEEE division and unflushed subnormals, so neither ``--use_fast_math`` nor
``-ftz=true`` may be added.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "hyft_splitk.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_ENTRY_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float]
               + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_lib: ctypes.CDLL | None = None


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libhyft_splitk_{digest}.so"


def build(verbose: bool = False) -> dict:
    """Compile the kernels unless this source's library exists.

    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and spills of
    each kernel) and forces a rebuild so the report is printed.  Returns
    {"path", "seconds", "log"}; raises RuntimeError with nvcc's output if
    the build fails.
    """
    out = library_path()
    if out.exists() and not verbose:
        return {"path": str(out), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds, "log": res.stdout + res.stderr}


def load() -> ctypes.CDLL:
    """The bound library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        for name in ("hyft_splitk_decode", "hyft_splitk_verify"):
            fn = getattr(lib, name)
            fn.argtypes = _ENTRY_ARGS
            fn.restype = ctypes.c_int
        lib.hyft_error_string.argtypes = [ctypes.c_int]
        lib.hyft_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
