"""Build the CUDA kernels with ``nvcc`` at first use and bind them by ctypes.

The sources under ``csrc/`` have a plain C interface, so ``nvcc`` compiles
them in seconds.  Every ``csrc/*.cu`` compiles to an object file, all of
them at once (one ``nvcc`` per source), and the objects link into one shared
library under ``build/repro_torch_kernels/`` at the repository root, named
by a hash over every source and header; a later process reuses it.  Nothing
builds at import: ``load()`` is called by the kernel wrappers on their first
CUDA launch.

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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the entry points' argument types, in the order of their C signatures
_SPLITK_ARGS = [_P] * 9 + [_I] * 8 + [_F] + [_I] * 5 + [_P]
_HYFT_ARGS = [_I] * 5 + [_P]                  # frac, total, mant, acc, step; stream
ENTRY_ARGS = {
    "hyft_splitk_decode": _SPLITK_ARGS,
    "hyft_splitk_verify": _SPLITK_ARGS,
    "hyft_flash_fwd": [_P] * 7 + [_I] * 10 + [_F] + _HYFT_ARGS,
    "hyft_flash_bwd_dq": [_P] * 9 + [_I] * 9 + [_F] + _HYFT_ARGS,
    "hyft_flash_bwd_dkv": [_P] * 10 + [_I] * 9 + [_F] + _HYFT_ARGS,
}
_lib: ctypes.CDLL | None = None


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libhyft_kernels_{h.hexdigest()[:16]}.so"


def _run(procs) -> str:
    """Wait for every (cmd, Popen); raise with nvcc's output on a failure."""
    log = ""
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log += out
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return log


def build(verbose: bool = False) -> dict:
    """Compile the kernels unless this set of sources' library exists.

    One ``nvcc -c`` per source, all started together, then one link.
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and spills of
    each kernel) and forces a rebuild so the report is printed.  Returns
    {"path", "seconds", "log"}; raises RuntimeError with nvcc's output if
    the build fails.
    """
    out = library_path()
    if out.exists() and not verbose:
        return {"path": str(out), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    compiles, objects = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-c", "-o", str(obj), str(src)]
        compiles.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objects.append(obj)
    try:
        log = _run(compiles)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = [nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]
        log += _run([(link, subprocess.Popen(
            link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))])
        os.replace(tmp, out)
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    return {"path": str(out), "seconds": time.perf_counter() - t0, "log": log}


def load() -> ctypes.CDLL:
    """The bound library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        for name, argtypes in ENTRY_ARGS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.hyft_error_string.argtypes = [ctypes.c_int]
        lib.hyft_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
