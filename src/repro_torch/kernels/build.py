"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a``, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.  The
build happens at first use, never at import, and is keyed by a hash of
the sources and flags: ``build/repro_torch/<key>/`` under the repository
root (listed in ``.gitignore``) holds the library, so an unchanged tree
builds once.  ``nvcc -Xptxas -v`` output (registers, shared memory,
spills) is kept beside it in ``nvcc.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("moe_gemm.cu", "vote.cu")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libreprotorch_kernels.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode() + b"\0" + (CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / build_key() / LIB_NAME


def build() -> Path:
    """Compile the sources (in parallel) and link the library, unless a
    library for this exact source tree is already built."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT))
    try:
        procs: Dict[str, subprocess.Popen] = {}
        for name in SOURCES:
            procs[name] = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name),
                 "-o", str(tmp / (name + ".o"))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log = []
        failed = []
        for name, p in procs.items():
            text, _ = p.communicate()
            log.append(f"== {name} (rc={p.returncode})\n{text}")
            if p.returncode:
                failed.append(name)
        (tmp / "nvcc.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / LIB_NAME),
             *[str(tmp / (n + ".o")) for n in SOURCES]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        try:
            tmp.rename(out.parent)
        except OSError:
            # another process finished the same build first
            if not out.exists():
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ("moe_gemm_f32", "moe_gemm_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [P, P, P, I, I, I, I, P]
        fn.restype = I
    fn = lib.redundancy_vote_masked_f32
    fn.argtypes = [P, P, F, I, I, I, P, P, P, P]
    fn.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    return _bind(ctypes.CDLL(str(build())))


def check(code: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if code:
        raise RuntimeError(f"{kernel}: CUDA launch failed with "
                           f"cudaError {code}")
