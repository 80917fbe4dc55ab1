"""Build and load the port's CUDA kernels.

`load()` compiles ``csrc/lorenzo.cu`` with nvcc for Hopper (``sm_90a``)
into a shared library with a plain C interface, the first time a kernel is
launched, and binds it with ctypes. The library lands in ``build/kernels/``
at the repository root (listed in ``.gitignore``) under a name keyed by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused.
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

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "lorenzo.cu"
BUILD_DIR = _PKG.parent.parent / "build" / "kernels"
#: IEEE division and no contracted multiply-adds: the codes must match the
#: reference bit for bit, so no --use_fast_math
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "--fmad=false",
    "-prec-div=true",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"liblorenzo-{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless this source's library already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            cmd + ["-o", tmp, str(SOURCE)], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        if verbose:
            print(proc.stderr.strip())
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' library, built on first use, with its C signatures."""
    lib = ctypes.CDLL(str(build()))
    ptr, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    lib.lorenzo2d_encode.argtypes = [ptr, ptr, i64, i64, f32, ptr]
    lib.lorenzo2d_encode.restype = ctypes.c_int
    lib.lorenzo3d_encode.argtypes = [ptr, ptr, i64, i64, i64, f32, ptr]
    lib.lorenzo3d_encode.restype = ctypes.c_int
    return lib
