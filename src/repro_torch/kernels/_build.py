"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` (`SOURCES`) is compiled with nvcc for Hopper
(``sm_90a``) into its own shared library with a plain C interface, the
first time one of its kernels is launched, and bound with ctypes. The
libraries land in ``build/kernels/`` at the repository root (listed in
``.gitignore``) under names keyed by a hash of the source and the flags, so
an edited source rebuilds and an unchanged one is reused. `build()` starts
one nvcc per missing library, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
#: library name -> CUDA source
SOURCES = {
    "lorenzo": _PKG / "csrc" / "lorenzo.cu",
    "bot4": _PKG / "csrc" / "bot4.cu",
}
BUILD_DIR = _PKG.parent.parent / "build" / "kernels"
#: IEEE division and no contracted multiply-adds: the codes and the BOT
#: coefficients must match the plain versions bit for bit, so no
#: --use_fast_math
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

_ptr, _i64, _f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
#: C signatures per library: function -> argument types (all return int,
#: the launch's cudaError_t)
SIGNATURES = {
    "lorenzo": {
        "lorenzo2d_encode": [_ptr, _ptr, _i64, _i64, _f32, _ptr],
        "lorenzo3d_encode": [_ptr, _ptr, _i64, _i64, _i64, _f32, _ptr],
        "dequantize2d": [_ptr, _ptr, _i64, _i64, _f32, _ptr],
        "dequantize3d": [_ptr, _ptr, _i64, _i64, _i64, _f32, _ptr],
    },
    "bot4": {
        # x, recon, bits, shape..., eb (device pointer), T (16 floats), gain^n, stream
        "bot2d_fused": [_ptr, _ptr, _ptr, _i64, _i64, _ptr, _ptr, _f32, _ptr],
        "bot3d_fused": [_ptr, _ptr, _ptr, _i64, _i64, _i64, _ptr, _ptr, _f32, _ptr],
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def library_path(name: str) -> Path:
    source = SOURCES[name]
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=None, verbose: bool = False) -> dict[str, Path]:
    """Compile the named libraries (default: all) unless they exist; one
    nvcc per library, run in parallel. Returns name -> library path."""
    names = list(SOURCES) if names is None else list(names)
    out = {name: library_path(name) for name in names}
    todo = [name for name in names if not out[name].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose else [])
    jobs = []
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                cmd + ["-o", tmp, str(SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            jobs.append((name, tmp, proc))
        errors = []
        for name, tmp, proc in jobs:
            _, stderr = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {SOURCES[name].name} ({proc.returncode}):\n{stderr}")
                continue
            if verbose:
                print(f"{SOURCES[name].name}: {stderr.strip()}")
            os.replace(tmp, out[name])  # atomic: a concurrent loader sees all or nothing
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


_LOADED: dict[str, ctypes.CDLL] = {}
#: one build at a time: the byte encoders of `compress_pytree` launch
#: kernels from several threads, and a cold first use must build once
_LOAD_LOCK = threading.Lock()


def load(name: str) -> ctypes.CDLL:
    """The named kernels' library, built on first use, with its C signatures."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        if name not in _LOADED:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LOADED[name] = lib
        return _LOADED[name]
