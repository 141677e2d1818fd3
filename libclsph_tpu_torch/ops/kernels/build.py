"""Build and load the hand-written CUDA kernels.

The sources under ``libclsph_tpu_torch/csrc/`` are compiled by ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface and
loaded with ``ctypes``. The build happens at the first CUDA launch (or
an explicit :func:`load_library` call), never at import, into
``build/libclsph_tpu_torch/`` beside the package; the file name carries
a hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads the existing library.
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

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "libclsph_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argument types of every C entry point (pointers and the stream as
# c_void_p so ctypes never truncates them to 32 bits)
SIGNATURES = {
    "density_c16_hit8_launch": [_P, _P, _P, _I, _I, _F, _F, _F, _F, _P, _P, _P],
    "forces_q32_c8_launch": [_P, _P, _P, _P, _P, _I, _I] + [_F] * 14 + [_P, _P],
}

_lock = threading.Lock()
_library = None


def sources() -> list[Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "libclsph_tpu_torch are compiled at first use"
        )
    return found


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libclsph_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if the hashed library is missing; returns its
    path. The compiler's output (ptxas register and shared-memory report)
    is kept beside the library as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, [s for s in sources() if s.suffix == ".cu"])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = out.with_suffix(".log")
    log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _library = lib
        return _library


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
