"""Build and load the hand-written CUDA kernels.

The sources under ``libclsph_tpu_torch/csrc/`` are compiled by ``nvcc``
for ``sm_90a``, one ``nvcc`` process per ``.cu`` file, all started
together, and linked into one shared library with a plain C interface
that is loaded with ``ctypes``. The build happens at the first CUDA
launch (or an explicit :func:`load_library` call), never at import,
into ``build/libclsph_tpu_torch/`` beside the package; the file name
carries a hash of the sources and flags, so a changed source rebuilds
and an unchanged one loads the existing library. A file lock beside the
library serialises builds across processes (the ranks of a mesh, which
the launcher builds for once before it starts them), so no two
processes compile the same hash at once.
"""

from __future__ import annotations

import ctypes
import fcntl
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argument types of every C entry point (pointers and the stream as
# c_void_p so ctypes never truncates them to 32 bits)
SIGNATURES = {
    "density_c16_launch": [_P] * 4 + [_I] * 3 + [_F] * 5 + [_P] * 4,
    "density_c32_launch": [_P] * 4 + [_I] * 4 + [_F] * 4 + [_P] * 3,
    "density_c32_rows_launch": [_P] * 4 + [_I] * 4 + [_F] * 4 + [_P] * 3,
    "density_gated16_launch": [_P] * 4 + [_I] * 3 + [_F] * 4 + [_P] * 3,
    "forces_q32_launch": [_P] * 6 + [_I] * 3 + [_F] * 14 + [_P, _P],
    "forces_c32_launch": [_P] * 6 + [_I] * 2 + [_F] * 14 + [_P, _P],
    "forces_c32_rows_launch": [_P] * 6 + [_I] * 3 + [_F] * 14 + [_P, _P],
    "radix_sort_launch": [_P] * 2 + [_I] * 4 + [_P] * 7,
    "gather_stream_launch": [_P] * 3 + [_I] * 5 + [_F] + [_P] * 2,
    "forces_stream_launch": [_P] * 5 + [_I] * 3 + [_F] * 14 + [_P, _P],
    "advect_collide_launch": [_P] * 4 + [_I] + [_P] * 5 + [_I] + [_F] * 4 + [_P] * 6,
    "refine_exact_launch": [_P] * 5 + [_L] * 3 + [_I] * 5 + [_F] + [_P] * 3,
}
# each identity-mode twin (StepConfig.pair_r2 = "mxu") takes its direct
# entry point's arguments
SIGNATURES.update({
    name.replace("_launch", "_mxu_launch"): SIGNATURES[name]
    for name in ("density_c16_launch", "density_c32_launch", "density_c32_rows_launch",
                 "forces_q32_launch", "forces_c32_launch", "forces_c32_rows_launch")
})

_lock = threading.Lock()
_library = None


def sources(src_dir: Path = CSRC_DIR) -> list[Path]:
    return sorted(p for p in Path(src_dir).iterdir() if p.suffix in (".cu", ".cuh"))


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


def library_path(src_dir: Path = CSRC_DIR, out_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256()
    for src in sources(src_dir):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return Path(out_dir) / f"libclsph_kernels_{digest.hexdigest()[:16]}.so"


def build(src_dir: Path = CSRC_DIR, out_dir: Path = BUILD_DIR) -> Path:
    """Compile the sources of ``src_dir`` (the package's by default; a
    measuring script may build another tree of the same C interface) into
    ``out_dir`` if the hashed library is missing; returns its path. Each
    ``.cu`` file is compiled to an object by its own ``nvcc`` process, all
    running at once, then the objects are linked. The compilers' output
    (ptxas register and shared-memory report) is kept beside the library
    as ``<name>.log``."""
    out = library_path(src_dir, out_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building it
        if not out.exists():
            _compile(src_dir, out)
    return out


def _compile(src_dir: Path, out: Path) -> None:
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        cus = [s for s in sources(src_dir) if s.suffix == ".cu"]
        objs = [work / (s.stem + ".o") for s in cus]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(cus, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for c in cmds]
        outputs = [p.communicate()[0] for p in procs]
        log = "".join(" ".join(c) + "\n" + o for c, o in zip(cmds, outputs))
        failed = [(c, p.returncode) for c, p in zip(cmds, procs) if p.returncode]
        if not failed:
            tmp = work / out.name
            link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(link, capture_output=True, text=True)
            log += " ".join(link) + "\n" + proc.stdout + proc.stderr
            if proc.returncode:
                failed.append((link, proc.returncode))
        out.with_suffix(".log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0][1]}) on {failed[0][0][-1]}:\n{log}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def open_library(path: Path) -> ctypes.CDLL:
    """Load a built library and declare its entry points' signatures (a
    library built from an older tree may lack some of them)."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        if not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _library
    with _lock:
        if _library is None:
            _library = open_library(build())
        return _library


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
