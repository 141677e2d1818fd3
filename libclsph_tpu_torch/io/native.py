"""Build and load the native ``.geo`` writer (``native/geo_writer.cpp``).

The C++ source is the JAX package's, read in place. It is compiled with
the host C++ compiler into a CPython extension under
``build/libclsph_tpu_torch/native/``, the file name keyed by a hash of
the source and the flags (as :mod:`ops.kernels.build` keys the CUDA
kernels), so a changed source rebuilds and an unchanged one is reused.
Nothing is compiled at import: :mod:`io.geo_format` builds the writer at
its first use.

The module is loaded from its path under the name ``_libclsph_native``
and is not left in ``sys.modules``: the JAX package's ``geo_format``
imports that name from the path, and must keep finding only its own
build there.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
from pathlib import Path

MODULE_NAME = "_libclsph_native"
REPO_DIR = Path(__file__).resolve().parents[2]
SOURCE = REPO_DIR / "native" / "geo_writer.cpp"
BUILD_DIR = REPO_DIR / "build" / "libclsph_tpu_torch" / "native"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def _compiler() -> str:
    found = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not found:
        raise RuntimeError("no C++ compiler found (set CXX) to build the native .geo writer")
    return found


def _include_flags() -> list[str]:
    return ["-I" + sysconfig.get_paths()["include"]]


def library_path(source: Path = SOURCE, out_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(Path(source).read_bytes())
    digest.update(" ".join(FLAGS + _include_flags()).encode())
    suffix = sysconfig.get_config_var("EXT_SUFFIX")
    return Path(out_dir) / f"geo_writer_{digest.hexdigest()[:16]}{suffix}"


def build(source: Path = SOURCE, out_dir: Path = BUILD_DIR) -> Path:
    """Compile ``source`` into ``out_dir`` unless the hashed extension is
    there already; returns its path. Raises with the compiler's output
    when the build fails."""
    out = library_path(source, out_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        tmp = work / out.name
        cmd = [_compiler(), *FLAGS, *_include_flags(), str(source), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"building the native .geo writer failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build loads a whole file
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def load(path: Path):
    """The extension at ``path`` as a module, without leaving it in
    ``sys.modules`` (a single-phase extension enters itself there while it
    loads; whatever held the name before is put back)."""
    before = sys.modules.get(MODULE_NAME)
    spec = importlib.util.spec_from_file_location(MODULE_NAME, str(path))
    try:
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        if before is None:
            sys.modules.pop(MODULE_NAME, None)
        else:
            sys.modules[MODULE_NAME] = before
    return module
