"""The port's build of the native ``.geo`` writer (``native/geo_writer.cpp``,
compiled by ``libclsph_tpu_torch.io.native`` into a temporary build
directory): the file it writes for seeded arrays equals, byte for byte,
the port's NumPy ``dump_geo`` and the JAX package's ``dump_geo``; the
loaded module is not left in ``sys.modules``; the build is keyed by the
source; a failed build raises with the compiler's output."""

import sys

import numpy as np
import pytest

from libclsph_tpu.io import geo_format as jgeo
from libclsph_tpu_torch.io import geo_format, native
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)


def seeded_frame(n=500):
    rng = np.random.default_rng(3)
    pos = (rng.standard_normal((n, 3)) * 10).astype(np.float32)
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    col = geo_format.density_color_ramp(rng.uniform(0.0, 2100.0, n))
    return pos, vel, col


def test_native_build_writes_the_plain_bytes(tmp_path):
    had = sys.modules.get(native.MODULE_NAME)
    path = native.build(out_dir=tmp_path / "build")
    assert path.parent == tmp_path / "build" and path == native.library_path(
        out_dir=tmp_path / "build")
    assert native.build(out_dir=tmp_path / "build") == path  # found, not rebuilt
    mod = native.load(path)
    assert sys.modules.get(native.MODULE_NAME) is had
    pos, vel, col = seeded_frame()
    out = tmp_path / "native.geo"
    mod.write_geo(str(out), pos, vel, col, 0.05)
    with open(tmp_path / "plain.geo", "w") as f:
        geo_format.dump_geo(f, pos, vel, col, 0.05)
    expected = jgeo.geo_string(pos, vel, col, 0.05).encode()
    assert out.read_bytes() == (tmp_path / "plain.geo").read_bytes() == expected


def test_write_geo_file_uses_the_native_writer(tmp_path):
    pos, vel, col = seeded_frame(64)
    assert geo_format.native_writer(required=True) is not None
    assert geo_format.have_native()
    assert sys.modules.get(native.MODULE_NAME) is not geo_format.native_writer()
    geo_format.write_geo_file(str(tmp_path / "f.geo"), pos, vel, col, 0.025)
    assert (tmp_path / "f.geo").read_text() == jgeo.geo_string(pos, vel, col, 0.025)


def test_library_path_keys_the_source(tmp_path):
    src = tmp_path / "geo_writer.cpp"
    src.write_bytes(native.SOURCE.read_bytes())
    a = native.library_path(src, tmp_path)
    src.write_bytes(native.SOURCE.read_bytes() + b"\n// changed\n")
    assert native.library_path(src, tmp_path) != a


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        native.build(src, tmp_path / "build")
