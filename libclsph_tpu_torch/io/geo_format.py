"""Houdini classic ASCII ``.geo`` (PGEOMETRY V5) serializer.

Byte-compatible re-implementation of the reference's generic dumper
(``util/houdini_geo/HoudiniFileDumpHelper.cpp:19-90``) with the
attribute schema of its ConcreteDataProvider
(HoudiniFileDumpHelper.h:76-93): point attributes v(3), color(3),
mass(1); position written homogeneous (px py pz 0); attributes joined
with '\\t' between attributes and ' ' between the values of one
attribute; the same Part/PrimitiveAttrib trailer.

Formatting is vectorised: all float -> text conversion happens in one
NumPy pass instead of a per-particle ostream loop (this writer is the
frame-export hot path at millions of particles). The native writer,
``native/geo_writer.cpp`` built by :mod:`io.native`, is used where it
builds; :func:`dump_geo` is its plain version.
"""

from __future__ import annotations

import io as _io
import threading
from typing import IO

import numpy as np

from . import native as native_build

_lock = threading.Lock()
_native = None  # the loaded native writer, once built
_native_error = None  # why the build failed, once it has


def native_writer(required: bool = False):
    """The native writer module, built and loaded at the first call of
    the process. Where it does not build, None, or with ``required`` a
    RuntimeError carrying the compiler's output."""
    global _native, _native_error
    with _lock:
        if _native is None and _native_error is None:
            try:
                _native = native_build.load(native_build.build())
            except (OSError, RuntimeError, ImportError) as e:
                _native_error = e
    if _native is None and required:
        raise RuntimeError(f"the native .geo writer is not available: {_native_error}")
    return _native


def have_native() -> bool:
    """Whether the native writer has been built and loaded."""
    return _native is not None


def write_geo_file(
    path: str,
    position: np.ndarray,
    velocity: np.ndarray,
    color: np.ndarray,
    mass: float,
) -> None:
    """Write a frame to ``path`` with the native writer where it builds,
    else with :func:`dump_geo`."""
    writer = native_writer()
    if writer is not None:
        writer.write_geo(
            path,
            np.ascontiguousarray(position, dtype=np.float32),
            np.ascontiguousarray(velocity, dtype=np.float32),
            np.ascontiguousarray(color, dtype=np.float32),
            float(mass),
        )
        return
    with open(path, "w") as f:
        dump_geo(f, position, velocity, color, mass)


def _fmt_float_array(a: np.ndarray) -> np.ndarray:
    """Format floats the way C++ ostream<< does by default: 6
    significant digits, shortest representation (no trailing zeros)."""
    return np.char.mod("%g", a.astype(np.float64))


def dump_geo(
    stream: IO[str],
    position: np.ndarray,  # (N, 3)
    velocity: np.ndarray,  # (N, 3)
    color: np.ndarray,  # (N, 3)
    mass: float,
) -> None:
    n = position.shape[0]
    w = stream.write
    # Header (HoudiniFileDumpHelper.cpp:26-29)
    w("PGEOMETRY V5\n")
    w(f"NPoints {n} NPrims 1\n")
    w("NPointGroups 0 NPrimGroups 1\n")
    w("NPointAttrib 3 NVertexAttrib 0 NPrimAttrib 2 NAttrib 0\n")
    # Attribute table (:35-44); 3 attribs, float, defaults all 1
    w("PointAttrib\n")
    w("v 3 float 1 1 1\n")
    w("color 3 float 1 1 1\n")
    w("mass 1 float 1\n")

    # Point block (:47-65): "px py pz 0 (vx vy vz\tcr cg cb\tmass)"
    cols = np.concatenate([position, velocity, color], axis=1)
    txt = _fmt_float_array(cols)  # (N, 9) strings
    mass_s = "%g" % mass
    p = txt[:, 0:3]
    v = txt[:, 3:6]
    c = txt[:, 6:9]
    lines = np.char.add(
        np.char.add(
            np.char.add(
                np.char.add(p[:, 0], " "), np.char.add(p[:, 1], " ")
            ),
            np.char.add(p[:, 2], " 0 ("),
        ),
        np.char.add(
            np.char.add(
                np.char.add(
                    np.char.add(v[:, 0], " "),
                    np.char.add(v[:, 1], np.char.add(" ", v[:, 2])),
                ),
                "\t",
            ),
            np.char.add(
                np.char.add(
                    np.char.add(c[:, 0], " "),
                    np.char.add(c[:, 1], np.char.add(" ", c[:, 2])),
                ),
                "\t" + mass_s + ")",
            ),
        ),
    )
    w("\n".join(lines.tolist()))
    w("\n")

    # Primitive trailer (:67-89)
    w("PrimitiveAttrib\n")
    w("generator 1 index 1 location1\n")
    w("dopobject 1 index 1 /obj/AutoDopNetwork:1\n")
    w(f"Part {n}")
    w("".join(f" {i}" for i in range(n)))
    w(" [0\t0]\n")
    w("box_object1 unordered\n")
    w("1 1\n")
    w("beginExtra\n")
    w("endExtra\n")


def density_color_ramp(density: np.ndarray) -> np.ndarray:
    """density -> RGB ramp (houdini_file_saver.cpp:46-60)."""
    d = np.asarray(density, dtype=np.float32)
    r = np.where((d > 1000.0) & (d <= 2000.0), (d - 1000.0) / 1000.0, 0.0)
    g = np.where((d >= 0.0) & (d < 1000.0), 1.0 - d / 1000.0, 0.0)
    b = np.where(
        (d >= 500.0) & (d <= 1000.0),
        (d - 500.0) / 500.0,
        np.where((d >= 1000.0) & (d <= 1500.0), 1.0 - (d - 1000.0) / 500.0, 0.0),
    )
    return np.stack([r, g, b], axis=1).astype(np.float32)


def geo_string(position, velocity, color, mass) -> str:
    buf = _io.StringIO()
    dump_geo(buf, position, velocity, color, mass)
    return buf.getvalue()
