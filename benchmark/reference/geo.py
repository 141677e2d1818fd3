"""Reading back a Houdini classic ASCII ``.geo`` frame as upstream's
``houdini_file_saver`` writes it (PGEOMETRY V5; point lines
``px py pz 0 (vx vy vz<TAB>r g b<TAB>mass)``; a ``Part`` primitive over
every point), and upstream's density colour ramp
(houdini_file_saver.cpp:46-60)."""

from __future__ import annotations

import re

import numpy as np

# the text format's precision: C++ ostream's default 6 significant digits
SIGNIFICANT = 6


def read(path: str):
    """(points (N, 11) float64: position, w, velocity, colour, mass; the
    Part primitive's point indices, or None where the file has none;
    the point count the header states)."""
    with open(path) as f:
        text = f.read()
    lines = text.split("\n")
    header = lines[1].split()
    n = int(header[1])
    start = lines.index("mass 1 float 1") + 1
    body = " ".join(lines[start:start + n]).replace("(", " ").replace(")", " ")
    pts = np.array(body.replace("\t", " ").split(), dtype=np.float64).reshape(n, 11)
    part = None
    for line in lines[start + n:]:
        if line.startswith("Part "):
            words = line.split(" [")[0].split()
            part = np.array(words[2:], dtype=np.int64) if int(words[1]) == n else None
    return pts, part, n


_NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


def rewrite(path: str, out: str, digits: int) -> None:
    """``path`` written again to ``out`` with every number of its point
    lines at ``digits`` significant digits: the same writer, less precise."""
    with open(path) as f:
        lines = f.read().split("\n")
    n = int(lines[1].split()[1])
    start = lines.index("mass 1 float 1") + 1
    fmt = lambda m: f"{float(m.group()):.{digits}g}"  # noqa: E731
    lines[start:start + n] = [_NUMBER.sub(fmt, line) for line in lines[start:start + n]]
    with open(out, "w") as f:
        f.write("\n".join(lines))


def color_ramp(density: np.ndarray) -> np.ndarray:
    """Density to RGB: red over 1000-2000, green falling over 0-1000, blue
    rising over 500-1000 and falling over 1000-1500."""
    d = np.asarray(density, dtype=np.float64)
    r = np.where((d > 1000.0) & (d <= 2000.0), (d - 1000.0) / 1000.0, 0.0)
    g = np.where((d >= 0.0) & (d < 1000.0), 1.0 - d / 1000.0, 0.0)
    b = np.where((d >= 500.0) & (d <= 1000.0), (d - 500.0) / 500.0,
                 np.where((d >= 1000.0) & (d <= 1500.0), 1.0 - (d - 1000.0) / 500.0, 0.0))
    return np.stack([r, g, b], axis=1)
