"""The port's examples on the CPU at tiny sizes: the headless viewer and
the live view writing valid PNGs with the standard-library writer (no
matplotlib), and the emitter example (test_torch_emitter_run.py runs
the emitter row's runner)."""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))

import torch_emitter  # noqa: E402
import torch_live_view  # noqa: E402
from libclsph_tpu_torch.io.render import write_png  # noqa: E402


def read_png(path) -> np.ndarray:
    """Decode an 8-bit RGB PNG of one IDAT stream with filter 0 rows,
    checking the signature and every chunk's CRC."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(kind + body)
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + length
    w, h, depth, color, _, _, _ = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    assert (depth, color) == (8, 2) and b"IEND" in chunks
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    assert not raw[:, 0].any()
    return raw[:, 1:].reshape(h, w, 3)


def test_png_writer_round_trip(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (7, 11, 3)).astype(np.uint8)
    write_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(read_png(tmp_path / "a.png"), img)
    with pytest.raises(ValueError):
        write_png(tmp_path / "b.png", img[..., :2])


def test_headless_viewer_writes_pngs_without_matplotlib(tmp_path):
    """The viewer in its own process: headless, on the CPU, device_view
    path; it writes an initial frame and one a frame, and never imports
    matplotlib."""
    code = (
        "import sys; sys.path.insert(0, 'examples'); import torch_viewer; "
        f"n = torch_viewer.main(['--headless', '--n', '512', '--time', str(1 / 60), "
        f"'--device', 'cpu', '--scene', 'cube.obj', '--out', {str(tmp_path)!r}]); "
        "assert 'matplotlib' not in sys.modules; print('FRAMES', n)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))  # see torch_cpu.py
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FRAMES 2" in proc.stdout
    names = sorted(os.listdir(tmp_path))
    assert names == ["frame0000.png", "frame0001.png"]
    img = read_png(tmp_path / names[-1])
    assert img.shape == (700, 900, 3) and (img != np.array([18, 18, 24], np.uint8)).any()


def test_live_view_and_emitter_examples_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    n = torch_live_view.main([str(tmp_path / "live"), "--device", "cpu", "--n", "1024",
                              "--time", str(2 / 60)])
    assert n == 2
    assert read_png(tmp_path / "live" / "frame0001.png").shape == (400, 400, 3)
    assert torch_emitter.main(["--device", "cpu", "--n", "1024", "--time", str(2 / 60)]) >= 0
