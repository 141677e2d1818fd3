"""The port's reference-format checkpoint (``io/legacy.py``) and the
CLI's ``--import-legacy``, against the JAX package's: the same bytes
written, the same arrays read, and the same checkpoint imported."""

import numpy as np
import pytest

from libclsph_tpu import cli as jcli
from libclsph_tpu.engine import simulation as jsim
from libclsph_tpu.io import legacy as jlegacy
from libclsph_tpu_torch import cli
from libclsph_tpu_torch.engine import simulation as tsim
from libclsph_tpu_torch.io import legacy
from test_torch_engine import _root
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

FIELDS3 = ("position", "velocity", "intermediate_velocity", "acceleration")


def _arrays(n, seed):
    rng = np.random.default_rng(seed)
    out = {k: rng.normal(size=(n, 3)).astype(np.float32) for k in FIELDS3}
    out["density"] = rng.uniform(900, 1100, n).astype(np.float32)
    out["pressure"] = rng.normal(size=n).astype(np.float32)
    out["grid_index"] = rng.integers(0, 1 << 30, n).astype(np.uint32)
    return out


def test_round_trip_and_bytes_equal_jax(tmp_path):
    a = _arrays(37, 3)
    legacy.write_legacy_checkpoint(tmp_path / "t.bin", a)
    jlegacy.write_legacy_checkpoint(tmp_path / "j.bin", a)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    assert (tmp_path / "t.bin").stat().st_size == 37 * 80
    back = legacy.read_legacy_checkpoint(tmp_path / "j.bin", 37)
    ref = jlegacy.read_legacy_checkpoint(tmp_path / "t.bin", 37)
    for k, v in a.items():
        np.testing.assert_array_equal(back[k], v)
        np.testing.assert_array_equal(back[k], ref[k])
        assert back[k].dtype == ref[k].dtype
    with pytest.raises(ValueError, match="incorrect size"):
        legacy.read_legacy_checkpoint(tmp_path / "t.bin", 36)


def _import(main, tmp_path, monkeypatch, sim_cls, name, legacy_file, root):
    """Run ``main`` with --import-legacy in its own directory, the run
    itself replaced by a no-op, and return the checkpoint it wrote."""
    work = tmp_path / name
    work.mkdir()
    monkeypatch.chdir(work)
    monkeypatch.setattr(sim_cls, "simulate", lambda self: 0.0)
    argv = ["water", "tiny", "cube", "out_", "--root", str(root), "--neighbor-impl", "tiles",
            "--import-legacy", str(legacy_file)]
    assert main(argv) == 0
    with np.load(work / "last_frame.npz") as z:
        return {k: z[k] for k in z.files}


def test_cli_import_legacy_equals_jax_cli(tmp_path, monkeypatch, capsys):
    root = _root(tmp_path)
    a = _arrays(2048, 5)
    src = tmp_path / "last_frame.bin"
    jlegacy.write_legacy_checkpoint(src, a)
    t = _import(lambda argv: cli.main(argv + ["--device", "cpu"]), tmp_path, monkeypatch,
                tsim.SPHSimulation, "port", src, root)
    j = _import(jcli.main, tmp_path, monkeypatch, jsim.SPHSimulation, "jax", src, root)
    assert "Imported legacy checkpoint" in capsys.readouterr().out
    assert set(t) == set(j)
    for k in t:
        np.testing.assert_array_equal(t[k], j[k])
        assert t[k].dtype == j[k].dtype
    for k, v in a.items():
        np.testing.assert_array_equal(t[k], v)


def test_cli_import_legacy_resumes_and_refuses_a_wrong_size(tmp_path, monkeypatch):
    """A real run from the imported state (its checkpoint is then the
    run's own), and a file of the wrong particle count exits 1."""
    root = _root(tmp_path, simulation_time=1.0 / 60.0)
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(6)
    a = _arrays(2048, 6)
    a["position"] = (rng.random((2048, 3)).astype(np.float32) - 0.5) * 0.4
    a["velocity"] = a["intermediate_velocity"] = np.zeros((2048, 3), np.float32)
    legacy.write_legacy_checkpoint(tmp_path / "in.bin", a)
    argv = ["water", "tiny", "cube", "out_", "--device", "cpu", "--root", str(root),
            "--neighbor-impl", "tiles", "--import-legacy", str(tmp_path / "in.bin")]
    assert cli.main(argv) == 0
    with np.load(tmp_path / "last_frame.npz") as z:
        pos = z["position"]
    # one frame from the imported cloud (|x| < 0.2 on every axis, centred
    # on 0; the state comes back in Morton order), not from the initial
    # lattice, whose centroid sits at y = 0.22
    assert np.isfinite(pos).all() and np.abs(pos).max() < 0.5
    assert np.abs(pos.mean(axis=0)).max() < 0.05
    assert not np.array_equal(np.sort(pos, axis=0), np.sort(a["position"], axis=0))
    legacy.write_legacy_checkpoint(tmp_path / "short.bin", _arrays(100, 7))
    argv[-1] = str(tmp_path / "short.bin")
    assert cli.main(argv) == 1
