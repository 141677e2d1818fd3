"""The check on loaded modules compares top-level names whole: a planted
``jax`` fails a run, in the process that prints the result or in a rank
of a mesh, the port's ``libclsph_tpu_torch`` passes, and the reference
loads nothing of the program."""

import subprocess
import sys
import types

import pytest

from conftest import MESH_CELL, ROOT, cpu_run


def test_top_level_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "libclsph_tpu_torch_probe", types.ModuleType("x"))
    assert "libclsph_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert run.forbidden_modules() == ["jax"]


def test_planted_jax_fails_the_run(small, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit) as e:
        cpu_run("dambreak_64k.substeps")
    assert "jax" in str(e.value)
    assert capsys.readouterr().out == ""


def _jax_rank_body(mesh, *args):
    """:func:`benchmark.mesh.rank_body` in a rank that has loaded ``jax``."""
    from benchmark import mesh as bench_mesh

    sys.modules["jax"] = types.ModuleType("jax")
    return bench_mesh.rank_body(mesh, *args)


def test_jax_in_a_rank_fails_the_run(mesh_cell, monkeypatch, capsys):
    from benchmark import mesh as bench_mesh

    monkeypatch.setattr(bench_mesh, "rank_body", _jax_rank_body)
    with pytest.raises(SystemExit) as e:
        cpu_run(MESH_CELL)
    assert "jax" in str(e.value)
    assert "jax" not in sys.modules
    assert capsys.readouterr().out == ""


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    names = _loaded("import benchmark.run, benchmark.harness, benchmark.judge\n"
                    "import libclsph_tpu_torch.engine.simulation")
    assert not names & {"jax", "jaxlib", "flax", "libclsph_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = _loaded("import benchmark.judge, benchmark.reference.sph, "
                    "benchmark.reference.scene, benchmark.reference.geo")
    assert not names & {"jax", "jaxlib", "flax", "libclsph_tpu", "libclsph_tpu_torch"}
