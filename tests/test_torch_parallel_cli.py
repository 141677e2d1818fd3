"""The sharded path through the port's entry points on the CPU:
``sph-torch ... --mesh 2 --device cpu`` (frames, checkpoint, resume),
``bench_torch.py --mesh 2`` and its warm-up's growth rule (bench.py's
mesh rule), the engine's ``halo_hops`` growth on
``FLAG_EXCHANGE``, the engine's callbacks over a mesh, and the JAX
module's ``dryrun`` hook."""

import datetime
import json
import os
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from scipy.spatial import cKDTree

import bench_torch
from libclsph_tpu_torch import cli
from libclsph_tpu_torch.engine import simulation as tsim
from libclsph_tpu_torch.engine.step import (
    FLAG_CAND_STALE,
    FLAG_CAPACITY,
    FLAG_CAPACITY_HIT,
    FLAG_CAPACITY_SUB,
    FLAG_CAPACITY_T2,
    FLAG_EXCHANGE,
    FLAG_GRID_DIM,
    StepConfig,
)
from libclsph_tpu_torch.parallel import bench as pbench
from libclsph_tpu_torch.parallel import mesh, sharded_step
from test_torch_engine import _root
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_cli_mesh_writes_frames_checkpoint_and_resumes(tmp_path, monkeypatch):
    root = _root(tmp_path)
    monkeypatch.chdir(tmp_path)
    base = ["water", "tiny", "cube", "out_", "--device", "cpu", "--root", str(root)]
    assert cli.main(base) == 0  # one device, for the comparison below
    single = np.load(tmp_path / "last_frame.npz")["position"]
    os.remove(tmp_path / "last_frame.npz")
    args = base + ["--mesh", "2", "--exchange", "halo"]
    assert cli.main(args) == 0
    frames = sorted(os.listdir(tmp_path / "out_frames"))
    assert frames[0] == "frame0000001.geo" and len(frames) == 4
    head = open(tmp_path / "out_frames" / frames[-1]).read(200).splitlines()
    assert head[0] == "PGEOMETRY V5" and head[1].startswith("NPoints 2048 ")
    ck = np.load(tmp_path / "last_frame.npz")
    pos = ck["position"]
    assert pos.shape == (2048, 3) and np.isfinite(pos).all()
    assert np.isfinite(ck["density"]).all() and ck["grid_index"].dtype == np.uint32
    # the same three frames as on one device, to float32 noise over ~30
    # substeps (the sharded path runs the 16-wide force pass)
    dist_, idx = cKDTree(pos).query(single)
    assert np.unique(idx).shape[0] == 2048 and dist_.max() < 1e-4
    # the next run resumes from the checkpoint rank 0 wrote
    assert cli.main(args) == 0
    pos2 = np.load(tmp_path / "last_frame.npz")["position"]
    assert not np.array_equal(pos2, pos) and np.isfinite(pos2).all()


def test_cli_mesh_returns_1_when_a_rank_fails(tmp_path, monkeypatch, capsys):
    # a file where rank 0 writes its frames: its save raises, the launch
    # stops the other rank, and the CLI reports the traceback and returns 1
    root = _root(tmp_path)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "out_frames").write_text("not a folder")
    args = ["water", "tiny", "cube", "out_", "--device", "cpu", "--root", str(root),
            "--mesh", "2", "--exchange", "halo"]
    assert cli.main(args) == 1
    err = capsys.readouterr().err
    assert "rank(s) [0] failed" in err and "FileExistsError" in err


def test_cli_mesh_refusals(tmp_path, monkeypatch):
    root = _root(tmp_path)
    monkeypatch.chdir(tmp_path)
    base = ["water", "tiny", "cube", "out_", "--root", str(root)]
    if not torch.cuda.is_available():
        assert cli.main(base + ["--mesh", "2"]) == -1  # cuda without a card
    assert cli.main(base + ["--device", "cpu", "--mesh", "-1"]) == -1
    assert cli.main(base + ["--device", "cpu", "--mesh", "2", "--cand-interval", "3"]) == -1


def test_bench_torch_mesh_prints_the_mesh_line(capsys):
    assert bench_torch.main(["--device", "cpu", "--n", "4096", "--warmup", "2", "--steps",
                             "3", "--mesh", "2", "--exchange", "ring", "--json-only"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["unit"] == "particle-steps/s" and out["vs_baseline"] is None
    d = out["detail"]
    assert (d["n"], d["mesh"], d["exchange"], d["steps"], d["platform"]) == (
        4096, 2, "ring", 3, "cpu")
    assert d["timed_flags"] == 0 and d["ranks_share_card"] is False and d["card"] is None
    assert d["halo_hops"] == 1 and d["halo_max"] == 16  # full coverage at 2 ranks
    assert d["config"]["force_sub8"] is False
    # the grown table shape: the 16-wide tables stay under bench.py's rule
    t = d["tables"]
    assert t["tables"] == [True, True, False] and t["force_query_rows"] == 32
    assert t["tier2_frac"] == 0
    assert {k: d["config"][k] for k in t if k != "tables"} == {
        k: v for k, v in t.items() if k != "tables"}
    calls = d["collectives_per_substep"]
    assert calls["ring"] > 0 and calls["all_reduce"] >= 2
    assert d["staged_bytes_per_substep"] == 0
    assert out["value"] == pytest.approx(4096 * 3 / d["elapsed_s"], rel=1e-3)


# bench.py's mesh warm-up (bench.py:115-140), copied here because
# bench.py imports jax at the top of its module: each flag's updates,
# doubled from the config the warm-up ran
BENCH_PY_MESH_RULE = {
    FLAG_CAPACITY: ("max_candidates",),  # bench.py:122-123
    FLAG_CAPACITY_SUB: ("max_candidates_sub",),  # :124-125
    FLAG_CAPACITY_HIT: ("max_candidates_hit", "max_candidates_hit16",
                        "max_candidates_hit8"),  # :126-129
    FLAG_CAND_STALE: ("cand_slack",),  # :130-131
}


@pytest.mark.parametrize("flags", range(1 << len(BENCH_PY_MESH_RULE)))
def test_mesh_growth_is_bench_py_rule(flags):
    """Every combination of the four flags bench.py's mesh warm-up reads
    gives its updates and no others; the bits it ignores (the tier-2 pool,
    the grid) add nothing, so its warm-up stops (bench.py:132-133)."""
    bits = [b for i, b in enumerate(BENCH_PY_MESH_RULE) if flags >> i & 1]
    f = sum(bits)
    cfg = StepConfig(force_sub8=False, max_candidates_hit8=80, cand_slack=0.25)
    want = {k: getattr(cfg, k) * 2 for b in bits for k in BENCH_PY_MESH_RULE[b]}
    for extra in (0, FLAG_CAPACITY_T2, FLAG_GRID_DIM):
        assert pbench.mesh_growth(cfg, f | extra, 1, 4) == (want, 1)


def test_mesh_growth_widens_the_ring_to_full_coverage():
    cfg = StepConfig(force_sub8=False)
    assert pbench.mesh_growth(cfg, FLAG_EXCHANGE, 1, 4) == ({}, 2)
    assert pbench.mesh_growth(cfg, FLAG_EXCHANGE, 2, 4) == ({}, 2)  # full: no update
    assert pbench.mesh_growth(cfg, FLAG_EXCHANGE | FLAG_CAPACITY, 2, 8) == (
        {"max_candidates": 192}, 4)


@pytest.mark.parametrize("world,grown", [(4, [2]), (8, [2, 4])])
def test_halo_hops_grow_to_full_coverage(world, grown):
    stub = types.SimpleNamespace(world=world, rank=0, device=torch.device("cpu"))
    sim = tsim.SPHSimulation(StepConfig(), mesh=stub, exchange="ring")
    for hops in grown:
        assert sim._needs_rerun(torch.tensor(FLAG_EXCHANGE)) is True
        assert sim.halo_hops == hops
    with pytest.raises(RuntimeError, match="full ring coverage"):
        sim._needs_rerun(torch.tensor(FLAG_EXCHANGE))
    # with a capacity bit beside it, both grow
    sim = tsim.SPHSimulation(StepConfig(force_sub8=False), mesh=stub, exchange="ring")
    assert sim._needs_rerun(torch.tensor(FLAG_EXCHANGE | FLAG_CAPACITY_HIT)) is True
    assert sim.halo_hops == 2 and sim.step_config.density_sub16 is False


def test_engine_refuses_reuse_off_the_pallas_impl():
    stub = types.SimpleNamespace(world=2, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="requires the pallas impl"):
        tsim.SPHSimulation(StepConfig(neighbor_impl="tiles", cand_interval=2,
                                      density_sub16=False, force_sub8=False), mesh=stub)
    with pytest.raises(ValueError, match="exchange must be one of"):
        tsim.SPHSimulation(StepConfig(), mesh=stub, exchange="tree")


def test_engine_callbacks_on_a_mesh(tmp_path):
    """A one-rank group in this process: the per-substep path with
    pre_frame writing back (the state re-partitioned and handed out), the
    saves of the gathered real rows, and the device_view hook."""
    dist.init_process_group("gloo", init_method="file://" + str(tmp_path / "store"), rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        root = _root(tmp_path, simulation_time=1.0 / 60.0, serialize=False,
                     write_all_frames=True, particles_count=1000)
        sim = tsim.SPHSimulation(StepConfig(), mesh=mesh.Mesh(0, 1, "cpu", "gloo"),
                                 exchange="halo", pretune=False)
        sim.load_settings(str(root / "fluid_properties" / "water.json"),
                          str(root / "simulation_properties" / "tiny.json"))
        sim.load_scene("cube.obj", scenes_dir=str(root / "scenes"))
        sim.checkpoint_path = str(tmp_path / "none.npz")
        seen = dict(pre=0, save=[], view=[])

        def pre(arrays, params, full):
            seen["pre"] += 1
            arrays["velocity"][:] = 0.0
            return True

        sim.pre_frame = pre
        sim.save_frame = lambda arrays, params: seen["save"].append(arrays["position"].shape)
        sim.device_view = lambda state, params, full: seen["view"].append(state.n)
        sim.simulate()
        assert seen["pre"] > 1 and len(seen["save"]) == seen["pre"] + 1
        assert set(seen["save"]) == {(1000, 3)} and seen["view"] == [1000, 1000]
        assert sim.halo_max == sharded_step.default_halo_max(1000, 1, 128) == 8
        assert sim.state.n == 1000 and bool(torch.isfinite(sim.state.velocity).all())
    finally:
        dist.destroy_process_group()


def test_dryrun_on_two_ranks():
    sharded_step.dryrun(2, device="cpu")
