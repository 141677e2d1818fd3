"""``bench_torch.py``, the port's counterpart of ``bench.py``: its
parameters equal bench.py's, its flag defaults are ``StepConfig()``, its
refusals carry their messages, a CPU run prints bench.py's one JSON line,
and its warm-up grows capacity by the engine's rule (the 8-wide hit
capacity stops at 160 and the tables move to the q-granular shape)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import bench
import bench_torch
from libclsph_tpu_torch.core.state import ParticleState
from libclsph_tpu_torch.engine import step
from libclsph_tpu_torch.engine.simulation import SPHSimulation
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

BENCH_DETAIL = {"n", "steps", "elapsed_s", "ms_per_step", "impl", "scene", "platform",
                "final_dt", "timed_flags"}


def parse(*argv):
    return bench_torch.build_arg_parser().parse_args(list(argv))


@pytest.mark.parametrize("fluid", ["water", "mucus"])
def test_build_params_equal_bench(fluid):
    j = bench.build_params(4096, fluid)
    t = bench_torch.build_params(4096, fluid)
    fields = [f.name for f in dataclasses.fields(t)]
    assert {f.name for f in dataclasses.fields(j)} == set(fields)
    for name in fields:
        assert getattr(t, name) == getattr(j, name), name


def test_flag_defaults_are_step_config():
    args = parse()
    assert bench_torch.config_from_args(args) == step.StepConfig()
    d = step.StepConfig()
    for name in ("max_candidates", "max_candidates_sub", "max_candidates_hit",
                 "max_candidates_hit16", "max_candidates_hit8", "force_query_rows",
                 "tier2_frac", "tier2_mult", "sort_interval", "cand_interval",
                 "cand_slack", "density_sub16", "force_sub16", "force_sub8",
                 "density_gate", "block_size", "nl_query_rows", "pallas_variant"):
        assert getattr(args, name) == getattr(d, name), name
    assert (args.impl, args.no_hit_compact, args.device) == (d.neighbor_impl, False, "cuda")
    assert (args.steps, args.warmup, args.scene, args.tile_mode) == (20, 3, "cube", "direct")


def test_off_the_nl_shape_rebuilds_every_substep():
    assert bench_torch.config_from_args(parse("--pallas-variant", "row")).cand_interval == 1
    cfg = bench_torch.config_from_args(parse("--impl", "exact", "--sort-interval", "1",
                                             "--cand-interval", "1"))
    assert (cfg.neighbor_impl, cfg.cand_interval) == ("exact", 1)


@pytest.mark.parametrize("argv,message", [
    (("--cand-interval", "3"), "--cand-interval must divide --sort-interval"),
    (("--mesh", "-1"), "--mesh and --halo-max must be >= 0, --halo-hops >= 1"),
    (("--mesh", "2", "--halo-hops", "0"),
     "--mesh and --halo-max must be >= 0, --halo-hops >= 1"),
    (("--exchange", "ring"), "--exchange, --halo-max and --halo-hops need --mesh N"),
    (("--halo-hops", "2"), "--exchange, --halo-max and --halo-hops need --mesh N"),
    (("--block-size", "96"), "StepConfig.block_size=96: use one of (64, 128, 256)"),
    (("--nl-query-rows", "16"), "StepConfig.nl_query_rows=16: use one of (32, 64, 128)"),
], ids=["cand-interval", "mesh", "halo-hops-0", "exchange", "halo", "block-size",
        "nl-query-rows"])
def test_refusals(argv, message):
    with pytest.raises(SystemExit) as e:
        bench_torch.config_from_args(parse(*argv))
    assert message in str(e.value.code)


def test_cpu_run_tiles_in_mxu_tile_mode(capsys):
    """--tile-mode mxu runs: the tiles impl with r^2 by the identity."""
    args = ["--device", "cpu", "--n", "4096", "--warmup", "1", "--steps", "2",
            "--impl", "tiles", "--tile-mode", "mxu", "--json-only"]
    assert bench_torch.config_from_args(parse(*args[:-1])).tile_mode == "mxu"
    assert bench_torch.main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["detail"]["config"]["tile_mode"] == "mxu"
    assert out["detail"]["timed_flags"] == 0


def test_refuses_to_run_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench_torch.main(["--n", "4096", "--steps", "1"])
    assert "--device cpu" in str(e.value.code)


def test_cpu_run_prints_one_bench_line(capsys):
    assert bench_torch.main(["--device", "cpu", "--n", "4096", "--warmup", "3", "--steps",
                             "4", "--json-only"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert out["vs_baseline"] is None and out["unit"] == "particle-steps/s"
    d = out["detail"]
    assert set(d) == BENCH_DETAIL | {"card", "host_cpu", "config", "host_reads_per_substep"}
    assert d["timed_flags"] == 0 and d["platform"] == "cpu" and d["card"] is None
    # one host read for the timed window's one candidate period of 4 substeps
    assert d["host_reads_per_substep"] == 0.25
    assert (d["n"], d["steps"], d["impl"], d["scene"]) == (4096, 4, "pallas", "cube")
    assert d["config"] == dataclasses.asdict(step.StepConfig())
    assert out["value"] == pytest.approx(4096 * 4 / d["elapsed_s"], rel=1e-3)


def test_hit8_growth_past_160_downgrades():
    """Every particle of a 2,048-particle sheet lies within h of every
    other: a query subgroup hits 256 runs of 8, past the 160 where the
    engine stops growing the 8-wide capacity. bench.py would go on to
    192; the warm-up moves to the q-granular tables instead."""
    n = 2048
    params = bench_torch.build_params(n)
    rng = np.random.default_rng(1234)
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = rng.uniform(0, 0.5 * params.h, n)
    pos[:, 1] = rng.uniform(0, 0.3 * params.h, n)
    pos[:, 2] = rng.uniform(0, 0.5 * params.h, n)
    state = ParticleState.zeros(n, "cpu").replace(position=torch.as_tensor(pos))
    engine = SPHSimulation(step.StepConfig(max_candidates_hit8=160), device="cpu",
                           pretune=False)
    st, _ = bench_torch.warm_up(state, params, None, engine, 1)
    cfg = engine.step_config
    assert (cfg.density_sub16, cfg.force_sub16, cfg.force_sub8) == (False, False, False)
    assert cfg.max_candidates_hit8 == 160 and cfg.max_candidates_hit > 96
    assert torch.isfinite(st.density).all()


@pytest.mark.parametrize("name,expected", [
    ("Intel(R) Xeon(R) Platinum 8480+", "Intel(R) Xeon(R) Platinum 8480+"),
    ("unknown", "vendor_id GenuineIntel cpu family 6 model 207"),
], ids=["named", "hidden"])
def test_host_cpu_names_the_model(tmp_path, name, expected):
    info = tmp_path / "cpuinfo"
    info.write_text(f"processor\t: 0\nvendor_id\t: GenuineIntel\ncpu family\t: 6\n"
                    f"model\t\t: 207\nmodel name\t: {name}\n")
    assert bench_torch.host_cpu(str(info)).startswith(expected + ", ")
