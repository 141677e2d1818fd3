"""Block shapes, finer query blocks and the refine mode at the port's
entry points, against the JAX package's rules: the CLI's quiet clamps
(JAX ``cli.py:195-210``) on the configs both CLIs build, bench_torch's
clamps (``bench.py:283-292``), ``step_config_from_jax`` carrying
``block_size``, ``nl_query_rows`` and ``refine_mode``, and the engine's
capacity growth (two-tier routing only at ``nl_query_rows >=
block_size``, JAX ``simulation.py:211-232``) and pretune guard
(``pretune.py:209-215``)."""

import dataclasses

import pytest
import torch

import bench_torch
from libclsph_tpu import cli as jcli
from libclsph_tpu.engine import simulation as jsim
from libclsph_tpu.engine import step as jstep
from libclsph_tpu_torch import cli, interop
from libclsph_tpu_torch.engine import pretune
from libclsph_tpu_torch.engine import simulation as tsim
from libclsph_tpu_torch.engine import step as tstep
from test_torch_engine import _root
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

CLAMPED = ("block_size", "nl_query_rows", "cand_interval", "density_sub16", "force_sub8",
           "pallas_variant")


class Captured(Exception):
    """Raised by the stand-in engine with the config a CLI built."""


def _capture(main, sim_module, monkeypatch, argv):
    def grab(step_config=None, **kw):
        raise Captured(step_config)

    monkeypatch.setattr(sim_module, "SPHSimulation", grab)
    with pytest.raises(Captured) as e:
        main(argv)
    return e.value.args[0]


@pytest.mark.parametrize("flags", [
    ("--block-size", "64"),
    ("--block-size", "256", "--no-density-sub16"),
    ("--nl-query-rows", "64"),
    ("--nl-query-rows", "32"),
    ("--block-size", "256", "--nl-query-rows", "32"),
    ("--block-size", "64", "--nl-query-rows", "32"),
    ("--pallas-variant", "asm", "--nl-query-rows", "32", "--no-density-sub16"),
], ids=["b64", "b256", "q64", "q32", "b256-q32", "b64-q32", "asm-q32"])
def test_cli_clamps_equal_jax_cli(tmp_path, monkeypatch, flags):
    root = _root(tmp_path)
    base = ["water", "tiny", "cube", "out_", "--root", str(root), "--neighbor-impl",
            "pallas", *flags]
    t = _capture(lambda a: cli.main(a + ["--device", "cpu"]), cli, monkeypatch, base)
    j = _capture(jcli.main, jcli, monkeypatch, base)
    for name in CLAMPED:
        assert getattr(t, name) == getattr(j, name), name
    assert isinstance(t, tstep.StepConfig)  # the port runs what the JAX CLI builds


def test_cli_refuses_what_jax_refuses(tmp_path, monkeypatch, capsys):
    """At block_size 256 the 16-granular tables stay on (min(256, 128) is
    128) and a block holds two query blocks: the JAX CLI builds the
    config and its substep refuses it; the port's CLI refuses it at
    once with the same message."""
    root = _root(tmp_path)
    base = ["water", "tiny", "cube", "out_", "--root", str(root), "--neighbor-impl",
            "pallas", "--block-size", "256"]
    j = _capture(jcli.main, jcli, monkeypatch, base)
    assert j.density_sub16 and j.block_size == 256
    assert cli.main(base + ["--device", "cpu"]) == -1
    assert "density_sub16 requires the nl variant at whole-128" in capsys.readouterr().err


def parse(*argv):
    return bench_torch.build_arg_parser().parse_args(list(argv))


@pytest.mark.parametrize("argv,expect", [
    (("--block-size", "64"), dict(block_size=64, density_sub16=False, force_sub8=False,
                                  cand_interval=4)),
    (("--block-size", "256", "--no-density-sub16", "--no-force-sub8"),
     dict(block_size=256, density_sub16=False, force_sub8=False, cand_interval=1)),
    (("--nl-query-rows", "64"), dict(nl_query_rows=64, density_sub16=False,
                                     force_sub8=False, cand_interval=1)),
    (("--nl-query-rows", "32", "--pallas-variant", "asm"),
     dict(nl_query_rows=32, pallas_variant="asm", density_sub16=False, cand_interval=1)),
], ids=["b64", "b256", "q64", "asm-q32"])
def test_bench_clamps(argv, expect):
    cfg = bench_torch.config_from_args(parse(*argv))
    for k, v in expect.items():
        assert getattr(cfg, k) == v, k


def test_step_config_from_jax_carries_the_shape():
    jcfg = jstep.StepConfig(neighbor_impl="pallas", block_size=256, nl_query_rows=32,
                            refine_mode="aabb")
    cfg = interop.step_config_from_jax(jcfg)
    assert (cfg.block_size, cfg.nl_query_rows, cfg.refine_mode) == (256, 32, "aabb")
    assert (cfg.q_rows, cfg.q_rep) == (32, 8)
    mxu = interop.step_config_from_jax(dataclasses.replace(jcfg, pair_r2="mxu",
                                                           tile_mode="mxu"))
    assert (mxu.pair_r2, mxu.tile_mode, mxu.r2_mxu) == ("mxu", "mxu", True)
    with pytest.raises(ValueError, match="pair_r2"):
        tstep.StepConfig(pair_r2="tf32")
    with pytest.raises(ValueError, match="refine_mode"):
        tstep.StepConfig(refine_mode="boxes")


@pytest.mark.parametrize("over", [
    dict(block_size=64),  # q_rows 64 = block: whole-block query rows, tier 2 allowed
    dict(nl_query_rows=64, cand_interval=1),  # finer query blocks: the cap doubles
    dict(block_size=256, cand_interval=1),
    dict(block_size=64, tier2_frac=8),  # tier 2 already on: its multiplier doubles
], ids=["b64", "q64", "b256", "b64-tier2"])
def test_capacity_growth_equals_jax(over):
    base = dict(neighbor_impl="pallas", pallas_variant="nl", density_sub16=False,
                force_sub8=False, force_sub16=False, **over)
    flags = tstep.FLAG_CAPACITY_SUB | tstep.FLAG_CAPACITY_HIT
    jcfg = jstep.StepConfig(**base)
    j = jsim.SPHSimulation(step_config=jcfg)
    j._grow_capacity(flags)
    t = tsim.SPHSimulation(interop.step_config_from_jax(jcfg), device="cpu")
    t._grow_capacity(flags)
    assert t.step_config == interop.step_config_from_jax(j.step_config)


def test_pretune_passes_finer_query_blocks_through():
    """The probe sizes the whole-block shape only: finer query blocks
    pass through untouched, without a probe."""
    cfg = tstep.StepConfig(nl_query_rows=64, density_sub16=False, force_sub8=False,
                           cand_interval=1)
    state = interop.state_from_arrays(dict(
        position=torch.zeros((8, 3)).numpy(), velocity=torch.zeros((8, 3)).numpy(),
        intermediate_velocity=torch.zeros((8, 3)).numpy(),
        acceleration=torch.zeros((8, 3)).numpy(), density=torch.zeros(8).numpy(),
        pressure=torch.zeros(8).numpy(), grid_index=torch.zeros(8, dtype=torch.int32).numpy()),
        "cpu")
    assert pretune.pretune_config(state, None, cfg) == (cfg, None)
