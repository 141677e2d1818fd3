"""The port's diagnostic probes, ``experiments/torch_refine_probe.py``,
``torch_scale_diag.py``, ``torch_river_frame_diag.py`` and
``torch_mesh_split.py``, on the CPU at 2,048-4,096 particles: the refine
probe's exact tables against the JAX package's
``tiles.refine_candidates_exact`` on the same inputs and its part times
at each query width; the scale probe's substeps against bench_torch's
from the same state; the river probe's dispatches against the substeps
its frames ran; the mesh split's ranges on one rank. The probes' own sizes
(the settled 1M cube, 2M, the 1M river) take minutes on a CPU;
``chip_smoke.py`` phase 13 runs them on the card."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libclsph_tpu.ops import tiles as jtiles
from libclsph_tpu_torch.engine import step as tstep
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "experiments"))

import bench_torch  # noqa: E402
import torch_mesh_split  # noqa: E402
import torch_refine_probe  # noqa: E402
import torch_river_frame_diag  # noqa: E402
import torch_scale_diag  # noqa: E402


def _refine_inputs(seed, nb=24, nbc=40, m=12, b=128, sub=8):
    """Coarse lists and query boxes made with numpy: ``nb`` query blocks,
    each with up to ``m`` distinct candidate blocks (its own first) of
    ``nbc`` blocks of ``b`` particles in the unit cube, and 4 split boxes
    a query block."""
    rng = np.random.default_rng(seed)
    pos = rng.random((nbc, b, 3)).astype(np.float32)
    cand = np.zeros((nb, m), np.int32)
    count = rng.integers(1, m + 1, nb).astype(np.int32)
    for i in range(nb):
        others = rng.permutation(np.delete(np.arange(nbc), i))[: count[i] - 1]
        cand[i, : count[i]] = np.concatenate([[i], np.sort(others)])
    centre = rng.random((nb, 4, 3)).astype(np.float32)
    half = (0.02 + 0.08 * rng.random((nb, 4, 3))).astype(np.float32)
    self_lo = (np.arange(nb) * sub).astype(np.int32)
    return pos, cand, count, centre - half, centre + half, self_lo


@pytest.mark.parametrize("cap", [24, 96])
def test_refine_probe_parts_equal_jax_exact_refine(cap):
    h, sub = 0.1, 8
    pos, cand, count, qlo, qhi, self_lo = _refine_inputs(7)
    want = jtiles.refine_candidates_exact(
        jnp.asarray(cand), jnp.asarray(count), jnp.asarray(qlo), jnp.asarray(qhi),
        jnp.asarray(pos), h, sub, cap, self_lo=jnp.asarray(self_lo), self_width=sub)
    T = torch.as_tensor
    cand_sub, count_sub, ovf, parts = torch_refine_probe.refine_parts(
        T(cand), T(count), T(qlo), T(qhi), T(pos), h, sub, cap, T(self_lo), sub, reps=1)
    np.testing.assert_array_equal(count_sub.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(cand_sub.numpy(), np.asarray(want[0]))
    assert bool(ovf) == bool(want[2]) == (cap == 24)
    assert set(parts) == {"gather", "test", "sort"}
    assert all(p["ms"] > 0 and p["device_ms"] is None for p in parts.values())


def test_refine_probe_times_every_query_width():
    out = torch_refine_probe.run(n=4096, settle=2, device="cpu", reps=1)
    assert [w["nl_query_rows"] for w in out["widths"]] == [128, 64, 32]
    for w in out["widths"]:
        assert set(w["parts"]) == {"gather", "test", "sort", "hit_lists", "compact_hits"}
        assert all(p["ms"] > 0 for p in w["parts"].values())
        assert w["rebuild_substep"]["ms"] > 0 and w["share_clock"] == "host clock"
        assert set(w["share_of_rebuild"]) == set(w["parts"])
        assert w["exact"]["tables_equal_refine_candidates_exact"]
        # the exact test keeps no more subblocks than the box test
        assert w["exact"]["mean"] <= w["aabb"]["mean"]
        assert not (w["coarse"]["overflow"] or w["exact"]["overflow"])


def test_scale_probe_substeps_equal_bench_torch():
    n, warmup, steps = 4096, 3, 4
    out = torch_scale_diag.run(n, warmup, steps, device="cpu")
    from libclsph_tpu_torch.core.state import init_state
    from libclsph_tpu_torch.engine.step import StepConfig
    from libclsph_tpu_torch.ops import collisions
    from libclsph_tpu_torch.scene.scene import Scene

    params = bench_torch.build_params(n)
    scene = collisions.build_device_scene(
        Scene.load("cube.obj", params.h * 2, scenes_dir=os.path.join(ROOT, "scenes")), "cpu")
    cfg = StepConfig()
    assert out["growth"] == [] and out["final"] == out["start"]
    st, dt, tables = init_state(params, "cpu"), torch.tensor(params.max_dt), None
    want = []
    for phase, k in (("warmup", warmup), ("steps", steps)):
        tables = None
        for i in range(k):
            st, dt, f, tables = bench_torch.run_substep(st, dt, i, tables, params, scene, cfg)
            want.append((phase, i, float(dt), int(f)))
    got = [(r["phase"], r["substep"], r["dt"], r["flags"]) for r in out["rows"]]
    assert got == want
    for r in out["rows"]:
        assert r["blocks"] == 32 and r["super_rows_max"] is None  # a dense search
        assert 0 < r["count_max"] <= 32 and 0 < r["count_sub_max"] <= cfg.max_candidates_sub
        assert r["min_density"] > 0 and not r["nan"]


def test_river_probe_dispatches_add_up_to_the_frames(monkeypatch):
    calls = []
    substep = tstep.substep

    def counted(*args, **kw):
        calls.append(1)
        return substep(*args, **kw)

    monkeypatch.setattr(tstep, "substep", counted)
    cap = 4
    out = torch_river_frame_diag.run(n=2048, frames=2, cap=cap, device="cpu")
    assert out["finite"] and len(out["frames"]) == 2
    assert sum(d["substeps"] for d in out["dispatches"]) == len(calls) > 0
    for fr in out["frames"]:
        mine = [d for d in out["dispatches"]
                if d["frame"] == fr["frame"] and d["attempt"] == fr["reruns"]]
        assert len(mine) == fr["dispatches"] > 1
        assert sum(d["substeps"] for d in mine) == fr["substeps"]
        assert fr["substeps"] == fr["rebuilds"] + fr["reuses"]
        for d in mine[:-1]:
            assert d["substeps"] == cap and d["timeleft"] > 0 and d["flags"] == 0
        assert mine[-1]["timeleft"] <= 0 and 0 < mine[-1]["substeps"] <= cap
        assert all(d["rebuilds"] >= 1 for d in mine)  # each dispatch builds its tables


def test_mesh_split_ranges_cover_both_paths():
    out = torch_mesh_split.run(n=4096, world=1, warmup=2, steps=4, device="cpu")
    r = out["ranks"][0]
    assert r["mesh"]["flags"] == r["single"]["flags"] == 0
    common = {"substep", "sort", "block_search", "refine", "passes", "advance"}
    assert set(r["mesh"]["ranges"]) == common | {"exchange", "collective"}
    assert set(r["single"]["ranges"]) == common
    for run in (r["mesh"], r["single"]):
        rg = run["ranges"]
        assert rg["substep"]["calls"] == rg["passes"]["calls"] == 1
        # one rebuild in 4 substeps
        assert rg["block_search"]["calls"] == rg["refine"]["calls"] == 0.25
        assert all(v["host_ms"] > 0 and v["device_ms"] is None for v in rg.values())
        assert rg["passes"]["host_ms"] < rg["substep"]["host_ms"]
        assert run["device_ms"] is None and run["ms_per_substep"] > 0
    # the ranges live inside the block only
    from libclsph_tpu_torch.ops import tiles

    with torch_mesh_split.ranges():
        assert hasattr(tiles.candidate_blocks, "__wrapped__")
    assert not hasattr(tiles.candidate_blocks, "__wrapped__")
