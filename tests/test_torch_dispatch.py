"""The frame loops' dispatch layer (``engine.step.dispatch``) against the
loops it replaced (``tests/torch_frame_ref.py``, a host read before each
decision), bit for bit: state, dt, time left, flags and the substep
stats, on a 4,096-particle cube lattice above ``scenes/cube.obj`` at
``cand_interval`` 4, in five cases:

* clean: no predicate fires, and the dispatch reads the host once a
  chunk plus once of its own;
* staleness firing mid-chunk (a small ``cand_slack``);
* a dt retry at the rebuild substep (a first dt ten times the stable
  one) and mid-chunk (particles driven together, so that the stable dt
  drops between substeps);
* time running out mid-chunk (a first dt below the stable one, so that
  the dispatch's estimate of the substeps left runs long);
* a capacity flag in the middle of the dispatch (hit lists too short).

And three sharded cases: ``parallel.sharded_step.local_frame`` on 2
gloo ranks against its old loop on the same ranks, bit for bit, clean
(and then against the single-chip frame by position, the tolerances of
``test_torch_parallel_reuse.py``), with staleness stops and with a dt
retry stop, where the predicates that decide the branch pass through
the mesh's all-reduce. And the dispatch with no time kept and a
staleness check (bench's cadence has none) against the same dispatch
with a time left that never runs out. torch only; the JAX package is
not run."""

import dataclasses
import os

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import bench_torch
import torch_frame_ref as ref
from libclsph_tpu_torch import interop
from libclsph_tpu_torch.core.state import init_state
from libclsph_tpu_torch.engine import step
from libclsph_tpu_torch.engine.step import FLAG_CAPACITY_HIT, StepConfig
from libclsph_tpu_torch.io import checkpoint
from libclsph_tpu_torch.ops import collisions
from libclsph_tpu_torch.parallel import mesh, sharded_step
from libclsph_tpu_torch.scene.scene import Scene
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4096
SUBSTEPS = 8
CFG = StepConfig(cand_interval=4, sort_interval=4, substeps_per_dispatch=SUBSTEPS)
FIELDS = ("position", "velocity", "intermediate_velocity", "acceleration", "density",
          "pressure", "grid_index")


@pytest.fixture(scope="module")
def cube():
    params = bench_torch.build_params(N)
    scene = collisions.build_device_scene(
        Scene.load("cube.obj", params.h * 2, scenes_dir=os.path.join(ROOT, "scenes")), "cpu")
    return params, scene, init_state(params, "cpu")


def converging(state, rate):
    """``state`` with every particle moving towards the centre at ``rate``
    times its distance (m/s per m)."""
    v = -rate * (state.position - state.position.mean(dim=0))
    return state.replace(velocity=v, intermediate_velocity=v)


_REF = {}  # the old loop's results, by inputs


def both(params, scene, state, cfg, dt, timeleft):
    """The old loop and the dispatch layer from the same inputs. Returns
    the dispatch's stats and host values."""
    dt_t = torch.tensor(dt, dtype=torch.float32)
    tl = torch.tensor(timeleft, dtype=torch.float32)
    stats, host = {}, {}
    key = (id(state), cfg, float(dt), float(timeleft))
    if key not in _REF:  # the state is kept with its results, so its id stays its own
        want_stats = {}
        _REF[key] = (state, ref.frame(state, dt_t, tl, params, scene, cfg, want_stats),
                     want_stats)
    _, want, want_stats = _REF[key]
    reads = step.host_read.count
    got = step.frame(state, dt_t, tl, params, scene, cfg, stats, host)
    assert host["reads"] == step.host_read.count - reads
    for k in FIELDS:
        assert torch.equal(getattr(got[0], k), getattr(want[0], k)), k
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert stats == want_stats
    assert host["flags"] == int(want[3])
    assert host["more"] == bool(want[2] > 0.0)
    return stats, host


def test_clean_chunks_read_once_each(cube):
    params, scene, state = cube
    stats, host = both(params, scene, state, CFG, params.max_dt, 3.0e38)
    assert host["events"] == [] and host["flags"] == 0
    assert stats["substeps"] == SUBSTEPS and stats["rebuilds"] == SUBSTEPS // 4
    # one read a chunk of cand_interval substeps, plus the dispatch's own
    assert host["reads"] == SUBSTEPS // CFG.cand_interval + 1


def test_staleness_mid_chunk(cube):
    """Staleness stops a chunk mid-way; the stale substep runs again as a
    rebuild, and the substeps after it in the chunk are discarded."""
    params, scene, state = cube
    cfg = dataclasses.replace(CFG, cand_slack=0.002)
    stats, host = both(params, scene, state, cfg, params.max_dt, 3.0e38)
    assert any(kind == "stale" and n % 4 for n, kind in host["events"])
    assert stats["rebuilds"] > SUBSTEPS // 4 and host["wasted"] > 0


def test_retry_at_the_rebuild_substep(cube):
    params, scene, state = cube
    stats, host = both(params, scene, state, CFG, 10 * params.max_dt, 3.0e38)
    assert (0, "retry") in host["events"]


def test_retry_and_staleness_mid_chunk(cube):
    params, scene, state = cube
    stats, host = both(params, scene, converging(state, 30.0), CFG, params.max_dt, 3.0e38)
    kinds = {kind for n, kind in host["events"] if n % 4}
    assert {"retry", "stale"} <= kinds


def test_time_runs_out_mid_chunk(cube):
    params, scene, state = cube
    dt0 = np.float32(params.max_dt / 4)
    stats, host = both(params, scene, state, CFG, dt0, dt0 + 1.5 * np.float32(params.max_dt))
    (n, kind), = host["events"]
    assert kind == "time" and n % 4 and not host["more"]
    assert stats["substeps"] == n


def test_capacity_flag_mid_dispatch(cube):
    params, scene, state = cube
    cfg = dataclasses.replace(CFG, max_candidates_hit8=8)
    stats, host = both(params, scene, converging(state, 5.0), cfg, params.max_dt, 3.0e38)
    assert host["flags"] & FLAG_CAPACITY_HIT


def test_untimed_dispatch_with_staleness_equals_the_timed_one(cube):
    """With no time kept, a staleness stop leaves the next chunks to their
    own reads: the same decisions as with a time left that never runs
    out (3.0e38 less any dt stays 3.0e38 in float32)."""
    params, scene, state = cube
    cfg = dataclasses.replace(CFG, cand_slack=0.02, substeps_per_dispatch=12)
    slack2 = torch.tensor((cfg.cand_slack * params.h) ** 2, dtype=torch.float32)

    def run(st, d, n, tables, rebuild):
        if rebuild:
            return step.substep(st, d, params, scene, cfg, do_sort=n % cfg.sort_interval == 0,
                                speculative=True)
        return step.substep(st, d, params, scene, cfg, do_sort=False, cand_in=tables,
                            speculative=True)

    def stale(st, tables):
        return 4.0 * torch.amax(torch.sum((st.position - tables[2][: st.n]) ** 2, dim=1)) > slack2

    out = {}
    for name, tl in (("timed", torch.tensor(3.0e38)), ("untimed", None)):
        kinds, host = [], {}
        res = step.dispatch(state, torch.tensor(params.max_dt, dtype=torch.float32), tl,
                            cfg.substeps_per_dispatch, cfg.cand_interval, run, stale,
                            on_commit=lambda n, rebuild, *_: kinds.append((n, rebuild)),
                            host=host)
        out[name] = res, kinds, host
    (want, want_kinds, want_host), (got, got_kinds, got_host) = out["timed"], out["untimed"]
    assert got_kinds == want_kinds and [n for n, _ in got_kinds] == list(range(12))
    assert got_host["events"] == want_host["events"]
    # a stale stop mid-dispatch, and reuses after it
    (stop, kind), = got_host["events"]
    assert kind == "stale" and not all(rebuild for n, rebuild in got_kinds[stop + 1:])
    for k in FIELDS:
        assert torch.equal(getattr(got[0], k), getattr(want[0], k)), k
    assert torch.equal(got[1], want[1]) and torch.equal(got[3], want[3])


def matched(pos_a, pos_b):
    """Row of ``pos_b`` nearest each row of ``pos_a`` (one to one)."""
    dist, idx = cKDTree(pos_b).query(pos_a)
    assert np.unique(idx).shape[0] == idx.shape[0]
    return dist, idx


def test_sharded_frame_equals_its_old_loop_and_the_single_chip_frame(cube):
    params, _, state = cube
    world = 2
    cfg = dataclasses.replace(CFG, force_sub8=False)
    shards = interop.split_for_mesh(sharded_step.pad_for_mesh(state, params, world, cfg),
                                    world)
    ranks = mesh.launch(ref.frame_pair, world, device="cpu", timeout=240, threads=1,
                        args=(shards, params, cfg, "all_gather", 0, params.max_dt, 3.0e38))
    for r in ranks:
        want, got = r["ref"], r["new"]
        for k in FIELDS:
            np.testing.assert_array_equal(got["state"][k], want["state"][k])
        assert (got["dt"], got["timeleft"], got["flags"]) == (
            want["dt"], want["timeleft"], want["flags"])
        assert got["stats"] == want["stats"] and got["flags"] == 0
        assert got["host"]["events"] == [] and got["host"]["reads"] == SUBSTEPS // 4 + 1
    assert len({r["new"]["dt"] for r in ranks}) == 1

    # the single-chip frame from the same state, matched by position
    single = step.frame(state, torch.tensor(params.max_dt, dtype=torch.float32),
                        torch.tensor(3.0e38), params, None, cfg)
    want = checkpoint.state_to_arrays(single[0])
    got = {k: np.concatenate([r["new"]["state"][k] for r in ranks]) for k in FIELDS}
    real = np.abs(got["position"]).max(axis=1) < 1e30
    dist, idx = matched(want["position"], got["position"][real])
    assert dist.max() < 1e-5
    np.testing.assert_allclose(got["density"][real][idx], want["density"], rtol=1e-5)
    a = want["acceleration"]
    np.testing.assert_allclose(got["acceleration"][real][idx], a, atol=5e-4 * np.abs(a).max())
    assert ranks[0]["new"]["dt"] == pytest.approx(float(single[1]), rel=1e-5)


@pytest.mark.parametrize("case", ["stale", "retry"])
def test_sharded_frame_stops_equal_its_old_loop(cube, case):
    """Stops whose predicates come from the all-reduce: staleness (a small
    ``cand_slack``), replayed as a rebuild, and a dt retry at the rebuild
    substep (a first dt ten times ``max_dt``), whose retry loop runs on."""
    params, _, state = cube
    world = 2
    cfg = dataclasses.replace(CFG, force_sub8=False)
    dt = params.max_dt
    if case == "stale":
        cfg = dataclasses.replace(cfg, cand_slack=0.002)
    else:
        dt = 10 * params.max_dt
    shards = interop.split_for_mesh(sharded_step.pad_for_mesh(state, params, world, cfg),
                                    world)
    ranks = mesh.launch(ref.frame_pair, world, device="cpu", timeout=240, threads=1,
                        args=(shards, params, cfg, "all_gather", 0, dt, 3.0e38))
    for r in ranks:
        want, got = r["ref"], r["new"]
        for k in FIELDS:
            np.testing.assert_array_equal(got["state"][k], want["state"][k])
        assert (got["dt"], got["timeleft"], got["flags"]) == (
            want["dt"], want["timeleft"], want["flags"])
        assert got["stats"] == want["stats"]
        assert any(kind == case for _, kind in got["host"]["events"])
    assert ranks[0]["new"]["host"]["events"] == ranks[1]["new"]["host"]["events"]
