"""The fidelity runners' float64 oracles and comparisons
(``experiments/torch_fidelity_64k.py``, ``torch_fidelity_collision.py``)
at a small n on the CPU: the production path stays under the 1e-4 RMS
bar in free space and with collisions active, and each comparison
catches an acceleration scaled by 1 + 1e-3 on one row."""

import os
import sys

import numpy as np
import pytest
import torch

import bench_torch
from libclsph_tpu_torch.core.state import init_state
from libclsph_tpu_torch.engine.simulation import SPHSimulation
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

sys.path.insert(0, os.path.join(bench_torch.ROOT, "experiments"))
import torch_fidelity_64k as free  # noqa: E402
import torch_fidelity_collision as coll  # noqa: E402

N = 2048
ROWS = 16


def planted(out, rows):
    """``out`` with the acceleration of its largest sampled row scaled by
    1 + 1e-3."""
    acc = out.acceleration.clone()
    r = rows[int(torch.argmax(acc[torch.as_tensor(rows)].abs().amax(dim=1)))]
    acc[r] *= 1.0 + 1e-3
    return out.replace(acceleration=acc)


@pytest.fixture(scope="module")
def free_space():
    params = bench_torch.build_params(N)
    engine = SPHSimulation(device="cpu", pretune=False)
    state, dt = bench_torch.warm_up(init_state(params, "cpu"), params, None, engine, 4)
    return state, free.probe(state, dt, params, None, engine), params


@pytest.fixture(scope="module")
def on_the_floor():
    """A lattice whose bottom layer rests 0.012 above box.obj's floor,
    moving down at 0.5 m/s: the layer collides on the probe substep."""
    params = bench_torch.build_params(N)
    scene = coll.load_scene("box", params, "cpu")
    st = init_state(params, "cpu")
    pos = st.position.clone()
    pos[:, 1] += -1.5 + 0.012 - pos[:, 1].min()
    vel = torch.zeros_like(pos)
    vel[:, 1] = -0.5
    st = st.replace(position=pos, velocity=vel, intermediate_velocity=vel.clone())
    dt = torch.tensor(params.max_dt, dtype=torch.float32)
    engine = SPHSimulation(device="cpu", pretune=False)
    out = free.probe(st, dt, params, scene, engine, adaptive_dt=False)
    return st, out, params, scene, dt, coll.sample_rows(st, dt, scene, ROWS)


def test_free_space_under_the_bar(free_space):
    state, out, params = free_space
    errors = free.pair_errors(state, out, params, free.sample_rows(N, ROWS))
    assert free.passes(errors), errors
    assert errors["rows"] == ROWS and errors["density_max_rel"] < 1e-5


def test_free_space_catches_a_planted_error(free_space):
    state, out, params = free_space
    rows = free.sample_rows(N, ROWS)
    errors = free.pair_errors(state, planted(out, rows), params, rows)
    assert errors["accel_rms_rel"] >= free.BAR and not free.passes(errors), errors


def test_collision_chain_under_the_bar(on_the_floor):
    st, out, params, scene, dt, rows = on_the_floor
    errors = coll.chain_errors(st, out, params, scene, dt, rows)
    assert free.passes(errors), errors
    assert errors["position_rms_h"] < free.BAR and errors["velocity_rms_rel"] < free.BAR
    assert errors["collided"] >= len(rows) // 4 and coll.band_is_rare(errors), errors


def test_collision_chain_catches_a_planted_error(on_the_floor):
    st, out, params, scene, dt, rows = on_the_floor
    errors = coll.chain_errors(st, planted(out, rows), params, scene, dt, rows)
    assert errors["accel_rms_rel"] >= free.BAR and not free.passes(errors), errors


def test_sample_rows_mix_colliders(on_the_floor):
    st, _, _, scene, dt, rows = on_the_floor
    pred = coll.predicted_collisions(st, dt, scene)[1].numpy()
    assert len(rows) > ROWS // 2 and pred[rows].sum() >= ROWS // 2
    assert np.array_equal(rows, np.unique(rows))
