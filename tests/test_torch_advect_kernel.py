"""The substep's advection kernel (``ops/kernels/advect.py``,
``csrc/advect_collide.cu``) against its plain PyTorch chain
(``advect_collide_torch``: ``integrate.advect``,
``collisions.handle_collisions``, ``integrate.reconstruct_velocities``,
``integrate.compute_time_step``).

On the card (marked ``cuda``; they skip without a GPU), bit for bit: the
new position, velocity and intermediate velocity, and dt_next, which the
two maxima set (each case's dt_next lies strictly inside its clamp, so
the maxima, and not a bound, give it). Cases: the cube scene with
particles on and through its walls, at restitution 0 and 0.5; free
flight; the 422-faced monkeybox, whose overlapping face boxes test the
"last face" rule; a particle count that is no multiple of the kernel's
256-thread block; a NaN velocity, which must reach dt_next; zero
accelerations (the 1e-12 floor); and the sharded step's call, without
the time step. Each advance is one launch. Both sides run the same
float32 operations in the same order on the card, so no tolerance is
needed: the 3-term sums inside ``torch.sum`` and
``torch.linalg.vector_norm`` are added by the kernel in the order that
PyTorch's reduction over a row of three takes on the card.

On the CPU: the wrapper takes the plain chain, bit for bit, and counts
no launch; its checks refuse a float64 or a non-contiguous input.

This file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_advect_kernel.py --noconftest -p no:cacheprovider -q
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from libclsph_tpu_torch.core.params import derive_parameters
from libclsph_tpu_torch.core.state import ParticleState
from libclsph_tpu_torch.engine import step
from libclsph_tpu_torch.ops import collisions, integrate
from libclsph_tpu_torch.ops.kernels import advect
from libclsph_tpu_torch.scene.scene import Scene
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUTS = ("position", "velocity", "intermediate_velocity", "dt_next")
# the cube's face boxes span |x|, |z| <= 0.63 and -1.63 <= y <= -0.37
CUBE_SPAN = (np.array([-0.7, -1.7, -0.7]), np.array([0.7, -0.3, 0.7]))
MONKEYBOX_SPAN = (np.array([-2.7, -1.8, -2.7]), np.array([2.7, 2.7, 2.7]))


def water(n=65536):
    fluid = json.load(open(os.path.join(ROOT, "fluid_properties", "water.json")))
    sim = json.load(open(os.path.join(ROOT, "simulation_properties", "bench64k.json")))
    return derive_parameters(fluid, dict(sim, particles_count=n))


def scene_on(name, params, dev):
    return collisions.build_device_scene(
        Scene.load(name, params.h * 2.0, scenes_dir=os.path.join(ROOT, "scenes")), dev)


def particles(n, seed, span, dev, speed=8.0, accel=2000.0):
    """Positions uniform over ``span``, normal intermediate velocities
    and accelerations: at these scales dt_next is neither clamp."""
    rng = np.random.default_rng(seed)
    lo, hi = span
    x = lo + rng.random((n, 3)) * (hi - lo)
    w = rng.normal(size=(n, 3)) * speed
    a = rng.normal(size=(n, 3)) * accel
    return tuple(torch.as_tensor(t.astype(np.float32), device=dev) for t in (x, w, a))


def advance(x, w, a, dt, scene, params, time_step=True):
    """The kernel's advance (one launch, counted) and the plain chain's,
    on the same inputs."""
    before = advect.advect_collide.launches
    got = advect.advect_collide(x, w, a, dt, scene, params, time_step=time_step)
    torch.cuda.synchronize()
    assert advect.advect_collide.launches == before + 1
    want = advect.advect_collide_torch(x, w, a, dt, scene, params, time_step=time_step)
    return got, want


def assert_bits(got, want):
    """Equal bits, NaN where NaN."""
    for name, g, e in zip(OUTPUTS, got, want):
        if e is None:
            assert g is None, name
            continue
        assert g.shape == e.shape and g.dtype == e.dtype, name
        nan = torch.isnan(e)
        assert torch.equal(torch.isnan(g), nan), f"{name}: NaN at other places"
        gb, eb = g[~nan].view(torch.int32), e[~nan].view(torch.int32)
        diff = int((gb != eb).sum())
        ulps = int((gb.to(torch.int64) - eb.to(torch.int64)).abs().max()) if gb.numel() else 0
        assert diff == 0, f"{name}: {diff} of {gb.numel()} differ, by up to {ulps} ulp"


def collided(x, w, a, dt, scene, params):
    adv = integrate.advect(x, w, a, dt)
    return int(collisions.handle_collisions(scene, x, adv.new_position, adv.next_velocity,
                                            params.restitution, dt).collision_happened.sum())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_scenes():
    """The cube and the monkeybox baked on the card (built on first use,
    by a test that has a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    params = water()
    return dict(params=params, cube=scene_on("cube.obj", params, "cuda"),
                monkeybox=scene_on("monkeybox.obj", params, "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("restitution", [0.0, 0.5])
@pytest.mark.parametrize("n", [65536, 65536 + 77])
def test_cube_bit_for_bit(cuda, card_scenes, restitution, n):
    params = dataclasses.replace(card_scenes["params"], restitution=restitution)
    scene = card_scenes["cube"]
    x, w, a = particles(n, 1, CUBE_SPAN, cuda)
    dt = torch.tensor(1.3e-3, dtype=torch.float32, device=cuda)
    assert collided(x, w, a, dt, scene, params) > 1000  # the response runs
    got, want = advance(x, w, a, dt, scene, params)
    assert integrate.DT_MIN < float(want[3]) < params.max_dt
    assert_bits(got, want)


@pytest.mark.cuda
def test_free_flight_bit_for_bit(cuda, card_scenes):
    params = card_scenes["params"]
    x, w, a = particles(100_003, 2, CUBE_SPAN, cuda)
    dt = torch.tensor(1.1e-3, dtype=torch.float32, device=cuda)
    got, want = advance(x, w, a, dt, None, params)
    assert integrate.DT_MIN < float(want[3]) < params.max_dt
    assert_bits(got, want)


@pytest.mark.cuda
def test_monkeybox_last_face(cuda, card_scenes):
    """422 faces whose boxes overlap: the last box holding a particle is
    the one whose distance field answers."""
    params = dataclasses.replace(card_scenes["params"], restitution=0.5)
    scene = card_scenes["monkeybox"]
    assert scene.face_count == 422
    x, w, a = particles(200_000, 3, MONKEYBOX_SPAN, cuda)
    dt = torch.tensor(1.3e-3, dtype=torch.float32, device=cuda)
    moved = x + (w + a * dt) * dt
    boxes = ((moved[:, None] <= scene.bb_max) & (moved[:, None] >= scene.bb_min)).all(-1)
    assert int((boxes.sum(1) >= 2).sum()) > 1000  # particles in overlapping boxes
    assert collided(x, w, a, dt, scene, params) > 100
    got, want = advance(x, w, a, dt, scene, params)
    assert integrate.DT_MIN < float(want[3]) < params.max_dt
    assert_bits(got, want)


@pytest.mark.cuda
def test_nan_velocity_reaches_dt(cuda, card_scenes):
    params = card_scenes["params"]
    x, w, a = particles(4099, 4, CUBE_SPAN, cuda)
    w[1234, 1] = float("nan")
    dt = torch.tensor(1.3e-3, dtype=torch.float32, device=cuda)
    got, want = advance(x, w, a, dt, card_scenes["cube"], params)
    assert torch.isnan(want[3]) and torch.isnan(got[3])
    assert_bits(got, want)


@pytest.mark.cuda
def test_zero_acceleration(cuda, card_scenes):
    """a_max 0 takes the 1e-12 floor, and dt_next, whose numerator then
    rounds to 0, the DT_MIN clamp."""
    params = card_scenes["params"]
    x, w, _ = particles(5000, 5, CUBE_SPAN, cuda, speed=40.0)
    dt = torch.tensor(1.3e-3, dtype=torch.float32, device=cuda)
    got, want = advance(x, w, torch.zeros_like(x), dt, card_scenes["cube"], params)
    assert float(want[3]) == float(torch.tensor(integrate.DT_MIN, dtype=torch.float32))
    assert_bits(got, want)


@pytest.mark.cuda
def test_sharded_call_without_time_step(cuda, card_scenes):
    """``parallel/sharded_step.py``'s call: ``_advect_collide`` with the
    time step off (the ranks reduce their own maxima)."""
    params = card_scenes["params"]
    x, w, a = particles(4096 + 128, 6, CUBE_SPAN, cuda)
    state = ParticleState.zeros(x.shape[0], cuda).replace(
        position=x, intermediate_velocity=w, acceleration=a)
    dt = torch.tensor(1.3e-3, dtype=torch.float32, device=cuda)
    before = advect.advect_collide.launches
    new, dt_next = step._advect_collide(state, card_scenes["cube"], dt, params,
                                        time_step=False)
    torch.cuda.synchronize()
    assert advect.advect_collide.launches == before + 1 and dt_next is None
    want = advect.advect_collide_torch(x, w, a, dt, card_scenes["cube"], params,
                                       time_step=False)
    assert_bits((new.position, new.velocity, new.intermediate_velocity, None), want)
    assert torch.equal(new.acceleration, a) and torch.equal(new.density, state.density)


@pytest.fixture(scope="module")
def cpu_case():
    params = dataclasses.replace(water(4096), restitution=0.5)
    x, w, a = particles(4096, 7, CUBE_SPAN, "cpu")
    dt = torch.tensor(1.3e-3, dtype=torch.float32)
    return params, scene_on("cube.obj", params, "cpu"), x, w, a, dt


@pytest.mark.parametrize("time_step", [True, False])
def test_cpu_takes_the_plain_chain(cpu_case, time_step):
    params, scene, x, w, a, dt = cpu_case
    before = advect.advect_collide.launches
    got = advect.advect_collide(x, w, a, dt, scene, params, time_step=time_step)
    assert advect.advect_collide.launches == before
    adv = integrate.advect(x, w, a, dt)
    resp = collisions.handle_collisions(scene, x, adv.new_position, adv.next_velocity,
                                        params.restitution, dt)
    assert int(resp.collision_happened.sum()) > 50
    vel, inter = integrate.reconstruct_velocities(w, resp.next_velocity)
    want = (resp.position, vel, inter,
            integrate.compute_time_step(vel, a, params) if time_step else None)
    assert_bits(got, want)


@pytest.mark.parametrize("bad", ["float64", "strided"])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_wrapper_refuses(cpu_case, bad, which):
    params, scene, x, w, a, dt = cpu_case
    args = [x, w, a]
    t = args[which]
    args[which] = t.double() if bad == "float64" else torch.cat([t, t], 1)[:, ::2]
    assert not args[which].is_contiguous() or bad == "float64"
    with pytest.raises(ValueError):
        advect.advect_collide(*args, dt, scene, params)
