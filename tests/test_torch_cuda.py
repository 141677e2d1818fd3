"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marked ``cuda``; they skip without a GPU).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider -q

Inputs: a random cloud made with numpy from a fixed seed, padded,
sorted and tabled by the port's own main path on the CPU, then moved to
the card. Tolerances: density rtol 1e-5 and acceleration atol 1e-5 *
max|a| (float32 summation order); hit counts are integers and must be
equal (both sides round r^2 without fused multiply-adds).
"""

import numpy as np
import pytest
import torch

from libclsph_tpu_torch.core.params import derive_parameters
from libclsph_tpu_torch.core.state import ParticleState
from libclsph_tpu_torch.engine import step
from libclsph_tpu_torch.ops.interactions import tait_pressure
from libclsph_tpu_torch.ops.kernels import density, forces

WATER = dict(fluid_density=998.29, dynamic_viscosity=3.5, restitution=0, k=100,
             surface_tension_threshold=7.065, surface_tension=0.0728,
             particles_inside_influence_radius=20)
N = 8000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tables():
    params = derive_parameters(WATER, dict(
        particles_count=N, particle_mass=0.05, simulation_time=1, target_fps=60,
        simulation_scale=0.1, constant_acceleration=dict(x=0, y=-9.8, z=0)))
    rng = np.random.default_rng(8)
    side = params.initial_volume ** (1 / 3) * 1.3
    pos = torch.as_tensor(((rng.random((N, 3)) - 0.5) * side).astype(np.float32))
    pos[1] = pos[0]  # a coincident pair: the spiky r -> 0 branch
    vel = torch.as_tensor(rng.normal(size=(N, 3)).astype(np.float32))
    st = ParticleState.zeros(N, "cpu").replace(position=pos, velocity=vel,
                                                intermediate_velocity=vel)
    cfg = step.StepConfig()
    st, real, _ = step.pad_and_sort(st, params, True)
    cand_sub, count_sub, flags = step.build_candidates(st, real, params, cfg)
    pos4 = density.pos_pack(st.position, real)
    dens, hits = density.density_c16_hit8_torch(pos4, cand_sub, count_sub, params)
    cand8, count8, hflags = step.hit_lists(cand_sub, hits, cfg)
    assert int(flags) == 0 and int(hflags) == 0
    pres = torch.where(real, tait_pressure(dens, params), 0.0)
    f8 = forces.force_pack(st.position, st.velocity, dens, pres, real,
                           params.particle_mass)
    return dict(params=params, pos4=pos4, cand_sub=cand_sub, count_sub=count_sub,
                dens=dens, real=real, cand8=cand8, count8=count8, f8=f8)


@pytest.mark.cuda
def test_density_kernel_matches_plain(tables, cuda):
    t = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v for k, v in tables.items()}
    args = (t["pos4"], t["cand_sub"], t["count_sub"], t["params"])
    before = density.density_c16_hit8.launches
    d, hits = density.density_c16_hit8(*args)
    torch.cuda.synchronize()
    assert density.density_c16_hit8.launches == before + 1
    d0, hits0 = density.density_c16_hit8_torch(*args)
    np.testing.assert_allclose(d.cpu().numpy(), d0.cpu().numpy(), rtol=1e-5)
    assert torch.equal(hits, hits0)


@pytest.mark.cuda
def test_force_kernel_matches_plain(tables, cuda):
    t = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v for k, v in tables.items()}
    args = (t["f8"], t["dens"], t["real"], t["cand8"], t["count8"], t["params"])
    before = forces.forces_q32_c8.launches
    a = forces.forces_q32_c8(*args)
    torch.cuda.synchronize()
    assert forces.forces_q32_c8.launches == before + 1
    a0 = forces.forces_q32_c8_torch(*args).cpu().numpy()
    np.testing.assert_allclose(a.cpu().numpy(), a0, atol=1e-5 * np.abs(a0).max())


@pytest.mark.cuda
def test_substep_on_gpu_matches_cpu(tables, cuda):
    """A whole main-path substep on the card (kernels) against the same
    substep on the CPU (plain versions)."""
    p = tables["params"]
    rng = np.random.default_rng(9)
    side = p.initial_volume ** (1 / 3) * 1.3
    pos = torch.as_tensor(((rng.random((N, 3)) - 0.5) * side).astype(np.float32))
    st = ParticleState.zeros(N, "cpu").replace(position=pos)
    dt = torch.tensor(p.max_dt, dtype=torch.float32)
    cfg = step.StepConfig()
    c1, cd, cf, _ = step.substep(st, dt, p, None, cfg)
    g1, gd, gf, _ = step.substep(st.map(lambda a: a.to(cuda)), dt.to(cuda), p, None, cfg)
    assert int(cf) == int(gf) == 0
    torch.testing.assert_close(g1.grid_index.cpu(), c1.grid_index)
    np.testing.assert_allclose(g1.density.cpu().numpy(), c1.density.numpy(), rtol=1e-5)
    a = c1.acceleration.numpy()
    np.testing.assert_allclose(g1.acceleration.cpu().numpy(), a, atol=1e-5 * np.abs(a).max())
