"""The block variants' force route on the CPU: ``fine`` (JAX's ``q_div``
4) runs ``forces_q128_c32`` over the expanded block table, as ``row``
and ``asym`` do, because a 128-row list shared by the block's four
32-row subgroups is the same function as the list repeated per
subgroup. Held here on the plain versions (the CUDA kernels are held to
the same bits in ``test_torch_cuda.py``):

* ``forces_q128_c32_torch`` over a block table equals
  ``forces_q32_c32_torch`` over the table repeated for the four
  subgroups, bit for bit, on a uniform and a clumped cloud, with and
  without a query-block map;
* ``forces_blocks`` at ``q_div`` 4 takes that route and no other on CPU
  tensors, and launches nothing.

Inputs: clouds made with numpy from fixed seeds, padded, sorted and
tabled by the port's block search at h.
"""

import numpy as np
import pytest
import torch

from libclsph_tpu_torch.core.params import derive_parameters
from libclsph_tpu_torch.core.state import ParticleState
from libclsph_tpu_torch.engine import step
from libclsph_tpu_torch.ops import tiles
from libclsph_tpu_torch.ops.interactions import tait_pressure
from libclsph_tpu_torch.ops.kernels import blocks, density, forces
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

WATER = dict(fluid_density=998.29, dynamic_viscosity=3.5, restitution=0, k=100,
             surface_tension_threshold=7.065, surface_tension=0.0728,
             particles_inside_influence_radius=20)
N = 3000


def _cloud(params, kind, rng):
    side = params.initial_volume ** (1 / 3) * 1.3
    pos = (rng.random((N, 3)) - 0.5) * side
    if kind == "clumped":  # a third of the particles in a ball of radius 2h
        ball = rng.normal(size=(N // 3, 3))
        ball *= 2 * params.h * rng.random((N // 3, 1)) / np.linalg.norm(ball, axis=1,
                                                                          keepdims=True)
        pos[: N // 3] = ball
    return pos.astype(np.float32)


@pytest.fixture(scope="module", params=["uniform", "clumped"])
def block_args(request):
    """(f8, density, real, block ids, counts, params) of a cloud, the
    block table from the block search at h."""
    p = derive_parameters(WATER, dict(
        particles_count=N, particle_mass=0.05, simulation_time=1, target_fps=60,
        simulation_scale=0.1, constant_acceleration=dict(x=0, y=-9.8, z=0)))
    rng = np.random.default_rng(31)
    pos = torch.as_tensor(_cloud(p, request.param, rng))
    vel = torch.as_tensor(rng.normal(size=(N, 3)).astype(np.float32))
    st = ParticleState.zeros(N, "cpu").replace(position=pos, velocity=vel,
                                               intermediate_velocity=vel)
    st, real, _ = step.pad_and_sort(st, p, True)
    nb = st.n // 128
    bmin, bmax = tiles.split_block_bounds(st.position.reshape(nb, 128, 3),
                                          real.reshape(nb, 128))
    cand, count, ovf = tiles.candidate_blocks_auto(bmin, bmax, p.h, 96)
    assert not bool(ovf)
    pos4 = density.pos_pack(st.position, real)
    dens = blocks.density_blocks_torch(pos4, cand, count, p)
    pres = torch.where(real, tait_pressure(dens, p), 0.0)
    f8 = forces.force_pack(st.position, st.velocity, dens, pres, real, p.particle_mass)
    return f8, dens, real, cand, count, p


@pytest.mark.parametrize("mapped", [False, True], ids=["identity", "qblock"])
def test_q128_block_table_equals_q32_repeated(block_args, mapped):
    f8, dens, real, cand, count, p = block_args
    ids, counts = blocks.expand_block_table(cand, count)
    qblock = None
    if mapped:  # every third block, in reverse order
        qblock = torch.arange(0, ids.shape[0], 3, dtype=torch.int32).flip(0)
        ids, counts = ids[qblock.long()].contiguous(), counts[qblock.long()].contiguous()
    a = forces.forces_q128_c32_torch(f8, dens, real, ids, counts, p, qblock=qblock)
    a32 = forces.forces_q32_c32_torch(f8, dens, real, ids.repeat_interleave(4, dim=0),
                                      counts.repeat_interleave(4), p, qblock=qblock)
    assert torch.equal(a, a32)
    assert float(a.abs().max()) > 0


def test_fine_takes_the_q128_route(block_args, monkeypatch):
    f8, dens, real, cand, count, p = block_args
    ids, counts = blocks.expand_block_table(cand, count)
    want = forces.forces_q128_c32_torch(f8, dens, real, ids, counts, p)

    def refuse(*args, **kw):
        raise AssertionError("fine ran the per-subgroup force kernel")

    monkeypatch.setattr(forces, "forces_q32_c32", refuse)
    monkeypatch.setattr(forces, "forces_q32_c32_torch", refuse)
    before = forces.forces_q128_c32.launches
    for q_div in (1, 4):
        assert torch.equal(blocks.forces_blocks(f8, dens, real, cand, count, p, q_div), want)
        assert torch.equal(blocks.forces_blocks_torch(f8, dens, real, cand, count, p, q_div),
                           want)
    assert forces.forces_q128_c32.launches == before
