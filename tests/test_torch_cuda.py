"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marked ``cuda``; they skip without a GPU): the main path's two,
the q-granular path's three (``density_c32`` at 4 and 1 hit rows per
block, ``forces_q32_c32``, ``forces_q128_c32``), the 16-wide force
path's (``density_c16`` at hit_sub 16 with and without the dilated tile
counts, ``density_c32`` at hit_sub 16, ``forces_q32_c16``,
``density_gated16`` against the ungated kernel bit for bit), the
query-block map of all of them, and whole substeps of the main, q32 +
tier-2, q128 and 16-wide configurations; the block-granular passes of
the row, fine and asym variants (``ops.kernels.blocks``) with their
launch counts, the rank kernel of the radix sort bit for bit
(``radix_rank``), the fused radix sort against ``torch.sort``, and whole
substeps of the row, fine, asym, asm and exact configurations. The
edge cases of the warp-per-list designs of ``density_c16`` and
``forces_q32`` (lists of unequal length in one thread block, one of them
empty; counts that are no multiple of a staging round; a candidate
inside the support of exactly one query of its subgroup and a coincident
pair; the query-block map), and ``density_c16`` at hit_sub 16 bit for
bit against ``density_gated16`` with every panel flagged. The edge
cases of ``density_gated16``'s gated mode (a zero mask, one set bit,
alternating nibbles, a capacity that is no multiple of a tile or a mask
word with counts crossing a word, empty lists) and of
``forces_q128_c32``'s warp-per-subgroup design (pairs closer than the
spiky guard, self-exclusion under the query-block map, padding queries,
empty lists), each also bit for bit against ``forces_q32_c32`` over the
list repeated per subgroup, which is the ``fine`` route's old kernel.
The mesh: two ranks that share the card (gloo, staged through host
buffers), their collectives and one sharded substep against two CPU
ranks. The stream kernels (``ops.kernels.stream``) on the 64k cube
lattice's hit lists: ``gather_stream`` bit for bit at 8, 16 and 32
particles a slot in both layouts, and ``forces_c32_stream``'s sums
(staged, planes, no cull; each sum within rtol 1e-5 and atol 1e-5 of its
largest |value|), its accel mode bit for bit against ``forces_q128_c32``,
its test mode's counts and the zero-count control; every mode at a cap
that is no multiple of the force kernel's 4-slot tile; both kernels bit
for bit against the parent build's, where its sources are unpacked in
``build/parent_csrc``. The frame loop's dispatch layer on the 1M cube:
one synchronising call a clean chunk, by ``set_sync_debug_mode``.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider -q

Inputs: a random cloud made with numpy from a fixed seed, padded,
sorted and tabled by the port's own candidate machinery on the CPU
(the q-granular tables on a cloud with a dense clump), then moved to
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
from libclsph_tpu_torch.ops import radix_sort
from libclsph_tpu_torch.ops import tiles as tiles_ops
from libclsph_tpu_torch.ops.kernels import blocks, density, forces, radix
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

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
    dens, hits = density.density_c16_torch(pos4, cand_sub, count_sub, params)
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
    before = density.density_c16.launches
    d, hits = density.density_c16(*args)
    torch.cuda.synchronize()
    assert density.density_c16.launches == before + 1
    d0, hits0 = density.density_c16_torch(*args)
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


def _clumped_state(params, seed):
    rng = np.random.default_rng(seed)
    side = params.initial_volume ** (1 / 3) * 1.3
    pos = ((rng.random((N, 3)) - 0.5) * side).astype(np.float32)
    k = N // 5  # a clump of side h: heavy blocks for the tier-2 pool
    pos[:k] = (rng.random((k, 3)).astype(np.float32) - 0.5) * params.h + pos[-1]
    pos[1] = pos[0]  # a coincident pair: the spiky r -> 0 branch
    vel = rng.normal(size=(N, 3)).astype(np.float32)
    return ParticleState.zeros(N, "cpu").replace(
        position=torch.as_tensor(pos), velocity=torch.as_tensor(vel),
        intermediate_velocity=torch.as_tensor(vel))


Q_PATH = dict(density_sub16=False, force_sub16=False, force_sub8=False,
              max_candidates_hit=256)


@pytest.fixture(scope="module")
def q_tables(tables):
    params = tables["params"]
    cfg = step.StepConfig(**Q_PATH)
    st, real, _ = step.pad_and_sort(_clumped_state(params, 12), params, True)
    cand_sub, count_sub, flags = step.build_candidates(st, real, params, cfg)
    assert int(flags) == 0
    pos4 = density.pos_pack(st.position, real)
    dens, hits4 = density.density_c32_torch(pos4, cand_sub, count_sub, params, groups=4)
    _, hits1 = density.density_c32_torch(pos4, cand_sub, count_sub, params, groups=1)
    cand32, count32, f32 = step.hit_lists(cand_sub, hits4, cfg, 4)
    cand128, count128, f128 = step.hit_lists(cand_sub, hits1, cfg, 1)
    assert int(f32) == 0 and int(f128) == 0
    pres = torch.where(real, tait_pressure(dens, params), 0.0)
    f8 = forces.force_pack(st.position, st.velocity, dens, pres, real, params.particle_mass)
    return dict(params=params, pos4=pos4, cand_sub=cand_sub, count_sub=count_sub,
                dens=dens, real=real, f8=f8, cand32=cand32, count32=count32,
                cand128=cand128, count128=count128)


def _pool(nb, device):
    return torch.arange(0, nb, 8, dtype=torch.int32, device=device).flip(0)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [4, 1])
@pytest.mark.parametrize("mapped", [False, True], ids=["identity", "qblock"])
def test_density_c32_matches_plain(q_tables, cuda, groups, mapped):
    t = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v for k, v in q_tables.items()}
    cand, count = t["cand_sub"], t["count_sub"]
    qblock = None
    if mapped:
        qblock = _pool(cand.shape[0], cuda)
        cand, count = cand[qblock.long()].contiguous(), count[qblock.long()].contiguous()
    args = (t["pos4"], cand, count, t["params"])
    before = density.density_c32.launches
    d, hits = density.density_c32(*args, groups=groups, qblock=qblock)
    torch.cuda.synchronize()
    assert density.density_c32.launches == before + 1
    d0, hits0 = density.density_c32_torch(*args, groups=groups, qblock=qblock)
    np.testing.assert_allclose(d.cpu().numpy(), d0.cpu().numpy(), rtol=1e-5)
    assert torch.equal(hits, hits0) and int(hits0.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["forces_q32_c32", "forces_q128_c32", "forces_q32_c8"])
@pytest.mark.parametrize("mapped", [False, True], ids=["identity", "qblock"])
def test_force_kernels_match_plain(q_tables, tables, cuda, name, mapped):
    src = tables if name == "forces_q32_c8" else q_tables
    t = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v for k, v in src.items()}
    cand, count = {"forces_q32_c32": ("cand32", "count32"),
                   "forces_q128_c32": ("cand128", "count128"),
                   "forces_q32_c8": ("cand8", "count8")}[name]
    cand, count = t[cand], t[count]
    lists = 1 if name == "forces_q128_c32" else 4
    qblock = None
    if mapped:
        qblock = _pool(t["f8"].shape[0] // 128, cuda)
        rows = (qblock.long()[:, None] * lists + torch.arange(lists, device=cuda)).reshape(-1)
        cand, count = cand[rows].contiguous(), count[rows].contiguous()
    fn = getattr(forces, name)
    args = (t["f8"], t["dens"], t["real"], cand, count, t["params"])
    before = fn.launches
    a = fn(*args, qblock=qblock)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    a0 = getattr(forces, name + "_torch")(*args, qblock=qblock).cpu().numpy()
    np.testing.assert_allclose(a.cpu().numpy(), a0, atol=1e-5 * np.abs(a0).max())


@pytest.mark.cuda
def test_density_c16_qblock_matches_plain(tables, cuda):
    t = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v for k, v in tables.items()}
    qblock = _pool(t["cand_sub"].shape[0], cuda)
    args = (t["pos4"], t["cand_sub"][qblock.long()].contiguous(),
            t["count_sub"][qblock.long()].contiguous(), t["params"])
    d, hits = density.density_c16(*args, qblock=qblock)
    torch.cuda.synchronize()
    d0, hits0 = density.density_c16_torch(*args, qblock=qblock)
    np.testing.assert_allclose(d.cpu().numpy(), d0.cpu().numpy(), rtol=1e-5)
    assert torch.equal(hits, hits0)


@pytest.mark.cuda
@pytest.mark.parametrize("over", [
    dict(max_candidates_sub=100, tier2_frac=2, tier2_mult=2, max_candidates_hit8=160),
    dict(Q_PATH, max_candidates_sub=60, tier2_frac=2, tier2_mult=2),
    dict(Q_PATH, force_query_rows=128),
    # both tiers' forces_q128_c32 over their full refined lists
    dict(Q_PATH, hit_compact=False, max_candidates_sub=60, tier2_frac=2, tier2_mult=2),
], ids=["main-tier2", "q32-tier2", "q128", "no-hit-compact-tier2"])
def test_q_and_tier2_substeps_on_gpu_match_cpu(tables, cuda, over):
    """Whole substeps of the other configurations on the card (kernels)
    against the CPU (plain versions), on the clumped cloud."""
    p = tables["params"]
    st = _clumped_state(p, 13)
    dt = torch.tensor(p.max_dt, dtype=torch.float32)
    cfg = step.StepConfig(**over)
    c1, _, cf, _ = step.substep(st, dt, p, None, cfg)
    g1, _, gf, _ = step.substep(st.map(lambda a: a.to(cuda)), dt.to(cuda), p, None, cfg)
    assert int(cf) == int(gf) == 0
    torch.testing.assert_close(g1.grid_index.cpu(), c1.grid_index)
    np.testing.assert_allclose(g1.density.cpu().numpy(), c1.density.numpy(), rtol=1e-5)
    a = c1.acceleration.numpy()
    np.testing.assert_allclose(g1.acceleration.cpu().numpy(), a, atol=1e-5 * np.abs(a).max())


SUB16 = dict(force_sub8=False, max_candidates_hit16=192)


@pytest.fixture(scope="module")
def sub16_tables(tables):
    """The 16-wide force path's inputs on the main fixture's cloud: the
    c16 table at hit_sub 16, its 16-wide lists and force pack."""
    p = tables["params"]
    cfg = step.StepConfig(**SUB16)
    _, hits16 = density.density_c16_torch(tables["pos4"], tables["cand_sub"],
                                          tables["count_sub"], p, hit_sub=16)
    cand16, count16, flags = step.hit_lists(tables["cand_sub"], hits16, cfg)
    assert int(flags) == 0
    return dict(tables, cand16=cand16, count16=count16)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["hit16", "hit16+tiles"])
@pytest.mark.parametrize("mapped", [False, True], ids=["identity", "qblock"])
def test_density_c16_hit16_matches_plain(tables, cuda, mode, mapped):
    t = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v for k, v in tables.items()}
    cand, count = t["cand_sub"], t["count_sub"]
    qblock = None
    if mapped:
        qblock = _pool(cand.shape[0], cuda)
        cand, count = cand[qblock.long()].contiguous(), count[qblock.long()].contiguous()
    args = (t["pos4"], cand, count, t["params"])
    hit2_h = 1.25 * t["params"].h if mode == "hit16+tiles" else None
    before = density.density_c16.launches
    out = density.density_c16(*args, hit_sub=16, hit2_h=hit2_h, qblock=qblock)
    torch.cuda.synchronize()
    assert density.density_c16.launches == before + 1
    ref = density.density_c16_torch(*args, hit_sub=16, hit2_h=hit2_h, qblock=qblock)
    np.testing.assert_allclose(out[0].cpu().numpy(), ref[0].cpu().numpy(), rtol=1e-5)
    assert len(out) == len(ref)
    for a, b in zip(out[1:], ref[1:]):
        assert torch.equal(a, b) and int(b.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mapped", [False, True], ids=["identity", "qblock"])
def test_density_c32_hit16_matches_plain(q_tables, cuda, mapped):
    t = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v for k, v in q_tables.items()}
    cand, count = t["cand_sub"], t["count_sub"]
    qblock = None
    if mapped:
        qblock = _pool(cand.shape[0], cuda)
        cand, count = cand[qblock.long()].contiguous(), count[qblock.long()].contiguous()
    args = (t["pos4"], cand, count, t["params"])
    d, hits = density.density_c32(*args, hit_sub=16, qblock=qblock)
    torch.cuda.synchronize()
    d0, hits0 = density.density_c32_torch(*args, hit_sub=16, qblock=qblock)
    np.testing.assert_allclose(d.cpu().numpy(), d0.cpu().numpy(), rtol=1e-5)
    assert torch.equal(hits, hits0) and int(hits0.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mapped", [False, True], ids=["identity", "qblock"])
def test_forces_q32_c16_matches_plain(sub16_tables, cuda, mapped):
    t = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v for k, v in sub16_tables.items()}
    cand, count = t["cand16"], t["count16"]
    qblock = None
    if mapped:
        qblock = _pool(t["f8"].shape[0] // 128, cuda)
        rows = (qblock.long()[:, None] * 4 + torch.arange(4, device=cuda)).reshape(-1)
        cand, count = cand[rows].contiguous(), count[rows].contiguous()
    args = (t["f8"], t["dens"], t["real"], cand, count, t["params"])
    before = forces.forces_q32_c16.launches
    a = forces.forces_q32_c16(*args, qblock=qblock)
    torch.cuda.synchronize()
    assert forces.forces_q32_c16.launches == before + 1
    a0 = forces.forces_q32_c16_torch(*args, qblock=qblock).cpu().numpy()
    np.testing.assert_allclose(a.cpu().numpy(), a0, atol=1e-5 * np.abs(a0).max())


@pytest.mark.cuda
def test_density_gated16_equals_ungated_bitwise(tables, cuda):
    """A c16 table built at (1 + slack) h and its mask; positions moved by
    up to 0.1 h: the gated kernel equals the ungated one bit for bit and
    its plain version."""
    p = tables["params"]
    cfg = step.StepConfig(**SUB16, cand_interval=4)
    rng = np.random.default_rng(14)
    st = _clumped_state(p, 15)
    st, real, _ = step.pad_and_sort(st, p, True)
    cand, count, flags = step.build_candidates(st, real, p, cfg)
    assert int(flags) == 0
    pos4 = density.pos_pack(st.position, real).to(cuda)
    cand, count = cand.to(cuda), count.to(cuda)
    _, _, tiles = density.density_c16(pos4, cand, count, p, hit_sub=16,
                                      hit2_h=p.h * (1 + cfg.cand_slack))
    mask = density.pack_tile_nibbles(tiles)
    step_ = torch.as_tensor(rng.uniform(-1, 1, st.position.shape).astype(np.float32))
    moved = density.pos_pack((st.position + 0.057 * p.h * step_), real).to(cuda)
    before = density.density_gated16.launches
    d, hits = density.density_gated16(moved, cand, count, mask, p)
    torch.cuda.synchronize()
    assert density.density_gated16.launches == before + 1
    d0, hits0 = density.density_c16(moved, cand, count, p, hit_sub=16)
    assert torch.equal(d, d0) and torch.equal(hits, hits0)
    dp, hp = density.density_gated16_torch(moved, cand, count, mask, p)
    np.testing.assert_allclose(d.cpu().numpy(), dp.cpu().numpy(), rtol=1e-5)
    assert torch.equal(hits, hp)


@pytest.mark.cuda
@pytest.mark.parametrize("over", [
    dict(SUB16, max_candidates_sub=1024),
    dict(SUB16, density_sub16=False, max_candidates_sub=512, max_candidates_hit=256),
    dict(SUB16, max_candidates_sub=100, tier2_frac=2, tier2_mult=8),
    dict(SUB16, density_sub16=False, max_candidates_sub=60, tier2_frac=2, tier2_mult=8,
         max_candidates_hit=256),
], ids=["TTF", "FTF", "TTF-tier2", "FTF-tier2"])
def test_16_wide_substeps_on_gpu_match_cpu(tables, cuda, over):
    p = tables["params"]
    st = _clumped_state(p, 16)
    dt = torch.tensor(p.max_dt, dtype=torch.float32)
    cfg = step.StepConfig(**over)
    c1, _, cf, _ = step.substep(st, dt, p, None, cfg)
    g1, _, gf, _ = step.substep(st.map(lambda a: a.to(cuda)), dt.to(cuda), p, None, cfg)
    assert int(cf) == int(gf) == 0
    torch.testing.assert_close(g1.grid_index.cpu(), c1.grid_index)
    np.testing.assert_allclose(g1.density.cpu().numpy(), c1.density.numpy(), rtol=1e-5)
    a = c1.acceleration.numpy()
    np.testing.assert_allclose(g1.acceleration.cpu().numpy(), a, atol=1e-5 * np.abs(a).max())


@pytest.mark.cuda
def test_gated_frame_on_gpu_equals_ungated(tables, cuda):
    """Eight substeps of the frame loop on the card, rebuilding every other
    substep, with and without the gate: the same state bit for bit."""
    p = tables["params"]
    rng = np.random.default_rng(17)
    side = p.initial_volume ** (1 / 3) * 1.3
    pos = torch.as_tensor(((rng.random((N, 3)) - 0.5) * side).astype(np.float32))
    st = ParticleState.zeros(N, cuda).replace(position=pos.to(cuda))
    dt = torch.tensor(p.max_dt, dtype=torch.float32, device=cuda)
    out = []
    for gate in (False, True):
        cfg = step.StepConfig(**SUB16, density_gate=gate, cand_interval=2,
                              substeps_per_dispatch=8)
        before = density.density_gated16.launches
        s, _, left, flags = step.frame(st, dt, torch.tensor(1.0, device=cuda), p, None, cfg)
        torch.cuda.synchronize()
        assert int(flags) == 0
        assert (density.density_gated16.launches > before) == gate
        out.append(s)
    for k in ("position", "velocity", "density", "acceleration"):
        assert torch.equal(getattr(out[0], k), getattr(out[1], k)), k


@pytest.fixture(scope="module")
def block_tables(tables):
    """The block search's table of the main fixture's cloud (block ids
    at h, the row/fine/asym variants' input)."""
    p = tables["params"]
    nb = tables["real"].shape[0] // 128
    pos = tables["pos4"][:, :3].reshape(nb, 128, 3)
    bmin, bmax = tiles_ops.split_block_bounds(pos, tables["real"].reshape(nb, 128))
    cand, count, ovf = tiles_ops.candidate_blocks_auto(bmin, bmax, p.h, 96)
    assert not bool(ovf)
    return dict(tables, cand=cand, count=count)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["row", "fine", "asym"])
def test_block_passes_match_plain(block_tables, cuda, variant):
    """density_blocks / forces_blocks launch the 32-wide kernels (counted
    on the kernel they run: density_c32 densities only, forces_q128_c32
    for every variant) and agree with the plain versions."""
    t = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v
         for k, v in block_tables.items()}
    p = t["params"]
    q_div = 4 if variant == "fine" else 1
    kernel = forces.forces_q128_c32
    only = density.DENSITY_ONLY
    before = (density.density_c32.variants.get(only, 0), kernel.launches)
    d = blocks.density_blocks(t["pos4"], t["cand"], t["count"], p)
    a = blocks.forces_blocks(t["f8"], t["dens"], t["real"], t["cand"], t["count"], p, q_div)
    torch.cuda.synchronize()
    after = (density.density_c32.variants[only], kernel.launches)
    assert after == tuple(b + 1 for b in before)
    d0 = blocks.density_blocks_torch(t["pos4"], t["cand"], t["count"], p)
    np.testing.assert_allclose(d.cpu().numpy(), d0.cpu().numpy(), rtol=1e-5)
    a0 = blocks.forces_blocks_torch(t["f8"], t["dens"], t["real"], t["cand"], t["count"],
                                    p, q_div).cpu().numpy()
    np.testing.assert_allclose(a.cpu().numpy(), a0, atol=1e-5 * np.abs(a0).max())


def _sort_inputs(n, num_bits, seed, kind="random"):
    """Keys below 2^num_bits (half of them drawn from 8 values: long runs
    of ties), all equal, or all at the largest 30-bit key; values that
    are no iota (random int32)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << num_bits, size=n)
    keys[::2] = rng.integers(0, 1 << num_bits, size=8)[rng.integers(0, 8, size=keys[::2].size)]
    if kind == "equal":
        keys[:] = keys[0]
    elif kind == "max":
        keys[:] = (1 << 30) - 1
    vals = rng.integers(-(1 << 31), 1 << 31, size=n)
    return torch.as_tensor(keys.astype(np.int32)), torch.as_tensor(vals.astype(np.int32))


def _assert_sorts_as_torch(keys, vals, k, v):
    sk, order = torch.sort(keys, stable=True)
    assert torch.equal(k, sk) and torch.equal(v, vals[order])


# key counts around the 128-key blocks of the plain version and the
# 8192-key tiles of the pass kernels (2048 of the histogram kernel)
SORT_N = [1, 127, 128, 129, 2049, radix.TILE, radix.TILE + 1, 100_003, 1 << 20, 4 << 20]


@pytest.mark.cuda
@pytest.mark.parametrize("apply", radix.APPLY)
@pytest.mark.parametrize("n", SORT_N)
def test_radix_sort_kernels_equal_torch_sort(cuda, n, apply):
    keys, vals = (x.to(cuda) for x in _sort_inputs(n, 30, n))
    before = radix.radix_sort.launches
    k, v = radix_sort.radix_sort_key_val(keys, vals, apply=apply)
    torch.cuda.synchronize()
    assert radix.radix_sort.launches == before + 6  # 30 bits at 5 a pass
    _assert_sorts_as_torch(keys, vals, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("apply", radix.APPLY)
@pytest.mark.parametrize("kind", ["equal", "max"])
def test_radix_sort_kernels_on_equal_and_pad_keys(cuda, kind, apply):
    """Every key equal, or every key at 2^30 - 1 (the plain version's pad
    key): the order is the index order, over a ragged last tile."""
    keys, vals = (x.to(cuda) for x in _sort_inputs(3 * radix.TILE + 5, 30, 7, kind))
    k, v = radix_sort.radix_sort_key_val(keys, vals, apply=apply)
    assert torch.equal(k, keys) and torch.equal(v, vals)


@pytest.mark.cuda
@pytest.mark.parametrize("apply", radix.APPLY)
@pytest.mark.parametrize("bits_per_pass", range(1, radix.MAX_BITS + 1))
@pytest.mark.parametrize("num_bits", [3, 12, 30])
def test_radix_sort_kernels_bits(cuda, num_bits, bits_per_pass, apply):
    """Every pass width at 3, 12 and 30 key bits: the kernels equal
    torch.sort and the plain version, one count a pass."""
    keys, vals = _sort_inputs(5000, num_bits, num_bits * 10 + bits_per_pass)
    plain = radix.radix_sort_torch(keys, vals, num_bits, bits_per_pass, apply)
    keys, vals = keys.to(cuda), vals.to(cuda)
    before = radix.radix_sort.launches
    k, v = radix_sort.radix_sort_key_val(keys, vals, num_bits=num_bits,
                                         bits_per_pass=bits_per_pass, apply=apply)
    torch.cuda.synchronize()
    assert radix.radix_sort.launches == before + -(-num_bits // bits_per_pass)
    _assert_sorts_as_torch(keys, vals, k, v)
    assert torch.equal(k.cpu(), plain[0]) and torch.equal(v.cpu(), plain[1])


@pytest.mark.cuda
def test_radix_sort_kernels_take_views(cuda):
    """A view that starts past a 16-byte boundary, and empty keys."""
    keys, vals = (x.to(cuda) for x in _sort_inputs(radix.TILE * 2 + 3, 30, 8))
    k, v = radix_sort.radix_sort_key_val(keys[1:], vals[1:])
    _assert_sorts_as_torch(keys[1:], vals[1:], k, v)
    k, v = radix_sort.radix_sort_key_val(keys[:0], vals[:0])
    assert k.shape == v.shape == (0,)


@pytest.mark.cuda
@pytest.mark.parametrize("apply", ["scatter", "gather"])
def test_fused_radix_sort_equals_torch_sort(cuda, apply):
    rng = np.random.default_rng(21)
    keys = torch.as_tensor(rng.integers(0, 1 << 30, size=100_003).astype(np.int32),
                           device=cuda)
    keys[::2] = keys[:8].repeat(6251)[: keys[::2].shape[0]]
    vals = torch.arange(keys.shape[0], dtype=torch.int32, device=cuda)
    before = radix.radix_sort.launches
    k, v = radix_sort.radix_sort_key_val(keys, vals, apply=apply)
    assert radix.radix_sort.launches == before + 6  # 30 bits at 5 a pass
    sk, order = torch.sort(keys, stable=True)
    assert torch.equal(k, sk) and torch.equal(v, order.to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("over", [
    dict(pallas_variant="row", cand_interval=1),
    dict(pallas_variant="fine", cand_interval=1),
    dict(pallas_variant="asym", cand_interval=1),
    dict(pallas_variant="asm", cand_interval=1, density_sub16=False, force_sub8=False,
         max_candidates_sub=512, max_candidates_hit=256),
    dict(neighbor_impl="exact", sort_interval=1, cand_interval=1),
    dict(hit_compact=False, density_sub16=False, force_sub8=False, max_candidates_sub=512),
], ids=["row", "fine", "asym", "asm", "exact", "no_hit_compact"])
def test_block_and_exact_substeps_on_gpu_match_cpu(tables, cuda, over):
    """The clumped cloud for the block variants; the exact impl, whose
    cells hold at most cell_capacity particles, on an unclumped one."""
    p = tables["params"]
    st = _clumped_state(p, 18)
    if over.get("neighbor_impl") == "exact":
        rng = np.random.default_rng(19)
        side = p.initial_volume ** (1 / 3) * 1.3
        pos = torch.as_tensor(((rng.random((N, 3)) - 0.5) * side).astype(np.float32))
        st = st.replace(position=pos)
    dt = torch.tensor(p.max_dt, dtype=torch.float32)
    cfg = step.StepConfig(**over)
    c1, _, cf, _ = step.substep(st, dt, p, None, cfg)
    g1, _, gf, _ = step.substep(st.map(lambda a: a.to(cuda)), dt.to(cuda), p, None, cfg)
    assert int(cf) == int(gf) == 0
    torch.testing.assert_close(g1.grid_index.cpu(), c1.grid_index)
    np.testing.assert_allclose(g1.density.cpu().numpy(), c1.density.numpy(), rtol=1e-5)
    a = c1.acceleration.numpy()
    np.testing.assert_allclose(g1.acceleration.cpu().numpy(), a, atol=1e-5 * np.abs(a).max())


# Edge cases of the density_c16 and forces_q32 designs (one warp walks
# one list: four of a thread block; the density stages 8 slots a round,
# the force kernel 64 candidates; the force kernel's lanes walk only
# their own in-support candidates).
EDGE_CASES = ["unequal", "ragged", "one_query", "qblock"]


def _cut(count, case):
    """Counts of an edge case, never above the table's own: "unequal"
    (and "qblock") give the four lists of each thread block (consecutive
    rows, from 0) 0, a third, all and all but one of their slots;
    "ragged" 9-13, 17-21 or 25-29 slots, no multiple of a density round
    and a mix for the force rounds (8, 4 or 2 slots)."""
    c = count.long()
    row = torch.arange(c.shape[0])
    if case in ("unequal", "qblock"):
        c = torch.stack([torch.zeros_like(c), c // 3, c, (c - 1).clamp(min=0)])[row % 4, row]
    elif case == "ragged":
        c = torch.minimum(c, 9 + 8 * (row % 3) + row % 5)
    return c.to(torch.int32).contiguous()


def _one_query_tables(params):
    """256 particles in two blocks: the 128 queries of block 0 on a line
    2h apart, and candidate 128 + j 0.3h from query (5 j) % 128 only (so
    inside the support of exactly one query of its subgroup), candidate
    131 on its query exactly (a coincident pair of two particles). Every
    list holds every subblock or run of the cloud, rotated per row."""
    h = params.h
    rng = np.random.default_rng(22)
    pos = np.zeros((256, 3), np.float32)
    pos[:128, 0] = 2.0 * h * np.arange(128)
    owner = (5 * np.arange(128)) % 128
    pos[128:] = pos[owner]
    pos[128:, 1] += np.float32(0.3 * h)
    pos[131] = pos[owner[3]]
    real = torch.ones(256, dtype=torch.bool)
    position = torch.as_tensor(pos)
    pos4 = density.pos_pack(position, real)

    def lists(width, rows):
        runs = 256 // width
        ids = np.stack([np.roll(np.arange(runs), 5 * r) for r in range(rows)])
        return (torch.as_tensor(ids.astype(np.int32)),
                torch.full((rows,), runs, dtype=torch.int32))

    cand_sub, count_sub = lists(16, 2)
    dens, _ = density.density_c16_torch(pos4, cand_sub, count_sub, params)
    pres = tait_pressure(dens, params)
    vel = torch.as_tensor(rng.normal(size=(256, 3)).astype(np.float32))
    f8 = forces.force_pack(position, vel, dens, pres, real, params.particle_mass)
    out = dict(params=params, pos4=pos4, cand_sub=cand_sub, count_sub=count_sub, dens=dens,
               real=real, f8=f8)
    for w in (8, 16, 32):
        out[f"cand{w}"], out[f"count{w}"] = lists(w, 8)
    out["cand_sub32"], out["count_sub32"] = lists(32, 2)
    return out


def _margin_tables(params):
    """Two blocks. The 32 queries of subgroup g of block 0 sit on one
    point (0, 10 g h, 0); run r of 8 candidates of block 1 (particles
    128 + 8r ..) sits on one point beside subgroup r // 4's, at an x set
    by r % 4: 1.01 h (a panel the box test culls), the largest float32 x
    whose x^2 rounds below h^2 (a pair just inside the support, beside the
    culled panel), h (1 + 2e-5) (a box gap within the test's 1e-4 margin:
    tested, no pair inside) and 0.5 h. Both rows list every 32-wide
    subblock: count = cap."""
    h, h2 = params.h, np.float32(params.h * params.h)
    under = np.float32(np.sqrt(h2))
    while under * under >= h2:
        under = np.nextafter(under, np.float32(0))
    xs = [np.float32(1.01 * h), under, np.float32(h * (1 + 2e-5)), np.float32(0.5 * h)]
    pos = np.zeros((256, 3), np.float32)
    for g in range(4):
        pos[32 * g:32 * g + 32, 1] = np.float32(10 * g * h)
    for r in range(16):
        g, k = divmod(r, 4)
        pos[128 + 8 * r:136 + 8 * r] = (xs[k], np.float32(10 * g * h), 0.0)
    pos4 = density.pos_pack(torch.as_tensor(pos), torch.ones(256, dtype=torch.bool))
    cand = torch.arange(8, dtype=torch.int32).repeat(2, 1)
    count = torch.full((2,), 8, dtype=torch.int32)
    hits = density.density_c32_torch(pos4, cand, count, params, hit_sub=16)[1]
    # subgroup 0 of row 0 against slot 4 (runs 0-3): the pair just inside
    # in half 0, the 0.5 h run (and none of the margin run) in half 1
    assert hits[0, 8] == hits[0, 9] == 32 * 8
    return dict(params=params, pos4=pos4, cand_sub32=cand, count_sub32=count)


def _density_inputs(t, case, key="cand_sub"):
    cand, count, qblock = t[key], t[key.replace("cand", "count")], None
    if case == "qblock":
        qblock = _pool(cand.shape[0], "cpu")
        cand, count = cand[qblock.long()].contiguous(), count[qblock.long()].contiguous()
    return t["pos4"], cand, _cut(count, case), qblock


def _force_inputs(t, width, case):
    cand, count, qblock = t[f"cand{width}"], t[f"count{width}"], None
    if case == "qblock":
        qblock = _pool(t["f8"].shape[0] // 128, "cpu")
        rows = (qblock.long()[:, None] * 4 + torch.arange(4)).reshape(-1)
        cand, count = cand[rows].contiguous(), count[rows].contiguous()
    return (t["f8"], t["dens"], t["real"], cand, _cut(count, case)), qblock


def _on(cuda, *tensors):
    return tuple(None if x is None else x.to(cuda) for x in tensors)


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("mode", ["hit8", "hit16", "hit16+tiles"])
def test_density_c16_edge_cases_match_plain(tables, cuda, mode, case):
    p = tables["params"]
    t = _one_query_tables(p) if case == "one_query" else tables
    pos4, cand, count, qblock = _on(cuda, *_density_inputs(t, case))
    kw = dict(hit_sub=8 if mode == "hit8" else 16,
              hit2_h=1.25 * p.h if mode == "hit16+tiles" else None, qblock=qblock)
    before = density.density_c16.launches
    out = density.density_c16(pos4, cand, count, p, **kw)
    torch.cuda.synchronize()
    assert density.density_c16.launches == before + 1
    ref = density.density_c16_torch(pos4, cand, count, p, **kw)
    np.testing.assert_allclose(out[0].cpu().numpy(), ref[0].cpu().numpy(), rtol=1e-5)
    assert len(out) == len(ref)
    for a, b in zip(out[1:], ref[1:]):
        assert torch.equal(a, b) and int(b.sum()) > 0


C32_MODES = {"groups4": dict(groups=4), "groups1": dict(groups=1),
             "hit16": dict(hit_sub=16), "densities": dict(groups=0)}


def _c32_edge_inputs(q_tables, case):
    """density_c32's inputs of an edge case: the q-granular tables (every
    fifth particle made non-real with "unreal"), or the one-query and
    margin clouds."""
    p = q_tables["params"]
    if case == "one_query":
        return _density_inputs(_one_query_tables(p), case, "cand_sub32")
    if case == "margin":
        return _density_inputs(_margin_tables(p), case, "cand_sub32")
    pos4, cand, count, qblock = _density_inputs(q_tables, case)
    if case == "unreal":
        pos4 = pos4.clone()
        pos4[::5, 3] = 0.0
    return pos4, cand, count, qblock


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES + ["unreal", "margin"])
@pytest.mark.parametrize("mode", list(C32_MODES))
def test_density_c32_edge_cases_match_plain(q_tables, cuda, mode, case):
    p = q_tables["params"]
    pos4, cand, count, qblock = _on(cuda, *_c32_edge_inputs(q_tables, case))
    kw = dict(C32_MODES[mode], qblock=qblock)
    before = density.density_c32.launches
    out = density.density_c32(pos4, cand, count, p, **kw)
    torch.cuda.synchronize()
    assert density.density_c32.launches == before + 1
    ref = density.density_c32_torch(pos4, cand, count, p, **kw)
    np.testing.assert_allclose(out[0].cpu().numpy(), ref[0].cpu().numpy(), rtol=1e-5)
    assert torch.equal(out[1], ref[1])
    assert int(ref[1].sum()) > 0 or mode == "densities"


def _as_c16(cand, count):
    """A 32-wide table as the 16-wide one of the same particles: slot k
    of id c becomes slots 2k, 2k + 1 with ids 2c, 2c + 1."""
    sent = tiles_ops.REFINE_SENTINEL
    dead = cand == sent
    ids = torch.stack([torch.where(dead, sent, 2 * cand), torch.where(dead, sent, 2 * cand + 1)],
                      dim=-1).reshape(cand.shape[0], -1)
    return ids.contiguous(), (2 * count).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES + ["unreal", "margin"])
def test_density_c32_equals_c16_bitwise(q_tables, cuda, case):
    """Both kernels add each query's candidates in ascending particle
    order: density_c32 in every mode gives density_c16's densities at
    hit_sub 16 over the same particles bit for bit, and its hit_sub-16
    and hit_sub-32 counts are c16's and the sums of their pairs."""
    p = q_tables["params"]
    pos4, cand, count, qblock = _on(cuda, *_c32_edge_inputs(q_tables, case))
    d16, h16 = density.density_c16(pos4, *_as_c16(cand, count), p, hit_sub=16,
                                   qblock=qblock)
    for mode, kw in C32_MODES.items():
        d, hits = density.density_c32(pos4, cand, count, p, qblock=qblock, **kw)
        assert torch.equal(d, d16), mode
        if mode == "hit16":
            assert torch.equal(hits, h16)
        elif mode == "groups4":
            assert torch.equal(hits, h16.reshape(hits.shape[0], -1, 2).sum(-1, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("width", [8, 16, 32])
def test_forces_q32_edge_cases_match_plain(tables, q_tables, sub16_tables, cuda, width,
                                           case):
    src = {8: tables, 16: sub16_tables, 32: q_tables}[width]
    t = _one_query_tables(src["params"]) if case == "one_query" else src
    fargs, qblock = _force_inputs(t, width, case)
    fargs, (qblock,) = _on(cuda, *fargs), _on(cuda, qblock)
    fn = getattr(forces, f"forces_q32_c{width}")
    before = fn.launches
    a = fn(*fargs, t["params"], qblock=qblock)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    a0 = getattr(forces, f"forces_q32_c{width}_torch")(*fargs, t["params"],
                                                       qblock=qblock).cpu().numpy()
    assert np.abs(a0).max() > 0
    np.testing.assert_allclose(a.cpu().numpy(), a0, atol=1e-5 * np.abs(a0).max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["unequal", "ragged", "one_query"])
def test_density_c16_hit16_equals_gated16_bitwise(tables, cuda, case):
    """With every panel flagged, density_gated16 sums the same pairs in
    the same order as density_c16 at hit_sub 16: the same bits."""
    p = tables["params"]
    t = _one_query_tables(p) if case == "one_query" else tables
    pos4, cand, count, _ = _on(cuda, *_density_inputs(t, case))
    mask = torch.full((cand.shape[0], -(-cand.shape[1] // 64)), -1, dtype=torch.int32,
                      device=cuda)
    d, hits = density.density_c16(pos4, cand, count, p, hit_sub=16)
    dg, hg = density.density_gated16(pos4, cand, count, mask, p)
    torch.cuda.synchronize()
    assert torch.equal(d, dg) and torch.equal(hits, hg)


# Edge cases of density_gated16 as density_c16's gated mode (the warp
# stages only the tiles whose mask nibble is set).
GATE_CASES = ["zero_mask", "one_bit", "alternating", "ragged_cap", "count0"]


@pytest.fixture(scope="module")
def gated_tables(tables):
    """A c16 table of the clumped cloud built at (1 + slack) h (cap 192:
    three mask words, most counts past the first), the positions moved by
    up to 0.1 h, and the mask the build's dilated tile counts give."""
    p = tables["params"]
    cfg = step.StepConfig(**SUB16, cand_interval=4)
    rng = np.random.default_rng(23)
    st, real, _ = step.pad_and_sort(_clumped_state(p, 15), p, True)
    cand, count, flags = step.build_candidates(st, real, p, cfg)
    assert int(flags) == 0 and int(count.max()) > 128
    tiles = density.density_c16_torch(density.pos_pack(st.position, real), cand, count, p,
                                      hit_sub=16, hit2_h=p.h * (1 + cfg.cand_slack))[2]
    step_ = torch.as_tensor(rng.uniform(-1, 1, st.position.shape).astype(np.float32))
    moved = density.pos_pack(st.position + 0.057 * p.h * step_, real)
    return dict(params=p, pos4=moved, cand=cand, count=count,
                mask=density.pack_tile_nibbles(tiles))


def _gate_inputs(t, case):
    """(pos4, cand, count, mask) of a gate edge case, and whether the
    mask leaves every panel with a pair inside the support flagged (then
    the gated kernel equals the ungated one bit for bit)."""
    pos4, cand, count, mask = t["pos4"], t["cand"], t["count"], t["mask"]
    nb, words = mask.shape
    if case == "zero_mask":
        return pos4, cand, count, torch.zeros_like(mask), False
    if case == "one_bit":  # the first panel past the first mask word with a pair
        hits = density.density_c16_torch(pos4, cand, count, t["params"], hit_sub=16)[1]
        row, slot = torch.nonzero(hits[:, 64:])[0].tolist()
        tile = (slot + 64) // 8
        one = torch.zeros_like(mask)
        one[row // 4, tile // 8] = 1 << ((tile % 8) * 4 + row % 4)
        return pos4, cand, count, one, False
    if case == "alternating":  # whole tiles and subgroup pairs, row by row
        alt = torch.tensor([0x0F0F0F0F, 0x5A5A5A5A], dtype=torch.int32)[torch.arange(nb) % 2]
        return pos4, cand, count, alt[:, None].expand(nb, words).contiguous(), False
    if case == "ragged_cap":  # cap 187: no multiple of 8 or 64, counts up to 165
        cap = 187
        cut = cand[:, :cap].contiguous()
        return pos4, cut, count, mask[:, :-(-cap // 64)].contiguous(), True
    assert case == "count0"
    return pos4, cand, torch.zeros_like(count), mask, True


@pytest.mark.cuda
@pytest.mark.parametrize("case", GATE_CASES)
def test_density_gated16_edge_cases_match_plain(gated_tables, cuda, case):
    p = gated_tables["params"]
    *inputs, exact = _gate_inputs(gated_tables, case)
    pos4, cand, count, mask = _on(cuda, *inputs)
    before = density.density_gated16.launches
    d, hits = density.density_gated16(pos4, cand, count, mask, p)
    torch.cuda.synchronize()
    assert density.density_gated16.launches == before + 1
    d0, h0 = density.density_gated16_torch(pos4, cand, count, mask, p)
    np.testing.assert_allclose(d.cpu().numpy(), d0.cpu().numpy(), rtol=1e-5)
    assert torch.equal(hits, h0)
    flagged = density.mask_panels(mask, cand.shape[1]).reshape(hits.shape)
    assert not bool(hits[~flagged].any())
    if case in ("one_bit", "alternating"):
        assert int(h0.sum()) > 0
    if exact:
        du, hu = density.density_c16(pos4, cand, count, p, hit_sub=16)
        assert torch.equal(d, du) and torch.equal(hits, hu)


# Edge cases of forces_q128_c32 (warp g = query subgroup g against the
# block's shared list, runs of 8 culled by their boxes).
Q128_CASES = ["near_eps", "self_qblock", "padding", "count0"]


def _near_eps_tables(params):
    """Two blocks: block 0 a cloud in a cube of side 2h at x ~ 0.3, block
    1 its copies moved along x by 0 to 4 float32 ulps (candidate 128 + j
    beside query j): pairs at r = 0, below the spiky guard (1e-7: 1 to 3
    ulps of 3e-8) and just above it (4 ulps). Both rows list every
    32-wide subblock."""
    h = params.h
    rng = np.random.default_rng(24)
    pos = np.zeros((256, 3), np.float32)
    pos[:128] = (0.3 + rng.random((128, 3)) * 2 * h).astype(np.float32)
    pos[128:] = pos[:128]
    for j in range(128):
        for _ in range(j % 5):
            pos[128 + j, 0] = np.nextafter(pos[128 + j, 0], np.float32(1))
    real = torch.ones(256, dtype=torch.bool)
    position = torch.as_tensor(pos)
    pos4 = density.pos_pack(position, real)
    cand = torch.arange(8, dtype=torch.int32).repeat(2, 1)
    count = torch.full((2,), 8, dtype=torch.int32)
    dens = density.density_c32_torch(pos4, cand, count, params, groups=0)[0]
    vel = torch.as_tensor(rng.normal(size=(256, 3)).astype(np.float32))
    f8 = forces.force_pack(position, vel, dens, tait_pressure(dens, params), real,
                           params.particle_mass)
    return f8, dens, real, cand, count


def _q128_inputs(q_tables, block_tables, case):
    """(f8, density, real, cand, count), qblock of a forces_q128_c32 edge
    case, on the CPU."""
    p = q_tables["params"]
    t = q_tables
    if case == "near_eps":
        return _near_eps_tables(p), None
    if case == "self_qblock":  # block tables list each block itself
        b = block_tables
        ids, counts = blocks.expand_block_table(b["cand"], b["count"])
        pool = _pool(ids.shape[0], "cpu")
        return (b["f8"], b["dens"], b["real"], ids[pool.long()].contiguous(),
                counts[pool.long()].contiguous()), pool
    if case == "padding":  # every fifth particle padding: pm = mr = 0, a = 0
        real = t["real"].clone()
        real[::5] = False
        f8 = t["f8"].clone()
        f8[~real, 6:] = 0.0
        return (f8, t["dens"], real, t["cand128"], t["count128"]), None
    assert case == "count0"
    return (t["f8"], t["dens"], t["real"], t["cand128"], torch.zeros_like(t["count128"])), None


@pytest.mark.cuda
@pytest.mark.parametrize("case", Q128_CASES)
def test_forces_q128_edge_cases_match_plain(q_tables, block_tables, cuda, case):
    """forces_q128_c32 against its plain version, and bit for bit against
    forces_q32_c32 over the list repeated for the block's four subgroups
    (each query adds its in-support candidates in ascending order)."""
    p = q_tables["params"]
    fargs, qblock = _q128_inputs(q_tables, block_tables, case)
    fargs, (qblock,) = _on(cuda, *fargs), _on(cuda, qblock)
    before = forces.forces_q128_c32.launches
    a = forces.forces_q128_c32(*fargs, p, qblock=qblock)
    torch.cuda.synchronize()
    assert forces.forces_q128_c32.launches == before + 1
    a0 = forces.forces_q128_c32_torch(*fargs, p, qblock=qblock).cpu().numpy()
    assert np.abs(a0).max() > 0
    np.testing.assert_allclose(a.cpu().numpy(), a0, atol=1e-5 * np.abs(a0).max())
    f8, dens, real, cand, count = fargs
    a32 = forces.forces_q32_c32(f8, dens, real, cand.repeat_interleave(4, dim=0),
                                count.repeat_interleave(4), p, qblock=qblock)
    assert torch.equal(a, a32)
    if case == "self_qblock":  # the same rows as the unmapped call's, bit for bit
        ids, counts = _on(cuda, *blocks.expand_block_table(block_tables["cand"],
                                                           block_tables["count"]))
        full = forces.forces_q128_c32(f8, dens, real, ids, counts, p).reshape(-1, 128, 3)
        assert torch.equal(a.reshape(-1, 128, 3), full[qblock.long()])
    if case == "padding":
        rows = real if qblock is None else real.reshape(-1, 128)[qblock.long()].reshape(-1)
        assert not bool(a[~rows].any())


@pytest.mark.cuda
def test_fine_route_equals_forces_q32_c32_bitwise(block_tables, cuda):
    """forces_blocks at q_div 4 (fine) runs forces_q128_c32 over the block
    table, and gives the bits of its old route, forces_q32_c32 over the
    table repeated for the four subgroups."""
    t = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v
         for k, v in block_tables.items()}
    p = t["params"]
    before = (forces.forces_q128_c32.launches, forces.forces_q32_c32.launches)
    a = blocks.forces_blocks(t["f8"], t["dens"], t["real"], t["cand"], t["count"], p, 4)
    torch.cuda.synchronize()
    assert (forces.forces_q128_c32.launches, forces.forces_q32_c32.launches) == (
        before[0] + 1, before[1])
    ids, counts = blocks.expand_block_table(t["cand"], t["count"])
    a32 = forces.forces_q32_c32(t["f8"], t["dens"], t["real"],
                                ids.repeat_interleave(4, dim=0).contiguous(),
                                counts.repeat_interleave(4).contiguous(), p)
    assert torch.equal(a, a32)


# Finer query blocks: density_c32 at 1 or 0 groups and forces_q128_c32 on
# lists that serve 64 or 32 query rows (nl_query_rows 64 or 32,
# block_size 64, asm at 32 rows), templated instantiations of the 128-row
# kernels.
ROWS = [64, 32]
ROWS_CASES = ["identity", "qblock", "ragged", "count0", "np64"]


@pytest.fixture(scope="module")
def rows_tables(tables):
    """The port's own 32-wide tables at nl_query_rows 64 and 32 on the
    clumped cloud: refined lists (nb * 128/R rows), the plain density's
    block hit counts and the compacted force lists."""
    params = tables["params"]
    out = {}
    for rows in ROWS:
        cfg = step.StepConfig(**Q_PATH, nl_query_rows=rows, cand_interval=1)
        st, real, _ = step.pad_and_sort(_clumped_state(params, 12), params, True)
        cand_sub, count_sub, flags = step.build_candidates(st, real, params, cfg)
        assert int(flags) == 0 and cand_sub.shape[0] == st.n // rows
        pos4 = density.pos_pack(st.position, real)
        dens, hits = density.density_c32_torch(pos4, cand_sub, count_sub, params, groups=1,
                                               rows=rows)
        cand_f, count_f, hflags = step.hit_lists(cand_sub, hits, cfg, 1)
        assert int(hflags) == 0
        pres = torch.where(real, tait_pressure(dens, params), 0.0)
        f8 = forces.force_pack(st.position, st.velocity, dens, pres, real,
                               params.particle_mass)
        out[rows] = dict(params=params, pos4=pos4, cand_sub=cand_sub, count_sub=count_sub,
                         dens=dens, real=real, f8=f8, cand_f=cand_f, count_f=count_f)
    return out


def _drop_tail(cand, count, limit):
    """The lists with every id at or past ``limit`` removed (live ids
    kept in order)."""
    sent = tiles_ops.REFINE_SENTINEL
    live = (torch.arange(cand.shape[1])[None, :] < count[:, None]) & (cand < limit)
    keys = torch.where(live, cand, sent)
    order = torch.sort((~live).to(torch.int8), dim=1, stable=True).indices
    return (torch.gather(keys, 1, order).contiguous(),
            live.sum(dim=1, dtype=torch.int32).contiguous())


def _rows_inputs(t, rows, case, cand_key, count_key):
    """(particle pack, cand, count, qblock, np) of a finer-rows case on
    the CPU: "np64" cuts the particles to a multiple of 64 that is not
    one of 128 (its last 64 particles and every list entry into them
    dropped)."""
    cand, count, qblock = t[cand_key], t[count_key], None
    npart = t["pos4"].shape[0]
    if case == "qblock":
        qblock = _pool(cand.shape[0], "cpu")
        cand, count = cand[qblock.long()].contiguous(), count[qblock.long()].contiguous()
    elif case == "ragged":
        count = torch.minimum(count, 1 + torch.arange(count.shape[0], dtype=torch.int32) % 7)
    elif case == "count0":
        count = torch.zeros_like(count)
        count[::3] = t[count_key][::3]
    elif case == "np64":
        npart -= 64
        keep = npart // rows
        cand, count = _drop_tail(cand[:keep], count[:keep], npart // 32)
        assert npart % 128 == 64 and int(count.sum()) > 0
    return npart, cand, count.contiguous(), qblock


@pytest.mark.cuda
@pytest.mark.parametrize("case", ROWS_CASES)
@pytest.mark.parametrize("groups", [1, 0])
@pytest.mark.parametrize("rows", ROWS)
def test_density_c32_rows_match_plain(rows_tables, cuda, rows, groups, case):
    t = rows_tables[rows]
    npart, cand, count, qblock = _rows_inputs(t, rows, case, "cand_sub", "count_sub")
    pos4, cand, count, qblock = _on(cuda, t["pos4"][:npart].contiguous(), cand, count, qblock)
    kw = dict(groups=groups, qblock=qblock, rows=rows)
    before = density.density_c32.variants.get(
        f"groups 1, rows {rows}" if groups else f"densities only, rows {rows}", 0)
    d, hits = density.density_c32(pos4, cand, count, t["params"], **kw)
    torch.cuda.synchronize()
    assert density.density_c32.variants[
        f"groups 1, rows {rows}" if groups else f"densities only, rows {rows}"] == before + 1
    d0, hits0 = density.density_c32_torch(pos4, cand, count, t["params"], **kw)
    np.testing.assert_allclose(d.cpu().numpy(), d0.cpu().numpy(), rtol=1e-5)
    assert torch.equal(hits, hits0)
    assert hits.shape == (cand.shape[0] * groups, cand.shape[1])
    assert int(hits0.sum()) > 0 or groups == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ROWS_CASES)
@pytest.mark.parametrize("rows", ROWS)
def test_forces_rows_match_plain(rows_tables, cuda, rows, case):
    """forces_q128_c32 at 64 and 32 rows against its plain version, and,
    where the lists are unmapped, bit for bit against forces_q32_c32 over
    each list repeated for its 32-row subgroups (each query adds its
    in-support candidates in ascending order)."""
    t = rows_tables[rows]
    npart, cand, count, qblock = _rows_inputs(t, rows, case, "cand_f", "count_f")
    f8, dens, real = (x[:npart].contiguous() for x in (t["f8"], t["dens"], t["real"]))
    f8, dens, real, cand, count, qblock = _on(cuda, f8, dens, real, cand, count, qblock)
    p = t["params"]
    before = forces.forces_q128_c32.variants.get(f"rows {rows}", 0)
    a = forces.forces_q128_c32(f8, dens, real, cand, count, p, qblock=qblock, rows=rows)
    torch.cuda.synchronize()
    assert forces.forces_q128_c32.variants[f"rows {rows}"] == before + 1
    a0 = forces.forces_q128_c32_torch(f8, dens, real, cand, count, p, qblock=qblock,
                                      rows=rows).cpu().numpy()
    assert a.shape == (cand.shape[0] * rows, 3)
    np.testing.assert_allclose(a.cpu().numpy(), a0, atol=1e-5 * np.abs(a0).max())
    if qblock is None and npart % 128 == 0:
        sub = rows // 32
        a32 = forces.forces_q32_c32(f8, dens, real, cand.repeat_interleave(sub, dim=0),
                                    count.repeat_interleave(sub), p)
        assert torch.equal(a, a32)


def _small_force_pack(pos4, params, seed):
    real = pos4[:, 3] > 0
    cand = torch.arange(pos4.shape[0] // 32, dtype=torch.int32)
    dens = density.density_c32_torch(pos4, cand.repeat(pos4.shape[0] // 128, 1).contiguous(),
                                     torch.full((pos4.shape[0] // 128,), cand.shape[0],
                                                dtype=torch.int32), params, groups=0)[0]
    vel = torch.as_tensor(np.random.default_rng(seed).normal(
        size=(pos4.shape[0], 3)).astype(np.float32))
    return forces.force_pack(pos4[:, :3].contiguous(), vel, dens,
                             tait_pressure(dens, params), real, params.particle_mass), dens, real


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ROWS)
def test_rows_margin_pair_beside_culled_run(tables, cuda, rows):
    """The margin cloud at 64 and 32 rows: a pair just inside h beside a
    run the box test culls, and a run within the test's margin; density,
    block counts and forces against their plain versions, the forces bit
    for bit against forces_q32_c32."""
    p = tables["params"]
    m = _margin_tables(p)
    pos4 = m["pos4"]
    nq = pos4.shape[0] // rows
    cand = torch.arange(8, dtype=torch.int32).repeat(nq, 1).contiguous()
    count = torch.full((nq,), 8, dtype=torch.int32)
    f8, dens, real = _small_force_pack(pos4, p, 25)
    pos4, cand, count, f8, dens, real = _on(cuda, pos4, cand, count, f8, dens, real)
    d, hits = density.density_c32(pos4, cand, count, p, groups=1, rows=rows)
    d0, hits0 = density.density_c32_torch(pos4, cand, count, p, groups=1, rows=rows)
    np.testing.assert_allclose(d.cpu().numpy(), d0.cpu().numpy(), rtol=1e-5)
    assert torch.equal(hits, hits0)
    # subgroup 0 (rows 0-31, in list 0) has the pair just inside h in
    # slot 4, half 0 (its 8 particles) and the 0.5 h run in half 1
    assert int(hits[0, 4]) == 16
    a = forces.forces_q128_c32(f8, dens, real, cand, count, p, rows=rows)
    a0 = forces.forces_q128_c32_torch(f8, dens, real, cand, count, p, rows=rows)
    np.testing.assert_allclose(a.cpu().numpy(), a0.cpu().numpy(),
                               atol=1e-5 * float(a0.abs().max()))
    a32 = forces.forces_q32_c32(f8, dens, real, cand.repeat_interleave(rows // 32, dim=0),
                                count.repeat_interleave(rows // 32), p)
    assert torch.equal(a, a32)


@pytest.mark.cuda
def test_rows32_self_exclusion(q_tables, cuda):
    """forces_q128_c32 at 32 rows on pairs at r = 0 and below the spiky
    guard: each query excludes only itself (by id), bit for bit with
    forces_q32_c32 over the same lists."""
    p = q_tables["params"]
    f8, dens, real, cand, count = _near_eps_tables(p)
    cand = torch.arange(8, dtype=torch.int32).repeat(8, 1).contiguous()
    count = torch.full((8,), 8, dtype=torch.int32)
    f8, dens, real, cand, count = _on(cuda, f8, dens, real, cand, count)
    a = forces.forces_q128_c32(f8, dens, real, cand, count, p, rows=32)
    a0 = forces.forces_q128_c32_torch(f8, dens, real, cand, count, p, rows=32)
    assert float(a0.abs().max()) > 0
    np.testing.assert_allclose(a.cpu().numpy(), a0.cpu().numpy(),
                               atol=1e-5 * float(a0.abs().max()))
    assert torch.equal(a, forces.forces_q32_c32(f8, dens, real, cand, count, p))


@pytest.mark.cuda
@pytest.mark.parametrize("block", [64, 256])
@pytest.mark.parametrize("variant", ["row", "fine", "asym"])
def test_block_passes_at_other_block_sizes_match_plain(tables, cuda, block, variant):
    """density_blocks and forces_blocks at block_size 64 (64-row lists)
    and 256 (each block's list for its two 128-row halves)."""
    p = tables["params"]
    cfg = step.StepConfig(pallas_variant=variant, block_size=block, cand_interval=1,
                          max_candidates=256)
    st, real, _ = step.pad_and_sort(_clumped_state(p, 18), p, True, block_size=block)
    nb = st.n // block
    bmin, bmax = tiles_ops.split_block_bounds(st.position.reshape(nb, block, 3),
                                              real.reshape(nb, block))
    cand, count, ovf = tiles_ops.candidate_blocks_auto(bmin, bmax, p.h, cfg.max_candidates)
    assert not bool(ovf)
    pos4 = density.pos_pack(st.position, real)
    d0 = blocks.density_blocks_torch(pos4, cand, count, p, block=block)
    f8 = forces.force_pack(st.position, st.velocity, d0,
                           torch.where(real, tait_pressure(d0, p), 0.0), real,
                           p.particle_mass)
    q_div = 4 if variant == "fine" else 1
    a0 = blocks.forces_blocks_torch(f8, d0, real, cand, count, p, q_div, block=block)
    pos4, cand, count, f8, d0c, realc = _on(cuda, pos4, cand, count, f8, d0, real)
    d = blocks.density_blocks(pos4, cand, count, p, block=block)
    a = blocks.forces_blocks(f8, d0c, realc, cand, count, p, q_div, block=block)
    torch.cuda.synchronize()
    np.testing.assert_allclose(d.cpu().numpy(), d0.numpy(), rtol=1e-5)
    np.testing.assert_allclose(a.cpu().numpy(), a0.numpy(), atol=1e-5 * float(a0.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("over", [
    dict(Q_PATH, nl_query_rows=64, cand_interval=1),
    dict(Q_PATH, nl_query_rows=32, cand_interval=1),
    dict(Q_PATH, nl_query_rows=64, hit_compact=False, cand_interval=1,
         max_candidates_sub=512),
    dict(pallas_variant="asm", nl_query_rows=32, cand_interval=1, density_sub16=False,
         force_sub8=False, max_candidates_sub=512, max_candidates_hit=256),
    dict(Q_PATH, block_size=64, max_candidates_sub=60, tier2_frac=2, tier2_mult=4),
    dict(Q_PATH, block_size=256, cand_interval=1, max_candidates=256,
         max_candidates_sub=512),
    dict(Q_PATH, block_size=256, nl_query_rows=32, cand_interval=1, max_candidates=256),
    dict(refine_mode="aabb", force_sub8=False, max_candidates_sub=400,
         max_candidates_hit16=256),
    dict(Q_PATH, refine_mode="aabb", nl_query_rows=32, cand_interval=1,
         max_candidates_sub=400),
], ids=["nl-q64", "nl-q32", "nl-q64-no-hit-compact", "asm-q32", "b64-tier2", "b256",
        "b256-q32", "aabb", "aabb-q32"])
def test_shape_substeps_on_gpu_match_cpu(tables, cuda, over):
    """Whole substeps of the finer query blocks, the other block sizes and
    the aabb refine on the card (kernels) against the CPU (plain
    versions), on the clumped cloud."""
    p = tables["params"]
    st = _clumped_state(p, 13)
    dt = torch.tensor(p.max_dt, dtype=torch.float32)
    cfg = step.StepConfig(**over)
    c1, _, cf, _ = step.substep(st, dt, p, None, cfg)
    g1, _, gf, _ = step.substep(st.map(lambda a: a.to(cuda)), dt.to(cuda), p, None, cfg)
    assert int(cf) == int(gf) == 0
    torch.testing.assert_close(g1.grid_index.cpu(), c1.grid_index)
    np.testing.assert_allclose(g1.density.cpu().numpy(), c1.density.numpy(), rtol=1e-5)
    a = c1.acceleration.numpy()
    np.testing.assert_allclose(g1.acceleration.cpu().numpy(), a, atol=1e-5 * np.abs(a).max())


@pytest.mark.cuda
def test_mesh_collectives_staged_on_the_card(cuda):
    """Two ranks that share the card run over gloo, every collective
    staged through pinned host buffers: the values arrive as on the CPU,
    and the staged bytes are counted."""
    from libclsph_tpu_torch.parallel import mesh

    res = mesh.launch(mesh.check_collectives, 2, device="cuda", backend="gloo", timeout=300)
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["max"], [1.0, 0.0])
        np.testing.assert_array_equal(out["gather"], [[0.0] * 3] * 2 + [[1.0] * 3] * 2)
        assert [h[0] for h in out["ring"]] == [1 - r]
        np.testing.assert_array_equal(out["broadcast"], [1.0, 1.0])
        assert out["stats"]["staged_bytes"] > 0


@pytest.mark.cuda
def test_sharded_substep_on_card_ranks_matches_cpu_ranks(tables, cuda):
    """Two ranks on the card (the kernels, queries at a qblock offset in
    the exchanged table) against two ranks on the CPU (plain versions), one
    halo substep from the same shards: tables equal, density rtol 1e-5,
    acceleration atol 1e-5 * max|a|."""
    from libclsph_tpu_torch.core.state import init_state
    from libclsph_tpu_torch.io import checkpoint
    from libclsph_tpu_torch.parallel import mesh, sharded_step

    p = tables["params"]
    cfg = step.StepConfig(force_sub8=False, cand_interval=1)
    padded = sharded_step.pad_for_mesh(init_state(p, "cpu"), p, 2, cfg)
    shards = [checkpoint.state_to_arrays(sharded_step.local_rows(padded, r, 2))
              for r in range(2)]
    args = (shards, p, cfg, "halo", sharded_step.default_halo_max(N, 2, 128), 1, None, True)
    gpu = mesh.launch(sharded_step.run_shards, 2, args=args, device="cuda", backend="gloo",
                      timeout=300)
    cpu = mesh.launch(sharded_step.run_shards, 2, args=args, device="cpu", timeout=300)
    for g, c in zip(gpu, cpu):
        assert g["flags"] == c["flags"] == 0
        for k in ("cand", "count", "cand_sub", "count_sub", "cand_f", "count_f"):
            np.testing.assert_array_equal(g["tables"][k], c["tables"][k], err_msg=k)
        np.testing.assert_allclose(g["state"]["density"], c["state"]["density"], rtol=1e-5)
        a = c["state"]["acceleration"]
        np.testing.assert_allclose(g["state"]["acceleration"], a, atol=1e-5 * np.abs(a).max())
        assert g["stats"]["staged_bytes"] > 0 and c["stats"]["staged_bytes"] == 0


STREAM_N = 65_536
STREAM_TABLES = {  # the lists' particles a slot: (StepConfig fields, hit rows a list)
    8: ({}, 4),
    16: (dict(force_sub8=False), 4),
    32: (dict(Q_PATH, force_query_rows=128, cand_interval=1), 1),
}


@pytest.fixture(scope="module")
def stream_tables():
    """The 64k cube lattice's hit lists at 8, 16 and 32 particles a slot
    (the main path's, the 16-wide force path's and the q128 lists), each
    with its force pack and densities, built on the card."""
    from libclsph_tpu_torch.core.state import init_state

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    params = derive_parameters(WATER, dict(
        particles_count=STREAM_N, particle_mass=0.05, simulation_time=1, target_fps=60,
        simulation_scale=0.1, constant_acceleration=dict(x=0, y=-9.8, z=0)))
    st, real, _ = step.pad_and_sort(init_state(params, "cuda"), params, True)
    pos4 = density.pos_pack(st.position, real)
    out = dict(params=params, real=real)
    for sub, (over, groups) in STREAM_TABLES.items():
        cfg = step.StepConfig(**over)
        cand_sub, count_sub, _ = step.build_candidates(st, real, params, cfg)
        if cfg.density_sub16:
            dens, hits = density.density_c16_torch(pos4, cand_sub, count_sub, params,
                                                   hit_sub=cfg.hit_width(groups))
        else:
            dens, hits = density.density_c32_torch(pos4, cand_sub, count_sub, params,
                                                   groups=groups)
        cand, count, _ = step.hit_lists(cand_sub, hits, cfg, groups)
        _, f8 = step._pressure_and_pack(st, real, dens, params)
        out[sub] = (f8, dens, cand, count)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["staged", "planes"])
@pytest.mark.parametrize("sub", [8, 16, 32])
def test_gather_stream_matches_plain(stream_tables, sub, layout):
    from libclsph_tpu_torch.ops.kernels import stream

    f8, _, cand, count = stream_tables[sub]
    visc = stream.stream_visc(stream_tables["params"])
    before = stream.gather_stream.launches
    got = stream.gather_stream(f8, cand, count, sub, visc, layout)
    torch.cuda.synchronize()
    assert stream.gather_stream.launches == before + 1
    want = stream.gather_stream_torch(f8, cand, count, sub, visc, layout)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _stream_args(stream_tables, layout="staged"):
    from libclsph_tpu_torch.ops.kernels import stream

    f8, dens, cand, count = stream_tables[32]
    params = stream_tables["params"]
    st = stream.gather_stream(f8, cand, count, 32, stream.stream_visc(params), layout)
    return (f8, dens, stream_tables["real"], st, count, params)


@pytest.mark.cuda
@pytest.mark.parametrize("layout, cull", [("staged", True), ("planes", True),
                                          ("staged", False)])
def test_forces_c32_stream_sums_match_plain(stream_tables, layout, cull):
    """Each of the ten sums within rtol 1e-5 and atol 1e-5 of its largest
    |value| (float32 summation order)."""
    from libclsph_tpu_torch.ops.kernels import stream

    args = _stream_args(stream_tables, layout)
    before = stream.forces_c32_stream.launches
    got = stream.forces_c32_stream(*args, layout=layout, cull=cull).cpu().numpy()
    torch.cuda.synchronize()
    assert stream.forces_c32_stream.launches == before + 1
    want = stream.forces_c32_stream_torch(*args, layout=layout, cull=cull).cpu().numpy()
    assert got.shape == want.shape == (STREAM_N, 10)
    for j in range(10):
        np.testing.assert_allclose(got[:, j], want[:, j], rtol=1e-5,
                                   atol=1e-5 * np.abs(want[:, j]).max(), err_msg=f"sum {j}")


@pytest.mark.cuda
def test_forces_c32_stream_accel_equals_forces_q128_c32(stream_tables):
    """Only the feed differs from forces_q128_c32 on the same lists: the
    same pairs in the same order, so the same bits."""
    from libclsph_tpu_torch.ops.kernels import stream

    args = _stream_args(stream_tables)
    f8, dens, cand, count = stream_tables[32]
    got = stream.forces_c32_stream(*args, out="accel")
    fused = forces.forces_q128_c32(f8, dens, stream_tables["real"], cand, count,
                                   stream_tables["params"])
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), fused.view(torch.int32))
    a0 = stream.forces_c32_stream_torch(*args, out="accel").cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), a0, atol=1e-5 * np.abs(a0).max())


@pytest.mark.cuda
def test_forces_c32_stream_test_counts_and_zero_count(stream_tables):
    from libclsph_tpu_torch.ops.kernels import stream

    args = _stream_args(stream_tables)
    got = stream.forces_c32_stream(*args, out="test")
    want = stream.forces_c32_stream_torch(*args, out="test")
    assert got.dtype == torch.int32 and torch.equal(got, want)
    zero = stream.forces_c32_stream(*args[:4], torch.zeros_like(args[4]), args[5])
    assert not zero.any()


@pytest.mark.cuda
def test_stream_kernels_past_a_cap_of_no_whole_tile(stream_tables):
    """A cap that is no multiple of the force kernel's 4-slot tile: the
    last tile's slots past the cap are not copied and their runs are
    masked out; every mode still matches the plain version."""
    from libclsph_tpu_torch.ops.kernels import stream

    f8, dens, cand, count = stream_tables[32]
    cap = cand.shape[1] - cand.shape[1] % 4 - 1
    cand = cand[:, :cap].contiguous()
    count = torch.clamp(count, max=cap)
    params = stream_tables["params"]
    st = stream.gather_stream(f8, cand, count, 32, stream.stream_visc(params))
    assert torch.equal(st.view(torch.int32), stream.gather_stream_torch(
        f8, cand, count, 32, stream.stream_visc(params)).view(torch.int32))
    args = (f8, dens, stream_tables["real"], st, count, params)
    for cull in (True, False):
        err, bad = stream.sums_error(stream.forces_c32_stream(*args, cull=cull),
                                     stream.forces_c32_stream_torch(*args, cull=cull))
        assert bad < 0, (cull, err)
    assert torch.equal(stream.forces_c32_stream(*args, out="test"),
                       stream.forces_c32_stream_torch(*args, out="test"))


def _parent_library():
    """The parent commit's kernels, built from ``build/parent_csrc`` (its
    ``libclsph_tpu_torch/csrc`` unpacked there, as ``kernel_ab.py --base``
    takes it)."""
    import os
    from pathlib import Path

    from libclsph_tpu_torch.ops.kernels import build

    src = Path(__file__).resolve().parents[1] / "build" / "parent_csrc"
    if not os.path.isdir(src):
        pytest.skip(f"no parent kernels at {src}: unpack them with `git archive <commit> "
                    "libclsph_tpu_torch/csrc | tar -x -C build/parent_csrc --strip-components=2`")
    return build.open_library(build.build(src, build.BUILD_DIR.parent / "parent_csrc_build"))


@pytest.mark.cuda
def test_stream_kernels_bit_equal_to_the_parent_build(stream_tables):
    """The stream kernels give the parent build's bits (the gather's
    redesign changed no byte): every stream at 8, 16 and 32 particles a
    slot in both layouts, and every mode of the sums."""
    from libclsph_tpu_torch.ops.kernels import build, stream

    parent = _parent_library()
    package = build.load_library()

    def both(fn):
        out = []
        for lib in (package, parent):
            build._library = lib
            try:
                r = fn()
                torch.cuda.synchronize()
                out.append(r.view(torch.int32) if r.dtype == torch.float32 else r)
            finally:
                build._library = package
        return out

    params = stream_tables["params"]
    visc = stream.stream_visc(params)
    for sub in (8, 16, 32):
        f8, _, cand, count = stream_tables[sub]
        for layout in stream.LAYOUTS:
            got, want = both(lambda: stream.gather_stream(f8, cand, count, sub, visc, layout))
            assert torch.equal(got, want), (sub, layout)
    for layout, cull, out in stream.MODES:
        args = _stream_args(stream_tables, layout)
        got, want = both(lambda: stream.forces_c32_stream(*args, layout=layout, cull=cull,
                                                          out=out))
        assert torch.equal(got, want), (layout, cull, out)


@pytest.mark.cuda
def test_dispatch_syncs_once_a_chunk_at_1m():
    """A clean chunk of the main path at 1M (the bench cube, warmed up as
    bench_torch warms it) synchronises once a candidate period, plus the
    dispatch's own read, by ``torch.cuda.set_sync_debug_mode``."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench_torch
    from libclsph_tpu_torch.core.state import init_state
    from libclsph_tpu_torch.engine.simulation import SPHSimulation
    from libclsph_tpu_torch.ops import collisions
    from libclsph_tpu_torch.scene.scene import Scene

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    params = bench_torch.build_params(1_000_000)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene = collisions.build_device_scene(
        Scene.load("cube.obj", params.h * 2, scenes_dir=os.path.join(root, "scenes")), "cuda")
    engine = SPHSimulation(step.StepConfig(), device="cuda", pretune=False)
    state, dt = bench_torch.warm_up(init_state(params, "cuda"), params, scene, engine, 3,
                                    window=8)
    cfg = engine.step_config
    import dataclasses

    cfg = dataclasses.replace(cfg, substeps_per_dispatch=2 * cfg.cand_interval)
    host = {}
    timeleft = torch.tensor(3.0e38, dtype=torch.float32, device="cuda")
    step.frame(state, dt, timeleft, params, scene, cfg)  # what a process makes once
    torch.cuda.synchronize()
    _, calls = bench_torch.sync_calls(
        lambda: step.frame(state, dt, timeleft, params, scene, cfg, None, host))
    assert host["events"] == [] and host["flags"] == 0
    assert host["reads"] == 3
    assert len(calls) <= 3, calls


# ---- the identity mode (StepConfig.pair_r2 = "mxu") --------------------------

def _centred(t):
    """A table fixture's packs centred on its domain (engine.step's
    domain_center of the real rows), as the identity mode takes them."""
    real = t["pos4"][:, 3] > 0
    center = step.domain_center(t["pos4"][:, :3], real)
    out = dict(t, pos4=density.pos_pack(t["pos4"][:, :3], real, center))
    if "f8" in t:
        out["f8"] = torch.cat([t["f8"][:, :3] - center, t["f8"][:, 3:]], dim=1).contiguous()
    return out


MXU_DENSITY = {
    "c16-hit8": ("density_c16", "main", dict(hit_sub=8)),
    "c16-hit16": ("density_c16", "main", dict(hit_sub=16)),
    "c16-hit16+tiles": ("density_c16", "main", dict(hit_sub=16, hit2_h="dil")),
    "c32-groups4": ("density_c32", "q", dict(groups=4)),
    "c32-groups1": ("density_c32", "q", dict(groups=1)),
    "c32-hit16": ("density_c32", "q", dict(hit_sub=16)),
    "c32-rows64": ("density_c32", 64, dict(groups=1, rows=64)),
    "c32-rows32": ("density_c32", 32, dict(groups=1, rows=32)),
}


def _mxu_source(tables, q_tables, rows_tables, which):
    return _centred({"main": tables, "q": q_tables}[which] if which in ("main", "q")
                    else rows_tables[which])


@pytest.mark.cuda
@pytest.mark.parametrize("mapped", [False, True], ids=["identity", "qblock"])
@pytest.mark.parametrize("case", list(MXU_DENSITY))
def test_mxu_density_kernels_match_plain(tables, q_tables, rows_tables, cuda, case, mapped):
    """Each density kernel's identity mode against its plain version on
    centred packs: the r^2 decisions (hit and tile counts) equal, the
    densities within rtol 1e-5 (the plain version sums in another
    order); the launch is counted under the mode's variant, and the
    direct mode's hits differ from the identity's somewhere or equal
    them."""
    name, which, kw = MXU_DENSITY[case]
    t = _mxu_source(tables, q_tables, rows_tables, which)
    p = t["params"]
    kw = dict(kw)
    if kw.get("hit2_h") == "dil":
        kw["hit2_h"] = 1.25 * p.h
    cand, count, qblock = t["cand_sub"], t["count_sub"], None
    if mapped:
        qblock = _pool(cand.shape[0], "cpu")
        cand, count = cand[qblock.long()].contiguous(), count[qblock.long()].contiguous()
    pos4, cand, count, qblock = _on(cuda, t["pos4"], cand, count, qblock)
    fn = getattr(density, name)
    before = sum(v for k, v in fn.variants.items() if k.endswith(", mxu"))
    out = fn(pos4, cand, count, p, qblock=qblock, r2_mxu=True, **kw)
    torch.cuda.synchronize()
    assert sum(v for k, v in fn.variants.items() if k.endswith(", mxu")) == before + 1
    ref = getattr(density, name + "_torch")(pos4, cand, count, p, qblock=qblock,
                                            r2_mxu=True, **kw)
    np.testing.assert_allclose(out[0].cpu().numpy(), ref[0].cpu().numpy(), rtol=1e-5)
    assert len(out) == len(ref)
    for a, b in zip(out[1:], ref[1:]):
        assert torch.equal(a, b) and int(b.sum()) > 0


@pytest.mark.cuda
def test_mxu_density_c32_equals_c16_bitwise(q_tables, cuda):
    """The identity mode keeps the bodies' order: density_c32 at hit_sub
    16 gives density_c16's densities and counts over the same particles
    bit for bit."""
    t = _centred(q_tables)
    p = t["params"]
    pos4, cand, count = _on(cuda, t["pos4"], t["cand_sub"], t["count_sub"])
    d16, h16 = density.density_c16(pos4, *_as_c16(cand, count), p, hit_sub=16, r2_mxu=True)
    d, hits = density.density_c32(pos4, cand, count, p, hit_sub=16, r2_mxu=True)
    assert torch.equal(d, d16) and torch.equal(hits, h16)


MXU_FORCES = {
    "q32-c8": ("forces_q32_c8", "main", "cand8", {}),
    "q32-c16": ("forces_q32_c16", "sub16", "cand16", {}),
    "q32-c32": ("forces_q32_c32", "q", "cand32", {}),
    "q128": ("forces_q128_c32", "q", "cand128", {}),
    "rows64": ("forces_q128_c32", 64, "cand_f", dict(rows=64)),
    "rows32": ("forces_q128_c32", 32, "cand_f", dict(rows=32)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MXU_FORCES))
def test_mxu_force_kernels_match_plain(tables, q_tables, sub16_tables, rows_tables, cuda,
                                       case):
    """Each force kernel's identity mode against its plain version on
    centred packs (atol 1e-5 * max|a|: the summation order), counted
    under the mode; forces_q128_c32 (its box cull widened by the
    identity's error bound) also bit for bit against forces_q32_c32 over
    each list repeated for its 32-row subgroups, which has no cull."""
    name, which, key, kw = MXU_FORCES[case]
    src = {"main": tables, "sub16": sub16_tables, "q": q_tables}.get(which)
    t = _centred(src if src is not None else rows_tables[which])
    cand, count = t[key], t[key.replace("cand", "count")]
    f8, dens, real, cand, count = _on(cuda, t["f8"], t["dens"], t["real"], cand, count)
    fn = getattr(forces, name)
    before = sum(v for k, v in fn.variants.items() if k.endswith("mxu"))
    a = fn(f8, dens, real, cand, count, t["params"], r2_mxu=True, **kw)
    torch.cuda.synchronize()
    assert sum(v for k, v in fn.variants.items() if k.endswith("mxu")) == before + 1
    a0 = getattr(forces, name + "_torch")(f8, dens, real, cand, count, t["params"],
                                          r2_mxu=True, **kw).cpu().numpy()
    np.testing.assert_allclose(a.cpu().numpy(), a0, atol=1e-5 * np.abs(a0).max())
    if name == "forces_q128_c32":
        sub = kw.get("rows", 128) // 32
        a32 = forces.forces_q32_c32(f8, dens, real, cand.repeat_interleave(sub, dim=0),
                                    count.repeat_interleave(sub), t["params"], r2_mxu=True)
        assert torch.equal(a, a32)


def _identity_margin_tables(params):
    """Two blocks far from the origin (centred coordinates about 100 h
    out, where the identity's rounding exceeds the box test's 1e-4
    margin). The 32 queries of subgroup g of block 0 sit on one point
    Q_g; run r of 8 candidates of block 1 sits on one point beside
    subgroup r // 4's, at Q_g + (d, 0, 0): for r % 4 = 0 a distance d
    whose box gap^2 is at or above h^2 (1 + 1e-4), where the direct box
    test culls, but whose identity r^2 lies below h^2 (a pair inside the
    support in the identity mode only); 2 h, 3 h (culled in both forms)
    and 0.5 h. Block 0's lists hold block 1's four 32-wide subblocks
    only, so the pairs beside the culled panels are the only ones of
    their queries besides the 0.5 h runs."""
    h = params.h
    h2 = np.float32(h * h)
    reach = np.float32(h2 * np.float32(1.0001))
    base = np.float32([97.0 * h, -83.0 * h, 61.0 * h])
    qs = [base + np.float32([0.0, 10.0 * g * h, 0.0]) for g in range(4)]

    def near_miss(q):
        for k in range(1, 400000):
            d = np.float32(h * (1.0 + k * 1e-6))
            c = q + np.float32([d, 0.0, 0.0])
            gx = np.float32(c[0] - q[0])
            if np.float32(gx * gx) < reach:
                continue
            r2 = density.pair_r2_identity(torch.as_tensor(q), torch.as_tensor(c))
            if float(r2) < float(h2):
                return c
            if np.float32(gx * gx) > 1.01 * h2:
                break
        raise AssertionError("no identity near miss beside the box margin")

    pos = np.zeros((256, 3), np.float32)
    for g in range(4):
        pos[32 * g:32 * g + 32] = qs[g]
    for r in range(16):
        g, k = divmod(r, 4)
        if k == 0:
            pos[128 + 8 * r:136 + 8 * r] = near_miss(qs[g])
        else:
            pos[128 + 8 * r:136 + 8 * r] = qs[g] + np.float32([(2.0, 3.0, 0.5)[k - 1] * h,
                                                               0.0, 0.0])
    pos4 = density.pos_pack(torch.as_tensor(pos), torch.ones(256, dtype=torch.bool))
    cand = torch.tensor([[4, 5, 6, 7], [0, 1, 2, 3]], dtype=torch.int32)
    count = torch.full((2,), 4, dtype=torch.int32)
    return pos4, cand, count


@pytest.mark.cuda
def test_mxu_cull_margin_pair_beside_culled_panel(tables, cuda):
    """The identity mode's box cull: a pair whose identity r^2 is below
    h^2 in a panel whose box gap lies beyond the direct test's reach. The
    plain versions count it in the identity mode and not in the direct
    one; every kernel must count it too (its reach widened by the
    identity's error bound), in the densities, the hit counts (c32 at 4
    and 1 groups, c16 over the same particles), and forces_q128_c32
    bit for bit against forces_q32_c32, which has no cull."""
    p = tables["params"]
    pos4, cand, count = _identity_margin_tables(p)
    d_id, h_id = density.density_c32_torch(pos4, cand, count, p, groups=4, r2_mxu=True)
    _, h_vpu = density.density_c32_torch(pos4, cand, count, p, groups=4)
    # subgroup g of row 0 against slot g (block 1's runs 4g .. 4g + 3):
    # the near miss counts in the identity mode only
    for g in range(4):
        assert int(h_id[g, g]) > int(h_vpu[g, g]) >= 32 * 8
    f8, dens, real = _small_force_pack(pos4, p, 26)
    dens = d_id
    f8 = forces.force_pack(pos4[:, :3].contiguous(), f8[:, 3:6].contiguous(), dens,
                           tait_pressure(dens, p), real, p.particle_mass)
    pos4, cand, count, f8, dens, real = _on(cuda, pos4, cand, count, f8, dens, real)
    for groups in (4, 1):
        d, hits = density.density_c32(pos4, cand, count, p, groups=groups, r2_mxu=True)
        d0, hits0 = density.density_c32_torch(pos4, cand, count, p, groups=groups,
                                              r2_mxu=True)
        np.testing.assert_allclose(d.cpu().numpy(), d0.cpu().numpy(), rtol=1e-5)
        assert torch.equal(hits, hits0), groups
    d16, h16 = density.density_c16(pos4, *_as_c16(cand, count), p, hit_sub=16, r2_mxu=True)
    assert torch.equal(h16.reshape(8, -1, 2).sum(-1, dtype=torch.int32),
                       density.density_c32(pos4, cand, count, p, r2_mxu=True)[1])
    a = forces.forces_q128_c32(f8, dens, real, cand, count, p, r2_mxu=True)
    a0 = forces.forces_q128_c32_torch(f8, dens, real, cand, count, p, r2_mxu=True)
    np.testing.assert_allclose(a.cpu().numpy(), a0.cpu().numpy(),
                               atol=1e-5 * float(a0.abs().max()))
    a32 = forces.forces_q32_c32(f8, dens, real, cand.repeat_interleave(4, dim=0),
                                count.repeat_interleave(4), p, r2_mxu=True)
    assert torch.equal(a, a32)


@pytest.mark.cuda
@pytest.mark.parametrize("over", [
    dict(max_candidates_sub=100, tier2_frac=2, tier2_mult=2, max_candidates_hit8=160,
         pair_r2="mxu"),
    dict(Q_PATH, pair_r2="mxu"),
    dict(Q_PATH, force_query_rows=128, pair_r2="mxu"),
    dict(pallas_variant="asm", cand_interval=1, density_sub16=False, force_sub8=False,
         pair_r2="mxu"),
    dict(neighbor_impl="tiles", cand_interval=1, density_sub16=False, force_sub8=False,
         tile_mode="mxu"),
], ids=["main-tier2", "q32", "q128", "asm", "tiles"])
def test_mxu_substeps_on_gpu_match_cpu(tables, cuda, over):
    """Whole identity-mode substeps on the card (kernels, the centre on
    the device) against the CPU (plain versions), on the clumped cloud."""
    p = tables["params"]
    st = _clumped_state(p, 14)
    dt = torch.tensor(p.max_dt, dtype=torch.float32)
    cfg = step.StepConfig(**over)
    c1, _, cf, _ = step.substep(st, dt, p, None, cfg)
    g1, _, gf, _ = step.substep(st.map(lambda a: a.to(cuda)), dt.to(cuda), p, None, cfg)
    assert int(cf) == int(gf) == 0
    torch.testing.assert_close(g1.grid_index.cpu(), c1.grid_index)
    np.testing.assert_allclose(g1.density.cpu().numpy(), c1.density.numpy(), rtol=1e-5)
    a = c1.acceleration.numpy()
    np.testing.assert_allclose(g1.acceleration.cpu().numpy(), a, atol=1e-5 * np.abs(a).max())
