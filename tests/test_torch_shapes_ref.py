"""Shared inputs of test_torch_shapes_tables.py and
test_torch_shapes_aabb.py: the port's candidate tables on finer query
blocks, other block sizes and the aabb refine, against the JAX
package's.

For each (block_size, q_rows, refine_mode) the JAX side runs the
composition of ``libclsph_tpu/engine/step.py:424-490`` and ``:674-683``
with the JAX package's own functions: the block search, each query
block's copy of its parent's list (q_rep = block_size / q_rows), the
exact refine against the query rows' split boxes or the aabb refine
against the query blocks' boxes, ``fused_density_nl`` at ``q_rows`` rows
with one hit row a list (interpret mode on the CPU), ``compact_hits``
per list and ``fused_forces_nl`` over the compacted lists. The port runs
``engine.step.build_candidates``, ``density_c32_torch`` at ``rows``,
``hit_lists`` and ``forces_q128_c32_torch`` at ``rows`` on the same
sorted cloud. The integer tables (refined ids and counts, hit counts,
compacted ids and counts) must be equal; density agrees to rtol 1e-5,
the acceleration to atol 1e-4 * max|a| (the JAX kernel's x_i * sum(a) -
sum(a x_j) form; ROADMAP section 3 item 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from conftest import WATER, make_params
from libclsph_tpu.ops import interactions as jinter
from libclsph_tpu.ops import tiles as jtiles
from libclsph_tpu.ops.pallas import neighbor_nl as nl
from libclsph_tpu_torch import interop
from libclsph_tpu_torch.core.state import ParticleState
from libclsph_tpu_torch.engine import step as tstep
from libclsph_tpu_torch.ops.kernels import density, forces
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

N = 1024
CAP_SUB, CAP_HIT = 160, 128
Q_PATH = dict(density_sub16=False, force_sub16=False, force_sub8=False, cand_interval=1,
              max_candidates=96, max_candidates_sub=CAP_SUB, max_candidates_hit=CAP_HIT)
JPARAMS = make_params(WATER, n=N)
TERMS = JPARAMS.precomputed()
NP = jtiles.padded_count(N, 256)  # every shape pads to the largest block's count


# One jitted program a kernel: every shape pads to NP, so shapes with the
# same query rows give the kernels the same array shapes, and a module's
# second shape of those rows reuses the first's compile instead of
# lowering the interpreted kernels again.
@jax.jit
def _density_nl(q_pos, c_pos, cand_sub, count_sub, real):
    return nl.fused_density_nl(q_pos, c_pos, cand_sub, count_sub, JPARAMS, TERMS, real,
                               want_hits=True)


@jax.jit
def _forces_nl(q_force, c_force, cand_f, count_f, real, dens):
    return nl.fused_forces_nl(q_force, c_force, cand_f, count_f, JPARAMS, TERMS, real, dens)


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def T(a):
    return torch.as_tensor(np.array(a))


def _sorted_cloud(params):
    """A random cloud padded to NP particles (whole superblocks at every
    block size) and sorted by a coarse cell key (any sorted order serves:
    both sides get it)."""
    rng = np.random.default_rng(31)
    side = params.initial_volume ** (1 / 3) * 1.2
    pos = ((rng.random((N, 3)) - 0.5) * side).astype(np.float32)
    pos[1] = pos[0]  # a coincident pair of distinct particles
    vel = (rng.normal(size=(N, 3)) * 0.5).astype(np.float32)
    far = pos.max(axis=0) + 1000.0 * params.h
    pos = np.concatenate([pos, np.broadcast_to(far, (NP - N, 3))]).astype(np.float32)
    vel = np.concatenate([vel, np.zeros((NP - N, 3), np.float32)])
    cell = np.floor(pos / (2 * params.h)).astype(np.int64)
    key = (cell[:, 0] * 1_000_003 + cell[:, 1]) * 1_000_003 + cell[:, 2]
    key[N:] = np.iinfo(np.int64).max
    order = np.argsort(key, kind="stable")
    return pos[order], vel[order], order < N


def _jax_side(params, pos, vel, real, block, q_rows, mode):
    """JAX step.py:424-490 and :674-683 at this shape, as NumPy."""
    nb = pos.shape[0] // block
    q_rep = block // q_rows
    sub = block // nl.SUB
    pos_b = jnp.asarray(pos.reshape(nb, block, 3))
    real_j = jnp.asarray(real)
    real_b = real_j.reshape(nb, block)
    bmin, bmax = jtiles.split_block_bounds(pos_b, real_b)
    cand, count, ovf = jtiles.candidate_blocks_auto(bmin, bmax, params.h, 96)
    cand_q, count_q = jnp.repeat(cand, q_rep, axis=0), jnp.repeat(count, q_rep, axis=0)
    nb_q = nb * q_rep
    self_lo = (jnp.arange(nb_q, dtype=jnp.int32) // q_rep) * sub
    if mode == "exact":
        if q_rep > 1:
            qlo, qhi = jtiles.split_block_bounds(pos_b.reshape(nb_q, q_rows, 3),
                                                 real_b.reshape(nb_q, q_rows))
        else:
            qlo, qhi = bmin, bmax
        cand_sub, count_sub, ovf2 = jtiles.refine_candidates_exact(
            cand_q, count_q, qlo, qhi, pos_b, params.h, sub, CAP_SUB,
            self_lo=self_lo, self_width=sub)
    else:
        sub_lo, sub_hi = jtiles.subblock_bounds(pos_b, real_b, sub)
        if q_rep > 1:
            qlo, qhi = jtiles.subblock_bounds(pos_b, real_b, q_rep)
            qlo, qhi = qlo[:, None, :], qhi[:, None, :]
        else:
            qlo, qhi = bmin, bmax
        cand_sub, count_sub, ovf2 = jtiles.refine_candidates(
            cand_q, count_q, qlo, qhi, sub_lo, sub_hi, params.h, sub, CAP_SUB,
            self_lo=self_lo, self_width=sub)
    assert not bool(ovf) and not bool(ovf2)
    zeros = jnp.zeros(pos.shape[0], jnp.float32)
    pj, vj = jnp.asarray(pos), jnp.asarray(vel)
    q_pos, _ = nl.make_query_planes(pj, vj, zeros, zeros, real_j, q_rows,
                                    mass=params.particle_mass)
    c_pos, _ = nl.make_csub_packs(pj, vj, zeros, zeros, real_j, mass=params.particle_mass)
    dens, hits = _density_nl(q_pos, c_pos, cand_sub, count_sub, real_j)
    hits = hits[:, : cand_sub.shape[1]]
    cand_f, count_f, ovf3 = jtiles.compact_hits(cand_sub, hits, CAP_HIT, self_lo=self_lo,
                                                self_width=sub)
    assert not bool(ovf3)
    pres = jnp.where(real_j, jinter.tait_pressure(dens, params), 0.0)
    _, q_force = nl.make_query_planes(pj, vj, dens, pres, real_j, q_rows,
                                      mass=params.particle_mass)
    _, c_force = nl.make_csub_packs(pj, vj, dens, pres, real_j, mass=params.particle_mass)
    accel = _forces_nl(q_force, c_force, cand_f, count_f, real_j, dens)
    out = dict(cand_sub=cand_sub, count_sub=count_sub, dens=dens, hits=hits, pres=pres,
               cand_f=cand_f, count_f=count_f, accel=accel)
    return {k: np.array(v) for k, v in out.items()}


def make_shape(block, q_rows, mode):
    """Both sides' inputs and the JAX side's outputs at one shape."""
    params = interop.params_from(JPARAMS)
    pos, vel, real = _sorted_cloud(JPARAMS)
    ref = _jax_side(JPARAMS, pos, vel, real, block, q_rows, mode)
    cfg = tstep.StepConfig(**Q_PATH, block_size=block, nl_query_rows=q_rows,
                           refine_mode=mode)
    assert (cfg.q_rows, cfg.q_rep) == (q_rows, block // q_rows)
    st = ParticleState.zeros(pos.shape[0], "cpu").replace(position=T(pos), velocity=T(vel))
    return dict(ref=ref, cfg=cfg, params=params, st=st, real=T(real), pos=pos, vel=vel,
                rows=q_rows)


def check_tables(shape):
    cand_sub, count_sub, flags = tstep.build_candidates(shape["st"], shape["real"],
                                                        shape["params"], shape["cfg"])
    assert int(flags) == 0
    ref = shape["ref"]
    np.testing.assert_array_equal(np_(cand_sub), ref["cand_sub"])
    np.testing.assert_array_equal(np_(count_sub), ref["count_sub"])
    assert ref["count_sub"].sum() > 0


def check_density_hits_and_lists(shape):
    """The plain density at ``rows`` against fused_density_nl at q_rows:
    densities, one hit row a list, and the per-list compaction."""
    ref, p, cfg = shape["ref"], shape["params"], shape["cfg"]
    pos4 = density.pos_pack(T(shape["pos"]), shape["real"])
    d, hits = density.density_c32_torch(pos4, T(ref["cand_sub"]), T(ref["count_sub"]), p,
                                        groups=1, rows=shape["rows"])
    np.testing.assert_allclose(np_(d), ref["dens"], rtol=1e-5)
    np.testing.assert_array_equal(np_(hits), ref["hits"].astype(np.int64))
    cand_f, count_f, flags = tstep.hit_lists(T(ref["cand_sub"]), hits, cfg, 1)
    assert int(flags) == 0
    np.testing.assert_array_equal(np_(cand_f), ref["cand_f"])
    np.testing.assert_array_equal(np_(count_f), ref["count_f"])


def check_forces(shape):
    """forces_q128_c32_torch at ``rows`` against fused_forces_nl at
    q_rows over the same compacted lists."""
    ref, p = shape["ref"], shape["params"]
    real = shape["real"]
    f8 = forces.force_pack(T(shape["pos"]), T(shape["vel"]), T(ref["dens"]), T(ref["pres"]),
                           real, p.particle_mass)
    a = np_(forces.forces_q128_c32_torch(f8, T(ref["dens"]), real, T(ref["cand_f"]),
                                         T(ref["count_f"]), p, rows=shape["rows"]))
    j = ref["accel"]
    np.testing.assert_allclose(a, j, atol=1e-4 * np.abs(j).max())
    assert not np.any(a[~np_(real)])
