"""The two hand kernels' plain versions against the JAX package's Pallas
kernels, and the kernel wrappers' dispatch.

(The CUDA kernels against their plain versions, on a GPU, are in
test_torch_cuda.py, which imports no JAX so it runs where the card is.)

The JAX side runs ``fused_density_nl(c16=True, hit_sub=8,
hit_groups=4)`` and ``fused_forces_nl32_c8`` in interpret mode (picked
automatically on the CPU) on tables built by its own candidate
machinery from one random cloud; the port's kernels get the same tables
and fields. Tolerances: density rtol 1e-5 and the force atol 1e-5 *
max|a| (test_physics.py:569) cover float32 summation order; hit counts
are integers and must be equal. The cloud holds one coincident pair of
distinct particles, so the spiky r -> 0 branch and the id-based
self-exclusion are exercised.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import WATER, make_params
from libclsph_tpu.ops import interactions as jinter
from libclsph_tpu.ops import tiles as jtiles
from libclsph_tpu.ops.pallas import neighbor_nl as nl
from libclsph_tpu_torch import interop
from libclsph_tpu_torch.ops import interactions as tinter
from libclsph_tpu_torch.ops.kernels import build, density, forces

N = 2000
B = 128


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def ref():
    """Sorted, padded cloud + the JAX main path's tables and kernel
    outputs, all as NumPy."""
    params = make_params(WATER, n=N)
    terms = params.precomputed()
    rng = np.random.default_rng(17)
    side = params.initial_volume ** (1 / 3) * 1.2
    pos = ((rng.random((N, 3)) - 0.5) * side).astype(np.float32)
    pos[1] = pos[0]  # a coincident pair of distinct particles
    vel = (rng.normal(size=(N, 3)) * 0.5).astype(np.float32)
    npad = jtiles.padded_count(N, B)
    far = pos.max(axis=0) + 1000.0 * params.h
    pos = np.concatenate([pos, np.broadcast_to(far, (npad - N, 3))]).astype(np.float32)
    vel = np.concatenate([vel, np.zeros((npad - N, 3), np.float32)])
    # a Morton-like locality order is not needed for correctness; sort by
    # a coarse cell key so blocks are compact
    cell = np.floor(pos / (2 * params.h)).astype(np.int64)
    key = (cell[:, 0] * 1_000_003 + cell[:, 1]) * 1_000_003 + cell[:, 2]
    key[N:] = np.iinfo(np.int64).max
    order = np.argsort(key, kind="stable")
    pos, vel = pos[order], vel[order]
    real = order < N
    nb = npad // B
    sub = B // 16
    cap_sub, cap8 = 192, 96

    pos_b = jnp.asarray(pos.reshape(nb, B, 3))
    real_j = jnp.asarray(real)
    bmin, bmax = jtiles.split_block_bounds(pos_b, real_j.reshape(nb, B))
    cand, count, ovf = jtiles.candidate_blocks_auto(bmin, bmax, params.h, 96)
    self_lo = jnp.arange(nb, dtype=jnp.int32) * sub
    cand_sub, count_sub, ovf2 = jtiles.refine_candidates_exact(
        cand, count, bmin, bmax, pos_b, params.h, sub, cap_sub,
        self_lo=self_lo, self_width=sub,
    )
    assert not bool(ovf) and not bool(ovf2)
    zeros = jnp.zeros(npad, jnp.float32)
    q_pos, _ = nl.make_query_planes(jnp.asarray(pos), jnp.asarray(vel), zeros, zeros,
                                    real_j, B, mass=params.particle_mass)
    c16 = nl.make_c16_pos_pack(jnp.asarray(pos), real_j)
    dens, hits = nl.fused_density_nl(
        q_pos, c16, cand_sub, count_sub, params, terms, real_j,
        want_hits=True, hit_groups=nl.QG, hit_sub=nl.SUB8, c16=True,
    )
    sent = jtiles.REFINE_SENTINEL
    twice = jnp.where(cand_sub == sent, sent, cand_sub * 2)
    ids8 = jnp.stack([twice, jnp.where(cand_sub == sent, sent, twice + 1)],
                     axis=-1).reshape(nb, -1)
    cand8, count8, ovf3 = jtiles.compact_hits(
        jnp.repeat(ids8, nl.QG, axis=0), hits[:, : ids8.shape[1]], cap8,
        self_lo=jnp.repeat(self_lo * 2, nl.QG), self_width=2 * sub,
    )
    assert not bool(ovf3)
    pres = jnp.where(real_j, jinter.tait_pressure(dens, params), 0.0)
    _, q_force = nl.make_query_planes(jnp.asarray(pos), jnp.asarray(vel), dens, pres,
                                      real_j, B, mass=params.particle_mass)
    c8 = nl.make_c8_force_pack(jnp.asarray(pos), jnp.asarray(vel), dens, pres, real_j,
                               mass=params.particle_mass)
    accel = nl.fused_forces_nl32_c8(q_force, c8, cand8, count8, params, terms, real_j, dens)
    out = dict(pos=pos, vel=vel, real=real, cand_sub=cand_sub, count_sub=count_sub,
               dens=dens, hits=hits[:, : 2 * cap_sub], cand8=cand8, count8=count8,
               pres=pres, accel=accel)
    out = {k: np.array(v) for k, v in out.items()}
    out["params"] = interop.params_from(params)
    return out


def _density_args(r, device="cpu"):
    t = lambda k: torch.as_tensor(r[k], device=device)  # noqa: E731
    return (density.pos_pack(t("pos"), t("real")), t("cand_sub"), t("count_sub"),
            r["params"])


def _force_args(r, device="cpu"):
    t = lambda k: torch.as_tensor(r[k], device=device)  # noqa: E731
    f8 = forces.force_pack(t("pos"), t("vel"), t("dens"), t("pres"), t("real"),
                           r["params"].particle_mass)
    return (f8, t("dens"), t("real"), t("cand8"), t("count8"), r["params"])


def test_density_plain_matches_pallas(ref):
    d, hits = density.density_c16_hit8_torch(*_density_args(ref))
    np.testing.assert_allclose(np_(d), ref["dens"], rtol=1e-5)
    assert hits.dtype == torch.int32 and hits.shape == ref["hits"].shape
    np.testing.assert_array_equal(np_(hits), ref["hits"].astype(np.int64))
    assert ref["hits"].sum() > 0


def test_force_plain_matches_pallas(ref):
    a = np_(forces.forces_q32_c8_torch(*_force_args(ref)))
    np.testing.assert_allclose(a, ref["accel"], atol=1e-5 * np.abs(ref["accel"]).max())
    assert not np.any(a[~ref["real"]])


def test_plain_versions_match_all_pairs_physics(ref):
    """Tables + kernels reproduce the O(N^2) reference sums
    (interactions.density_sum / force_sums / combine_forces over every
    pair), so nothing inside the support radius was dropped."""
    p = ref["params"]
    terms = p.precomputed()
    real = ref["real"]
    pos = torch.as_tensor(ref["pos"][real])
    vel = torch.as_tensor(ref["vel"][real])
    n = pos.shape[0]
    valid = torch.ones((n, n), dtype=torch.bool)
    d_all = tinter.density_sum(pos, pos[None].expand(n, n, 3), valid, p, terms)
    d, _ = density.density_c16_hit8_torch(*_density_args(ref))
    np.testing.assert_allclose(np_(d)[real], np_(d_all), rtol=1e-5)
    pr = tinter.tait_pressure(d_all, p)
    f = tinter.force_sums(pos, vel, d_all, pr, pos[None].expand(n, n, 3),
                          vel[None].expand(n, n, 3), d_all[None].expand(n, n),
                          pr[None].expand(n, n), valid, torch.eye(n, dtype=torch.bool),
                          p, terms)
    a_all = np_(tinter.combine_forces(f, d_all, p))
    ref_d = dict(ref, dens=np_(d_all).copy(), pres=np_(pr).copy())
    full_d = np.full(ref["dens"].shape, p.fluid_density, np.float32)
    full_p = np.zeros_like(full_d)
    full_d[real], full_p[real] = ref_d["dens"], ref_d["pres"]
    a = np_(forces.forces_q32_c8_torch(*_force_args(dict(ref, dens=full_d, pres=full_p))))
    # the coincident pair's singular pressure splat is the same in both
    np.testing.assert_allclose(a[real], a_all, atol=1e-5 * np.abs(a_all).max())


def test_wrappers_take_the_plain_version_on_cpu(ref):
    before = (density.density_c16_hit8.launches, forces.forces_q32_c8.launches)
    d, hits = density.density_c16_hit8(*_density_args(ref))
    d0, hits0 = density.density_c16_hit8_torch(*_density_args(ref))
    assert torch.equal(d, d0) and torch.equal(hits, hits0)
    a = forces.forces_q32_c8(*_force_args(ref))
    assert torch.equal(a, forces.forces_q32_c8_torch(*_force_args(ref)))
    # counters count kernel launches only
    assert (density.density_c16_hit8.launches, forces.forces_q32_c8.launches) == before


def test_wrappers_refuse_other_devices_and_bad_inputs(ref):
    args = _density_args(ref)
    with pytest.raises(ValueError, match="unsupported device"):
        density.density_c16_hit8(*(a.to("meta") for a in args[:3]), args[3])
    with pytest.raises(ValueError, match="int32"):
        density.density_c16_hit8(args[0], args[1].long(), args[2], args[3])
    fargs = _force_args(ref)
    with pytest.raises(ValueError, match="unsupported device"):
        forces.forces_q32_c8(*(a.to("meta") for a in fargs[:5]), fargs[5])
    with pytest.raises(ValueError, match="multiple of 128"):
        forces.forces_q32_c8(fargs[0][:100], *fargs[1:])


def test_build_is_keyed_by_source_hash():
    path = build.library_path()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libclsph_kernels_") and path.suffix == ".so"
    assert {p.name for p in build.sources()} >= {"density_c16_hit8.cu", "forces_q32_c8.cu"}
    assert build.library_path() == path
