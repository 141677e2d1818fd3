"""The identity mode of the nl and asm kernels (``StepConfig.pair_r2 =
"mxu"``) of the port against the JAX package's kernels at ``r2_mxu=True``.

The JAX side runs ``fused_density_nl`` (c16 at hit_sub 8 and 16; c32 at
4 and 1 hit groups), ``fused_forces_nl32_c8``, ``fused_forces_nl32_c16``,
``fused_forces_nl32``, ``fused_forces_nl`` and the asm pair
``fused_density_asm`` / ``fused_forces_asm`` in interpret mode (picked
automatically on the CPU) on packs centred on the domain, the centre as
``engine/step.py:380-385`` forms it; the port's plain versions get the
same tables and the same centre, formed by ``engine.step.domain_center``
(bit-equal to JAX's). The cloud sits off the origin, so the centring
matters.

Tolerances: accelerations atol 1e-4 * max|a| (the identity rounds at
about |p|^2 * 6e-8 on both sides, in other orders; the JAX force kernels
also take the x_i * sum(a) - sum(a x_j) form). Densities rtol 1e-5 (the
summation order) plus, per query, the first-order effect of both sides'
identity errors, each below 12 * 2^-24 (|q|^2 + |c|^2) a pair
(sph_pair.cuh): m poly6 sum_j 3 t_j^2 * 24 * 2^-24 (|q|^2 + |c|^2). The
identity alone moves a density by more than 1e-5 here: JAX's kernel and
the port's each differ from the float64 densities by about 2e-5 at this
cloud (|p| up to 8 h), so a bare rtol 1e-5 cannot hold between them. The
hit tables must be equal cell for cell except where a cell holds pairs
whose exact r^2 (float64) lies within the identity's error band of h^2,
2^-19 (|q|^2 + |c|^2): there the two sides may differ by at most that
many pairs. The number of such pairs is printed; the seed is not chosen
to empty the band. The force lists are JAX's, compacted from its hits,
so each force kernel is compared on identical lists.
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
from libclsph_tpu_torch.engine import step as tstep
from libclsph_tpu_torch.ops.kernels import density, forces
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

N = 2000
B = 128
CAP16, CAP32, CAP8, CAP_F16, CAP_HIT = 192, 96, 96, 96, 96
BAND = 2.0 ** -19  # the identity's error band, relative to |q|^2 + |c|^2
OFFSET = np.float32([0.31, -0.17, 0.44])  # where the cloud sits


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def T(a):
    return torch.as_tensor(np.array(a))


def _tables(pos_b, real_j, bmin, bmax, cand, count, params, sub, cap):
    nb = pos_b.shape[0]
    self_lo = jnp.arange(nb, dtype=jnp.int32) * sub
    cand_sub, count_sub, ovf = jtiles.refine_candidates_exact(
        cand, count, bmin, bmax, pos_b, params.h, sub, cap,
        self_lo=self_lo, self_width=sub)
    assert not bool(ovf)
    return cand_sub, count_sub, self_lo


def _split(cand_sub, parts):
    """Ids split into ``parts`` runs each (slot j -> ids j*parts + e)."""
    sent = jtiles.REFINE_SENTINEL
    ids = [jnp.where(cand_sub == sent, sent, cand_sub * parts + e) for e in range(parts)]
    return jnp.stack(ids, axis=-1).reshape(cand_sub.shape[0], -1)


@pytest.fixture(scope="module")
def ref():
    """Sorted, padded cloud off the origin; JAX's identity-mode kernel
    outputs on centred packs, all as NumPy."""
    params = make_params(WATER, n=N)
    terms = params.precomputed()
    rng = np.random.default_rng(41)
    side = params.initial_volume ** (1 / 3) * 1.2
    pos = ((rng.random((N, 3)) - 0.5) * side + OFFSET).astype(np.float32)
    vel = (rng.normal(size=(N, 3)) * 0.5).astype(np.float32)
    npad = jtiles.padded_count(N, B)
    far = pos.max(axis=0) + 1000.0 * params.h
    pos = np.concatenate([pos, np.broadcast_to(far, (npad - N, 3))]).astype(np.float32)
    vel = np.concatenate([vel, np.zeros((npad - N, 3), np.float32)])
    cell = np.floor(pos / (2 * params.h)).astype(np.int64)
    key = (cell[:, 0] * 1_000_003 + cell[:, 1]) * 1_000_003 + cell[:, 2]
    key[N:] = np.iinfo(np.int64).max
    order = np.argsort(key, kind="stable")
    pos, vel = pos[order], vel[order]
    real = order < N
    nb = npad // B

    pj, vj, real_j = jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(real)
    # the centre as libclsph_tpu/engine/step.py:380-385 forms it
    real_pos = jnp.where(real_j[:, None], pj, pj[0])
    center = 0.5 * (jnp.min(real_pos, axis=0) + jnp.max(real_pos, axis=0))
    pos_b = pj.reshape(nb, B, 3)
    bmin, bmax = jtiles.split_block_bounds(pos_b, real_j.reshape(nb, B))
    cand, count, ovf = jtiles.candidate_blocks_auto(bmin, bmax, params.h, 96)
    assert not bool(ovf)
    c16, n16, lo16 = _tables(pos_b, real_j, bmin, bmax, cand, count, params, B // 16, CAP16)
    c32, n32, lo32 = _tables(pos_b, real_j, bmin, bmax, cand, count, params, B // 32, CAP32)
    mass = params.particle_mass
    zeros = jnp.zeros(npad, jnp.float32)
    q_pos, _ = nl.make_query_planes(pj, vj, zeros, zeros, real_j, B, mass=mass,
                                    center=center)
    p16 = nl.make_c16_pos_pack(pj, real_j, center=center)
    p32, _ = nl.make_csub_packs(pj, vj, zeros, zeros, real_j, mass=mass, center=center)
    pparent, _ = nl.make_cparent_packs(pj, vj, zeros, zeros, real_j, mass=mass,
                                       center=center)
    out = dict(pos=pos, vel=vel, real=real, center=center, c16=c16, n16=n16, c32=c32,
               n32=n32)

    def dens(q, c, cand_, count_, **kw):
        return nl.fused_density_nl(q, c, cand_, count_, params, terms, real_j,
                                   r2_mxu=True, want_hits=True, **kw)

    out["d8"], h8 = dens(q_pos, p16, c16, n16, hit_groups=nl.QG, hit_sub=nl.SUB8, c16=True)
    out["d16"], h16 = dens(q_pos, p16, c16, n16, hit_groups=nl.QG, hit_sub=nl.SUB16,
                           c16=True)
    out["d32g4"], h32g4 = dens(q_pos, p32, c32, n32, hit_groups=nl.QG, hit_sub=nl.SUB,
                               c16=False)
    out["d32g1"], h32g1 = dens(q_pos, p32, c32, n32, hit_groups=1, hit_sub=nl.SUB,
                               c16=False)
    out["dasm"], hasm = nl.fused_density_asm(q_pos, pparent, c32, n32, params, terms,
                                             real_j, r2_mxu=True, want_hits=True)
    out.update(h8=h8[:, : 2 * CAP16], h16=h16[:, :CAP16], h32g4=h32g4[:, :CAP32],
               h32g1=h32g1[:, :CAP32], hasm=hasm[:, :CAP32])

    dens_ = out["d8"]
    pres = jnp.where(real_j, jinter.tait_pressure(dens_, params), 0.0)
    out.update(dens=dens_, pres=pres)
    _, q_force = nl.make_query_planes(pj, vj, dens_, pres, real_j, B, mass=mass,
                                      center=center)
    _, f32 = nl.make_csub_packs(pj, vj, dens_, pres, real_j, mass=mass, center=center)
    f16 = nl.make_c16_force_pack(pj, vj, dens_, pres, real_j, mass=mass, center=center,
                                 with_gid=False)
    f8 = nl.make_c8_force_pack(pj, vj, dens_, pres, real_j, mass=mass, center=center)
    _, fparent = nl.make_cparent_packs(pj, vj, dens_, pres, real_j, mass=mass,
                                       center=center)

    def compact(ids, hits, cap, self_lo, width, groups):
        rep = (lambda a: jnp.repeat(a, groups, axis=0)) if groups > 1 else (lambda a: a)
        cf, nf, ovf = jtiles.compact_hits(rep(ids), hits, cap, self_lo=rep(self_lo),
                                          self_width=width)
        assert not bool(ovf)
        return cf, nf

    sub16, sub32 = B // 16, B // 32
    lists = dict(
        c8=compact(_split(c16, 2), out["h8"], CAP8, lo16 * 2, 2 * sub16, nl.QG),
        c16=compact(c16, out["h16"], CAP_F16, lo16, sub16, nl.QG),
        c32=compact(c32, out["h32g4"], max(32, CAP_HIT // 2), lo32, sub32, nl.QG),
        q128=compact(c32, out["h32g1"], CAP_HIT, lo32, sub32, 1),
    )
    call = dict(c8=(nl.fused_forces_nl32_c8, f8), c16=(nl.fused_forces_nl32_c16, f16),
                c32=(nl.fused_forces_nl32, f32), q128=(nl.fused_forces_nl, f32))
    for name, (fn, pack) in call.items():
        cf, nf = lists[name]
        out[f"cand_{name}"], out[f"count_{name}"] = cf, nf
        out[f"a_{name}"] = fn(q_force, pack, cf, nf, params, terms, real_j, dens_,
                              r2_mxu=True)
    cf, nf = lists["q128"]
    out["a_asm"] = nl.fused_forces_asm(q_force, fparent, cf, nf, params, terms, real_j,
                                       dens_, r2_mxu=True)
    out = {k: np.array(v) for k, v in out.items()}
    out["params"] = interop.params_from(params)
    return out


def _pos4(r):
    return density.pos_pack(T(r["pos"]), T(r["real"]), T(r["center"]))


def _f8(r):
    return forces.force_pack(T(r["pos"]), T(r["vel"]), T(r["dens"]), T(r["pres"]),
                             T(r["real"]), r["params"].particle_mass, center=T(r["center"]))


def band_pairs(r, cand, width, hit_sub, groups):
    """Per hit cell of a (cand: (nb, cap) ids of ``width`` particles) table
    at ``hit_sub`` and ``groups``: the pairs (any-query particles at one
    group) whose exact r^2 lies within the identity's band of h^2."""
    h2 = float(r["params"].h) ** 2
    p = r["pos"].astype(np.float64) - r["center"].astype(np.float64)
    nb, cap = cand.shape
    runs = width // hit_sub
    q = p.reshape(nb, groups or 1, -1, 3)  # (nb, G, Q, 3)
    ids = np.where(cand < jtiles.REFINE_SENTINEL, cand, 0)
    cpos = p[ids[..., None] * width + np.arange(width)]  # (nb, cap, width, 3)
    d2 = np.sum((q[:, :, :, None, None] - cpos[:, None, None]) ** 2, axis=-1)
    n2 = (np.sum(q ** 2, -1)[:, :, :, None, None]
          + np.sum(cpos ** 2, -1)[:, None, None])
    near = np.abs(d2 - h2) <= BAND * n2  # (nb, G, Q, cap, width)
    near &= (cand < jtiles.REFINE_SENTINEL)[:, None, None, :, None]
    if groups == 1:
        per = near.any(axis=2).reshape(nb, cap, runs, hit_sub).sum(-1)
        return per.reshape(nb, cap * runs)
    return near.sum(axis=2).reshape(nb, groups, cap, runs, hit_sub).sum(-1).reshape(
        nb * groups, cap * runs)


def density_allowance(r, cand, width):
    """Per query: 1e-5 of its density plus the first-order effect of both
    sides' identity errors over its candidates (float64)."""
    p = r["params"]
    h2, poly6 = float(p.h) ** 2, float(p.precomputed().poly_6)
    pc = r["pos"].astype(np.float64) - r["center"].astype(np.float64)
    nb, cap = cand.shape
    ids = (np.where(cand < jtiles.REFINE_SENTINEL, cand, 0)[..., None] * width
           + np.arange(width)).reshape(nb, cap * width)
    live = np.repeat(cand < jtiles.REFINE_SENTINEL, width, axis=1) & r["real"][ids]
    q = pc.reshape(nb, -1, 3)
    c = pc[ids]
    t = np.clip(h2 - np.sum((q[:, :, None] - c[:, None]) ** 2, -1), 0.0, None)
    s = np.sum(q ** 2, -1)[:, :, None] + np.sum(c ** 2, -1)[:, None]
    eps = 24 * 2.0 ** -24 * s
    first = float(p.particle_mass) * poly6 * np.sum(3 * t * t * eps * live[:, None], -1)
    return first.reshape(-1)


def assert_densities_match(port, jax_d, r, cand, width):
    allow = 1e-5 * np.abs(jax_d) + density_allowance(r, cand, width)
    diff = np.abs(np_(port) - jax_d)
    assert np.all(diff <= allow), (diff.max(), np.argmax(diff - allow))
    return float(np.max(diff / np.abs(jax_d)))


def assert_hits_match(port, jax_hits, band):
    """Equal cell for cell but where the band explains the difference;
    returns the band's pairs."""
    diff = np.abs(np_(port).astype(np.int64) - jax_hits.astype(np.int64))
    bad = diff > band
    assert not bad.any(), (np.argwhere(bad)[:5], diff[bad][:5], band[bad][:5])
    assert jax_hits.sum() > 0
    return int(band.sum())


def test_center_bit_equal_to_jax(ref):
    c = tstep.domain_center(T(ref["pos"]), T(ref["real"]))
    assert c.dtype == torch.float32
    np.testing.assert_array_equal(np_(c), ref["center"])
    assert np.abs(ref["center"]).min() > 0.01  # the cloud is off the origin


@pytest.mark.parametrize("hit_sub", [8, 16])
def test_density_c16_mxu_matches_pallas(ref, hit_sub):
    d, hits = density.density_c16_torch(_pos4(ref), T(ref["c16"]), T(ref["n16"]),
                                        ref["params"], hit_sub=hit_sub, r2_mxu=True)
    band = band_pairs(ref, ref["c16"], 16, hit_sub, 4)
    n_band = assert_hits_match(hits, ref[f"h{hit_sub}"], band)
    rel = assert_densities_match(d, ref[f"d{hit_sub}"], ref, ref["c16"], 16)
    print(f"c16 hit_sub {hit_sub}: {n_band} pairs in the identity's band of h^2; "
          f"densities within {rel:.3g} relative")


@pytest.mark.parametrize("groups", [4, 1])
def test_density_c32_mxu_matches_pallas(ref, groups):
    d, hits = density.density_c32_torch(_pos4(ref), T(ref["c32"]), T(ref["n32"]),
                                        ref["params"], groups=groups, r2_mxu=True)
    band = band_pairs(ref, ref["c32"], 32, 32, groups)
    n_band = assert_hits_match(hits, ref[f"h32g{groups}"], band)
    rel = assert_densities_match(d, ref[f"d32g{groups}"], ref, ref["c32"], 32)
    print(f"c32 groups {groups}: {n_band} pairs in the identity's band of h^2; "
          f"densities within {rel:.3g} relative")


def test_density_asm_mxu_matches_pallas(ref):
    """The asm variant's density runs density_c32 at one hit row a list:
    densities and the slots with a hit against fused_density_asm's."""
    d, hits = density.density_c32_torch(_pos4(ref), T(ref["c32"]), T(ref["n32"]),
                                        ref["params"], groups=1, r2_mxu=True)
    assert_densities_match(d, ref["dasm"], ref, ref["c32"], 32)
    band = band_pairs(ref, ref["c32"], 32, 32, 1)
    flips = (np_(hits) > 0) != (ref["hasm"] > 0)
    assert not (flips & (band == 0)).any()
    assert (ref["hasm"] > 0).sum() > 0


@pytest.mark.parametrize("name,fn", [
    ("c8", forces.forces_q32_c8_torch), ("c16", forces.forces_q32_c16_torch),
    ("c32", forces.forces_q32_c32_torch), ("q128", forces.forces_q128_c32_torch),
    ("asm", forces.forces_q128_c32_torch),
], ids=["q32-c8", "q32-c16", "q32-c32", "q128", "asm"])
def test_forces_mxu_match_pallas(ref, name, fn):
    lists = "q128" if name == "asm" else name
    a = np_(fn(_f8(ref), T(ref["dens"]), T(ref["real"]), T(ref[f"cand_{lists}"]),
               T(ref[f"count_{lists}"]), ref["params"], r2_mxu=True))
    j = ref[f"a_{name}"]
    np.testing.assert_allclose(a, j, atol=1e-4 * np.abs(j).max())
    assert not np.any(a[~ref["real"]])


def test_identity_mode_differs_from_direct_within_its_band(ref):
    """The mode is a mode: on the same centred inputs the direct form's
    densities and hits differ from the identity's only at rounding level
    and inside the band."""
    args = (_pos4(ref), T(ref["c16"]), T(ref["n16"]), ref["params"])
    d_id, h_id = density.density_c16_torch(*args, r2_mxu=True)
    d_vpu, h_vpu = density.density_c16_torch(*args)
    assert not torch.equal(d_id, d_vpu)
    assert_densities_match(d_id, np_(d_vpu), ref, ref["c16"], 16)
    band = band_pairs(ref, ref["c16"], 16, 8, 4)
    assert_hits_match(h_id, np_(h_vpu), band)


def test_identity_r2_of_equal_points_is_zero():
    """Its fixed order gives exactly 0 for a point against itself (the
    self pairs), and fmax turns the NaN of two 1e32 sentinels into 0, as
    the kernels' fmaxf does; the clamp holds r^2 at 0 or above."""
    rng = np.random.default_rng(3)
    p = torch.as_tensor((rng.random((4096, 3)) * 3 - 1.5).astype(np.float32))
    assert torch.all(density.pair_r2_identity(p, p) == 0)
    far = torch.full((1, 3), 1.0e32)
    assert density.pair_r2_identity(far, far).item() == 0.0
    assert torch.isinf(density.pair_r2_identity(p[:1], far)).all()
    q = p[:, None]
    assert torch.all(density.pair_r2_identity(q, p[None, :64]) >= 0)
