"""The gated reuse density and two-tier routing on the 16-wide force path,
in the port against the JAX package.

* ``density_gated16``: the JAX ``fused_density_gated16`` on a carried
  c16 table and the mask of its build (``fused_density_nl`` with
  ``hit2_h``, ``pack_tile_nibbles``), at positions moved within the
  staleness guard, against the port's plain version; and, in the port,
  gated against ungated: density and hit counts bit for bit.
* Whole substeps (a rebuild and a reuse substep, the port's reuse from
  the JAX rebuild's state and tables) of (density_sub16, force_sub16,
  force_sub8) = (True, True, False) with ``density_gate`` and
  ``cand_interval=2`` (the carried mask is compared bit for bit) in
  test_torch_gate_pair.py, and with two-tier routing in
  test_torch_gate_tier2.py (files of their own, so that no file sets the
  length of a parallel run).
* The frame loop with and without the gate gives the same state, bit
  for bit, on the CPU.

Tolerances as in test_torch_sub16.py. JAX's gated kernel counts, per
(subgroup, slot), the candidates that some query of the subgroup hits,
where its ungated kernel and both of the port's count pairs: the counts
are > 0 on the same slots, which is all the hit compaction reads, so the
JAX comparison of the gated hits is of ``hits > 0``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import WATER, make_params
from libclsph_tpu.ops import tiles as jtiles
from libclsph_tpu.ops.pallas import neighbor_nl as nl
from libclsph_tpu_torch import interop
from libclsph_tpu_torch.engine import step as tstep
from libclsph_tpu_torch.ops.kernels import density
from test_torch_step import random_state
from test_torch_sub16 import SHAPES, jax_blocks, sorted_cloud
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

N = 2000
B = 128
SLACK = 0.25
CAP_SUB = 192
TTF = dict(SHAPES[16], max_candidates_hit16=192)


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def gated():
    """A c16 table and its mask built at (1 + slack) h on the anchor
    positions, then JAX's gated and ungated density at positions moved
    by up to 0.104 h (under the guard's slack * h / 2), all as NumPy."""
    params = make_params(WATER, n=N)
    terms = params.precomputed()
    pos, _, real = sorted_cloud(params, N, 71)
    nb = pos.shape[0] // B
    h_search = params.h * (1.0 + SLACK)
    pos_b, bmin, bmax, cand, count = jax_blocks(pos, real, h_search)
    self_lo = jnp.arange(nb, dtype=jnp.int32) * 8
    cand16, count16, ovf = jtiles.refine_candidates_exact(
        cand, count, bmin, bmax, pos_b, h_search, 8, CAP_SUB, self_lo=self_lo,
        self_width=8)
    assert not bool(ovf)
    real_j = jnp.asarray(real)
    zeros = jnp.zeros(pos.shape[0], jnp.float32)

    def packs(p):
        q_pos, _ = nl.make_query_planes(jnp.asarray(p), jnp.zeros(p.shape, jnp.float32),
                                        zeros, zeros, real_j, B, mass=params.particle_mass)
        return q_pos, nl.make_c16_pos_pack(jnp.asarray(p), real_j)

    q_pos, c_pos = packs(pos)
    _, _, tiles = nl.fused_density_nl(
        q_pos, c_pos, cand16, count16, params, terms, real_j, want_hits=True,
        hit_groups=nl.QG, hit_sub=nl.SUB16, c16=True, hit2_h=h_search)
    mask = nl.pack_tile_nibbles(tiles, nb)
    rng = np.random.default_rng(72)
    moved = (pos + rng.uniform(-1, 1, pos.shape) * 0.06 * params.h).astype(np.float32)
    q_pos, c_pos = packs(moved)
    dens_g, hits_g = nl.fused_density_gated16(q_pos, c_pos, cand16, count16, mask,
                                              params, terms, real_j)
    dens_u, hits_u = nl.fused_density_nl(
        q_pos, c_pos, cand16, count16, params, terms, real_j, want_hits=True,
        hit_groups=nl.QG, hit_sub=nl.SUB16, c16=True)
    cap = cand16.shape[1]
    out = dict(moved=moved, real=real, cand16=cand16, count16=count16, mask=mask,
               dens_g=dens_g, hits_g=hits_g[:, :cap], dens_u=dens_u, hits_u=hits_u[:, :cap])
    out = {k: np.array(v) for k, v in out.items()}
    out["params"] = interop.params_from(params)
    return out


def _args(g):
    t = lambda k: torch.as_tensor(g[k])  # noqa: E731
    return density.pos_pack(t("moved"), t("real")), t("cand16"), t("count16")


def test_gated_density_plain_matches_pallas(gated):
    pos4, cand, count = _args(gated)
    d, hits = density.density_gated16_torch(pos4, cand, count,
                                            torch.as_tensor(gated["mask"]), gated["params"])
    np.testing.assert_allclose(np_(d), gated["dens_g"], rtol=1e-5)
    assert hits.shape == gated["hits_g"].shape
    np.testing.assert_array_equal(np_(hits) > 0, gated["hits_g"] > 0)
    # JAX's own gated and ungated flags agree on the moved state
    np.testing.assert_array_equal(gated["hits_g"] > 0, gated["hits_u"] > 0)


def test_gated_density_equals_ungated_bitwise(gated):
    """Within the staleness guard the gate drops only panels whose every
    term is +0: density and hit counts equal the ungated pass's bit for
    bit, and the gate did skip live panels."""
    pos4, cand, count = _args(gated)
    mask = torch.as_tensor(gated["mask"])
    p = gated["params"]
    d, hits = density.density_gated16(pos4, cand, count, mask, p)
    d0, hits0 = density.density_c16_torch(pos4, cand, count, p, hit_sub=16)
    assert torch.equal(d, d0) and torch.equal(hits, hits0)
    np.testing.assert_allclose(np_(d0), gated["dens_u"], rtol=1e-5)
    np.testing.assert_array_equal(np_(hits0), gated["hits_u"].astype(np.int64))
    cap = cand.shape[1]
    panels = density.mask_panels(mask, cap)
    live = torch.arange(cap)[None, None, :] < count[:, None, None]
    skipped = int((live & ~panels).sum())
    assert 0 < skipped < int(live.sum())
    with pytest.raises(ValueError, match="mask"):
        density.density_gated16(pos4, cand, count, mask[:, :1].contiguous(), p)


def test_gated_frame_equals_ungated_frame_bitwise():
    """Eight substeps of the frame loop, rebuilding every other substep:
    with the gate the state is the same bit for bit as without it."""
    params = interop.params_from(make_params(WATER, n=1500))
    st = interop.state_from_arrays(random_state(params, 1500, 74), "cpu")
    dt = torch.tensor(params.max_dt, dtype=torch.float32)
    out = []
    for gate in (False, True):
        cfg = tstep.StepConfig(**TTF, density_gate=gate, cand_interval=2,
                               substeps_per_dispatch=8)
        s, d, left, flags = tstep.frame(st, dt, torch.tensor(1.0), params, None, cfg)
        assert int(flags) == 0
        out.append((s, d, left))
    (s0, d0, l0), (s1, d1, l1) = out
    for k in ("position", "velocity", "density", "acceleration"):
        assert torch.equal(getattr(s0, k), getattr(s1, k)), k
    assert torch.equal(d0, d1) and torch.equal(l0, l1)
    assert float(l0) < 1.0  # the frame ran
