"""The radix sort's plain version and its wrapper on the CPU, and the
densities-only mode of ``density_c32`` that the block variants run.

* ``radix_sort_key_val`` bit-identical to JAX's (fused and unfused) and
  to ``torch.sort(stable=True)``: scatter and gather, 5, 6 and 7 bits a
  pass, 30 and 15 key bits, heavy duplicates and n not a multiple of 128
  (as tests/test_sort.py holds JAX's to lax.sort); the max-code padding,
  all-equal, sorted, reversed and max-code keys.
* ``radix_sort_key_val`` on CPU tensors (the plain passes over 128-key
  blocks) against ``torch.sort(stable=True)`` at every pass width 1..7
  and 3, 12 and 30 key bits, with values that are no iota and key counts
  around the blocks and the kernels' 8,192-key tiles; bit for bit.
* The wrapper takes the plain version on CPU tensors without counting a
  launch, and refuses other devices.
* ``density_c32_torch`` at ``groups=0`` against JAX's row
  ``fused_density`` (Pallas, interpret mode) over the expanded block
  table of a random cloud, density rtol 1e-5 (float32 summation order),
  and equal bit for bit to its densities at 1 and 4 groups.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import WATER, make_params
from libclsph_tpu.ops import radix_sort as jradix
from libclsph_tpu.ops import tiles as jtiles
from libclsph_tpu.ops.pallas import neighbor as jrow
from libclsph_tpu_torch import interop
from libclsph_tpu_torch.ops import radix_sort
from libclsph_tpu_torch.ops.kernels import blocks, density, radix
from test_torch_exact import _keys, np_
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

B = 128


@pytest.mark.parametrize("num_bits", [30, 15])
@pytest.mark.parametrize("bits_per_pass", [5, 6, 7])
@pytest.mark.parametrize("apply", ["scatter", "gather"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_radix_sort_bit_identical(fused, apply, bits_per_pass, num_bits):
    """The port's sort against each of JAX's two rank stages (XLA one-hot
    and the fused Pallas kernel; the port has one sort)."""
    n = 3000  # not a multiple of 128
    keys, vals = _keys(n, num_bits, seed=bits_per_pass * 100 + num_bits)
    k, v = radix_sort.radix_sort_key_val(torch.as_tensor(keys), torch.as_tensor(vals),
                                         num_bits=num_bits, bits_per_pass=bits_per_pass,
                                         apply=apply)
    jk, jv = jradix.radix_sort_key_val(jnp.asarray(keys.astype(np.uint32)), jnp.asarray(vals),
                                       num_bits=num_bits, bits_per_pass=bits_per_pass,
                                       fused=fused, apply=apply)
    sk, order = torch.sort(torch.as_tensor(keys), stable=True)
    assert k.dtype == torch.int32 and v.dtype == torch.int32
    np.testing.assert_array_equal(np_(k), np.asarray(jk).astype(np.int32))
    np.testing.assert_array_equal(np_(v), np.asarray(jv))
    assert torch.equal(k, sk) and torch.equal(v, torch.as_tensor(vals)[order])


@pytest.mark.parametrize("n", [128, 256, 4096])
def test_radix_sort_padding_knobs_and_extreme_keys(n):
    """The max-code padding to whole 128-key blocks (none, 1 key, 127
    keys) sorts behind every real max code; all-equal, sorted, reversed
    and max-code keys sort as torch.sort, with either apply."""
    for keys in (torch.full((n,), (1 << 30) - 1, dtype=torch.int32),
                 torch.zeros(n, dtype=torch.int32),
                 torch.arange(n, dtype=torch.int32),
                 torch.arange(n, dtype=torch.int32).flip(0),
                 torch.as_tensor(_keys(n, 30, n)[0])):
        for m in (n, n - 1, n - 127):
            sk, order = torch.sort(keys[:m], stable=True)
            for apply in ("scatter", "gather"):
                k, v = radix_sort.radix_sort_key_val(
                    keys[:m], torch.arange(m, dtype=torch.int32), apply=apply)
                assert torch.equal(k, sk) and torch.equal(v, order.to(torch.int32)), (m, apply)


def _inputs(n, num_bits, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << num_bits, size=n)
    keys[::3] = rng.integers(0, 1 << num_bits, size=4)[rng.integers(0, 4, size=keys[::3].size)]
    vals = rng.integers(-(1 << 31), 1 << 31, size=n)
    return torch.as_tensor(keys.astype(np.int32)), torch.as_tensor(vals.astype(np.int32))


@pytest.mark.parametrize("bits_per_pass", range(1, radix.MAX_BITS + 1))
@pytest.mark.parametrize("num_bits", [3, 12, 30])
def test_plain_sort_every_pass_width(num_bits, bits_per_pass):
    keys, vals = _inputs(3001, num_bits, num_bits * 10 + bits_per_pass)
    sk, order = torch.sort(keys, stable=True)
    for apply in radix.APPLY:
        k, v = radix_sort.radix_sort_key_val(keys, vals, num_bits=num_bits,
                                             bits_per_pass=bits_per_pass, apply=apply)
        assert torch.equal(k, sk) and torch.equal(v, vals[order]), apply
    assert [b for _, b in radix.passes(num_bits, bits_per_pass)] == (
        [bits_per_pass] * (num_bits // bits_per_pass)
        + ([num_bits % bits_per_pass] if num_bits % bits_per_pass else []))


@pytest.mark.parametrize("n", [0, 1, radix.TILE - 1, radix.TILE + 1, 2 * radix.TILE + 129])
def test_plain_sort_around_blocks_and_tiles(n):
    keys, vals = _inputs(n, 30, n)
    sk, order = torch.sort(keys, stable=True)
    k, v = radix_sort.radix_sort_key_val(keys, vals)
    assert torch.equal(k, sk) and torch.equal(v, vals[order])


def test_sort_wrapper_on_cpu_and_other_devices():
    keys, vals = _inputs(500, 30, 1)
    before = radix.radix_sort.launches
    k, v = radix.radix_sort(keys, vals, 30, 5, "gather")
    assert radix.radix_sort.launches == before
    plain = radix.radix_sort_torch(keys, vals, 30, 5, "scatter")
    assert torch.equal(k, plain[0]) and torch.equal(v, plain[1])
    with pytest.raises(ValueError, match="unsupported devices"):
        radix.radix_sort(keys.to("meta"), vals.to("meta"), 30, 5, "scatter")


@pytest.fixture(scope="module")
def block_cloud():
    """A random cloud sorted by a coarse cell key, padded with far
    sentinels, JAX's block table at h and its row ``fused_density``."""
    n = 1500
    params = make_params(WATER, n=n)
    rng = np.random.default_rng(31)
    side = params.initial_volume ** (1 / 3) * 1.2
    pos = ((rng.random((n, 3)) - 0.5) * side).astype(np.float32)
    npad = jtiles.padded_count(n, B)
    far = pos.max(axis=0) + 1000.0 * params.h
    pos = np.concatenate([pos, np.broadcast_to(far, (npad - n, 3))]).astype(np.float32)
    cell = np.floor(pos / (2 * params.h)).astype(np.int64)
    key = (cell[:, 0] * 1_000_003 + cell[:, 1]) * 1_000_003 + cell[:, 2]
    key[n:] = np.iinfo(np.int64).max
    order = np.argsort(key, kind="stable")
    pos, real = pos[order], order < n
    nb = npad // B
    jpos, jreal = jnp.asarray(pos), jnp.asarray(real)
    bmin, bmax = jtiles.split_block_bounds(jpos.reshape(nb, B, 3), jreal.reshape(nb, B))
    cand, count, ovf = jtiles.candidate_blocks_auto(bmin, bmax, params.h, 96)
    assert not bool(ovf)
    zeros = jnp.zeros(npad, jnp.float32)
    planes = jrow.make_planes(jpos, jnp.zeros((npad, 3), jnp.float32), zeros, zeros, jreal, B,
                              mass=params.particle_mass, q_div=1)
    dens = jrow.fused_density(planes, cand, count, params, params.precomputed(), jreal)
    return dict(pos=torch.as_tensor(pos), real=torch.as_tensor(real),
                cand=torch.as_tensor(np.array(cand)), count=torch.as_tensor(np.array(count)),
                dens=np.array(dens), params=interop.params_from(params))


def test_density_c32_densities_only_matches_pallas_row(block_cloud):
    t = block_cloud
    p = t["params"]
    pos4 = density.pos_pack(t["pos"], t["real"])
    ids, counts = blocks.expand_block_table(t["cand"], t["count"])
    before = density.density_c32.launches
    d, hits = density.density_c32(pos4, ids, counts, p, groups=0)
    assert density.density_c32.launches == before
    assert hits.shape == (0, ids.shape[1]) and hits.dtype == torch.int32
    np.testing.assert_allclose(d.numpy(), t["dens"], rtol=1e-5)
    for groups in (1, 4):
        assert torch.equal(density.density_c32_torch(pos4, ids, counts, p, groups=groups)[0], d)
    with pytest.raises(ValueError, match="groups"):
        density.density_c32(pos4, ids, counts, p, groups=0, hit_sub=16)
