"""The port's candidate machinery against the JAX package's tiles.py.

Every integer table must be equal slot for slot: split-box bounds,
the dense and the hierarchical block search, the exact refine to
16-particle subblocks (at h and at the reuse slack), and the hit
compaction with its self priority. Inputs are random clouds made with
numpy from fixed seeds, Morton-sorted by the JAX package and handed to
both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import WATER, make_params
from libclsph_tpu.core import state as jstate
from libclsph_tpu.ops import grid as jgrid
from libclsph_tpu.ops import tiles as jtiles
from libclsph_tpu_torch.ops import tiles as ttiles

B = 128


def T(a):
    return torch.as_tensor(np.array(a))


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_tables_equal(t, j):
    for a, b in zip(t, j):
        np.testing.assert_array_equal(np_(a), np.asarray(b))


def _sorted_blocks(n, seed, spread=2.0):
    """A random cloud of n particles, Morton-sorted and padded to whole
    SUPER-block groups the way the substep pads it."""
    params = make_params(WATER, n=n)
    rng = np.random.default_rng(seed)
    side = params.initial_volume ** (1 / 3) * spread
    pos = ((rng.random((n, 3)) - 0.5) * side).astype(np.float32)
    grid = jgrid.compute_bounds(jnp.asarray(pos), params)
    codes = np.asarray(jgrid.locate_in_grid(jnp.asarray(pos), grid))
    npad = jtiles.padded_count(n, B)
    far = np.asarray(grid.max_point + 1000.0 * params.h)
    pos = np.concatenate([pos, np.broadcast_to(far, (npad - n, 3))]).astype(np.float32)
    codes = np.concatenate([codes, np.full(npad - n, jtiles.SENTINEL_CODE, np.uint32)])
    order = np.argsort(codes, kind="stable")
    real = order < n
    return params, pos[order].reshape(-1, B, 3), real.reshape(-1, B)


@pytest.fixture(scope="module")
def cloud():
    """2000 particles -> 16 blocks after padding (one superblock group)."""
    return _sorted_blocks(2000, 1)


@pytest.fixture(scope="module")
def big_cloud():
    """30000 particles -> 240 blocks: 15 superblocks for the hierarchical
    search (called directly below its size threshold)."""
    return _sorted_blocks(30000, 2, spread=1.6)


@pytest.mark.parametrize("n", [1, 127, 128, 2047, 2048, 2049, 64000, 1_000_000])
def test_padded_count(n):
    assert ttiles.padded_count(n, B) == jtiles.padded_count(n, B)


@pytest.mark.parametrize("which", ["cloud", "big_cloud"])
def test_split_block_bounds_equal(which, request):
    _, pos_b, real_b = request.getfixturevalue(which)
    assert_tables_equal(
        ttiles.split_block_bounds(T(pos_b), T(real_b)),
        jtiles.split_block_bounds(jnp.asarray(pos_b), jnp.asarray(real_b)),
    )


def test_split_block_bounds_ties_go_to_lowest_index():
    """Equal jumps (a lattice row) split at the first equal gaps, as
    lax.top_k breaks ties."""
    x = np.arange(B, dtype=np.float32) * 0.01
    pos = np.stack([x, np.zeros_like(x), np.zeros_like(x)], axis=1)[None]
    real = np.ones((1, B), bool)
    assert_tables_equal(
        ttiles.split_block_bounds(T(pos), T(real)),
        jtiles.split_block_bounds(jnp.asarray(pos), jnp.asarray(real)),
    )


@pytest.mark.parametrize("cap", [4, 16, 96])
@pytest.mark.parametrize("which", ["cloud", "big_cloud"])
def test_candidate_blocks_dense_equal(which, cap, request):
    params, pos_b, real_b = request.getfixturevalue(which)
    bmin, bmax = jtiles.split_block_bounds(jnp.asarray(pos_b), jnp.asarray(real_b))
    j = jtiles.candidate_blocks(bmin, bmax, params.h * 1.25, cap)
    t = ttiles.candidate_blocks(T(np.asarray(bmin)), T(np.asarray(bmax)), params.h * 1.25, cap)
    assert_tables_equal(t, j)
    if cap == 4:
        assert bool(j[2])  # the overflow flag is exercised


@pytest.mark.parametrize("cap", [24, 96])
def test_candidate_blocks_hierarchical_equal(big_cloud, cap):
    params, pos_b, real_b = big_cloud
    bmin, bmax = jtiles.split_block_bounds(jnp.asarray(pos_b), jnp.asarray(real_b))
    j = jtiles.candidate_blocks_hierarchical(bmin, bmax, params.h, cap, super_cand=8)
    t = ttiles.candidate_blocks_hierarchical(
        T(np.asarray(bmin)), T(np.asarray(bmax)), params.h, cap, super_cand=8
    )
    assert_tables_equal(t, j)


def test_candidate_blocks_auto_dispatch(big_cloud):
    """Below the threshold the auto search is the dense one; both sides
    agree on which one runs."""
    params, pos_b, real_b = big_cloud
    bmin, bmax = jtiles.split_block_bounds(jnp.asarray(pos_b), jnp.asarray(real_b))
    assert ttiles.HIERARCHICAL_THRESHOLD == jtiles.HIERARCHICAL_THRESHOLD
    assert_tables_equal(
        ttiles.candidate_blocks_auto(T(np.asarray(bmin)), T(np.asarray(bmax)), params.h, 96),
        jtiles.candidate_blocks_auto(bmin, bmax, params.h, 96),
    )


@pytest.mark.parametrize("slack", [0.0, 0.25])
@pytest.mark.parametrize("cap_sub", [40, 192])
def test_refine_candidates_exact_equal(cloud, slack, cap_sub):
    params, pos_b, real_b = cloud
    h = params.h * (1.0 + slack)
    nb = pos_b.shape[0]
    sub = B // 16
    bmin, bmax = jtiles.split_block_bounds(jnp.asarray(pos_b), jnp.asarray(real_b))
    cand, count, _ = jtiles.candidate_blocks_auto(bmin, bmax, h, 96)
    self_lo = np.arange(nb, dtype=np.int32) * sub
    j = jtiles.refine_candidates_exact(
        cand, count, bmin, bmax, jnp.asarray(pos_b), h, sub, cap_sub,
        self_lo=jnp.asarray(self_lo), self_width=sub,
    )
    t = ttiles.refine_candidates_exact(
        T(np.asarray(cand)), T(np.asarray(count)), T(np.asarray(bmin)), T(np.asarray(bmax)),
        T(pos_b), h, sub, cap_sub, self_lo=T(self_lo), self_width=sub,
    )
    assert_tables_equal(t, j)
    if cap_sub == 40:
        assert bool(j[2])  # truncation exercised: self ids must survive it
        full = real_b.all(axis=1)  # every own subblock holds a query
        own = np.asarray(t[0])[full, :sub]
        np.testing.assert_array_equal(own, self_lo[full, None] + np.arange(sub))


@pytest.mark.parametrize("cap", [6, 80])
def test_compact_hits_equal(cap):
    rng = np.random.default_rng(4)
    rows, width = 64, 48
    ids = np.sort(rng.choice(4000, size=(rows, width)), axis=1).astype(np.int32)
    ids[:, -5:] = jtiles.REFINE_SENTINEL
    hits = (rng.random((rows, width)) < 0.4) * rng.integers(1, 30, size=(rows, width))
    hits[:, -5:] = 0
    self_lo = ids[:, 3].copy()
    hits[:, 3] = 7
    j = jtiles.compact_hits(jnp.asarray(ids), jnp.asarray(hits, jnp.float32), cap,
                            self_lo=jnp.asarray(self_lo), self_width=2)
    t = ttiles.compact_hits(T(ids), T(hits.astype(np.int32)), cap,
                            self_lo=T(self_lo), self_width=2)
    assert_tables_equal(t, j)
    assert np.all(np.asarray(t[0])[:, 0] == self_lo)  # self first even when truncated


def test_lattice_tables_equal():
    """The first substep's tables on the cube lattice (many equal jumps
    and codes)."""
    params = make_params(WATER, n=2048)
    pos = jstate.init_lattice_positions(params)
    grid = jgrid.compute_bounds(jnp.asarray(pos), params)
    codes = np.asarray(jgrid.locate_in_grid(jnp.asarray(pos), grid))
    order = np.argsort(codes, kind="stable")
    pos_b = pos[order].reshape(-1, B, 3)
    real_b = np.ones(pos_b.shape[:2], bool)
    bmin, bmax = jtiles.split_block_bounds(jnp.asarray(pos_b), jnp.asarray(real_b))
    tb = ttiles.split_block_bounds(T(pos_b), T(real_b))
    assert_tables_equal(tb, (bmin, bmax))
    j = jtiles.candidate_blocks_auto(bmin, bmax, params.h * 1.25, 96)
    t = ttiles.candidate_blocks_auto(tb[0], tb[1], params.h * 1.25, 96)
    assert_tables_equal(t, j)
