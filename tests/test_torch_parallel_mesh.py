"""The port's mesh layer (``libclsph_tpu_torch/parallel/mesh.py`` and the
host-side helpers of ``parallel/sharded_step.py``) against the JAX
package's ``parallel/``: the Morton partition, the padding, the block
search against an exchanged candidate table, the surface-set compaction;
then the collectives on gloo ranks spawned by the launcher, its failure
and time-limit paths, and the refusal of NCCL for ranks that share a
card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import WATER, make_params
from libclsph_tpu.core.state import init_state as jinit_state
from libclsph_tpu.engine.step import StepConfig as JStepConfig
from libclsph_tpu.ops import tiles as jtiles
from libclsph_tpu.parallel import mesh as jmesh
from libclsph_tpu.parallel import sharded_step as jsharded
from libclsph_tpu_torch import interop
from libclsph_tpu_torch.core.state import init_state
from libclsph_tpu_torch.engine.step import StepConfig
from libclsph_tpu_torch.ops import tiles
from libclsph_tpu_torch.parallel import mesh, sharded_step
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

LAUNCH_S = 120  # time limit of each launch here


@pytest.mark.parametrize("kind", ["random", "lattice", "flat"])
def test_morton_partition_equals_jax(kind):
    rng = np.random.default_rng(7)
    if kind == "random":
        pos = rng.random((3000, 3)).astype(np.float32)
    elif kind == "lattice":
        pos = np.asarray(jinit_state(make_params(WATER, n=4096)).position)
    else:  # a flat sheet: one axis of zero extent takes the 1e-12 floor
        pos = rng.random((1000, 3)).astype(np.float32)
        pos[:, 1] = 0.25
    np.testing.assert_array_equal(mesh.morton_partition(pos, 4),
                                  jmesh.morton_partition(pos, 4))


@pytest.mark.parametrize("n,shards,block", [(4096, 4, 128), (1000, 4, 64), (2048, 2, 128)])
def test_pad_for_mesh_equals_jax(n, shards, block):
    params = make_params(WATER, n=n)
    jcfg = JStepConfig(block_size=block)
    jstate = jsharded.pad_for_mesh(jinit_state(params), params,
                                   jmesh.make_mesh(jax.devices()[:shards]), jcfg)
    state = sharded_step.pad_for_mesh(init_state(interop.params_from(params), "cpu"),
                                      interop.params_from(params), shards,
                                      StepConfig(block_size=block, density_sub16=block >= 128,
                                                 force_sub8=block >= 128))
    got = interop.state_to_numpy(state)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jstate, k)), err_msg=k)
    assert state.n % (shards * block) == 0
    parts = interop.split_for_mesh(jstate, shards)
    assert len(parts) == shards
    np.testing.assert_array_equal(np.concatenate([p["position"] for p in parts]),
                                  got["position"])
    rows = mesh.shard_rows(state.n, 1, shards)
    np.testing.assert_array_equal(parts[1]["density"], got["density"][rows])


def _boxes(rng, nb, spread=4.0):
    lo = rng.random((nb, 4, 3)).astype(np.float32) * spread
    hi = lo + rng.random((nb, 4, 3)).astype(np.float32) * 0.3
    return lo, hi


@pytest.mark.parametrize("offset", [0, 5])
def test_candidate_blocks_against_an_exchanged_table_equals_jax(offset):
    """Query blocks against a larger candidate table with each query's
    own block at ``self_index`` (the all_gather layout at offset 5 and the
    halo/ring layout at 0), including dead (inverted) candidate rows and
    a cap that truncates."""
    rng = np.random.default_rng(3)
    q_lo, q_hi = _boxes(rng, 12)
    c_lo, c_hi = _boxes(rng, 40)
    c_lo[offset:offset + 12], c_hi[offset:offset + 12] = q_lo, q_hi
    c_lo[30:], c_hi[30:] = 3.0e38, -3.0e38  # dead rows never overlap
    self_index = np.arange(12, dtype=np.int32) + offset
    for cap in (6, 40):
        want = jtiles.candidate_blocks(jnp.asarray(q_lo), jnp.asarray(q_hi), 0.4, cap,
                                       jnp.asarray(c_lo), jnp.asarray(c_hi),
                                       self_index=jnp.asarray(self_index))
        got = tiles.candidate_blocks(torch.from_numpy(q_lo), torch.from_numpy(q_hi), 0.4, cap,
                                     torch.from_numpy(c_lo), torch.from_numpy(c_hi),
                                     self_index=torch.from_numpy(self_index))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[2]) is False and bool(want[2]) is False


@pytest.mark.parametrize("cap", [1, 4, 9, 20])
def test_compact_mask_equals_jax(cap):
    mask = np.random.default_rng(cap).random(13) < 0.5
    want = jsharded._compact_mask(jnp.asarray(mask), cap)
    got = tiles.compact_mask(torch.from_numpy(mask), cap)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_choose_backend_refuses_nccl_for_ranks_that_share_a_card():
    assert mesh.choose_backend(4, "cuda", 1) == "gloo"
    assert mesh.choose_backend(4, "cuda", 4) == "nccl"
    assert mesh.choose_backend(2, "cpu", 0) == "gloo"
    assert mesh.choose_backend(2, "cuda", 1, "gloo") == "gloo"
    with pytest.raises(ValueError, match="cannot put 2 ranks on 1 card"):
        mesh.choose_backend(2, "cuda", 1, "nccl")
    with pytest.raises(ValueError, match="needs CUDA ranks"):
        mesh.choose_backend(2, "cpu", 0, "nccl")
    with pytest.raises(ValueError, match="backend must be one of"):
        mesh.choose_backend(2, "cpu", 0, "mpi")


@pytest.mark.parametrize("world", [2, 3])
def test_collectives_on_gloo_ranks(world):
    res = mesh.launch(mesh.check_collectives, world, device="cpu", timeout=LAUNCH_S,
                      threads=1)
    assert len(res) == world
    fwd = world // 2
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["max"], [world - 1, 0])
        np.testing.assert_array_equal(out["gather"], np.repeat(np.arange(world), 2)[:, None]
                                      * np.ones((1, 3)))
        np.testing.assert_array_equal(out["many"][0], np.repeat(np.arange(world), 2)
                                      .reshape(world, 2))
        np.testing.assert_array_equal(out["many"][1], np.concatenate(
            [np.arange(3) + k for k in range(world)]))
        # forward hop k brings rank r-k's values, backward hop k rank r+k's
        want = [(r - k) % world for k in range(1, fwd + 1)] + [
            (r + k) % world for k in range(1, world - fwd)]
        assert [h[0] for h in out["ring"]] == want
        np.testing.assert_array_equal(out["broadcast"], [1.0, 1.0])
        assert out["stats"]["calls"] == {"ring": world - 1, "all_gather": 2,
                                         "all_reduce": 1, "broadcast": 1}
        assert out["stats"]["staged_bytes"] == 0  # CPU ranks stage nothing


def test_launch_raises_a_failed_ranks_traceback():
    # divmod(mesh, 0) raises TypeError in every rank
    with pytest.raises(RuntimeError, match="TypeError"):
        mesh.launch(divmod, 2, args=(0,), device="cpu", timeout=LAUNCH_S, threads=1)


def test_launch_kills_ranks_past_its_time_limit():
    # the ranks cannot even start in 0.2 s: the launch must stop them and raise
    with pytest.raises(TimeoutError, match="still running"):
        mesh.launch(mesh.check_collectives, 2, device="cpu", timeout=0.2, threads=1)


def test_launch_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        mesh.launch(mesh.check_collectives, 2, device="cuda")
