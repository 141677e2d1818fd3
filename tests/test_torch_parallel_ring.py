"""The port's ring exchange (point-to-point sends of surface blocks over
``halo_hops`` hops a direction) on 4 gloo ranks against the JAX
package's ``ppermute`` ring on a 4-device CPU mesh, at 1 hop (ranks two
apart are out of reach: ``FLAG_EXCHANGE`` where JAX raises it) and at 2
hops (full coverage at 4 shards). 4,096 particles, the mesh path's
config; the JAX side runs once per hop count for the module."""

import numpy as np
import pytest

import torch_mesh_ref as ref
from libclsph_tpu_torch import interop
from libclsph_tpu_torch.engine.step import FLAG_EXCHANGE
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

N = 4096
HALO_MAX = N // ref.SHARDS // 128


@pytest.fixture(scope="module", params=[1, 2])
def ring(request):
    params, state = ref.lattice(N)
    jcfg = ref.jax_config()
    want = ref.run_jax(params, state, jcfg, "ring", HALO_MAX, request.param)
    ranks, got = ref.run_port(params, state, interop.step_config_from_jax(jcfg), "ring",
                              HALO_MAX, request.param)
    return dict(hops=request.param, jax=want, ranks=ranks, port=got)


def test_flags_equal_jax(ring):
    """At 1 hop the shards two apart overlap but are out of reach and JAX
    raises FLAG_EXCHANGE; at 2 hops nothing. Every rank returns JAX's
    word, the OR of the ranks' own flags."""
    want = ring["jax"]["flags"]
    assert bool(want & FLAG_EXCHANGE) == (ring["hops"] == 1)
    local = 0
    for rank in ring["ranks"]:
        assert rank["flags"] == want
        local |= int(rank["tables"]["local_flags"])
    assert local == want


def test_tables_equal_id_for_id(ring):
    ref.assert_tables_match(ring["ranks"], ring["jax"]["tables"])


def test_rows_match_per_shard(ring):
    ref.assert_rows_match(ring["port"], ring["jax"]["state"])
    for rank in ring["ranks"]:
        assert rank["dt"] == pytest.approx(ring["jax"]["dt"], rel=1e-5)


def test_combined_table_layout(ring):
    """Local blocks, then the forward hops' and the backward hops' surface
    blocks (halo_max each); each live particle once."""
    ref.assert_each_particle_once(ring["ranks"], N)
    hops = 2 * ring["hops"] if ring["hops"] == 1 else 3  # 4 shards: 2 forward, 1 back
    for rank in ring["ranks"]:
        t = rank["tables"]
        assert t["pos4"].shape[0] == (8 + hops * HALO_MAX) * 128
        np.testing.assert_array_equal(t["qblock"], np.arange(8))
        if ring["hops"] == 2:
            # full coverage: every particle reaches every rank that needs it
            assert (t["pos4"][:, 3] > 0).sum() <= N
