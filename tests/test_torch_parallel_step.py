"""The port's sharded substep on 4 gloo ranks against the JAX package's
``make_sharded_substep`` on a 4-device CPU mesh, for the ``all_gather``
and ``halo`` exchanges, at 4,096 particles on the mesh path's config (the
main path without the 8-wide force pass). Both sides start from JAX's
``pad_for_mesh`` of the cube lattice, split into the same shards; the
JAX side runs once per exchange for the module (each compile of the
interpreted kernels takes about half a minute)."""

import numpy as np
import pytest

import torch_mesh_ref as ref
from libclsph_tpu_torch import interop
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

N = 4096


@pytest.fixture(scope="module", params=["all_gather", "halo"])
def pair(request):
    params, state = ref.lattice(N)
    jcfg = ref.jax_config()
    halo_max = 0 if request.param == "all_gather" else N // ref.SHARDS // 128
    want = ref.run_jax(params, state, jcfg, request.param, halo_max)
    ranks, got = ref.run_port(params, state, interop.step_config_from_jax(jcfg),
                              request.param, halo_max)
    return dict(exchange=request.param, jax=want, ranks=ranks, port=got)


def test_tables_equal_id_for_id(pair):
    ref.assert_tables_match(pair["ranks"], pair["jax"]["tables"])


def test_rows_match_per_shard(pair):
    ref.assert_rows_match(pair["port"], pair["jax"]["state"])


def test_dt_and_flags_equal_on_every_rank(pair):
    assert pair["jax"]["flags"] == 0
    for rank in pair["ranks"]:
        assert rank["flags"] == pair["jax"]["flags"]
        assert rank["dt"] == pytest.approx(pair["jax"]["dt"], rel=1e-5)


def test_each_particle_once_in_the_combined_table(pair):
    ref.assert_each_particle_once(pair["ranks"], N)
    tables = [r["tables"] for r in pair["ranks"]]
    if pair["exchange"] == "all_gather":
        # the gathered table is the ranks' sorted rows in rank order, and
        # rank r's queries sit at rows r * n_local onward
        for r, t in enumerate(tables):
            np.testing.assert_array_equal(t["qblock"], np.arange(8) + 8 * r)
        assert all(np.array_equal(t["pos4"], tables[0]["pos4"]) for t in tables)
        assert (tables[0]["pos4"][:, 3] > 0).sum() == N
    else:
        for t in tables:
            np.testing.assert_array_equal(t["qblock"], np.arange(8))
            assert t["pos4"].shape[0] == 1024 + ref.SHARDS * 8 * 128
