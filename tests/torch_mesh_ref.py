"""Shared by the port's mesh tests (``tests/test_torch_parallel_*.py``):
the JAX package's sharded substep and frame on a virtual CPU mesh, with
the candidate, refined and hit tables of every shard recorded, and the
port's ranks on the same rows.

JAX's tables are recorded without touching the package: while a sharded
function is traced, ``_nl_passes`` and ``tiles.compact_hits`` are wrapped
(pytest's ``MonkeyPatch``) by functions that hand their outputs, with the
shard's ``axis_index``, to ``jax.debug.callback``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from conftest import WATER, make_params
from libclsph_tpu.core.state import ParticleState as JState
from libclsph_tpu.core.state import init_state as jinit_state
from libclsph_tpu.engine.step import StepConfig as JStepConfig
from libclsph_tpu.ops import tiles as jtiles
from libclsph_tpu.parallel import mesh as jmesh
from libclsph_tpu.parallel import sharded_step as jsharded
from libclsph_tpu_torch import interop
from libclsph_tpu_torch.parallel import mesh, sharded_step

LAUNCH_S = 240  # time limit of each launch of the port's ranks
SHARDS = 4
# the port's main path under the mesh (bench.py:184-226 with force_sub8
# off, as JAX's cli.py:161 runs it); the substep rebuilds every time
MESH_PATH = dict(
    neighbor_impl="pallas", pallas_variant="nl", block_size=128, max_candidates=96,
    nl_query_rows=128, max_candidates_sub=192, force_query_rows=32, force_sub16=True,
    density_sub16=True, force_sub8=False, max_candidates_hit16=64, sort_interval=4,
    cand_interval=1, cand_slack=0.25, adaptive_dt=True, tier2_frac=0, density_gate=False,
)


def jax_config(**overrides):
    return JStepConfig(**dict(MESH_PATH, **overrides))


def padded_state(params, n_shards=SHARDS, block=128):
    """JAX's pad_for_mesh of the cube lattice, as host arrays."""
    st = jsharded.pad_for_mesh(jinit_state(params), params,
                               jmesh.make_mesh(jax.devices()[:n_shards]),
                               JStepConfig(block_size=block))
    return {k: np.asarray(getattr(st, k)) for k in interop.FIELDS}


def _recorder(store):
    def wrapped_nl_passes(*args, **kw):
        out = _ORIG["nl"](*args, **kw)

        def cb(shard, cand, count, cand_sub, count_sub):
            store.setdefault(int(shard), {}).update(
                cand=np.asarray(cand), count=np.asarray(count), cand_sub=np.asarray(cand_sub),
                count_sub=np.asarray(count_sub))

        jax.debug.callback(cb, jax.lax.axis_index(jmesh.AXIS), args[4], args[5], *out[4])
        return out

    def wrapped_compact_hits(*args, **kw):
        out = _ORIG["hits"](*args, **kw)

        def cb(shard, cand_f, count_f):
            store.setdefault(int(shard), {}).update(cand_f=np.asarray(cand_f),
                                                    count_f=np.asarray(count_f))

        jax.debug.callback(cb, jax.lax.axis_index(jmesh.AXIS), out[0], out[1])
        return out

    return wrapped_nl_passes, wrapped_compact_hits


_ORIG = dict(nl=jsharded._nl_passes, hits=jtiles.compact_hits)


def run_jax(params, state_np, jcfg, exchange="all_gather", halo_max=0, halo_hops=1,
            frame_time=None, n_shards=SHARDS, record=True):
    """JAX's make_sharded_substep (or, with ``frame_time``, its
    make_sharded_frame until that much time has run) on ``n_shards``
    virtual CPU devices from ``state_np``. Returns the state (host
    arrays), dt, flags and the recorded tables by shard."""
    jm = jmesh.make_mesh(jax.devices()[:n_shards])
    sharding = NamedSharding(jm, P(jmesh.AXIS))
    st = JState(**{k: jax.device_put(jnp.asarray(v), sharding) for k, v in state_np.items()})
    dt = jnp.float32(params.max_dt)
    store = {}
    with pytest.MonkeyPatch.context() as mp:
        if record:
            nl, hits = _recorder(store)
            mp.setattr(jsharded, "_nl_passes", nl)
            mp.setattr(jtiles, "compact_hits", hits)
        kw = dict(exchange=exchange, halo_max=halo_max, halo_hops=halo_hops)
        if frame_time is None:
            st, dt, flags = jsharded.make_sharded_substep(jm, params, None, jcfg, **kw)(st, dt)
            flags = int(flags)
        else:
            frame = jsharded.make_sharded_frame(jm, params, None, jcfg, **kw)
            tl, flags = jnp.float32(frame_time), 0
            while float(tl) > 0.0:
                st, dt, tl, f = frame(st, dt, tl)
                flags |= int(f)
        jax.block_until_ready(st.position)
        jax.effects_barrier()
    return dict(state={k: np.asarray(getattr(st, k)) for k in interop.FIELDS},
                dt=float(dt), flags=flags, tables=store)


def run_port(params, state_np, cfg, exchange="all_gather", halo_max=0, halo_hops=1,
             frame_time=None, n_shards=SHARDS, record=True):
    """The port's ranks (gloo, CPU) on the same rows: rank r takes shard r
    of ``state_np``. Returns the ranks' results
    (:func:`sharded_step.run_shards`) and their states concatenated."""
    shards = interop.split_for_mesh(state_np, n_shards)
    ranks = mesh.launch(sharded_step.run_shards, n_shards, device="cpu", timeout=LAUNCH_S,
                        threads=1,
                        args=(shards, interop.params_from(params), cfg, exchange, halo_max,
                              halo_hops, frame_time, record))
    state = {k: np.concatenate([r["state"][k] for r in ranks]) for k in interop.FIELDS}
    return ranks, state


def assert_rows_match(p, j):
    """Row for row (both packages sort each shard the same way), at the
    single-chip tolerances of test_torch_step.py: sort codes equal,
    density rtol 1e-5, acceleration atol 1e-5 * max|a|, velocities atol
    1e-5 * max|v|, positions atol 1e-6."""
    np.testing.assert_array_equal(p["grid_index"], j["grid_index"])
    np.testing.assert_allclose(p["density"], j["density"], rtol=1e-5)
    amax = np.abs(j["acceleration"]).max()
    np.testing.assert_allclose(p["acceleration"], j["acceleration"], atol=1e-5 * amax)
    vmax = np.abs(j["velocity"]).max()
    np.testing.assert_allclose(p["velocity"], j["velocity"], atol=1e-5 * vmax)
    np.testing.assert_allclose(p["intermediate_velocity"], j["intermediate_velocity"],
                               atol=1e-5 * vmax)
    np.testing.assert_allclose(p["position"], j["position"], atol=1e-6)
    np.testing.assert_allclose(p["pressure"], j["pressure"],
                               atol=1e-4 * np.abs(j["pressure"]).max())


def assert_tables_match(ranks, jax_tables):
    """Block, refined and hit tables equal id for id on every shard."""
    assert sorted(jax_tables) == list(range(len(ranks)))
    for r, rank in enumerate(ranks):
        got, want = rank["tables"], jax_tables[r]
        for k in ("cand", "count", "cand_sub", "count_sub", "cand_f", "count_f"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"shard {r} {k}")


def assert_each_particle_once(ranks, n_real):
    """Each live particle appears once in every rank's combined table (so
    the kernels' exclusion of self by row equals JAX's by global id), and
    every rank's queries sit at its qblock offset."""
    for r, rank in enumerate(ranks):
        pos4 = rank["tables"]["pos4"]
        live = pos4[:, 3] > 0
        assert np.unique(pos4[live, :3], axis=0).shape[0] == live.sum(), r
        n_local = rank["state"]["position"].shape[0]
        q = rank["tables"]["qblock"]
        assert q.shape[0] * 128 == n_local
        assert live.sum() <= n_real


def lattice(n):
    params = make_params(WATER, n=n)
    return params, padded_state(params)

