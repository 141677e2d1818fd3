"""The frame loops as they were before their dispatch layer: one host read
for the time left, one for the staleness and at least one for the dt
retry, each before the substep acts on it. The port's tests hold
``engine.step.frame`` and ``parallel.sharded_step.local_frame`` to these
loops bit for bit (``tests/test_torch_dispatch.py``)."""

from functools import partial

import torch

from libclsph_tpu_torch.engine import step as step_mod
from libclsph_tpu_torch.parallel import sharded_step


def frame(state, dt, timeleft, params, scene, config, stats=None):
    """``engine.step.frame``'s loop, a host read before each decision."""
    interval = config.sort_interval
    ci = config.cand_interval
    slack2 = torch.tensor((config.cand_slack * params.h) ** 2, dtype=torch.float32,
                          device=state.device)
    flags = torch.zeros((), dtype=torch.int32, device=state.device)
    tables = None
    for n in range(config.substeps_per_dispatch):
        if not bool(timeleft > 0.0):
            break
        do_sort = n % interval == 0
        rebuild = tables is None or n % ci == 0
        if not rebuild:
            d2 = torch.sum((state.position - tables[2][: state.n]) ** 2, dim=1)
            rebuild = bool(4.0 * torch.amax(d2) > slack2)
        if rebuild:
            state, dt_next, step_flags, tables = step_mod.substep(
                state, dt, params, scene, config, do_sort=do_sort
            )
        else:
            state, dt_next, step_flags, _ = step_mod.substep(
                state, dt, params, scene, config, do_sort=False, cand_in=tables
            )
        step_mod.count_substep(stats, rebuild, tables, config)
        timeleft = timeleft - dt_next
        dt = torch.where(timeleft < dt_next, timeleft, dt_next)
        flags = flags | step_flags
    return state, dt, timeleft, flags


def local_frame(mesh, state, dt, timeleft, params, scene, config, exchange="all_gather",
                halo_max=0, halo_hops=1, stats=None):
    """``parallel.sharded_step.local_frame``'s loop, a host read before
    each decision."""
    config = sharded_step.mesh_config(config)
    interval, ci = config.sort_interval, config.cand_interval
    slack2 = (config.cand_slack * params.h) ** 2
    run = partial(sharded_step.local_substep, mesh, params=params, scene=scene,
                  config=config, exchange=exchange, halo_max=halo_max, halo_hops=halo_hops)
    flags = torch.zeros((), dtype=torch.int32, device=state.device)
    tables = None
    for k in range(config.substeps_per_dispatch):
        if not bool(timeleft > 0.0):
            break
        do_sort = interval <= 1 or k % interval == 0
        rebuild = ci <= 1 or tables is None or k % ci == 0
        if not rebuild:
            d2 = torch.sum((state.position - tables["anchor"]) ** 2, dim=1)
            ok = state.position.abs().amax(dim=1) < sharded_step.LIVE_LIMIT
            d2max = mesh.all_reduce_max(torch.amax(torch.where(ok, d2, 0.0))[None])[0]
            rebuild = bool(4.0 * d2max > slack2)
        if rebuild:
            state, dt_next, step_flags, tables = run(state, dt, do_sort=do_sort)
        else:
            state, dt_next, step_flags, _ = run(state, dt, do_sort=False, cand_in=tables)
        carried = None if tables is None else (tables["cand_sub"], tables["count_sub"])
        step_mod.count_substep(stats, rebuild, carried, config)
        timeleft = timeleft - dt_next
        dt = torch.where(timeleft < dt_next, timeleft, dt_next)
        flags = flags | step_flags
    return state, dt, timeleft, flags


def frame_pair(mesh, shards, params, config, exchange, halo_max, dt, timeleft):
    """A rank body for ``parallel.mesh.launch``: this rank's shard through
    the loop above and through ``local_frame``, from the same state.
    Returns both results as host arrays, with each run's stats and the
    dispatch's host reads and values."""
    from libclsph_tpu_torch.io import checkpoint

    dev = mesh.device
    state = checkpoint.arrays_to_state(shards[mesh.rank], dev)
    out = {}
    for name in ("ref", "new"):
        stats, host = {}, {}
        dt_t = torch.tensor(dt, dtype=torch.float32, device=dev)
        tl = torch.tensor(timeleft, dtype=torch.float32, device=dev)
        reads = step_mod.host_read.count
        if name == "ref":
            res = local_frame(mesh, state, dt_t, tl, params, None, config, exchange, halo_max,
                              1, stats)
        else:
            res = sharded_step.local_frame(mesh, state, dt_t, tl, params, None, config,
                                           exchange, halo_max, 1, stats, host)
        st, d, left, flags = res
        out[name] = dict(state=checkpoint.state_to_arrays(st), dt=d.item(), timeleft=left.item(),
                         flags=int(flags), stats=stats, host=host,
                         reads=step_mod.host_read.count - reads)
    return out
