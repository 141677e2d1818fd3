"""The sharded frame loop timed on one rank: the rank body of
``bench_torch.py --mesh`` (JAX's ``bench.py:45-170``).

Every rank runs the same schedule on its rows: a warm-up of W substeps of
the frame loop, re-run from the start with the flagged tables grown by
``bench.py``'s mesh rule (:func:`mesh_growth`, ``bench.py:115-140``) until
no flag is raised, no update applies, or 5 tries ran; the K substeps of
the timed window once, untimed, from the warm state, grown the same way;
then the K substeps timed between two barriers. The rule doubles the
capacities and the slack in place, so the mesh keeps its 16-wide tables
(the engine's own rule would leave them for the q-granular ones and
turn two-tier routing on). Beyond ``bench.py``, which starts the ring
at full coverage, ``FLAG_EXCHANGE`` doubles ``halo_hops`` up to
(N + 1) // 2 a direction as the engine does (``bench_torch --halo-hops``
starts at 1). Every rank reads flags already OR'd over the ranks, so
every rank takes the same decision and none skips a collective. The
collectives of the timed window are counted by the mesh (calls, bytes
arriving on the rank, bytes staged through host buffers) and the
kernels' launches by their wrappers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..core.params import SimulationParameters
from ..core.state import init_state
from ..engine.step import (
    FLAG_CAND_STALE,
    FLAG_CAPACITY,
    FLAG_CAPACITY_HIT,
    FLAG_CAPACITY_SUB,
    FLAG_EXCHANGE,
    StepConfig,
)
from ..ops import kernels
from . import sharded_step
from .mesh import Mesh

GROWTH_TRIES = 5  # bench.py:115


def mesh_growth(config: StepConfig, flags: int, halo_hops: int, world: int):
    """The updates that ``bench.py``'s mesh warm-up (``bench.py:115-140``)
    makes on the status bits ``flags``: ``FLAG_CAPACITY`` doubles
    ``max_candidates``, ``FLAG_CAPACITY_SUB`` ``max_candidates_sub``,
    ``FLAG_CAPACITY_HIT`` the three hit capacities and ``FLAG_CAND_STALE``
    ``cand_slack``; and ``FLAG_EXCHANGE`` doubles ``halo_hops`` up to full
    coverage, (world + 1) // 2. Returns (the StepConfig updates, the
    hops); nothing to update is ({}, halo_hops)."""
    updates = {}
    if flags & FLAG_CAPACITY:
        updates["max_candidates"] = config.max_candidates * 2
    if flags & FLAG_CAPACITY_SUB:
        updates["max_candidates_sub"] = config.max_candidates_sub * 2
    if flags & FLAG_CAPACITY_HIT:
        updates.update(max_candidates_hit=config.max_candidates_hit * 2,
                       max_candidates_hit16=config.max_candidates_hit16 * 2,
                       max_candidates_hit8=config.max_candidates_hit8 * 2)
    if flags & FLAG_CAND_STALE:
        updates["cand_slack"] = config.cand_slack * 2
    if flags & FLAG_EXCHANGE:
        halo_hops = min((world + 1) // 2, halo_hops * 2)
    return updates, halo_hops


def table_shape(config: StepConfig) -> dict:
    """The tables a config runs: (density_sub16, force_sub16, force_sub8),
    force_query_rows, the capacities and tier2_frac."""
    return dict(tables=[config.density_sub16, config.force_sub16, config.force_sub8],
                **{k: getattr(config, k) for k in (
                    "force_query_rows", "max_candidates", "max_candidates_sub",
                    "max_candidates_hit", "max_candidates_hit16", "max_candidates_hit8",
                    "tier2_frac")})


def _frame_substeps(mesh: Mesh, grown: dict, state, dt, k: int):
    """Exactly ``k`` substeps of the sharded frame loop (its time never
    runs out first) on the ``grown`` config and hops. Returns (state, dt,
    flags)."""
    cfg = dataclasses.replace(grown["config"], substeps_per_dispatch=k)
    timeleft = torch.tensor(1.0e9, dtype=torch.float32, device=mesh.device)
    st, dt, _, flags = sharded_step.local_frame(
        mesh, state, dt, timeleft, grown["params"], grown["scene"], cfg, grown["exchange"],
        grown["halo_max"], grown["halo_hops"])
    return st, dt, flags


def _grown(mesh, grown: dict, state, dt, k: int):
    """``k`` substeps from (state, dt), re-run with :func:`mesh_growth`'s
    updates applied to ``grown`` until no flag is raised or none applies,
    at most GROWTH_TRIES times (bench.py:115-140). Returns the last run's
    (state, dt)."""
    for _ in range(GROWTH_TRIES):
        st, dt_out, flags = _frame_substeps(mesh, grown, state, dt, k)
        flags = int(flags)  # OR'd over the ranks: every rank agrees
        if not flags:
            break
        updates, hops = mesh_growth(grown["config"], flags, grown["halo_hops"], mesh.world)
        if not updates and hops == grown["halo_hops"]:
            break
        grown.update(config=dataclasses.replace(grown["config"], **updates), halo_hops=hops)
    return st, dt_out


def bench_rank(mesh: Mesh, params: SimulationParameters, config: StepConfig,
               scene_file: Optional[str], exchange: str, halo_max: int, halo_hops: int,
               warmup: int, steps: int) -> dict:
    """Warm up, rehearse and time ``steps`` substeps on this rank (the
    cube lattice of ``params``, ``scene_file`` an OBJ path or None).
    Returns the window's seconds and flags, the grown config and hops,
    the collectives' and the kernels' counts in the window, and the
    warm-up's seconds."""
    from ..ops import collisions
    from ..scene.scene import Scene

    dev = mesh.device
    if exchange in ("halo", "ring") and not halo_max:
        halo_max = sharded_step.default_halo_max(params.particles_count, mesh.world,
                                                 config.block_size)
    scene = None
    if scene_file is not None:
        import os

        scene = collisions.build_device_scene(
            Scene.load(os.path.basename(scene_file), params.h * 2.0,
                       scenes_dir=os.path.dirname(scene_file)), dev)
    grown = dict(config=sharded_step.mesh_config(config), params=params, scene=scene,
                 exchange=exchange, halo_max=halo_max, halo_hops=halo_hops)
    state = sharded_step.local_rows(
        sharded_step.pad_for_mesh(init_state(params, dev), params, mesh.world, config),
        mesh.rank, mesh.world)
    dt0 = torch.tensor(params.max_dt, dtype=torch.float32, device=dev)

    mesh.barrier()
    t0 = time.perf_counter()
    state, dt = _grown(mesh, grown, state, dt0, warmup)
    _grown(mesh, grown, state, dt, steps)  # the window, rehearsed
    mesh.barrier()
    warm_s = time.perf_counter() - t0

    mesh.reset_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    st, dt, flags = _frame_substeps(mesh, grown, state, dt, steps)
    flags = int(flags)  # waits for the window's work
    stats = mesh.read_stats()
    launches = kernels.launch_counts()
    mesh.barrier()
    elapsed = time.perf_counter() - t0
    finite = bool(torch.isfinite(st.position).all() and torch.isfinite(st.density).all())
    return dict(elapsed_s=elapsed, timed_flags=flags, final_dt=float(dt), finite=finite,
                warm_s=warm_s, config=dataclasses.asdict(grown["config"]),
                tables=table_shape(grown["config"]), halo_max=halo_max,
                halo_hops=grown["halo_hops"], stats=stats, launches=launches, n_local=st.n)
