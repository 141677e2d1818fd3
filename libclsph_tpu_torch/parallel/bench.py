"""The sharded frame loop timed on one rank: the rank body of
``bench_torch.py --mesh`` (JAX's ``bench.py:45-170``).

Every rank runs the same schedule on its rows: a warm-up of W substeps of
the frame loop, re-run from the start with the engine's growth rules
(``SPHSimulation._needs_rerun``: capacities, cand_slack and halo_hops)
until no flag is raised; the K substeps of the timed window once,
untimed, from the warm state, grown the same way; then the K substeps
timed between two barriers. The collectives of the timed window are
counted by the mesh (calls, bytes arriving on the rank, bytes staged
through host buffers) and the kernels' launches by their wrappers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..core.params import SimulationParameters
from ..core.state import init_state
from ..engine.simulation import SPHSimulation
from ..engine.step import StepConfig
from ..ops import kernels
from . import sharded_step
from .mesh import Mesh

GROWTH_TRIES = 6


def _frame_substeps(mesh: Mesh, engine: SPHSimulation, state, dt, k: int):
    """Exactly ``k`` substeps of the sharded frame loop (its time never
    runs out first). Returns (state, dt, flags)."""
    cfg = dataclasses.replace(engine.step_config, substeps_per_dispatch=k)
    timeleft = torch.tensor(1.0e9, dtype=torch.float32, device=mesh.device)
    st, dt, _, flags = sharded_step.local_frame(
        mesh, state, dt, timeleft, engine.parameters, engine.device_scene, cfg,
        engine.exchange, engine.halo_max, engine.halo_hops)
    return st, dt, flags


def _grown(mesh, engine, state, dt, k: int):
    for _ in range(GROWTH_TRIES):
        st, dt_out, flags = _frame_substeps(mesh, engine, state, dt, k)
        if not engine._needs_rerun(flags):
            return st, dt_out
    raise RuntimeError("capacity growth did not converge")


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
    engine = SPHSimulation(config, mesh=mesh, exchange=exchange, halo_max=halo_max,
                           halo_hops=halo_hops, pretune=False)
    engine.parameters = params
    if exchange in ("halo", "ring") and not halo_max:
        engine.halo_max = sharded_step.default_halo_max(params.particles_count, mesh.world,
                                                        config.block_size)
    if scene_file is not None:
        import os

        engine.device_scene = collisions.build_device_scene(
            Scene.load(os.path.basename(scene_file), params.h * 2.0,
                       scenes_dir=os.path.dirname(scene_file)), dev)
    state = sharded_step.local_rows(
        sharded_step.pad_for_mesh(init_state(params, dev), params, mesh.world, config),
        mesh.rank, mesh.world)
    dt0 = torch.tensor(params.max_dt, dtype=torch.float32, device=dev)

    mesh.barrier()
    t0 = time.perf_counter()
    state, dt = _grown(mesh, engine, state, dt0, warmup)
    _grown(mesh, engine, state, dt, steps)  # the window, rehearsed
    mesh.barrier()
    warm_s = time.perf_counter() - t0

    mesh.reset_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    st, dt, flags = _frame_substeps(mesh, engine, state, dt, steps)
    flags = int(flags)  # waits for the window's work
    stats = mesh.read_stats()
    launches = kernels.launch_counts()
    mesh.barrier()
    elapsed = time.perf_counter() - t0
    finite = bool(torch.isfinite(st.position).all() and torch.isfinite(st.density).all())
    return dict(elapsed_s=elapsed, timed_flags=flags, final_dt=float(dt), finite=finite,
                warm_s=warm_s, config=dataclasses.asdict(engine.step_config),
                halo_max=engine.halo_max, halo_hops=engine.halo_hops, stats=stats,
                launches=launches, n_local=st.n)
