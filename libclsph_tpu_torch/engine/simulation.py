"""Host-side orchestration — the ``sph_simulation`` class on one device.

PyTorch counterpart of the single-chip ``SPHSimulation`` of
``libclsph_tpu/engine/simulation.py``: ``load_settings``,
``load_scene``, ``simulate``, the ``pre_frame`` / ``save_frame`` /
``post_frame`` callbacks (reference sph_simulation.h:8-28), checkpoint
resume, and the capacity autotune that re-runs a frame from its saved
state after a capacity or staleness flag.

* Fast path (no ``write_all_frames``): the frame's substeps run through
  :func:`engine.step.frame`, up to ``substeps_per_dispatch`` per call.
* Per-substep path: one :func:`engine.step.substep` per call with the
  callbacks between substeps; it rebuilds the candidate tables every
  substep, because a callback may move particles.

On both paths a ``device_view`` hook, if set, receives the
device-resident state (no host fetch) on the initial frame and after
every frame, as the JAX package's does; :class:`io.render.PointRenderer`'s
``view`` is its intended target.

With a ``mesh`` (:class:`parallel.mesh.Mesh`, one per rank; every rank
runs the same simulation) the state is Morton-partitioned over the ranks
and each substep runs :mod:`parallel.sharded_step` (JAX's
``_simulate_sharded``): both paths, the capacity autotune (every rank
takes the same decision from the flags OR'd over the ranks) and the
``halo_hops`` growth on ``FLAG_EXCHANGE``. Rank 0 runs the callbacks, the
view hook and the checkpoint on the real rows gathered from every rank;
a state that a callback changed is re-partitioned on rank 0 and handed
out again. After :meth:`simulate`, ``state`` holds the real rows of the
whole simulation on every rank, as on one device. No pretune under the
mesh, as in JAX.

Before the first frame, runs of 200k particles or more take the
init-state capacity probe (:mod:`engine.pretune`), so deep-column
scenes start on the q-granular tables instead of re-running a frame.

Frame export runs on a background thread, as the reference's
``std::thread`` (sph_simulation.cpp:370-430). That thread also makes the
copy of the state to the host, once a state: the save, post_frame and
the next pre_frame share it until a callback uploads a change, as the
JAX package's ``_save_deferred`` and host cache do.
"""

from __future__ import annotations

import dataclasses
import time as _time
from concurrent.futures import Future
from typing import Callable, Optional

import numpy as np
import torch

from ..core import params as params_mod
from ..core.params import PrecomputedKernelValues, SimulationParameters
from ..core.state import ParticleState, init_state
from ..io import checkpoint as ckpt_mod
from ..io.async_saver import AsyncSaver
from ..ops import collisions as collisions_ops
from ..ops import grid as grid_ops
from ..scene.scene import Scene
from ..utils import profiling
from ..utils.logging import get_logger
from .step import (
    FLAG_CAND_STALE,
    FLAG_CAPACITY,
    FLAG_CAPACITY_HIT,
    FLAG_CAPACITY_SUB,
    FLAG_CAPACITY_T2,
    FLAG_EXCHANGE,
    FLAG_GRID_DIM,
    FLAGS_ALL_CAPACITY,
    StepConfig,
    frame,
    substep,
)

MAX_CAPACITY_RETRIES = 6
_HOOKS = ("pre_frame", "save_frame", "post_frame", "device_view")
# ``pretune="auto"`` probes runs of at least this many particles
# (simulation.py:524-527)
PRETUNE_AUTO_MIN = 200_000

log = get_logger(__name__)

# host-side callback signatures (the JAX package's):
#   pre_frame(arrays: dict, params, is_full_frame) -> bool (True = write back)
#   save_frame(arrays: dict, params) -> None
#   post_frame(arrays: dict, params, is_full_frame) -> bool
Callback = Callable[[dict, SimulationParameters, bool], bool]
SaveCallback = Callable[[dict, SimulationParameters], None]
# device-side view hook: device_view(state: ParticleState, params, True)
# receives the device-resident state each frame (no host fetch), e.g.
# io/render.PointRenderer.view, which copies only the image to the host
DeviceView = Callable[[ParticleState, SimulationParameters, bool], None]


def configure_device(device) -> torch.device:
    """Resolve ``device`` and refuse a CUDA device without a GPU. On CUDA,
    TF32 is switched off for matmuls and cuDNN, so any float32 product on
    the path stays full float32."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is False"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


class SPHSimulation:
    def __init__(self, step_config: Optional[StepConfig] = None, device="cuda",
                 pretune: bool | str = "auto", mesh=None, exchange: str = "all_gather",
                 halo_max: int = 0, halo_hops: int = 1):
        """``device``: 'cuda' (default) or 'cpu'; 'cuda' without a GPU
        raises. ``pretune``: run the init-state capacity probe
        (:func:`engine.pretune.pretune_config`) before the first frame;
        ``"auto"`` (default) probes runs of PRETUNE_AUTO_MIN particles or
        more, True/False force it. ``mesh``: this rank's
        :class:`parallel.mesh.Mesh` to run sharded (its device replaces
        ``device``); ``exchange`` ('all_gather', 'halo' or 'ring'),
        ``halo_max`` (0: every local block) and ``halo_hops`` pick the
        exchange (:mod:`parallel.sharded_step`)."""
        if not (pretune is True or pretune is False or pretune == "auto"):
            raise ValueError(f"pretune must be True, False or 'auto', not {pretune!r}")
        self.pretune = pretune
        self.pretune_stats: Optional[dict] = None
        self.mesh = mesh
        self.device = configure_device(mesh.device if mesh is not None else device)
        self.step_config = step_config or StepConfig()
        if mesh is not None:
            from ..parallel.sharded_step import EXCHANGES

            if exchange not in EXCHANGES:
                raise ValueError(f"exchange must be one of {EXCHANGES}, not {exchange!r}")
            if self.step_config.cand_interval > 1 and (
                    self.step_config.neighbor_impl != "pallas"):
                raise ValueError("sharded cand_interval > 1 requires the pallas impl (the "
                                 "carried refined lists are an nl-kernel feature)")
        self.exchange = exchange
        self.halo_max = halo_max
        self.halo_hops = halo_hops
        self.parameters: Optional[SimulationParameters] = None
        self.precomputed_terms: Optional[PrecomputedKernelValues] = None
        self.initial_volume: float = 0.0
        self.write_intermediate_frames = False
        self.serialize = False
        self.current_scene: Optional[Scene] = None
        self.pre_frame: Optional[Callback] = None
        self.save_frame: Optional[SaveCallback] = None
        self.post_frame: Optional[Callback] = None
        self.device_view: Optional[DeviceView] = None
        self.capacity_retries = 0
        # the fast path's dispatches, their host reads, the substeps they
        # ran and discarded, and the chunks that stopped on each predicate
        # (engine.step.dispatch), re-runs included
        self.dispatch_stats = dict(dispatches=0, reads=0, wasted=0, time=0, stale=0, retry=0)
        self.checkpoint_path = ckpt_mod.DEFAULT_CHECKPOINT
        self.state: Optional[ParticleState] = None
        self.device_scene = None

    # ------------------------------------------------------------------
    def load_settings(self, fluid_file_name: str, parameters_file_name: str):
        """Parse the two JSON configs (sph_simulation.cpp:434-532)."""
        p = params_mod.load_parameters(fluid_file_name, parameters_file_name)
        self.parameters = p
        self.precomputed_terms = p.precomputed()
        self.initial_volume = p.initial_volume
        self.write_intermediate_frames = p.write_all_frames
        self.serialize = p.serialize
        return p

    def load_scene(self, filename: str, scenes_dir: str = "scenes"):
        """scene::load with threshold 2h (example/particles.cpp:67)."""
        if self.parameters is None:
            raise RuntimeError("call load_settings first")
        self.current_scene = Scene.load(
            filename, self.parameters.h * 2.0, scenes_dir=scenes_dir
        )
        return self.current_scene

    # ------------------------------------------------------------------
    def init_particles(self) -> ParticleState:
        """Checkpoint resume or the cube lattice (sph_simulation.cpp:52-98)."""
        p = self.parameters
        try:
            arrays = ckpt_mod.load_checkpoint(self.checkpoint_path, p)
        except ValueError as e:
            raise RuntimeError(str(e))
        if arrays is not None:
            log.info("resuming from %s", self.checkpoint_path)
            return ckpt_mod.arrays_to_state(arrays, self.device)
        log.info("volume: %g side_length: %g", self.initial_volume,
                 self.initial_volume ** (1.0 / 3.0))
        return init_state(p, self.device)

    def _fetch(self, state: ParticleState) -> dict:
        return ckpt_mod.state_to_arrays(state)

    def _upload(self, arrays: dict) -> ParticleState:
        return ckpt_mod.arrays_to_state(arrays, self.device)

    def _grow_capacity(self, flags: int):
        """Capacity autotune (simulation.py:190-270): grow ONLY what a
        substep reported as truncated, then the caller re-runs the frame
        from its saved state.

        * the exact impl: cell_capacity x2, and nothing else;
        * block cap: max_candidates x2;
        * subblock cap: on the nl variant at whole-block query rows
          (nl_query_rows >= block_size) the first overflow turns two-tier
          routing on (tier2_frac 8) and later ones double tier2_mult;
          elsewhere (asm, finer query blocks) max_candidates_sub doubles;
        * tier-2 pool: tier2_frac halves;
        * hit cap: max_candidates_hit8 +32 while below 160 (force_sub8);
          past that, or on the 16-wide force path's tables at once, the
          deep-column regime downgrades to the q-granular tables
          (density_sub16, force_sub16, force_sub8 off); on the
          q-granular path max_candidates_hit doubles."""
        cfg = self.step_config
        self.capacity_retries += 1
        if self.capacity_retries > MAX_CAPACITY_RETRIES:
            raise RuntimeError(
                "neighbour capacity keeps overflowing; the particle "
                "distribution is degenerate (all particles in one cell?)"
            )
        if cfg.neighbor_impl == "exact":
            self.step_config = dataclasses.replace(cfg, cell_capacity=cfg.cell_capacity * 2)
            log.warning("neighbour capacity overflow - growing cell_capacity to %d and "
                        "re-running frame", self.step_config.cell_capacity)
            return
        updates = {}
        if flags & FLAG_CAPACITY:
            updates["max_candidates"] = cfg.max_candidates * 2
        if flags & FLAG_CAPACITY_SUB:
            can_t2 = cfg.pallas_variant == "nl" and cfg.q_rep == 1
            if can_t2 and cfg.tier2_frac == 0:
                updates["tier2_frac"] = 8
            elif cfg.tier2_frac > 0:
                updates["tier2_mult"] = cfg.tier2_mult * 2
            else:
                updates["max_candidates_sub"] = cfg.max_candidates_sub * 2
        if flags & FLAG_CAPACITY_T2:
            updates["tier2_frac"] = max(1, cfg.tier2_frac // 2)
        if flags & FLAG_CAPACITY_HIT:
            if cfg.force_sub8 and cfg.max_candidates_hit8 < 160:
                updates["max_candidates_hit8"] = cfg.max_candidates_hit8 + 32
            elif cfg.force_sub16 and cfg.force_query_rows == 32:
                updates.update(force_sub16=False, density_sub16=False, force_sub8=False)
            else:
                updates["max_candidates_hit"] = cfg.max_candidates_hit * 2
        self.step_config = dataclasses.replace(cfg, **updates)
        log.warning(
            "neighbour capacity overflow - growing %s and re-running frame", updates
        )

    def _needs_rerun(self, flags) -> bool:
        """Interpret the status bitfield: True when the frame must be
        re-run; raises on unrecoverable conditions."""
        f = int(flags)
        if f & FLAG_GRID_DIM:
            raise RuntimeError(
                "simulation grid too large: a grid axis reached the 1024-cell "
                "Morton limit (the reference aborts here too, "
                "sph_simulation.cpp:722-724); check dt / fluid stiffness"
            )
        rerun = False
        if f & FLAG_EXCHANGE:
            # the ring's reach is a capacity like the others: double the
            # hops up to full coverage, (S + 1) // 2 a direction
            # (simulation.py:286-309), where the reach check cannot fire
            max_hops = (self.mesh.world + 1) // 2 if self.mesh is not None else 1
            if self.halo_hops >= max_hops:
                raise RuntimeError("ring halo exchange out of reach at full ring coverage: "
                                   "an exchange bug, not a capacity shortfall")
            self.halo_hops = min(max_hops, max(self.halo_hops * 2, 1))
            log.warning("ring exchange under-reach - growing halo_hops to %d and "
                        "re-running frame", self.halo_hops)
            rerun = True
        if f & FLAGS_ALL_CAPACITY:
            self._grow_capacity(f)
            rerun = True
        if f & FLAG_CAND_STALE:
            self.capacity_retries += 1
            if self.capacity_retries > MAX_CAPACITY_RETRIES:
                raise RuntimeError(
                    "candidate-reuse slack keeps overflowing; set "
                    "cand_interval=1 for this workload"
                )
            cfg = self.step_config
            self.step_config = dataclasses.replace(cfg, cand_slack=cfg.cand_slack * 2)
            log.warning(
                "candidate reuse outran its slack margin - growing cand_slack "
                "to %g and re-running frame", self.step_config.cand_slack,
            )
            rerun = True
        return rerun

    # ---- what differs between one device and a mesh ----------------------
    def _frame(self, state, dt, timeleft, host: dict):
        if self.mesh is None:
            return frame(state, dt, timeleft, self.parameters, self.device_scene,
                         self.step_config, host=host)
        from ..parallel import sharded_step

        return sharded_step.local_frame(
            self.mesh, state, dt, timeleft, self.parameters, self.device_scene,
            self.step_config, self.exchange, self.halo_max, self.halo_hops, host=host)

    def _substep(self, state, dt):
        """(new_state, dt, flags) of one substep that rebuilds its tables."""
        if self.mesh is None:
            return substep(state, dt, self.parameters, self.device_scene,
                           self.step_config)[:3]
        from ..parallel import sharded_step

        return sharded_step.make_sharded_substep(
            self.mesh, self.parameters, self.device_scene, self.step_config,
            self.exchange, self.halo_max, self.halo_hops)(state, dt)

    def _root(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def _gathered(self, state) -> ParticleState:
        """The real rows of the whole state (on a mesh: gathered from every
        rank, which must all call this)."""
        if self.mesh is None:
            return state
        from ..parallel import sharded_step

        return sharded_step.gather_real(self.mesh, state)

    def _hooks(self) -> dict:
        """Which hooks run: on a mesh, rank 0's, agreed by every rank (each
        hook gathers the state, a collective)."""
        have = [getattr(self, k) is not None for k in _HOOKS]
        if self.mesh is not None:
            have = self.mesh.broadcast(torch.tensor(have, dtype=torch.float32,
                                                    device=self.device)).tolist()
        return {k: bool(v) for k, v in zip(_HOOKS, have)}

    def _callback(self, cb, state, arrays, is_full_frame: bool):
        """pre_frame / post_frame on ``arrays``, the future of the host
        arrays of the whole state (:meth:`_host`); a True return uploads
        them back (re-partitioned over a mesh)."""
        p = self.parameters
        with profiling.annotate("callback"):
            arrays = arrays.result() if self._root() else None
            if self.mesh is None:
                return self._upload(arrays) if cb(arrays, p, is_full_frame) else state
            write = torch.zeros(1, dtype=torch.float32, device=self.device)
            if self._root():
                write[0] = float(bool(cb(arrays, p, is_full_frame)))
            if not bool(self.mesh.broadcast(write)[0]):
                return state
            from ..parallel import sharded_step

            return sharded_step.scatter_state(self.mesh, self._upload(arrays) if self._root()
                                              else None, p, self.step_config, p.particles_count)

    def _view(self, state):
        real = self._gathered(state)
        if self._root():
            self.device_view(real, self.parameters, True)

    def _host(self, saver: AsyncSaver, state: ParticleState, save: bool, callbacks: bool):
        """Hand ``state`` (on a mesh, the real rows gathered to rank 0) to
        the saver thread, which fetches it to the host once and, with
        ``save``, saves it (save_frame, then the checkpoint). The loop
        thread only records a CUDA event on its stream; the saver thread
        makes its copy on a stream of its own that waits on that event,
        and holds the tensors until the copy has ended (the step never
        writes to its input). ``callbacks``: pre_frame or post_frame will
        read the arrays, so the save gets a host copy of its own, which a
        callback that edits its arrays in place cannot reach. Returns a
        future of the host arrays (None off rank 0)."""
        real = self._gathered(state)
        if not self._root():
            return None
        p = self.parameters
        save_cb = self.save_frame if save else None
        ckpt = self.checkpoint_path if self.serialize else None
        event = None
        if real.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(real.device))
        arrays = Future()
        handoff = profiling.current()  # the saver's spans name the span that handed over

        def fetch():
            if event is None:
                return self._fetch(real)
            side = torch.cuda.Stream(real.device)
            side.wait_event(event)
            with torch.cuda.stream(side):
                return self._fetch(real)

        def run():
            try:
                with profiling.annotate("saver.fetch", parent=handoff):
                    host = fetch()
            except BaseException as e:
                arrays.set_exception(e)
                raise
            if profiling.active():
                profiling.count("saver.bytes", sum(v.nbytes for v in host.values()))
            saved = {k: v.copy() for k, v in host.items()} if save_cb and callbacks else host
            arrays.set_result(host)
            if save_cb is not None:
                with profiling.annotate("saver.save", parent=handoff):
                    save_cb(saved, p)
                    if ckpt:
                        ckpt_mod.save_checkpoint(ckpt, saved, p)

        saver.submit(run)
        return arrays

    # ------------------------------------------------------------------
    def simulate(self) -> float:
        """The frame loop (sph_simulation.cpp:265-432). Returns the
        wall-clock seconds it took."""
        if self.parameters is None:
            raise RuntimeError("call load_settings first")
        p = self.parameters
        dev = self.device

        t_start = _time.perf_counter()
        with profiling.annotate("simulate"):
            with profiling.annotate("simulate.start"):
                self.device_scene = collisions_ops.build_device_scene(self.current_scene, dev)
                state = self.init_particles()
                if self.mesh is not None:
                    from ..parallel import sharded_step

                    world, cfg = self.mesh.world, self.step_config
                    if self.exchange in ("halo", "ring") and not self.halo_max:
                        self.halo_max = sharded_step.default_halo_max(
                            p.particles_count, world, cfg.block_size)
                    state = sharded_step.local_rows(
                        sharded_step.pad_for_mesh(state, p, world, cfg), self.mesh.rank, world)
                elif self.pretune is True or (
                    self.pretune == "auto" and p.particles_count >= PRETUNE_AUTO_MIN
                ):
                    from . import pretune as pretune_mod

                    self.step_config, self.pretune_stats = pretune_mod.pretune_config(
                        state, p, self.step_config
                    )
                hooks = self._hooks()
                saver = AsyncSaver()
                callbacks = hooks["pre_frame"] or hooks["post_frame"]
                # the one host copy of ``state`` (a future, fetched on the saver
                # thread), kept until the state changes
                cache = [None, None]

                def host(state, save=False):
                    if save or cache[0] is not state:
                        cache[:] = state, self._host(saver, state, save, callbacks)
                    return cache[1]

                timeperframe = p.frame_time
                dt = torch.tensor(timeperframe * p.simulation_scale, dtype=torch.float32,
                                  device=dev)
                sim_time = 0.0
                current_frame = 2  # reference starts at 2 (sph_simulation.cpp:365)

                if hooks["device_view"]:  # the initial frame, like the initial save
                    self._view(state)
                if hooks["save_frame"]:
                    host(state, save=True)
            fast_path = not self.write_intermediate_frames

            try:
                while sim_time < p.simulation_time:
                    with profiling.annotate("frame") as span:
                        retries = self.capacity_retries
                        if self._root():
                            log.info("Simulating frame %d (%gs)", current_frame, sim_time)
                        if fast_path:
                            if hooks["pre_frame"]:
                                state = self._callback(self.pre_frame, state, host(state), True)
                            state, dt = self._run_frame(state, dt)
                        else:
                            state, dt = self._run_frame_per_substep(state, dt, host, hooks)
                        sim_time += timeperframe
                        current_frame += 1
                        if hooks["device_view"]:
                            self._view(state)
                        if fast_path and hooks["save_frame"]:
                            host(state, save=True)
                        if fast_path and hooks["post_frame"]:
                            state = self._callback(self.post_frame, state, host(state), True)
                        if span:
                            span.set(capacity_retries=self.capacity_retries - retries)
            finally:
                saver.close()
            # on a mesh every rank gets the whole simulation, not its shard
            self.state = self._gathered(state)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return _time.perf_counter() - t_start

    def _run_frame(self, state, dt):
        """One frame through the frame loop; on a flag, grow and re-run the
        frame from ``state`` (the step never modifies its input). The time
        left and the flags come from each dispatch's own reads."""
        p = self.parameters
        frame_time = np.float32(p.frame_time)
        while True:
            st_try, dt_try = state, dt
            timeleft = grid_ops.device_scalar(p.frame_time, self.device)
            rerun = False
            more = bool(frame_time > 0.0)
            while more:
                host = {}
                st_try, dt_try, timeleft, _ = self._frame(st_try, dt_try, timeleft, host)
                ds = self.dispatch_stats
                ds["dispatches"] += 1
                ds["reads"] += host["reads"]
                ds["wasted"] += host["wasted"]
                for k, v in host["stops"].items():
                    ds[k] += v
                if self._needs_rerun(host["flags"]):
                    rerun = True
                    break
                more = host["more"]
            if not rerun:
                return st_try, dt_try

    def _run_frame_per_substep(self, state, dt, host, hooks):
        """One frame substep by substep, with the callbacks in between;
        ``host(state, save=False)`` the future of the host arrays."""
        p = self.parameters
        timeleft = p.frame_time
        while timeleft > 0.0:
            if hooks["pre_frame"]:
                state = self._callback(self.pre_frame, state, host(state), False)
            while True:
                new_state, dt_dev, flags = self._substep(state, dt)
                if not self._needs_rerun(flags):
                    state = new_state
                    break
            dt_f = float(dt_dev)
            timeleft -= dt_f
            dt = torch.tensor(min(dt_f, timeleft) if timeleft < dt_f else dt_f,
                              dtype=torch.float32, device=self.device)
            if hooks["save_frame"]:
                host(state, save=True)
            if hooks["post_frame"]:
                state = self._callback(self.post_frame, state, host(state), False)
        return state, dt
