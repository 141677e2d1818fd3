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

Frame export runs on a background thread, as the reference's
``std::thread`` (sph_simulation.cpp:370-430).
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Optional

import torch

from ..core import params as params_mod
from ..core.params import PrecomputedKernelValues, SimulationParameters
from ..core.state import ParticleState, init_state
from ..io import checkpoint as ckpt_mod
from ..io.async_saver import AsyncSaver
from ..ops import collisions as collisions_ops
from ..scene.scene import Scene
from ..utils.logging import get_logger
from .step import (
    FLAG_CAND_STALE,
    FLAG_CAPACITY,
    FLAG_CAPACITY_HIT,
    FLAG_CAPACITY_SUB,
    FLAG_GRID_DIM,
    FLAGS_ALL_CAPACITY,
    StepConfig,
    frame,
    substep,
)

MAX_CAPACITY_RETRIES = 6

log = get_logger(__name__)

# host-side callback signatures (the JAX package's):
#   pre_frame(arrays: dict, params, is_full_frame) -> bool (True = write back)
#   save_frame(arrays: dict, params) -> None
#   post_frame(arrays: dict, params, is_full_frame) -> bool
Callback = Callable[[dict, SimulationParameters, bool], bool]
SaveCallback = Callable[[dict, SimulationParameters], None]


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
                 pretune: bool = False):
        """``device``: 'cuda' (default) or 'cpu'; 'cuda' without a GPU
        raises. ``pretune``: the JAX engine's init-state capacity probe is
        not ported yet (ROADMAP.md queue 1 item 10); only False is
        accepted."""
        if pretune is not False:
            raise ValueError(
                "pretune is not ported yet (ROADMAP.md queue 1 item 10); "
                "the port grows capacities reactively"
            )
        self.device = configure_device(device)
        self.parameters: Optional[SimulationParameters] = None
        self.precomputed_terms: Optional[PrecomputedKernelValues] = None
        self.initial_volume: float = 0.0
        self.write_intermediate_frames = False
        self.serialize = False
        self.current_scene: Optional[Scene] = None
        self.pre_frame: Optional[Callback] = None
        self.save_frame: Optional[SaveCallback] = None
        self.post_frame: Optional[Callback] = None
        self.step_config = step_config or StepConfig()
        self.capacity_retries = 0
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
        """Capacity autotune: grow ONLY the table(s) a substep reported as
        truncated, then the caller re-runs the frame from its saved state.
        The port takes the JAX engine's non-tier-2 branches
        (simulation.py:190-270): max_candidates x2, max_candidates_sub x2
        (where the JAX engine would enable two-tier routing), and
        max_candidates_hit8 +32 (also past 160, where the JAX engine
        downgrades to the 16-wide kernels). Both stay physics-exact."""
        cfg = self.step_config
        self.capacity_retries += 1
        if self.capacity_retries > MAX_CAPACITY_RETRIES:
            raise RuntimeError(
                "neighbour capacity keeps overflowing; the particle "
                "distribution is degenerate (all particles in one cell?)"
            )
        updates = {}
        if flags & FLAG_CAPACITY:
            updates["max_candidates"] = cfg.max_candidates * 2
        if flags & FLAG_CAPACITY_SUB:
            updates["max_candidates_sub"] = cfg.max_candidates_sub * 2
        if flags & FLAG_CAPACITY_HIT:
            updates["max_candidates_hit8"] = cfg.max_candidates_hit8 + 32
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

    def _save(self, saver: AsyncSaver, state: ParticleState):
        """Hand a host snapshot of ``state`` to the save thread (the copy
        is taken here: the loop may go on replacing tensors)."""
        p = self.parameters
        save_cb = self.save_frame
        ckpt = self.checkpoint_path if self.serialize else None
        arrays = self._fetch(state)

        def run():
            save_cb(arrays, p)
            if ckpt:
                ckpt_mod.save_checkpoint(ckpt, arrays, p)

        saver.submit(run)

    # ------------------------------------------------------------------
    def simulate(self) -> float:
        """The frame loop (sph_simulation.cpp:265-432). Returns the
        wall-clock seconds it took."""
        if self.parameters is None:
            raise RuntimeError("call load_settings first")
        p = self.parameters
        dev = self.device

        t_start = _time.perf_counter()
        self.device_scene = collisions_ops.build_device_scene(self.current_scene, dev)
        state = self.init_particles()
        saver = AsyncSaver()

        timeperframe = p.frame_time
        dt = torch.tensor(timeperframe * p.simulation_scale, dtype=torch.float32, device=dev)
        sim_time = 0.0
        current_frame = 2  # reference starts at 2 (sph_simulation.cpp:365)

        if self.save_frame:
            self._save(saver, state)
        fast_path = not self.write_intermediate_frames

        try:
            while sim_time < p.simulation_time:
                log.info("Simulating frame %d (%gs)", current_frame, sim_time)
                if fast_path:
                    if self.pre_frame:
                        arrays = self._fetch(state)
                        if self.pre_frame(arrays, p, True):
                            state = self._upload(arrays)
                    state, dt = self._run_frame(state, dt)
                else:
                    state, dt = self._run_frame_per_substep(state, dt, saver)
                sim_time += timeperframe
                current_frame += 1
                if fast_path and self.save_frame:
                    self._save(saver, state)
                if fast_path and self.post_frame:
                    arrays = self._fetch(state)
                    if self.post_frame(arrays, p, True):
                        state = self._upload(arrays)
        finally:
            saver.close()
        self.state = state
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return _time.perf_counter() - t_start

    def _run_frame(self, state, dt):
        """One frame through :func:`frame`; on a flag, grow and re-run the
        frame from ``state`` (the step never modifies its input)."""
        p = self.parameters
        while True:
            st_try, dt_try = state, dt
            timeleft = torch.tensor(p.frame_time, dtype=torch.float32, device=self.device)
            rerun = False
            while bool(timeleft > 0.0):
                st_try, dt_try, timeleft, flags = frame(
                    st_try, dt_try, timeleft, p, self.device_scene, self.step_config
                )
                if self._needs_rerun(flags):
                    rerun = True
                    break
            if not rerun:
                return st_try, dt_try

    def _run_frame_per_substep(self, state, dt, saver):
        """One frame substep by substep, with the callbacks in between."""
        p = self.parameters
        timeleft = p.frame_time
        while timeleft > 0.0:
            if self.pre_frame:
                arrays = self._fetch(state)
                if self.pre_frame(arrays, p, False):
                    state = self._upload(arrays)
            while True:
                new_state, dt_dev, flags, _ = substep(
                    state, dt, p, self.device_scene, self.step_config
                )
                if not self._needs_rerun(flags):
                    state = new_state
                    break
            dt_f = float(dt_dev)
            timeleft -= dt_f
            dt = torch.tensor(min(dt_f, timeleft) if timeleft < dt_f else dt_f,
                              dtype=torch.float32, device=self.device)
            if self.save_frame:
                self._save(saver, state)
            if self.post_frame:
                arrays = self._fetch(state)
                if self.post_frame(arrays, p, False):
                    state = self._upload(arrays)
        return state, dt
