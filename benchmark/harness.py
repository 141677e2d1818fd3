"""The two entries a cell's traffic names, driven through the program's
own entry points, and what each hands to the judge and the readers.

* ``substeps``: ``engine.step.dispatch`` on bench.py's schedule (a re-sort
  and candidate rebuild every ``cand_interval``-th substep, the carried
  tables reused in between), a fixed segment replayed from the same warm
  state until the window's seconds are spent.
* ``frames``: ``SPHSimulation.simulate()`` over the first frames of the
  simulation, resumed from a checkpoint of the seeded start (upstream's
  resume path), with a ``save_frame`` that writes every frame's ``.geo``
  through the program's saver, replayed the same way.

The seed makes the start: the cube lattice of upstream's
``init_particles`` with a uniform jitter of ``jitter`` rest spacings on
every axis, drawn on the device.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from . import judge, spec
from . import devtrace as trace_mod
from .reference import geo as geo_ref
from .reference import scene as scene_ref
from .reference import sph


def lattice(n: int, volume: float, seed: int, jitter: float, device) -> torch.Tensor:
    """(n, 3) float32 positions: upstream's cube lattice (a cube of side
    cbrt(volume), centred in x and z, resting on y = 0, x fastest) moved
    by a uniform jitter of ``jitter`` spacings a side, from ``seed``."""
    per_side = 1
    while per_side ** 3 < n:
        per_side += 1
    side = volume ** (1.0 / 3.0)
    spacing = side / per_side
    i = torch.arange(n, device=device)
    grid = torch.stack([i % per_side, (i // per_side) % per_side, i // per_side ** 2], 1)
    pos = grid.to(torch.float32) * spacing - torch.tensor(
        [side / 2.0, 0.0, side / 2.0], device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    noise = torch.rand((n, 3), generator=gen, device=device, dtype=torch.float32)
    return (pos + (2.0 * noise - 1.0) * (jitter * spacing)).to(torch.float32)


def sample(seed: int, count: int, k: int, always=()) -> list:
    """``k`` of range(count) drawn from ``seed``, with ``always`` in."""
    rng = np.random.default_rng(seed % (1 << 63))
    rest = [i for i in range(count) if i not in always]
    picked = list(always) + list(rng.choice(rest, size=max(0, min(k - len(always), len(rest))),
                                            replace=False))
    return sorted(int(i) for i in picked)


class Clock:
    """Host-clock spans kept in memory, by name (seconds)."""

    def __init__(self, on: bool):
        self.on = on
        self.spans: dict = {}
        self.lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self.lock:
                self.spans.setdefault(name, []).append(dt)


def _range(name: str, on: bool):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profiled(fn, tmpdir: str, names, dev):
    """Run ``fn`` under ``torch.profiler`` (host and device activity) in a
    ``segment`` range; returns (fn's result, the reduced trace)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(tmpdir, "bench_trace.json")
    _sync(dev)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("segment"):
            out = fn()
            _sync(dev)
    prof.export_chrome_trace(path)
    try:
        tr = trace_mod.load(path, names, "segment")
    finally:
        remove(path)
    return out, tr


def remove(path: str) -> None:
    try:
        os.remove(path)
    except FileNotFoundError:
        pass


def host_reads() -> int:
    """The frame loops' host reads so far (``engine.step.host_read``)."""
    from libclsph_tpu_torch.engine import step

    return step.host_read.count


# ---- substeps ---------------------------------------------------------------


class Substeps:
    """The ``substeps`` entry on one device."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, dev, clock: Clock):
        from libclsph_tpu_torch.core.params import derive_parameters
        from libclsph_tpu_torch.core.state import ParticleState
        from libclsph_tpu_torch.engine.simulation import SPHSimulation
        from libclsph_tpu_torch.engine.step import StepConfig
        from libclsph_tpu_torch.ops import collisions
        from libclsph_tpu_torch.scene.scene import Scene

        self.cfg, self.traffic, self.seed, self.dev, self.clock = cfg, traffic, seed, dev, clock
        self.params = derive_parameters(dict(cfg["fluid"]), dict(cfg["simulation"]))
        self.scene = collisions.build_device_scene(
            Scene.load(cfg["scene"], self.params.h * 2.0, scenes_dir=spec.SCENES), dev)
        self.engine = SPHSimulation(StepConfig(**cfg.get("step_config", {})), device=dev,
                                    pretune=False)
        n = self.params.particles_count
        pos = lattice(n, self.params.initial_volume, seed, traffic["jitter"], dev)
        self.start = ParticleState.zeros(n, dev).replace(position=pos)
        self.steps = traffic["segment_substeps"]
        self.checked = sample(seed, self.steps, traffic["checked_substeps"],
                              always=(0, self.steps - 1))
        self.sort_interval = self.engine.step_config.sort_interval
        self.profiling = False
        self.records = {}
        self.warm_records = {}

    def _run(self, st, d, i, tables, rebuild):
        from libclsph_tpu_torch.engine import step

        cfg = self.engine.step_config
        with self.clock.span("enqueue"), _range("rebuild" if rebuild else "reuse",
                                                  self.profiling):
            if rebuild:
                return step.substep(st, d, self.params, self.scene, cfg,
                                    do_sort=i % cfg.sort_interval == 0, speculative=True)
            return step.substep(st, d, self.params, self.scene, cfg, do_sort=False,
                                cand_in=tables, speculative=True)

    def replay(self, state, dt, steps: int, records: dict = None, keep=None):
        """``steps`` substeps of the schedule from (state, dt) through the
        dispatch layer. ``records``: filled with each substep's dt and,
        for those in ``keep`` (all where None), its input and output.
        Returns (state, dt, flags as an int)."""
        from libclsph_tpu_torch.engine import step

        def on_commit(k, rebuild, before, after, dt_next, flags, tables):
            records.setdefault("dt", {})[k] = dt_next
            if keep is None or k in keep:
                records[k] = (rebuild, before, after)

        host = {}
        with _range("dispatch", self.profiling):
            st, dt, _, _ = step.dispatch(state, dt, None, steps,
                                         self.engine.step_config.cand_interval, self._run,
                                         on_commit=on_commit if records is not None else None,
                                         host=host)
        return st, dt, host["flags"]

    def _grown(self, state, dt, steps, records=None):
        for _ in range(8):
            if records is not None:
                records.clear()
            st, dt_out, flags = self.replay(state, dt, steps, records)
            if not self.engine._needs_rerun(flags):
                return st, dt_out
        raise RuntimeError("capacity growth did not converge")

    def setup(self):
        """The warm-up's substeps from the start, then the segment once
        from the warm state, each re-run with the engine's capacity growth
        until no flag is raised (bench_torch.warm_up's rule)."""
        dt0 = torch.tensor(self.params.max_dt, dtype=torch.float32, device=self.dev)
        self.warm, self.warm_dt = self._grown(self.start, dt0, self.traffic["warmup_substeps"],
                                              self.warm_records)
        self.warm_records["dt0"] = dt0
        self._grown(self.warm, self.warm_dt, self.steps)
        _sync(self.dev)

    def window(self, seconds: float) -> dict:
        """Replays of the segment from the warm state until ``seconds`` have
        passed; each replay keeps the records of the checked substeps."""
        bad = torch.zeros((), dtype=torch.int32, device=self.dev)
        replays = flagged = 0
        _sync(self.dev)
        start, t0 = time.monotonic(), time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            rec = {}
            replays += 1
            try:
                st, _, flags = self.replay(self.warm, self.warm_dt, self.steps, rec,
                                           self.checked)
            except RuntimeError as e:  # the program gave up: a failed replay
                print(f"replay {replays} failed: {e}", file=sys.stderr)
                flagged += 1
                break
            bad += (~torch.isfinite(st.position).all()).to(torch.int32)
            self.records = rec
            flagged += int(flags != 0)
        _sync(self.dev)
        elapsed = time.perf_counter() - t0
        nonfinite = int(bad)
        return dict(start=start, elapsed=elapsed, replays=replays,
                    failed=max(flagged, nonfinite),
                    work=self.params.particles_count * self.steps * replays,
                    substeps=self.steps * replays)

    def trace(self, tmpdir: str):
        self.profiling = True
        try:
            _, tr = profiled(lambda: self.replay(self.warm, self.warm_dt, self.steps),
                             tmpdir, ("dispatch", "rebuild", "reuse"), self.dev)
        finally:
            self.profiling = False
        return dict(trace=tr, trace_substeps=self.steps)

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.dev) if self.dev.type == "cuda" else 0

    def cleanup(self):
        pass

    def release(self):
        """Drop the program's state and tables but the checked records."""
        self.warm = self.start = None
        self.scene = None
        self.engine = None

    def judge(self, obj_path: str, prm, control: bool = False, shell: bool = False) -> tuple:
        """(numbers, the reference's mean pairs within h a substep). With
        ``control`` the reference computed in TF32 stands in the program's
        place; with ``shell`` the reference that leaves out the pairs
        beyond ``judge.SHELL_CUT`` h (a fault of the neighbour search)."""
        field = scene_ref.bake(obj_path, prm.h, self.dev)
        out = []
        for recs in (self.warm_records, self.records):
            dts = recs["dt"]
            for k in sorted(x for x in recs if isinstance(x, int)):
                rebuild, before, after = recs[k]
                dt_in = recs.get("dt0") if k == 0 and "dt0" in recs else (
                    dts[k - 1] if k > 0 else self.warm_dt)
                out.append(judge.substep_numbers(
                    prm, field, _fields(before), _fields(after),
                    float(dt_in), sorted_=rebuild and k % self.sort_interval == 0,
                    tf32=control, cut=judge.SHELL_CUT if shell else None))
        nums = judge.worst(out)
        pairs = nums.pop("pairs") / max(1, len(out))
        return nums, pairs


def _fields(st) -> dict:
    return dict(position=st.position, velocity=st.velocity,
                intermediate_velocity=st.intermediate_velocity, density=st.density,
                acceleration=st.acceleration, grid_index=st.grid_index)


# ---- frames -----------------------------------------------------------------


class Frames:
    """The ``frames`` entry on one device."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, dev, clock: Clock, tmpdir: str):
        from libclsph_tpu_torch.engine.simulation import SPHSimulation
        from libclsph_tpu_torch.engine.step import StepConfig
        from libclsph_tpu_torch.io import checkpoint
        from libclsph_tpu_torch.io.houdini import HoudiniFileSaver

        self.cfg, self.traffic, self.seed, self.dev, self.clock = cfg, traffic, seed, dev, clock
        self.dir = tmpdir
        sim = dict(cfg["simulation"])
        self.frames = traffic["segment_frames"]
        # half a frame short of the segment's end: the frame loop adds the
        # frame time up in floating point and runs while the sum is below
        sim["simulation_time"] = (self.frames - 0.5) / float(sim["target_fps"])
        paths = []
        for name, body in (("fluid", cfg["fluid"]), ("simulation", sim)):
            paths.append(os.path.join(tmpdir, name + ".json"))
            with open(paths[-1], "w") as f:
                json.dump(body, f)
        self.engine = SPHSimulation(StepConfig(**cfg.get("step_config", {})), device=dev,
                                    pretune=cfg.get("pretune", "auto"))
        p = self.engine.load_settings(*paths)
        self.engine.load_scene(cfg["scene"], scenes_dir=spec.SCENES)
        pos = lattice(p.particles_count, p.initial_volume, seed, traffic["jitter"], dev)
        n = p.particles_count
        zeros3 = np.zeros((n, 3), np.float32)
        self.start = dict(position=pos.cpu().numpy(), velocity=zeros3, intermediate_velocity=zeros3,
                          acceleration=zeros3, density=np.zeros(n, np.float32),
                          pressure=np.zeros(n, np.float32), grid_index=np.zeros(n, np.uint32))
        self.engine.checkpoint_path = os.path.join(tmpdir, "start.npz")
        checkpoint.save_checkpoint(self.engine.checkpoint_path, self.start, p)
        self.out = os.path.join(tmpdir, "frames_")
        self.writer = HoudiniFileSaver(self.out, use_partio=traffic.get("export") == "bgeo")
        self.engine.save_frame = self._save
        self.saved = []  # (time the save ended, host arrays, file) of the current segment
        self.last = []
        self.profiling = False
        self.lock = threading.Lock()

    def _save(self, arrays, params):
        from libclsph_tpu_torch.io.houdini import OUTPUT_FILE_NAME, zero_pad_number

        with self.clock.span("export"), _range("export", self.profiling):
            self.writer.write_frame_to_file(arrays, params)
        path = (self.out + OUTPUT_FILE_NAME + zero_pad_number(self.writer.frame_count)
                + (".bgeo" if self.writer.use_partio else ".geo"))
        with self.lock:
            self.saved.append((time.perf_counter(), arrays, path))

    def segment(self):
        """One replay: ``simulate()`` from the checkpoint; the previous
        segment's files are removed first (at most one segment on disk)."""
        for _, _, path in self.last:
            remove(path)
        self.saved = []
        with _range("simulate", self.profiling):
            self.engine.simulate()
        self.last = self.saved
        self.saved = []
        return self.last

    def setup(self):
        """The segment once: its frames grow the tables as the engine
        grows them (a frame re-run from its saved state)."""
        self.segment()
        self.retries = self.engine.capacity_retries

    def window(self, seconds: float) -> dict:
        stats0 = dict(self.engine.dispatch_stats)
        reads0 = host_reads()
        intervals, segments, failed = [], 0, 0
        _sync(self.dev)
        start, t0 = time.monotonic(), time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            segments += 1
            try:
                saved = self.segment()
            except RuntimeError as e:  # the program gave up: a failed replay
                print(f"segment {segments} failed: {e}", file=sys.stderr)
                failed += 1
                break
            ends = [s[0] for s in saved]
            intervals += [b - a for a, b in zip(ends[:-1], ends[1:])]
        elapsed = time.perf_counter() - t0
        stats = {k: self.engine.dispatch_stats[k] - stats0[k] for k in stats0}
        frames = segments * self.frames
        return dict(start=start, elapsed=elapsed, replays=segments, frames=frames,
                    intervals=intervals,
                    failed=failed + int(self.engine.capacity_retries != self.retries),
                    dispatch=stats, host_reads=host_reads() - reads0)

    def trace(self, tmpdir: str):
        self.profiling = True
        try:
            _, tr = profiled(self.segment, tmpdir, ("simulate", "export"), self.dev)
        finally:
            self.profiling = False
        return dict(trace=tr)

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.dev) if self.dev.type == "cuda" else 0

    def release(self):
        self.engine.state = None
        self.engine = None

    def judge(self, obj_path: str, prm, control: bool = False) -> tuple:
        """(numbers, None); the reference's substeps a frame go to
        ``substeps_per_frame``. With ``control`` the reference computed in
        TF32 stands in the program's place for the frames, and for the
        exports the program's files written again at
        ``judge.CONTROL_DIGITS`` significant digits."""
        field = scene_ref.bake(obj_path, prm.h, self.dev)
        frames = [a for _, a, _ in self.last]
        if control:
            frames = judge.control_frames(prm, field, frames[0], len(frames) - 1, self.dev)
        start = dict(start_mismatch=int(not np.array_equal(frames[0]["position"],
                                                           self.start["position"])),
                     frames_missing=abs(len(frames) - (self.frames + 1)))
        nums, counts = judge.frame_numbers(prm, field, frames, self.dev)
        picked = sample(self.seed, len(self.last), self.traffic["checked_exports"],
                        always=(0, len(self.last) - 1))
        exports = []
        for k in picked:
            path = self.last[k][2]
            if control:
                geo_ref.rewrite(path, path + ".control", judge.CONTROL_DIGITS)
                path += ".control"
            exports.append(judge.export_numbers(path, self.last[k][1], prm.mass))
            if control:
                remove(path)
        out = judge.worst([start, nums] + exports)
        self.substeps_per_frame = sum(counts) / max(1, len(counts))
        return out, None

    def cleanup(self):
        shutil.rmtree(self.out + "frames", ignore_errors=True)


def make_entry(cfg: dict, traffic: dict, seed: int, dev, clock: Clock, tmpdir: str):
    """The entry that the traffic names, over a mesh where the
    configuration has one."""
    if traffic["entry"] == "substeps" and cfg.get("mesh"):
        from .mesh import MeshSubsteps

        return MeshSubsteps(cfg, traffic, seed, dev, clock, tmpdir)
    if traffic["entry"] == "frames":
        return Frames(cfg, traffic, seed, dev, clock, tmpdir)
    if traffic["entry"] == "substeps":
        return Substeps(cfg, traffic, seed, dev, clock)
    raise ValueError(f"unknown traffic entry {traffic['entry']!r}")


def new_tmpdir() -> str:
    return tempfile.mkdtemp(prefix="bench_")


def params_of(cfg: dict):
    return sph.derive(cfg)


def scene_path(cfg: dict) -> str:
    return os.path.join(spec.SCENES, cfg["scene"])


