"""The ``substeps`` entry over a mesh: the cell's particles
Morton-partitioned over the configuration's ranks, one process and one
card a rank (:func:`libclsph_tpu_torch.parallel.mesh.launch`), each
substep the program's sharded one (``parallel.sharded_step.local_substep``)
on bench.py's schedule through ``engine.step.dispatch``, its predicates
all-reduced so that every rank takes the same branch.

Everything runs in the ranks: the set-up (the warm-up grown by the
program's mesh rule, ``parallel.bench.mesh_growth``), the window (rank 0
decides when its seconds are spent and tells the others), the profiled
replay on rank 0, and the comparison: the checked substeps' states are
gathered (``sharded_step.gather_real``) and rank 0 holds them against the
reference, row by row against the nearest reference particle
(:func:`benchmark.judge.matched_numbers`). The parent gets each rank's
results back, with the modules of JAX or the JAX package that the rank
had loaded once it was done (:func:`benchmark.spec.forbidden_modules`):
a rank starts with modules of its own, which the parent's look cannot
see.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from . import harness, judge, spec
from .reference import scene as scene_ref


class _Rank:
    """One rank's program: the sharded substep and its growth."""

    def __init__(self, mesh, cfg: dict, traffic: dict, seed: int):
        from libclsph_tpu_torch.core.params import derive_parameters
        from libclsph_tpu_torch.core.state import ParticleState
        from libclsph_tpu_torch.engine.step import StepConfig
        from libclsph_tpu_torch.ops import collisions
        from libclsph_tpu_torch.parallel import sharded_step
        from libclsph_tpu_torch.scene.scene import Scene

        self.mesh = mesh
        dev = mesh.device
        self.params = derive_parameters(dict(cfg["fluid"]), dict(cfg["simulation"]))
        self.scene = collisions.build_device_scene(
            Scene.load(cfg["scene"], self.params.h * 2.0, scenes_dir=spec.SCENES), dev)
        self.config = sharded_step.mesh_config(StepConfig(**cfg.get("step_config", {})))
        self.exchange = cfg["mesh"]["exchange"]
        self.halo_max = (0 if self.exchange == "all_gather" else sharded_step.default_halo_max(
            self.params.particles_count, mesh.world, self.config.block_size))
        self.halo_hops = 1
        n = self.params.particles_count
        pos = harness.lattice(n, self.params.initial_volume, seed, traffic["jitter"], dev)
        start = ParticleState.zeros(n, dev).replace(position=pos)
        self.start = sharded_step.local_rows(
            sharded_step.pad_for_mesh(start, self.params, mesh.world, self.config),
            mesh.rank, mesh.world)
        self.profiling = False

    def run(self, st, d, k, tables, rebuild):
        from libclsph_tpu_torch.parallel import sharded_step

        with harness._range("rebuild" if rebuild else "reuse", self.profiling):
            return sharded_step.local_substep(
                self.mesh, st, d, self.params, self.scene, self.config, self.exchange,
                self.halo_max, self.halo_hops, do_sort=k % self.config.sort_interval == 0
                if rebuild else False, cand_in=None if rebuild else tables, speculative=True)

    def replay(self, state, dt, steps: int, records=None, keep=None):
        from libclsph_tpu_torch.engine import step

        def on_commit(k, rebuild, before, after, dt_next, flags, tables):
            records.setdefault("dt", {})[k] = dt_next
            if keep is None or k in keep:
                records[k] = (before, after)

        host = {}
        with harness._range("dispatch", self.profiling):
            st, dt, _, _ = step.dispatch(state, dt, None, steps, self.config.cand_interval,
                                         self.run, combine=self.mesh.all_reduce_max,
                                         on_commit=on_commit if records is not None
                                         else None, host=host)
        return st, dt, host["flags"]

    def grown(self, state, dt, steps, records=None):
        """``steps`` substeps re-run with the program's mesh growth rule
        until no flag is raised (every rank reads the same flags)."""
        import dataclasses

        from libclsph_tpu_torch.parallel import bench

        for _ in range(bench.GROWTH_TRIES + 3):
            if records is not None:
                records.clear()
            st, dt_out, flags = self.replay(state, dt, steps, records)
            if not flags:
                return st, dt_out
            updates, hops = bench.mesh_growth(self.config, flags, self.halo_hops,
                                              self.mesh.world)
            if not updates and hops == self.halo_hops:
                break
            self.config = dataclasses.replace(self.config, **updates)
            self.halo_hops = hops
        raise RuntimeError(f"mesh capacity growth did not converge (flags {flags})")


def rank_body(mesh, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
              control: bool, tmpdir: str) -> dict:
    """A rank's whole run; rank 0's result carries the window, the trace
    and the comparison."""
    dev = mesh.device
    r = _Rank(mesh, cfg, traffic, seed)
    steps = traffic["segment_substeps"]
    checked = harness.sample(seed, steps, traffic["checked_substeps"], always=(0, steps - 1))
    dt0 = torch.tensor(r.params.max_dt, dtype=torch.float32, device=dev)
    warm_rec = {}
    warm, warm_dt = r.grown(r.start, dt0, traffic["warmup_substeps"], warm_rec)
    r.grown(warm, warm_dt, steps)

    mesh.reset_stats()
    mesh.barrier()
    start, t0 = time.monotonic(), time.perf_counter()
    rec, replays, failed = {}, 0, 0
    bad = torch.zeros((), dtype=torch.int32, device=dev)
    while True:
        go = torch.tensor([float(time.perf_counter() - t0 < seconds)], device=dev)
        if not bool(mesh.broadcast(go)[0]):
            break
        replays += 1
        cur = {}
        st, _, flags = r.replay(warm, warm_dt, steps, cur, checked)
        live = st.position.abs().amax(dim=1) < 1e30
        bad += (~torch.isfinite(st.position[live]).all()).to(torch.int32)
        rec = cur
        failed += int(flags != 0)
    mesh.barrier()
    elapsed = time.perf_counter() - t0
    stats = mesh.read_stats()
    out = dict(start=start, elapsed=elapsed, replays=replays,
               failed=max(failed, int(bad)), substeps=replays * steps,
               work=r.params.particles_count * steps * replays,
               collective_bytes=sum(stats["bytes"].values()))
    if trace:
        r.profiling = mesh.rank == 0
        if mesh.rank == 0:
            out["trace"] = harness.profiled(lambda: r.replay(warm, warm_dt, steps), tmpdir,
                                            ("dispatch", "rebuild", "reuse"), dev)[1]
        else:
            r.replay(warm, warm_dt, steps)
        r.profiling = False
        out["trace_substeps"] = steps
    out["peak"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # the comparison: the checked states gathered, held on rank 0
    from libclsph_tpu_torch.parallel import sharded_step

    r.start = warm = st = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    prm = harness.params_of(cfg)
    field = scene_ref.bake(harness.scene_path(cfg), prm.h, dev) if mesh.rank == 0 else None
    numbers, controls = [], []
    for recs, first_dt in ((warm_rec, dt0), (rec, warm_dt)):
        for k in sorted(x for x in recs if isinstance(x, int)):
            before, after = (harness._fields(sharded_step.gather_real(mesh, s))
                             for s in recs[k])
            if mesh.rank != 0:
                continue
            dt_in = float(first_dt if k == 0 else recs["dt"][k - 1])
            numbers.append(judge.matched_numbers(prm, field, before, after, dt_in))
            if control:
                controls.append(judge.matched_numbers(prm, field, before, after, dt_in,
                                                      tf32=True))
    if mesh.rank == 0:
        out["numbers"] = judge.worst(numbers)
        out["pairs"] = out["numbers"].pop("pairs") / max(1, len(numbers))
        if control:
            out["control"] = judge.worst(controls)
            out["control"].pop("pairs")
    out["forbidden"] = spec.forbidden_modules()
    return out


class MeshSubsteps:
    """The parent's side: one launch of the ranks does the whole run."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, dev, clock, tmpdir: str):
        self.cfg, self.traffic, self.seed, self.dev, self.clock = cfg, traffic, seed, dev, clock
        self.tmpdir = tmpdir
        self.control = False
        self.ranks = None

    def setup(self):
        pass

    def window(self, seconds: float) -> dict:
        from libclsph_tpu_torch.parallel import mesh

        world = self.cfg["mesh"]["ranks"]
        self.ranks = mesh.launch(rank_body, world, device=self.dev.type, args=(
            self.cfg, self.traffic, self.seed, seconds, self.clock.on, self.control,
            self.tmpdir), log=lambda msg: print(msg, file=sys.stderr, flush=True))
        r0 = self.ranks[0]
        return dict(start=r0["start"], elapsed=max(r["elapsed"] for r in self.ranks),
                    replays=r0["replays"], failed=max(r["failed"] for r in self.ranks),
                    work=r0["work"], substeps=r0["substeps"],
                    collective_bytes=r0["collective_bytes"],
                    forbidden=sorted({m for r in self.ranks for m in r["forbidden"]}))

    def trace(self, tmpdir: str) -> dict:
        return dict(trace=self.ranks[0]["trace"], trace_substeps=self.ranks[0]["trace_substeps"])

    def peak(self) -> int:
        return max(r["peak"] for r in self.ranks)

    def release(self):
        pass

    def cleanup(self):
        pass

    def judge(self, obj_path: str, prm, control: bool = False) -> tuple:
        r0 = self.ranks[0]
        return (r0["control"] if control else r0["numbers"]), r0["pairs"]
