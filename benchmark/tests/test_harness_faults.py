"""The comparison fails what it must: the control (the reference in TF32
in the program's place) and, with the timed path broken underneath a
whole run, each fault that a cell can have."""

import pytest
import torch

from benchmark import harness
from conftest import MESH_CELL, cpu_run


def _alter(kind, before, after):
    n = after.n
    if kind == "unchanged":  # a step that returns its state unchanged
        return before.map(lambda a: a[:n])
    if kind == "half":  # half of the particles left out of the step
        keep = before.map(lambda a: a[:n])
        return after.map(lambda a: a.clone()).replace(
            position=torch.cat([after.position[: n // 2], keep.position[n // 2:]]),
            velocity=torch.cat([after.velocity[: n // 2], keep.velocity[n // 2:]]))
    density = after.density.clone()  # an answer altered where it is produced
    density[n // 3] *= 1.5
    return after.replace(density=density)


def _broken(monkeypatch, kind, export=False):
    """Break the substep (with ``export``: the frame's export) once the
    set-up is done, for the window and after it."""
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.io.houdini import HoudiniFileSaver

    orig = step.substep
    write = HoudiniFileSaver.write_frame_to_file

    def write_altered(self, arrays, params):
        arrays = dict(arrays, position=arrays["position"].copy())
        arrays["position"][len(arrays["position"]) // 3, 1] += 1e-3
        return write(self, arrays, params)

    def substep(state, dt, params, scene, config, do_sort=True, cand_in=None,
                speculative=False):
        out = orig(state, dt, params, scene, config, do_sort=do_sort, cand_in=cand_in,
                   speculative=speculative)
        new = _alter(kind, state, out[0])
        if not speculative:
            return (new,) + tuple(out[1:])

        def finish(retry=None):
            st, dt_out = out[5](retry)
            return _alter(kind, state, st), dt_out

        return (new,) + tuple(out[1:5]) + (finish,)

    for cls in (harness.Substeps, harness.Frames):
        def window(self, seconds, _orig=cls.window):
            if export:
                monkeypatch.setattr(HoudiniFileSaver, "write_frame_to_file", write_altered)
            else:
                monkeypatch.setattr(step, "substep", substep)
            return _orig(self, seconds)

        monkeypatch.setattr(cls, "window", window)


@pytest.mark.parametrize("workload", ["dambreak_64k.substeps", "dambreak_64k.frames_geo"])
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_fault_is_not_correct(small, monkeypatch, workload, kind):
    """In the frame cell the answer is the exported frame: there an
    answer is altered in the file as it is written."""
    _broken(monkeypatch, kind, export=kind == "altered" and "frames" in workload)
    result, _ = cpu_run(workload)
    assert result["correct"] is False


@pytest.mark.parametrize("workload", ["dambreak_64k.substeps", "dambreak_64k.frames_geo"])
def test_control_is_not_correct(small, workload):
    """The reference computed in TF32 in the program's place fails one of
    the cell's numbers."""
    from benchmark import spec

    bench = spec.benchmark()
    cell = spec.cell(bench, workload)
    cfg, traffic = spec.config(bench, cell["config"]), spec.traffic(cell["traffic"])
    dev = torch.device("cpu")
    tmp = harness.new_tmpdir()
    entry = harness.make_entry(cfg, traffic, 2_200_000_003, dev, harness.Clock(False), tmp)
    entry.setup()
    entry.window(0.1)
    entry.release()
    prm = harness.params_of(cfg)
    sound = entry.judge(harness.scene_path(cfg), prm)[0]
    control = entry.judge(harness.scene_path(cfg), prm, control=True)[0]
    entry.cleanup()
    limits = spec.limits(workload)
    assert all(sound[k] <= v for k, v in limits.items())
    assert any(control[k] > v for k, v in limits.items())
    if "frames" in workload:  # the exports written at one digit fewer
        assert control["export_pv_rel"] > limits["export_pv_rel"]


@pytest.mark.parametrize("workload", ["dambreak_1m.substeps", "dambreak_64k.substeps"])
def test_dropped_shell_is_not_correct(small, workload):
    """A neighbour search that loses the pairs in the outer 7 % of the
    support (the reference with those pairs left out, in the program's
    place) fails one of the cell's numbers: on the cube's lattice, the
    acceleration."""
    from benchmark import judge, spec

    bench = spec.benchmark()
    cell = spec.cell(bench, workload)
    cfg, traffic = spec.config(bench, cell["config"]), spec.traffic(cell["traffic"])
    tmp = harness.new_tmpdir()
    entry = harness.make_entry(cfg, traffic, 2_200_000_007, torch.device("cpu"),
                               harness.Clock(False), tmp)
    entry.setup()
    entry.window(0.1)
    entry.release()
    prm = harness.params_of(cfg)
    shell = entry.judge(harness.scene_path(cfg), prm, shell=True)[0]
    assert judge.SHELL_CUT < 1.0
    assert any(shell[k] > v for k, v in spec.limits(workload).items())


# ---- the mesh: the faults are planted inside the ranks ---------------------


def _faulty_rank_body(kind, mesh, *args):
    """:func:`benchmark.mesh.rank_body` with ``kind`` planted once the
    window starts (the first ``reset_stats`` of the rank's mesh)."""
    from libclsph_tpu_torch.parallel import sharded_step

    from benchmark import mesh as bench_mesh

    live = []
    reset = type(mesh).reset_stats

    def reset_stats(self):
        live.append(True)
        reset(self)

    type(mesh).reset_stats = reset_stats
    if kind == "exchange":  # the exchange between ranks left out
        orig = sharded_step.exchange_tables

        def exchange_tables(m, *a, **k):
            if not live:
                return orig(m, *a, **k)
            gather = m.all_gather_many

            def own_only(tensors):
                out = gather(tensors)
                rows = [t.shape[0] // m.world for t in out]
                masked = []
                for t, r in zip(out, rows):
                    t = t.clone()
                    for q in range(m.world):
                        if q != m.rank:
                            t[q * r:(q + 1) * r] = 1e30
                    masked.append(t)
                return masked

            m.all_gather_many = own_only
            try:
                return orig(m, *a, **k)
            finally:
                del m.all_gather_many

        sharded_step.exchange_tables = exchange_tables
    else:
        orig = sharded_step.local_substep

        def local_substep(m, state, *a, **k):
            out = orig(m, state, *a, **k)
            if not live:
                return out
            new = _alter(kind, state, out[0])

            def finish(retry=None):
                st, dt_out = out[5](retry)
                return _alter(kind, state, st), dt_out

            return (new,) + tuple(out[1:5]) + (finish,)

        sharded_step.local_substep = local_substep
    return bench_mesh.rank_body(mesh, *args)


@pytest.mark.parametrize("kind", ["exchange", "unchanged", "half", "altered"])
def test_mesh_fault_is_not_correct(mesh_cell, monkeypatch, kind):
    import functools

    from benchmark import mesh as bench_mesh

    monkeypatch.setattr(bench_mesh, "rank_body", functools.partial(_faulty_rank_body, kind))
    result, _ = cpu_run(MESH_CELL)
    assert result["correct"] is False
