"""``experiments/torch_emitter_run.py``, the round-5 matrix's emitter row
(a shower from ``shower.obj``'s tray onto an obstacle through the
pre_frame write-back), on the CPU at 2,048 particles for 2 frames: every
frame after the first recycles particles, and the JSON record holds the
frames, substeps and rates. The obstacle is ``box.obj``: the row's
``monkey.obj`` takes most of a minute to bake on a CPU. The bake itself
is held to the JAX package's in ``test_torch_core.py``, and
``chip_smoke.py`` phase 11 runs the row onto the monkey on the card."""

import os
import sys
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "experiments"))

import torch_emitter_run  # noqa: E402


def test_emitter_run_recycles_every_frame():
    out = torch_emitter_run.run(n=2048, frames=2, device="cpu", obstacle="box.obj")
    assert out["frames"] == 2 and len(out["recycled_per_frame"]) == 2
    assert all(r > 0 for r in out["recycled_per_frame"][1:])
    assert out["substeps"] == sum(out["substeps_per_frame"]) > 0
    assert out["particle_steps_per_s"] > 0 and out["device"] == "cpu"
    assert len(out["s_per_frame"]) == 2 and out["median_s_per_frame"] > 0
