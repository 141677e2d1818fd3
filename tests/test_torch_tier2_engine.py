"""Both 16-wide force shapes run end to end: the engine runs the tiny
cube on the CPU on the (True, True, False) and (False, True, False)
tables and writes its frames, with no downgrade.
"""

import numpy as np
import pytest

from libclsph_tpu_torch.engine import simulation as tsim
from libclsph_tpu_torch.engine import step as tstep
from test_torch_tier2 import _tiny_root
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("tables", [(True, True, False), (False, True, False)])
def test_step_config_refuses_16_wide_force_pass(tables, tmp_path):
    """Both 16-wide force shapes are ported: the engine runs the tiny cube
    on the CPU on them and writes its frames."""
    keys = ("density_sub16", "force_sub16", "force_sub8")
    cfg = tstep.StepConfig(**dict(zip(keys, tables)))
    root = _tiny_root(tmp_path)
    sim = tsim.SPHSimulation(cfg, device="cpu", pretune=False)
    sim.checkpoint_path = str(tmp_path / "none.npz")
    sim.load_settings(str(root / "fluid_properties" / "water.json"),
                      str(root / "simulation_properties" / "tiny.json"))
    sim.load_scene("cube.obj", scenes_dir=str(root / "scenes"))
    frames = []
    sim.save_frame = lambda arrays, params: frames.append(arrays["position"])
    sim.simulate()
    assert sim.step_config == cfg  # no downgrade: the 16-wide tables ran
    assert len(frames) == 4 and np.isfinite(frames[-1]).all()
    assert frames[-1][:, 1].min() > -1.6
