"""Emitter example on the PyTorch port: interactive fluid editing through
the pre_frame hook (the JAX package's examples/emitter.py).

The reference documents that a pre_frame callback returning true writes
the edited particle array back to the device (sph_simulation.cpp:
730-748), which makes it an editing hook: emitters and drains live in
user code. This shower head recycles the particles that fell below the
box back to a nozzle above it each frame.

    python examples/torch_emitter.py [--device cuda|cpu] [--n 2048] [--time 0.25]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from libclsph_tpu_torch.core.params import derive_parameters  # noqa: E402
from libclsph_tpu_torch.engine.simulation import SPHSimulation  # noqa: E402
from libclsph_tpu_torch.engine.step import StepConfig  # noqa: E402
from libclsph_tpu_torch.models.presets import WATER, simulation_config  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--time", type=float, default=0.25, help="simulated seconds")
    args = ap.parse_args(argv)

    sim = SPHSimulation(step_config=StepConfig(), device=args.device)
    sim.parameters = derive_parameters(
        dict(WATER), simulation_config(particles_count=args.n, simulation_time=args.time))
    sim.precomputed_terms = sim.parameters.precomputed()
    sim.initial_volume = sim.parameters.initial_volume
    sim.load_scene("box.obj",
                   scenes_dir=os.path.join(os.path.dirname(__file__), "..", "scenes"))

    rng = np.random.default_rng(0)
    recycled = [0]

    def emitter(arrays, params, is_full_frame):
        pos, vel = arrays["position"], arrays["velocity"]
        # particles that fell past the recycling plane go back up to the
        # nozzle with a downward jet velocity, at most 64 a frame
        idx = np.where(pos[:, 1] < -0.2)[0][:64]
        if len(idx) == 0:
            return False
        pos[idx] = rng.normal([0.0, 2.0, 0.0], [0.05, 0.02, 0.05], (len(idx), 3))
        vel[idx] = [0.0, -2.0, 0.0]
        arrays["intermediate_velocity"][idx] = vel[idx]
        recycled[0] += len(idx)
        return True  # write the edits back to the device

    sim.pre_frame = emitter
    sim.simulate()
    print(f"recycled {recycled[0]} particles through the emitter")
    return recycled[0]


if __name__ == "__main__":
    main()
