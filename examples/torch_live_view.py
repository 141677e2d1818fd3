"""Live-view example on the PyTorch port: the reference's OpenGL viewer
as a client callback, headless (the JAX package's examples/live_view.py).

The reference's ``example/opengl.cpp`` installs a ``pre_frame`` callback
that uploads the freshly read particle buffer into a VBO and draws
density-coloured points each frame (opengl.cpp:105-160,
shaders/vert.glsl). Rendering is a client callback, not an engine
feature. This example installs the same hook on the port's engine: the
callback renders each frame's host copy of the particles with the port's
point renderer (``io/render.py``, here on the host arrays) and writes a
PNG with a standard-library writer, while the device computes the next
frame. Swap the renderer for anything interactive.

    python examples/torch_live_view.py [out_dir] [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from libclsph_tpu_torch.core.params import derive_parameters  # noqa: E402
from libclsph_tpu_torch.engine.simulation import SPHSimulation  # noqa: E402
from libclsph_tpu_torch.engine.step import StepConfig  # noqa: E402
from libclsph_tpu_torch.io.render import PointRenderer, write_png  # noqa: E402
from libclsph_tpu_torch.models.presets import WATER, simulation_config  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", nargs="?", default="live_frames")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--time", type=float, default=0.5, help="simulated seconds")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    sim = SPHSimulation(step_config=StepConfig(), device=args.device)
    sim.parameters = derive_parameters(
        dict(WATER), simulation_config(particles_count=args.n, simulation_time=args.time))
    sim.precomputed_terms = sim.parameters.precomputed()
    sim.initial_volume = sim.parameters.initial_volume
    sim.load_scene("cube.obj", scenes_dir=os.path.join(
        os.path.dirname(__file__), "..", "scenes"))

    renderer = PointRenderer(width=400, height=400)
    frame = [0]

    def render(arrays, params, is_full_frame):
        path = os.path.join(args.out_dir, f"frame{frame[0]:04d}.png")
        write_png(path, renderer.render(arrays["position"], arrays["density"]))
        frame[0] += 1
        return False  # particles not modified

    sim.pre_frame = render
    sim.simulate()
    print(f"wrote {frame[0]} rendered frames to {args.out_dir}/")
    return frame[0]


if __name__ == "__main__":
    main()
