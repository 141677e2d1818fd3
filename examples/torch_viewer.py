"""Interactive live viewer on the PyTorch port: the reference's OpenGL
example on the GPU (the JAX package's examples/viewer.py).

``example/opengl.cpp:41-171`` opens a GLFW window, installs a
``pre_frame`` callback that uploads the particle buffer as a VBO, and
draws density-coloured points with a rotating camera
(shaders/vert.glsl). This is the same architecture on the port's engine:
an interactive window (pygame/SDL, optional), the export's density colour
ramp, a rotating orbit camera, and the rasterisation on the particles'
device by default (``io/render.py`` through the engine's ``device_view``
hook): the host receives pixels, not particles, so a 1M-particle live
view copies about 1.9 MB a frame instead of 12 MB and a NumPy
projection. ``--host-render`` keeps the software path (pre_frame hook
and NumPy splatting) for comparison.

Controls: drag = orbit camera, wheel / +,- = zoom, space = pause,
r = toggle auto-rotate, q/ESC = quit.

Headless (no display, or no pygame): pass ``--headless`` (or let SDL
fail) and the same renderer writes ``view_frames/frameNNNN.png`` with a
standard-library PNG writer instead.

    python examples/torch_viewer.py [--n 8192] [--scene cube.obj] [--headless]
        [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libclsph_tpu_torch.core.params import derive_parameters  # noqa: E402
from libclsph_tpu_torch.engine.simulation import SPHSimulation  # noqa: E402
from libclsph_tpu_torch.engine.step import StepConfig  # noqa: E402
from libclsph_tpu_torch.io.geo_format import density_color_ramp  # noqa: E402
from libclsph_tpu_torch.io.render import render_points as render_device  # noqa: E402
from libclsph_tpu_torch.io.render import write_png  # noqa: E402
from libclsph_tpu_torch.models.presets import WATER, simulation_config  # noqa: E402

W, H = 900, 700


def render_points(pos, colors, yaw, pitch, zoom, center):
    """Software point renderer: orbit camera, perspective projection,
    far-to-near painter's order, 2x2 splats. Returns (H, W, 3) uint8."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    p = pos - center
    # yaw about y, pitch about x
    x = cy * p[:, 0] + sy * p[:, 2]
    z0 = -sy * p[:, 0] + cy * p[:, 2]
    y = cp * p[:, 1] - sp * z0
    z = sp * p[:, 1] + cp * z0
    z = z + zoom  # camera distance
    vis = z > 0.05
    f = 0.9 * H
    xi = (f * x / z + W / 2).astype(np.int32)
    yi = (H / 2 - f * y / z).astype(np.int32)
    ok = vis & (xi >= 0) & (xi < W - 1) & (yi >= 0) & (yi < H - 1)
    order = np.argsort(-z[ok])  # far first; near points overwrite
    xi, yi = xi[ok][order], yi[ok][order]
    rgb = (np.clip(colors[ok][order], 0.0, 1.0) * 255).astype(np.uint8)
    fb = np.zeros((H, W, 3), np.uint8)
    fb[:, :, :] = (18, 18, 24)
    for dy in (0, 1):
        for dx in (0, 1):
            fb[yi + dy, xi + dx] = rgb
    return fb


def main(argv=None):
    """Run the viewer; returns the number of frames shown or written."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--scene", default="labyrinth.obj")
    ap.add_argument("--time", type=float, default=2.0)
    ap.add_argument("--headless", action="store_true")
    ap.add_argument("--out", default="view_frames")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    ap.add_argument(
        "--host-render", action="store_true",
        help="NumPy software rasteriser via the pre_frame hook "
        "(default: on-device rendering via device_view)",
    )
    args = ap.parse_args(argv)

    screen = None
    pygame = None
    if not args.headless:
        try:
            import pygame as _pygame

            pygame = _pygame
            pygame.init()
            screen = pygame.display.set_mode((W, H))
            pygame.display.set_caption("libclsph-tpu live view (PyTorch port)")
        except Exception as ex:  # no display: degrade to PNG frames
            print(f"no interactive display ({ex}); writing PNGs", file=sys.stderr)
            screen = None
    if screen is None:
        os.makedirs(args.out, exist_ok=True)

    sim = SPHSimulation(step_config=StepConfig(), device=args.device)
    sim.parameters = derive_parameters(
        dict(WATER),
        simulation_config(particles_count=args.n, simulation_time=args.time),
    )
    sim.precomputed_terms = sim.parameters.precomputed()
    sim.initial_volume = sim.parameters.initial_volume
    sim.load_scene(
        args.scene,
        scenes_dir=os.path.join(os.path.dirname(__file__), "..", "scenes"),
    )

    view = dict(yaw=0.6, pitch=0.35, zoom=3.0, auto=True, frame=0, drag=None)

    def present(fb):
        i = view["frame"]
        view["frame"] += 1
        if screen is None:
            write_png(os.path.join(args.out, f"frame{i:04d}.png"), fb)
            return False

        pygame.surfarray.blit_array(screen, fb.swapaxes(0, 1))
        pygame.display.flip()
        paused = True
        while paused:
            paused = False
            for ev in pygame.event.get():
                if ev.type == pygame.QUIT:
                    raise SystemExit(0)
                if ev.type == pygame.KEYDOWN:
                    if ev.key in (pygame.K_q, pygame.K_ESCAPE):
                        raise SystemExit(0)
                    if ev.key == pygame.K_SPACE:
                        view["auto"] = False
                        paused = not paused
                    if ev.key == pygame.K_r:
                        view["auto"] = not view["auto"]
                    if ev.key in (pygame.K_PLUS, pygame.K_EQUALS):
                        view["zoom"] = max(0.3, view["zoom"] * 0.9)
                    if ev.key == pygame.K_MINUS:
                        view["zoom"] *= 1.1
                if ev.type == pygame.MOUSEBUTTONDOWN and ev.button == 1:
                    view["drag"] = ev.pos
                if ev.type == pygame.MOUSEBUTTONUP and ev.button == 1:
                    view["drag"] = None
                if ev.type == pygame.MOUSEMOTION and view["drag"]:
                    dx = ev.pos[0] - view["drag"][0]
                    dy = ev.pos[1] - view["drag"][1]
                    view["drag"] = ev.pos
                    view["yaw"] += dx * 0.01
                    view["pitch"] = np.clip(
                        view["pitch"] + dy * 0.01, -1.4, 1.4
                    )
                    view["auto"] = False
                if ev.type == pygame.MOUSEWHEEL:
                    view["zoom"] *= 0.9 if ev.y > 0 else 1.1

    def show(arrays, params, is_full_frame):
        # host path: the reference's pre_frame architecture verbatim —
        # fetch particles, project in NumPy (opengl.cpp:105-160)
        pos = arrays["position"]
        colors = density_color_ramp(arrays["density"])
        center = pos.mean(axis=0)
        if view["auto"]:
            view["yaw"] += 0.02  # rotating camera (opengl.cpp:108-117)
        present(render_points(
            pos, colors, view["yaw"], view["pitch"], view["zoom"], center
        ))
        return False  # particles not modified

    if args.host_render:
        sim.pre_frame = show
    else:
        # device path: rasterise on the particles' device, fetch pixels only
        def device_show(state, params, is_full_frame):
            if view["auto"]:
                view["yaw"] += 0.02
            pos = state.position
            real = torch.abs(pos[:, 0]) < 1.0e30  # sentinel rows sit far
            cnt = torch.clamp(real.sum(), min=1)
            center = torch.where(real[:, None], pos, 0.0).sum(dim=0) / cnt
            fb = render_device(pos, state.density, np.float32(view["yaw"]),
                               np.float32(view["pitch"]), np.float32(view["zoom"]),
                               center, width=W, height=H).cpu().numpy()
            present(fb)

        sim.device_view = device_show
    try:
        sim.simulate()
    except SystemExit:
        pass
    if screen is None:
        print(f"wrote {view['frame']} frames to {args.out}/")
    return view["frame"]


if __name__ == "__main__":
    main()
