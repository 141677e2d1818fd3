"""Headless CLI of the PyTorch port — the reference's
example/particles.cpp as a console entry point (``sph-torch``).

Same four positional arguments and exit codes as
``libclsph_tpu/cli.py`` (particles.cpp:13-16):

    python -m libclsph_tpu_torch.cli <fluid> <sim_properties> <scene> <out_prefix>

resolving ``fluid_properties/<fluid>.json``,
``simulation_properties/<sim>.json`` and ``scenes/<scene>``; it prints
the parameter table, writes Houdini frames (and the checkpoint when the
config asks for it) and times the run. Capacity and cadence defaults
come from :class:`engine.step.StepConfig`. Exit codes: 0 done, -1 bad
configuration or scene, 1 refused checkpoint or failed run.
"""

from __future__ import annotations

import argparse
import os
import sys

from .engine.simulation import SPHSimulation
from .engine.step import StepConfig
from .io.houdini import HoudiniFileSaver

_DEFAULTS = StepConfig()


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="sph-torch",
        description="SPH fluid simulation on one GPU (libclsph-tpu's PyTorch port)",
    )
    ap.add_argument("fluid", help="fluid properties name (fluid_properties/<name>.json)")
    ap.add_argument(
        "simulation", help="simulation properties name (simulation_properties/<name>.json)"
    )
    ap.add_argument("scene", help="scene OBJ name (scenes/<name>[.obj])")
    ap.add_argument("out_prefix", help="frames folder prefix")
    ap.add_argument("--partio", action="store_true", help="write .bgeo instead of .geo")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    ap.add_argument("--max-candidates", type=int, default=_DEFAULTS.max_candidates)
    ap.add_argument("--max-candidates-sub", type=int,
                    default=_DEFAULTS.max_candidates_sub)
    ap.add_argument("--max-candidates-hit8", type=int,
                    default=_DEFAULTS.max_candidates_hit8)
    ap.add_argument("--sort-interval", type=int, default=_DEFAULTS.sort_interval,
                    help="re-sort particles every k-th substep")
    ap.add_argument("--cand-interval", type=int, default=_DEFAULTS.cand_interval,
                    help="rebuild candidate lists every k-th substep "
                    "(must divide --sort-interval)")
    ap.add_argument("--cand-slack", type=float, default=_DEFAULTS.cand_slack,
                    help="candidate-reuse refine dilation as a fraction of h")
    ap.add_argument("--confirm", action="store_true",
                    help="ask for confirmation before simulating (reference behaviour)")
    ap.add_argument("--root", default=".",
                    help="directory holding fluid_properties/ etc.")
    return ap


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    try:
        cfg = StepConfig(
            max_candidates=args.max_candidates,
            max_candidates_sub=args.max_candidates_sub,
            max_candidates_hit8=args.max_candidates_hit8,
            sort_interval=args.sort_interval,
            cand_interval=args.cand_interval,
            cand_slack=args.cand_slack,
        )
        simulation = SPHSimulation(step_config=cfg, device=args.device)
    except (ValueError, RuntimeError) as ex:
        print(ex, file=sys.stderr)
        return -1
    saver = HoudiniFileSaver(args.out_prefix, use_partio=args.partio)

    try:
        simulation.load_settings(
            os.path.join(args.root, "fluid_properties", args.fluid + ".json"),
            os.path.join(args.root, "simulation_properties", args.simulation + ".json"),
        )
    except Exception as ex:  # same failure path as particles.cpp:27-30
        print(ex, file=sys.stderr)
        return -1

    def save_frame(arrays, params):
        saver.write_frame_to_file(arrays, params)

    simulation.save_frame = save_frame

    p = simulation.parameters
    print(
        f"""
Loaded parameters
-----------------
Simulation time:           {p.simulation_time:g}
Target FPS:                {p.target_fps:g}
Simulation scale:          {p.simulation_scale:g}
Write intermediate frames: {'true' if simulation.write_intermediate_frames else 'false'}
Serialize frames:          {'true' if simulation.serialize else 'false'}

Particle count:            {p.particles_count}
Particle mass:             {p.particle_mass:g}
Total mass:                {p.total_mass:g}
Initial volume:            {simulation.initial_volume:g}

Fluid density:             {p.fluid_density:g}
Dynamic viscosity:         {p.dynamic_viscosity:g}
Surface tension threshold: {p.surface_tension_threshold:g}
Surface tension:           {p.surface_tension:g}
Stiffness (k):             {p.K:g}
Restitution:               {p.restitution:g}

Kernel support radius (h): {p.h:g}

Device:                    {simulation.device}
Saving to folder:          {args.out_prefix}frames/"""
    )

    scene_name = args.scene if args.scene.endswith(".obj") else args.scene + ".obj"
    try:
        simulation.load_scene(scene_name, scenes_dir=os.path.join(args.root, "scenes"))
    except Exception as ex:
        print(f"Unable to load scene: {args.scene} ({ex})", file=sys.stderr)
        return -1

    if args.confirm:
        print(
            "\nRevise simulation parameters. Press q to quit, any other "
            "key to proceed with simulation"
        )
        if input().strip().lower() == "q":
            return 0

    try:
        duration = simulation.simulate()
    except RuntimeError as ex:
        # e.g. a stale checkpoint (the reference aborts on a wrong-size
        # last_frame.bin, particles.cpp:89-92)
        print(ex, file=sys.stderr)
        return 1
    print(f"Duration : {duration:g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
