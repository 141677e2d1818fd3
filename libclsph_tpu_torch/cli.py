"""Headless CLI of the PyTorch port — the reference's
example/particles.cpp as a console entry point (``sph-torch``).

Same four positional arguments and exit codes as
``libclsph_tpu/cli.py`` (particles.cpp:13-16):

    python -m libclsph_tpu_torch.cli <fluid> <sim_properties> <scene> <out_prefix>

resolving ``fluid_properties/<fluid>.json``,
``simulation_properties/<sim>.json`` and ``scenes/<scene>``; it prints
the parameter table, writes Houdini frames (and the checkpoint when the
config asks for it) and times the run. Capacity, table and cadence
defaults come from :class:`engine.step.StepConfig`; a combination the
port does not run exits -1 with ``StepConfig``'s message. As in the JAX
CLI, there is no flag for ``density_gate``: it is a ``StepConfig`` field.
``--import-legacy LAST_FRAME_BIN`` converts a reference-format
``last_frame.bin`` into the checkpoint the run then resumes from.
``--mesh N`` runs the simulation sharded over N ranks
(:mod:`parallel.mesh`), one process each, with ``--exchange``,
``--halo-max`` and ``--halo-hops`` (JAX's ``cli.py:113-127``): on the
card, rank r takes ``cuda:(r % cards)`` (ranks that share a card run
over gloo); with ``--device cpu`` the ranks run over gloo on the CPU. As
in the JAX CLI, the 8-wide force pass is off under the mesh. Rank 0
prints and writes the frames and the checkpoint.
Exit codes: 0 done, -1 bad configuration or scene, 1 refused checkpoint
or failed run.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys

from .engine.simulation import SPHSimulation, configure_device
from .engine.step import BLOCK_SIZES, IMPLS, QUERY_ROWS, TILE_MODES, VARIANTS, StepConfig
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
    ap.add_argument("--neighbor-impl", choices=list(IMPLS), default=_DEFAULTS.neighbor_impl,
                    help="'pallas' (default: the hand kernels), 'tiles' (dense pair "
                    "tiles in plain PyTorch) or 'exact' (the 27-cell gather; needs "
                    "--sort-interval 1)")
    ap.add_argument("--pallas-variant", choices=list(VARIANTS),
                    default=_DEFAULTS.pallas_variant,
                    help="kernel family of the pallas impl: nl (default), asm "
                    "(needs --no-density-sub16), or row/fine/asym (whole "
                    "candidate blocks)")
    ap.add_argument("--tile-mode", choices=list(TILE_MODES), default=_DEFAULTS.tile_mode,
                    help="the tiles impl's r^2: 'direct' (default) or 'mxu' (by the "
                    "identity |q|^2 + |c|^2 - 2 q.c, centred on each query block)")
    ap.add_argument("--block-size", type=int, choices=list(BLOCK_SIZES),
                    default=_DEFAULTS.block_size,
                    help="particles per Morton block (64, 128 or 256)")
    ap.add_argument("--nl-query-rows", type=int, choices=list(QUERY_ROWS),
                    default=_DEFAULTS.nl_query_rows,
                    help="query rows per candidate list of the nl and asm variants "
                    "(finer query blocks below the block size; below 128 the "
                    "16-granular tables are switched off)")
    ap.add_argument("--hit-compact", action=argparse.BooleanOptionalAction,
                    default=_DEFAULTS.hit_compact,
                    help="force pass over the true-hit lists (--no-hit-compact: "
                    "over the full refined lists; needs --no-density-sub16)")
    ap.add_argument("--max-candidates", type=int, default=_DEFAULTS.max_candidates)
    ap.add_argument("--max-candidates-sub", type=int,
                    default=_DEFAULTS.max_candidates_sub)
    ap.add_argument("--max-candidates-hit8", type=int,
                    default=_DEFAULTS.max_candidates_hit8,
                    help="per-subgroup capacity of the 8-wide force pass")
    ap.add_argument("--max-candidates-hit", type=int,
                    default=_DEFAULTS.max_candidates_hit,
                    help="capacity of the q-granular force pass (per block at "
                    "--force-query-rows 128, half of it per subgroup at 32)")
    ap.add_argument("--max-candidates-hit16", type=int,
                    default=_DEFAULTS.max_candidates_hit16,
                    help="per-subgroup capacity of the 16-wide force pass "
                    "(--no-force-sub8 or --no-density-sub16)")
    ap.add_argument("--force-query-rows", type=int, choices=[32, 128],
                    default=_DEFAULTS.force_query_rows,
                    help="query rows per force-pass list (128 needs the 32-wide "
                    "tables: --no-density-sub16)")
    ap.add_argument("--density-sub16", action=argparse.BooleanOptionalAction,
                    default=_DEFAULTS.density_sub16,
                    help="16-wide candidate subblocks (else 32-wide)")
    ap.add_argument("--force-sub16", action=argparse.BooleanOptionalAction,
                    default=_DEFAULTS.force_sub16,
                    help="16-granular force-pass tables")
    ap.add_argument("--force-sub8", action=argparse.BooleanOptionalAction,
                    default=_DEFAULTS.force_sub8,
                    help="8-wide force-pass hit lists (needs --density-sub16); "
                    "--no-force-sub8 runs the 16-wide force pass")
    ap.add_argument("--tier2-frac", type=int, default=_DEFAULTS.tier2_frac,
                    help="two-tier capacity routing: heavy blocks go to "
                    "ceil(blocks / k) tier-2 slots (0 = off)")
    ap.add_argument("--pretune", choices=["auto", "on", "off"], default="auto",
                    help="init-state capacity probe before the first frame; "
                    "auto = on for >= 200k particles")
    ap.add_argument("--sort-interval", type=int, default=_DEFAULTS.sort_interval,
                    help="re-sort particles every k-th substep")
    ap.add_argument("--cand-interval", type=int, default=_DEFAULTS.cand_interval,
                    help="rebuild candidate lists every k-th substep "
                    "(must divide --sort-interval)")
    ap.add_argument("--cand-slack", type=float, default=_DEFAULTS.cand_slack,
                    help="candidate-reuse refine dilation as a fraction of h")
    ap.add_argument("--confirm", action="store_true",
                    help="ask for confirmation before simulating (reference behaviour)")
    ap.add_argument("--import-legacy", metavar="LAST_FRAME_BIN", default=None,
                    help="resume from a reference-format last_frame.bin checkpoint")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run sharded over N ranks, one process each (0: one device)")
    ap.add_argument("--exchange", choices=["all_gather", "halo", "ring"],
                    default="all_gather", help="neighbour exchange between ranks (--mesh)")
    ap.add_argument("--halo-max", type=int, default=0,
                    help="surface blocks a rank sends under halo and ring (0: all)")
    ap.add_argument("--halo-hops", type=int, default=1,
                    help="ring exchange: hops a direction")
    ap.add_argument("--root", default=".",
                    help="directory holding fluid_properties/ etc.")
    return ap


def config_from_args(args) -> StepConfig:
    """The run's ``StepConfig`` after the JAX CLI's quiet clamps
    (cli.py:161, :178-211); raises ValueError on a refused combination."""
    fields = {f.name for f in dataclasses.fields(StepConfig)}
    values = {k: v for k, v in vars(args).items() if k in fields}
    ci, si = values["cand_interval"], values["sort_interval"]
    if ci > 1 and si % ci and args.cand_interval == _DEFAULTS.cand_interval:
        # a pinned --sort-interval with the default --cand-interval: the
        # default comes down to a divisor
        ci = values["cand_interval"] = math.gcd(ci, si)
    if ci > 1 and si % ci:
        raise ValueError("--cand-interval must divide --sort-interval")
    if (values["neighbor_impl"] != "pallas" or values["pallas_variant"] != "nl"
            or values["nl_query_rows"] < values["block_size"]):
        # reuse is a feature of the nl variant at whole-block query rows
        values["cand_interval"] = 1
    if (values["neighbor_impl"] != "pallas"
            or min(values["block_size"], values["nl_query_rows"]) < 128):
        # the 16-granular tables need the pallas nl shape at 128 query rows
        values["density_sub16"] = False
    if not values["density_sub16"] or args.mesh:
        # the 8-wide pass rides the 16-granular tables, on one device
        values["force_sub8"] = False
    return StepConfig(**values)


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    try:
        cfg = config_from_args(args)
        if args.mesh:
            if args.mesh < 1:
                raise ValueError("--mesh must be >= 1")
            device = configure_device(args.device)
        else:
            simulation = SPHSimulation(
                step_config=cfg, device=args.device,
                pretune={"auto": "auto", "on": True, "off": False}[args.pretune],
            )
    except (ValueError, RuntimeError) as ex:
        print(ex, file=sys.stderr)
        return -1
    if args.mesh:
        from .parallel.mesh import launch

        argv = sys.argv[1:] if argv is None else list(argv)
        try:
            # no time limit on the whole run: a hung collective still
            # fails its rank after mesh.COLLECTIVE_TIMEOUT_S
            return launch(_rank_main, args.mesh, args=(argv,), device=device.type,
                          timeout=None)[0]
        except (RuntimeError, TimeoutError) as ex:  # a rank failed: its traceback
            print(ex, file=sys.stderr)
            return 1
    return _run(args, simulation)


def _rank_main(mesh, argv) -> int:
    """A rank of ``sph-torch --mesh N``: the same run on ``mesh``; rank 0
    prints and writes."""
    args = build_arg_parser().parse_args(argv)
    simulation = SPHSimulation(step_config=config_from_args(args), mesh=mesh,
                               exchange=args.exchange, halo_max=args.halo_max,
                               halo_hops=args.halo_hops, pretune=False)
    return _run(args, simulation, mesh.rank == 0)


def _run(args, simulation, root: bool = True) -> int:
    """Load the settings and the scene, print the table, simulate; with
    ``root`` False (a rank other than 0) print and write nothing."""
    def say(*lines):
        if root:
            print(*lines)

    try:
        simulation.load_settings(
            os.path.join(args.root, "fluid_properties", args.fluid + ".json"),
            os.path.join(args.root, "simulation_properties", args.simulation + ".json"),
        )
    except Exception as ex:  # same failure path as particles.cpp:27-30
        print(ex, file=sys.stderr)
        return -1

    if root:
        saver = HoudiniFileSaver(args.out_prefix, use_partio=args.partio)

        def save_frame(arrays, params):
            saver.write_frame_to_file(arrays, params)

        simulation.save_frame = save_frame

    p = simulation.parameters
    say(
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

    if args.import_legacy:
        from .io.checkpoint import save_checkpoint
        from .io.legacy import read_legacy_checkpoint

        try:
            arrays = read_legacy_checkpoint(args.import_legacy, p.particles_count)
        except (OSError, ValueError) as ex:
            print(ex, file=sys.stderr)
            return 1
        if root:
            save_checkpoint(simulation.checkpoint_path, arrays, p)
        if simulation.mesh is not None:
            simulation.mesh.barrier()  # every rank resumes from the imported file
        say(f"Imported legacy checkpoint {args.import_legacy}")

    if args.confirm and simulation.mesh is None:
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
    say(f"Duration : {duration:g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
