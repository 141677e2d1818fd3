"""The SPH substep and the frame loop on one device.

PyTorch counterpart of ``libclsph_tpu/engine/step.py`` at the shipped
main path (the shape ``bench.py`` and the CLI run): Morton blocks of
128 particles, the exact refine to 16-particle candidate subblocks,
the density kernel's hit counts per (32-row query subgroup, 8-particle
half-slot), the force kernel over the compacted 8-wide hit lists, a
re-sort and candidate rebuild every 4th substep with a 0.25 h slack,
and the adaptive time step with its retry. Every other variant of the
JAX package's ``StepConfig`` is refused with the ROADMAP item that will
port it.

PyTorch runs eagerly, so the loops are Python loops: the dt retry
condition, the frame's time left and the predictive staleness check
are read back to the host once per substep.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import morton
from ..core.params import SimulationParameters
from ..core.state import ParticleState
from ..ops import collisions as collisions_ops
from ..ops import grid as grid_ops
from ..ops import integrate as integrate_ops
from ..ops import interactions as interactions_ops
from ..ops import tiles as tiles_ops
from ..ops.kernels import density_c16_hit8, force_pack, forces_q32_c8, pos_pack

# Bits of the substep's status flag (int32), as in the JAX package:
FLAG_CAPACITY = 1  # block-level candidate capacity (max_candidates)
FLAG_GRID_DIM = 2  # a grid axis reached the 10-bit Morton limit (1024)
FLAG_EXCHANGE = 4  # multi-device exchange reach (not used on one device)
FLAG_CAPACITY_SUB = 8  # refined subblock capacity (max_candidates_sub)
FLAG_CAPACITY_HIT = 16  # hit-compacted force capacity (max_candidates_hit8)
FLAG_CAPACITY_T2 = 32  # two-tier overflow pool (not ported yet)
FLAG_CAND_STALE = 64  # reused candidate lists outran their slack margin
FLAGS_ALL_CAPACITY = (
    FLAG_CAPACITY | FLAG_CAPACITY_SUB | FLAG_CAPACITY_HIT | FLAG_CAPACITY_T2
)

BLOCK = 128  # particles per Morton block (= density/force query rows)
SUB16 = 16  # particles per refined candidate subblock
GROUPS = 4  # 32-row query subgroups per block


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Knobs of the main-path substep; the defaults ARE the main path
    (``bench.py:184-226``). The first ten fields select the variant and
    accept only the main path's value."""

    neighbor_impl: str = "pallas"
    pallas_variant: str = "nl"
    block_size: int = 128
    nl_query_rows: int = 128
    force_query_rows: int = 32
    density_sub16: bool = True
    force_sub16: bool = True
    force_sub8: bool = True
    tier2_frac: int = 0
    density_gate: bool = False
    # block-level candidate cap (the engine doubles it on overflow)
    max_candidates: int = 96
    # refined 16-particle subblock cap per query block (doubled on overflow)
    max_candidates_sub: int = 192
    # 8-particle hit runs per query subgroup (+32 on overflow)
    max_candidates_hit8: int = 80
    # re-sort every k-th substep; rebuild the candidate tables every
    # k-th substep (reused in between, guarded by the staleness check)
    sort_interval: int = 4
    cand_interval: int = 4
    cand_slack: float = 0.25  # refine dilation for reuse, fraction of h
    adaptive_dt: bool = True
    substeps_per_dispatch: int = 64  # substeps per frame-loop call

    def __post_init__(self):
        not_yet = {
            "neighbor_impl": (
                "pallas",
                "ROADMAP.md queue 1 items 5 ('exact') and 12 ('tiles')",
            ),
            "pallas_variant": (
                "nl",
                "ROADMAP.md queue 2 items 7 ('asm'), 8 ('row', 'fine') and 9 ('asym')",
            ),
            "block_size": (128, "ROADMAP.md queue 1 item 12 (other block shapes)"),
            "nl_query_rows": (128, "ROADMAP.md queue 1 item 12 (finer query blocks)"),
            "force_query_rows": (32, "ROADMAP.md queue 2 item 5 (whole-block force pass)"),
            "density_sub16": (True, "ROADMAP.md queue 1 item 12 (32-wide tables)"),
            "force_sub16": (True, "ROADMAP.md queue 2 item 4 (q-granular force pass)"),
            "force_sub8": (True, "ROADMAP.md queue 2 item 3 (16-wide force pass)"),
            "tier2_frac": (0, "ROADMAP.md queue 1 item 12 (two-tier routing)"),
            "density_gate": (False, "ROADMAP.md queue 2 item 6 (gated density)"),
        }
        for name, (value, item) in not_yet.items():
            if getattr(self, name) != value:
                raise ValueError(
                    f"StepConfig.{name}={getattr(self, name)!r} is not ported yet: "
                    f"the port runs only the main path ({name}={value!r}); see {item}"
                )
        if self.sort_interval < 1 or self.cand_interval < 1:
            raise ValueError("sort_interval and cand_interval must be >= 1")
        if self.cand_interval > 1 and self.sort_interval % self.cand_interval:
            raise ValueError(
                "sort_interval must be a multiple of cand_interval "
                "(re-sorts must coincide with candidate rebuilds)"
            )


def build_candidates(state: ParticleState, real: torch.Tensor,
                     params: SimulationParameters, config: StepConfig):
    """Block search and exact refine to 16-particle subblocks over the
    padded, sorted state (step.py:434-495), at (1 + cand_slack) h when
    the tables will be reused. Returns (cand_sub (nb, cap) int32,
    count_sub (nb,) int32, flags)."""
    nb = state.n // BLOCK
    sub = BLOCK // SUB16
    reuse_on = config.cand_interval > 1
    h_search = params.h * (1.0 + config.cand_slack) if reuse_on else params.h
    pos_b = state.position.reshape(nb, BLOCK, 3)
    real_b = real.reshape(nb, BLOCK)
    bmin, bmax = tiles_ops.split_block_bounds(pos_b, real_b)
    cand, count, ovf = tiles_ops.candidate_blocks_auto(
        bmin, bmax, h_search, config.max_candidates
    )
    self_lo = torch.arange(nb, dtype=torch.int32, device=state.device) * sub
    cand_sub, count_sub, ovf2 = tiles_ops.refine_candidates_exact(
        cand, count, bmin, bmax, pos_b, h_search, sub,
        config.max_candidates_sub, self_lo=self_lo, self_width=sub,
    )
    flags = ovf.to(torch.int32) * FLAG_CAPACITY + ovf2.to(torch.int32) * FLAG_CAPACITY_SUB
    return cand_sub, count_sub, flags


def hit_lists(cand_sub: torch.Tensor, hits: torch.Tensor, config: StepConfig):
    """16-granular ids -> 8-granular half ids [2c, 2c + 1] (slot-aligned
    with the hit columns 2k + e), repeated per query subgroup and
    compacted to the halves with a pair inside the support
    (step.py:623-639). Returns (cand8 (nb*4, cap8), count8, flags)."""
    nb = cand_sub.shape[0]
    sub = BLOCK // SUB16
    sent = tiles_ops.REFINE_SENTINEL
    dead = cand_sub == sent
    twice = torch.where(dead, sent, cand_sub * 2)
    ids8 = torch.stack([twice, torch.where(dead, sent, twice + 1)], dim=-1)
    ids8 = ids8.reshape(nb, -1)
    self_lo = torch.arange(nb, dtype=torch.int32, device=cand_sub.device) * sub
    cand8, count8, ovf = tiles_ops.compact_hits(
        torch.repeat_interleave(ids8, GROUPS, dim=0),
        hits[:, : ids8.shape[1]],
        config.max_candidates_hit8,
        self_lo=torch.repeat_interleave(self_lo * 2, GROUPS),
        self_width=2 * sub,
    )
    return cand8.contiguous(), count8, ovf.to(torch.int32) * FLAG_CAPACITY_HIT


def _density_forces(state: ParticleState, real: torch.Tensor,
                    params: SimulationParameters, config: StepConfig, cand_in=None):
    """Candidate tables (built, or carried in ``cand_in``), the density
    kernel, hit compaction, Tait pressure and the force kernel
    (step.py:360-735 at the main-path shape).
    Returns (density, pressure, accel, flags, cand_out)."""
    if cand_in is None:
        cand_sub, count_sub, flags = build_candidates(state, real, params, config)
        pos_anchor = state.position
    else:
        # carried lists were built against pos_anchor at (1 + slack) h: a
        # pair can close by at most twice the largest displacement since
        cand_sub, count_sub, pos_anchor = cand_in
        d2 = torch.sum((state.position - pos_anchor) ** 2, dim=1)
        d2max = torch.amax(torch.where(real, d2, 0.0))
        stale = 4.0 * d2max > (config.cand_slack * params.h) ** 2
        flags = stale.to(torch.int32) * FLAG_CAND_STALE

    density, hits = density_c16_hit8(
        pos_pack(state.position, real), cand_sub.contiguous(), count_sub.contiguous(),
        params,
    )
    cand8, count8, hit_flags = hit_lists(cand_sub, hits, config)
    flags = flags + hit_flags
    cand_out = (cand_sub, count_sub, pos_anchor) if config.cand_interval > 1 else None

    pressure = interactions_ops.tait_pressure(density, params)
    pressure = torch.where(real, pressure, 0.0)
    f8 = force_pack(state.position, state.velocity, density, pressure, real,
                    params.particle_mass)
    accel = forces_q32_c8(f8, density, real, cand8, count8, params)
    return density, pressure, accel, flags, cand_out


def _advect_collide(state: ParticleState, scene, dt, params: SimulationParameters):
    """advection_collision (sphb.cl:177-223): leapfrog, DF response,
    half-step velocity reconstruction."""
    adv = integrate_ops.advect(
        state.position, state.intermediate_velocity, state.acceleration, dt
    )
    resp = collisions_ops.handle_collisions(
        scene, adv.old_position, adv.new_position, adv.next_velocity,
        params.restitution, dt,
    )
    velocity, intermediate = integrate_ops.reconstruct_velocities(
        state.intermediate_velocity, resp.next_velocity
    )
    return state.replace(
        position=resp.position, velocity=velocity, intermediate_velocity=intermediate
    )


def pad_and_sort(state: ParticleState, params: SimulationParameters, do_sort: bool):
    """Grid bounds and Morton codes, sentinel padding to whole blocks
    (and superblocks), and the stable sort by code when ``do_sort``
    (step.py:1099-1168). Returns (padded state, real mask, grid_bad)."""
    n = params.particles_count
    dev = state.device
    grid = grid_ops.compute_bounds(state.position, params)
    codes = grid_ops.locate_in_grid(state.position, grid)
    grid_bad = torch.any(grid.grid_size >= morton.MAX_GRID_DIM)

    # sentinels sit far away and sort last
    npad = tiles_ops.padded_count(n, BLOCK)
    pad = npad - n
    if pad:
        far = grid.max_point + 1000.0 * params.h
        state = state.map(
            lambda a: torch.cat([a, torch.zeros((pad,) + a.shape[1:], dtype=a.dtype,
                                                device=dev)])
        )
        position = state.position.clone()
        position[n:] = far
        state = state.replace(position=position)
        codes = torch.cat([
            codes, torch.full((pad,), tiles_ops.SENTINEL_CODE, dtype=torch.int32,
                              device=dev),
        ])

    if do_sort:
        # permute only what the rest of the substep reads; density,
        # pressure and acceleration are recomputed from scratch
        sorted_codes, order = grid_ops.sort_codes(codes)
        state = state.replace(
            position=state.position[order],
            velocity=state.velocity[order],
            intermediate_velocity=state.intermediate_velocity[order],
            grid_index=sorted_codes,
        )
    else:
        state = state.replace(grid_index=codes)
    real = torch.arange(npad, device=dev) < n
    return state, real, grid_bad


def substep(state: ParticleState, dt: torch.Tensor, params: SimulationParameters,
            scene: Optional[collisions_ops.DeviceScene], config: StepConfig,
            do_sort: bool = True, cand_in=None):
    """One SPH substep. Returns (new_state, dt_next, flags, cand_out).

    ``dt`` and ``dt_next`` are 0-d float32 device tensors and ``flags``
    a 0-d int32 device tensor with the FLAG_* bits. ``cand_out`` is the
    carried candidate state when ``config.cand_interval > 1`` (pass it
    back as ``cand_in`` on reuse substeps, which must not sort), else
    None. The input state is not modified. Like the reference, the
    returned state is in Morton-sorted order; ``grid_index`` holds the
    codes.
    """
    n = params.particles_count
    if cand_in is not None and do_sort:
        raise ValueError(
            "candidate reuse substeps must skip the sort (do_sort=False): "
            "the carried ids index the sorted order"
        )
    state, real, grid_bad = pad_and_sort(state, params, do_sort)
    density, pressure, accel, cap_flags, cand_out = _density_forces(
        state, real, params, config, cand_in=cand_in
    )
    state = state.replace(density=density, pressure=pressure, acceleration=accel)
    state = state.map(lambda a: a[:n])  # drop the sentinel tail

    # adaptive dt with retry (sph_simulation.cpp:246-262)
    def advance(dt_try):
        new_state = _advect_collide(state, scene, dt_try, params)
        dt_next = integrate_ops.compute_time_step(
            new_state.velocity, new_state.acceleration, params
        )
        return new_state, dt_next

    new_state, dt_out = advance(dt)
    if config.adaptive_dt:
        dt_used = dt
        while bool(dt_used - dt_out > integrate_ops.DT_RETRY_EPS):
            dt_used = dt_out
            new_state, dt_out = advance(dt_used)

    flags = cap_flags + grid_bad.to(torch.int32) * FLAG_GRID_DIM
    return new_state, dt_out, flags, cand_out


def frame(state: ParticleState, dt: torch.Tensor, timeleft: torch.Tensor,
          params: SimulationParameters, scene, config: StepConfig):
    """A frame's substep loop (sph_simulation.cpp:384-409; frame_jit,
    step.py:1245-1376): runs until the frame's time is spent or
    ``config.substeps_per_dispatch`` substeps ran, clamping dt to the
    time left. Substep n re-sorts when n % sort_interval == 0 and
    rebuilds the candidate tables when n % cand_interval == 0 or when
    the displacement since the carried anchor already exceeds the
    slack (the predictive staleness check); substep 0 always rebuilds.
    Returns (state, dt, timeleft, flags), flags ORed over the substeps.
    """
    interval = config.sort_interval
    ci = config.cand_interval
    slack2 = torch.tensor((config.cand_slack * params.h) ** 2, dtype=torch.float32,
                          device=state.device)
    flags = torch.zeros((), dtype=torch.int32, device=state.device)
    tables = None
    for n in range(config.substeps_per_dispatch):
        if not bool(timeleft > 0.0):
            break
        do_sort = n % interval == 0
        rebuild = tables is None or n % ci == 0
        if not rebuild:
            d2 = torch.sum((state.position - tables[2][: state.n]) ** 2, dim=1)
            rebuild = bool(4.0 * torch.amax(d2) > slack2)
        if rebuild:
            state, dt_next, step_flags, tables = substep(
                state, dt, params, scene, config, do_sort=do_sort
            )
        else:
            state, dt_next, step_flags, _ = substep(
                state, dt, params, scene, config, do_sort=False, cand_in=tables
            )
        timeleft = timeleft - dt_next
        dt = torch.where(timeleft < dt_next, timeleft, dt_next)
        flags = flags | step_flags
    return state, dt, timeleft, flags
