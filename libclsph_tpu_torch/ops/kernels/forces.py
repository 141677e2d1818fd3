"""Force passes with the combine fused in: the CUDA kernels, their
plain PyTorch versions and the wrappers that pick between them by
device. Each replaces a ``libclsph_tpu/ops/pallas/neighbor_nl.py``
force kernel together with its ``_combine_forces``:

* :func:`forces_q32_c8`: ``fused_forces_nl32_c8``, 8-particle hit runs
  per 32-row query subgroup (the main path);
* :func:`forces_q32_c16`: ``fused_forces_nl32_c16``, 16-particle hit
  runs per 32-row query subgroup (the 16-wide force path);
* :func:`forces_q32_c32`: ``fused_forces_nl32``, 32-particle subblocks
  per 32-row query subgroup (the q-granular path); the three in
  ``csrc/forces_q32.cu``;
* :func:`forces_q128_c32`: ``fused_forces_nl``, 32-particle subblocks
  per 128-row query block (the q128 path and the tier 2 of the 32-wide
  tables), and at ``rows`` 64 or 32 per query block of those rows (finer
  query blocks: ``nl_query_rows`` 64 or 32, ``block_size`` 64, and
  ``fused_forces_asm`` at 32 rows); ``csrc/forces_c32.cu``.

Inputs, for ``np`` particles in ``np / R`` query blocks of R = 128 rows
(``forces_q128_c32``'s ``rows`` otherwise):

* ``f8`` (np, 8) float32 [x, y, z, vx, vy, vz, pm, mr] from
  :func:`force_pack`, pm = m p / rho^2 and mr = m / rho (rho guarded to
  1 where it is 0; both 0 on padding particles);
* ``density`` (np,) float32 and ``real`` (np,) bool;
* ``cand`` (nq*L, cap) int32: candidate ids per list, L = 4 lists of 32
  query rows (row b*4 + g) or L = 1 list of R rows per row block,
  dead slots after ``count`` (nq*L,) int32;
* ``qblock`` (nq,) int32 or None: the query block of each row block
  (the two-tier path runs gathered heavy blocks against the full
  arrays); None is the identity, nq = np / R.

Output: the acceleration (nq*R, 3) float32 of the row blocks' queries,
0 on padding queries.

Each kernel also has the JAX kernels' ``r2_mxu`` mode: r^2 by
:func:`density.pair_r2_identity` on a centred pack (``force_pack``'s
``center``) for the support test and every term that reads r, the
directions still the direct x_i - x_j, and a pair of equal ids adds no
pressure term (the identity's rounding can put a self pair above
eps^2, where the r -> 0 guard would not zero it; neighbor_nl.py
_forces_pair_q32's gid test).
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import smoothing
from ...core.params import SimulationParameters
from . import build
from .density import FINE_ROWS, pair_r2_identity

BLOCK = 128  # queries per block
GROUPS = 4  # query subgroups per block
CHUNK_PAIRS = 1 << 23  # pair elements per chunk of the plain versions


def force_pack(position, velocity, density, pressure, real, mass: float,
               center=None) -> torch.Tensor:
    """(np, 8) float32 [x, y, z, vx, vy, vz, pm, mr] with the
    ``safe_rho`` and real-mask rules of make_c8_force_pack
    (neighbor_nl.py:1576-1578); the positions less ``center`` ((3,)
    float32) where one is given (the identity mode's packs)."""
    if center is not None:
        position = position - center
    safe_rho = torch.where(density > 0, density, 1.0)
    pm = torch.where(real, mass * pressure / (safe_rho * safe_rho), 0.0)
    mr = torch.where(real, mass / safe_rho, 0.0)
    return torch.cat([position, velocity, pm[:, None], mr[:, None]], dim=1).contiguous()


def _consts(params: SimulationParameters) -> dict:
    """The kernel's float32 constants, each rounded once from double as
    the JAX kernel's Python-float closures are."""
    t = params.precomputed()
    h = float(params.h)
    vals = dict(
        h=h,
        h2=h * h,
        eps2=smoothing.EPSILON * smoothing.EPSILON,
        spiky=t.spiky,
        visc=t.viscosity,
        pgrad=t.poly_6_gradient,
        lap7=7.0 * t.poly_6_laplacian / t.poly_6_gradient,
        lap4=4.0 * h * h * t.poly_6_laplacian,
        mu=params.dynamic_viscosity,
        st_threshold=params.surface_tension_threshold,
        sigma=params.surface_tension,
        gx=params.constant_acceleration[0],
        gy=params.constant_acceleration[1],
        gz=params.constant_acceleration[2],
    )
    return {k: float(np.float32(v)) for k, v in vals.items()}


def combine(press, visc, normal, lap, density, real, c: dict) -> torch.Tensor:
    """The kernel's epilogue (_combine_forces, neighbor_nl.py:764-790):
    a = (-rho P + mu V + ST)/rho + g, rho guarded, 0 on padding rows."""
    rho = torch.where(density > 0, density, 1.0)[:, None]
    total = -rho * press + visc * c["mu"]
    nlen = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    apply_st = nlen > c["st_threshold"]
    st = -c["sigma"] * lap[:, None] * normal / torch.where(apply_st, nlen, 1.0)
    total = total + torch.where(apply_st, st, 0.0)
    g = torch.tensor([c["gx"], c["gy"], c["gz"]], dtype=torch.float32, device=rho.device)
    return torch.where(real[:, None], total / rho + g, 0.0)


def _f8_candidates(f8, cand, count, sub: int):
    """The plain force passes' candidates of list rows r0..r1: each live
    slot's ``sub`` particles fetched from the f8 pack by id (a dead slot
    reads subblock 0, masked by ``live``). See :func:`_force_sums_torch`."""
    cap = cand.shape[1]
    slot = torch.arange(cap, device=f8.device)
    lane = torch.arange(sub, device=f8.device)

    def chunk(r0, r1):
        r = r1 - r0
        live = slot[None, :] < count[r0:r1, None]
        jid = (torch.where(live, cand[r0:r1], 0).to(torch.int64)[:, :, None] * sub
               + lane).reshape(r, cap * sub)
        live = live[:, :, None].expand(r, cap, sub).reshape(r, 1, cap * sub)
        return f8[jid][:, None], jid, live

    return chunk


def _force_sums_torch(f8, params, qids, width: int, candidates, r2_mxu: bool = False):
    """Plain raw force sums: list row l's queries ``qids[l]`` ((nrows,
    qrows) global ids into ``f8``) against the ``width`` candidates that
    ``candidates(r0, r1)`` gives for list rows r0..r1: (f8 fields (r, 1,
    width, 8), global ids (r, width) int64, live (r, 1, width) bool),
    chunked over list rows; ``r2_mxu``: r^2 by the identity and no
    pressure term between equal ids. Returns (P with the r -> 0 splat, V,
    N (each (nrows*qrows, 3)), L (nrows*qrows,))."""
    c = _consts(params)
    nrows, qrows = qids.shape
    dev = f8.device
    press = torch.empty((nrows * qrows, 3), dtype=torch.float32, device=dev)
    visc = torch.empty((nrows * qrows, 3), dtype=torch.float32, device=dev)
    normal = torch.empty((nrows * qrows, 3), dtype=torch.float32, device=dev)
    lap = torch.empty(nrows * qrows, dtype=torch.float32, device=dev)
    rows = max(1, CHUNK_PAIRS // (qrows * width))
    for r0 in range(0, nrows, rows):
        r1 = min(nrows, r0 + rows)
        cj, jid, live = candidates(r0, r1)  # (r, 1, K, 8), (r, K), (r, 1, K)
        qid = qids[r0:r1, :, None]  # (r, qrows, 1)
        qi = f8[qid]  # (r, qrows, 1, 8)
        dx = qi[..., 0] - cj[..., 0]
        dy = qi[..., 1] - cj[..., 1]
        dz = qi[..., 2] - cj[..., 2]
        if r2_mxu:
            r2 = pair_r2_identity(qi[..., :3], cj[..., :3])  # (r, qrows, K)
        else:
            r2 = (dx * dx + dy * dy) + dz * dz  # (r, qrows, K)
        inside = (r2 < c["h2"]) & live
        near0 = r2 < c["eps2"]
        inv_r = torch.where(near0, 0.0, torch.rsqrt(r2))
        dist = r2 * inv_r
        hr = torch.clamp(c["h"] - dist, min=0.0)
        t = torch.clamp(c["h2"] - r2, min=0.0)
        mr = cj[..., 7]
        b = (c["visc"] * mr) * hr
        u = mr * t
        pc = cj[..., 6] + qi[..., 6]
        if r2_mxu:
            pc = torch.where(jid[:, None, :] == qid, 0.0, pc)
        a = pc * ((c["spiky"] * (hr * hr)) * inv_r)
        g = (c["pgrad"] * u) * t
        lp = c["lap7"] * g - c["lap4"] * u
        a, b, g, lp = (torch.where(inside, x, 0.0) for x in (a, b, g, lp))
        sing = torch.where(inside & near0 & (jid[:, None, :] != qid), pc * c["spiky"], 0.0)
        sing = sing.sum(dim=-1)
        sl = slice(r0 * qrows, r1 * qrows)
        press[sl] = torch.stack(
            [(a * d).sum(dim=-1) + sing for d in (dx, dy, dz)], dim=-1
        ).reshape(-1, 3)
        visc[sl] = torch.stack(
            [(b * (cj[..., k] - qi[..., k])).sum(dim=-1) for k in (3, 4, 5)], dim=-1
        ).reshape(-1, 3)
        normal[sl] = torch.stack(
            [(g * d).sum(dim=-1) for d in (dx, dy, dz)], dim=-1
        ).reshape(-1, 3)
        lap[sl] = lp.sum(dim=-1).reshape(-1)
    return press, visc, normal, lap


def _forces_torch(f8, density, real, cand, count, params, qblock, qrows: int, sub: int,
                  block: int = BLOCK, r2_mxu: bool = False):
    """Plain force pass over ``sub``-particle candidate lists shared by
    ``qrows`` query rows, ``block // qrows`` lists to a query block of
    ``block`` rows (the unit of ``qblock``), chunked over lists."""
    nrows, cap = cand.shape
    nq = nrows // (block // qrows)
    dev = f8.device
    qlane = torch.arange(block, device=dev)
    qb_all = (torch.arange(nq, device=dev) if qblock is None else qblock.to(torch.int64))
    qids = (qb_all[:, None] * block + qlane).reshape(nrows, qrows)  # per list
    sums = _force_sums_torch(f8, params, qids, cap * sub,
                             _f8_candidates(f8, cand, count, sub), r2_mxu)
    q = qids.reshape(-1)
    return combine(*sums, density[q], real[q], _consts(params))


def forces_q32_c8_torch(f8, density, real, cand8, count8, params: SimulationParameters,
                        qblock=None, r2_mxu: bool = False):
    """Plain PyTorch version of :func:`forces_q32_c8`."""
    return _forces_torch(f8, density, real, cand8, count8, params, qblock, 32, 8,
                         r2_mxu=r2_mxu)


def forces_q32_c16_torch(f8, density, real, cand16, count16, params: SimulationParameters,
                         qblock=None, r2_mxu: bool = False):
    """Plain PyTorch version of :func:`forces_q32_c16`."""
    return _forces_torch(f8, density, real, cand16, count16, params, qblock, 32, 16,
                         r2_mxu=r2_mxu)


def forces_q32_c32_torch(f8, density, real, cand, count, params: SimulationParameters,
                         qblock=None, r2_mxu: bool = False):
    """Plain PyTorch version of :func:`forces_q32_c32`."""
    return _forces_torch(f8, density, real, cand, count, params, qblock, 32, 32,
                         r2_mxu=r2_mxu)


def forces_q128_c32_torch(f8, density, real, cand, count, params: SimulationParameters,
                          qblock=None, rows: int = BLOCK, r2_mxu: bool = False):
    """Plain PyTorch version of :func:`forces_q128_c32`."""
    return _forces_torch(f8, density, real, cand, count, params, qblock, rows, 32,
                         block=rows, r2_mxu=r2_mxu)


def _check(f8, density, real, cand, count, qblock, lists: int, block: int = BLOCK):
    if f8.dtype != torch.float32 or f8.dim() != 2 or f8.shape[1] != 8:
        raise ValueError("f8 must be (np, 8) float32")
    npart = f8.shape[0]
    if npart % block:
        raise ValueError(f"particle count {npart} is not a multiple of {block}")
    if density.dtype != torch.float32 or density.shape != (npart,):
        raise ValueError("density must be (np,) float32")
    if real.dtype != torch.bool or real.shape != (npart,):
        raise ValueError("real must be (np,) bool")
    if cand.dtype != torch.int32 or cand.dim() != 2 or cand.shape[0] % lists:
        raise ValueError(f"cand must be (nq*{lists}, cap) int32")
    nq = cand.shape[0] // lists
    if qblock is None:
        if nq != npart // block:
            raise ValueError(f"cand must have np/{block}*{lists} rows without a qblock map")
    elif qblock.dtype != torch.int32 or qblock.shape != (nq,):
        raise ValueError("qblock must be (nq,) int32")
    if count.dtype != torch.int32 or count.shape != (cand.shape[0],):
        raise ValueError(f"count must be (nq*{lists},) int32")
    named = (("density", density), ("real", real), ("cand", cand), ("count", count),
             ("f8", f8)) + (() if qblock is None else (("qblock", qblock),))
    for name, t in named:
        if t.device != f8.device:
            raise ValueError(f"{name} is on {t.device}, f8 on {f8.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(name, f8, density, real, cand, count, qblock, params, lists, *extra,
            block: int = BLOCK, r2_mxu: bool = False):
    c = _consts(params)
    nq = cand.shape[0] // lists
    accel = torch.empty((nq * block, 3), dtype=torch.float32, device=f8.device)
    stream = torch.cuda.current_stream(f8.device).cuda_stream
    status = getattr(build.load_library(), name + ("_mxu" if r2_mxu else "") + "_launch")(
        f8.data_ptr(), density.data_ptr(), real.data_ptr(), cand.data_ptr(),
        count.data_ptr(), None if qblock is None else qblock.data_ptr(),
        nq, cand.shape[1], *extra,
        c["h"], c["h2"], c["eps2"], c["spiky"], c["visc"], c["pgrad"],
        c["lap7"], c["lap4"], c["mu"], c["st_threshold"], c["sigma"],
        c["gx"], c["gy"], c["gz"], accel.data_ptr(), stream,
    )
    build.check(status, name)
    return accel


def _dispatch(fn, plain, entry, f8, density, real, cand, count, params, qblock,
              qrows, *extra, block: int = BLOCK, variant=None, r2_mxu: bool = False):
    """Check the inputs, then run the plain version on CPU tensors or
    launch C entry point ``entry`` (its ``_mxu`` twin with ``r2_mxu``),
    counting the launch on ``fn`` and on ``fn.variants``: under
    ``variant`` where one is named (", mxu" added in the identity mode),
    under "mxu" for another identity-mode launch."""
    lists = block // qrows
    _check(f8, density, real, cand, count, qblock, lists, block)
    if f8.device.type == "cpu":
        return plain(f8, density, real, cand, count, params, qblock, r2_mxu=r2_mxu)
    if f8.device.type != "cuda":
        raise ValueError(f"{fn.__name__}: unsupported device {f8.device}")
    accel = _launch(entry, f8, density, real, cand, count, qblock, params, lists, *extra,
                    block=block, r2_mxu=r2_mxu)
    fn.launches += 1
    if r2_mxu:
        variant = "mxu" if variant is None else variant + ", mxu"
    if variant is not None:
        fn.variants[variant] = fn.variants.get(variant, 0) + 1
    return accel


def forces_q32_c8(f8, density, real, cand8, count8, params: SimulationParameters,
                  qblock=None, r2_mxu: bool = False):
    """Accelerations over 8-particle hit runs per 32-row subgroup;
    ``r2_mxu``: the identity mode (on a centred pack). CPU tensors take
    the plain version; CUDA tensors launch the kernel (building it at
    first use) or raise."""
    return _dispatch(forces_q32_c8, forces_q32_c8_torch, "forces_q32", f8, density,
                     real, cand8, count8, params, qblock, 32, 8, r2_mxu=r2_mxu)


def forces_q32_c16(f8, density, real, cand16, count16, params: SimulationParameters,
                   qblock=None, r2_mxu: bool = False):
    """Accelerations over 16-particle hit runs per 32-row subgroup (lists
    (nq*4, cap)); ``r2_mxu``: the identity mode (on a centred pack). CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (building it at first use) or raise."""
    return _dispatch(forces_q32_c16, forces_q32_c16_torch, "forces_q32", f8, density,
                     real, cand16, count16, params, qblock, 32, 16, r2_mxu=r2_mxu)


def forces_q32_c32(f8, density, real, cand, count, params: SimulationParameters,
                   qblock=None, r2_mxu: bool = False):
    """Accelerations over 32-particle subblocks per 32-row subgroup
    (lists (nq*4, cap)); ``r2_mxu``: the identity mode (on a centred
    pack). CPU tensors take the plain version; CUDA tensors launch the
    kernel (building it at first use) or raise."""
    return _dispatch(forces_q32_c32, forces_q32_c32_torch, "forces_q32", f8, density,
                     real, cand, count, params, qblock, 32, 32, r2_mxu=r2_mxu)


def forces_q128_c32(f8, density, real, cand, count, params: SimulationParameters,
                    qblock=None, rows: int = BLOCK, r2_mxu: bool = False):
    """Accelerations over 32-particle subblocks per query block of
    ``rows`` rows (lists (nq, cap)): 128, or 64 and 32 on finer query
    blocks (``qblock`` counts blocks of ``rows``); ``r2_mxu``: the
    identity mode (on a centred pack). CPU tensors take the plain
    version; CUDA tensors launch the kernel (building it at first use)
    or raise."""
    if rows not in FINE_ROWS + (BLOCK,):
        raise ValueError(f"forces_q128_c32: rows must be {BLOCK} or one of {FINE_ROWS}, "
                         f"not {rows}")

    def plain(*args, r2_mxu=False):
        return forces_q128_c32_torch(*args, rows=rows, r2_mxu=r2_mxu)

    if rows == BLOCK:
        return _dispatch(forces_q128_c32, plain, "forces_c32", f8, density, real, cand,
                         count, params, qblock, BLOCK, variant=f"rows {rows}",
                         r2_mxu=r2_mxu)
    return _dispatch(forces_q128_c32, plain, "forces_c32_rows", f8, density, real, cand,
                     count, params, qblock, rows, rows, block=rows, variant=f"rows {rows}",
                     r2_mxu=r2_mxu)


for _fn in (forces_q32_c8, forces_q32_c16, forces_q32_c32, forces_q128_c32):
    _fn.launches = 0
    _fn.variants = {}
