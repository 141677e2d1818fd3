"""The candidate stream and the force sums over it: the CUDA kernels,
their plain PyTorch versions and the wrappers that pick between them by
device. The JAX package's force kernels read their candidates as a
stream gathered ahead of the kernel (``neighbor_nl.py`` ``gather_raw``
and the in-kernel tile assembly ``_tile_from_raw`` / ``_tile_from_raw16``),
and its probes time the sums on such a stream alone
(``experiments/force_kernel_bisect.py``, ``nl_kernel_variants.py``). The
port's force kernels fetch each candidate by id instead; these two
kernels are the stream form, for the probes
(``experiments/torch_force_kernel_bisect.py``,
``torch_nl_kernel_variants.py``). No engine path runs them.

* :func:`gather_stream`: the records of every slot's particles, in slot
  order; ``csrc/gather_stream.cu``.
* :func:`forces_c32_stream`: :func:`forces.forces_q128_c32`'s sums over
  a 32-wide stream of 128-row lists; ``csrc/forces_stream.cu``.

Inputs: ``f8`` (np, 8) float32 from :func:`forces.force_pack`; ``cand``
(rows, cap) int32 slot ids of ``sub``-particle subblocks (8, 16 or 32),
dead slots after ``count`` (rows,) int32 (the sentinel
``REFINE_SENTINEL`` is an id outside the pack).

The stream, for record e = k * sub + l of row r (particle j = cand[r, k]
* sub + l of slot k):

* ``"staged"``: (rows, cap * sub, 12) float32, three float4 a record as
  the force kernels stage it: (x, y, z, j as int32 bits), (vx, vy, vz,
  pm), (mr, visc * mr, 0, 0);
* ``"planes"``: (10, rows, cap * sub) float32, the ten used fields a
  plane: x, y, z, j (int32 bits), vx, vy, vz, pm, mr, visc * mr.

A dead slot (k >= count[r], or an id outside the pack) holds position
+inf, id -1 and zeros.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.params import SimulationParameters
from . import build
from .density import _count
from .forces import BLOCK, CHUNK_PAIRS, _consts, _force_sums_torch, combine

LAYOUTS = ("staged", "planes")
SUBS = (8, 16, 32)
STAGED_FLOATS = 12  # floats of a staged record (three float4)
PLANES = 10  # fields of the planes layout
# field indices of a staged record: the f8 pack's eight, and the id
F8_FIELDS = (0, 1, 2, 4, 5, 6, 7, 8)
ID_FIELD = 3
SUB = 32  # particles a slot of forces_c32_stream's lists
# (layout, cull, out) -> the kernel's mode, by its launch variant name
MODES = {
    ("staged", True, "sums"): (0, "sums"),
    ("staged", True, "accel"): (1, "accel"),
    ("planes", True, "sums"): (2, "planes"),
    ("staged", False, "sums"): (3, "no cull"),
    ("staged", True, "test"): (4, "test"),
}
CHUNK_RECORDS = 1 << 22  # records per chunk of the plain gather


def stream_visc(params: SimulationParameters) -> float:
    """The viscosity factor that the stream's visc * mr carries: the force
    kernels' float32 constant."""
    return _consts(params)["visc"]


def _stream_shape(layout: str, rows: int, width: int) -> tuple:
    return (rows, width, STAGED_FLOATS) if layout == "staged" else (PLANES, rows, width)


def gather_stream_torch(f8, cand, count, sub: int, visc: float, layout: str = "staged"):
    """Plain PyTorch version of :func:`gather_stream`, chunked over list
    rows."""
    rows, cap = cand.shape
    dev = f8.device
    width = cap * sub
    nsub = f8.shape[0] // sub
    visc = float(np.float32(visc))
    out = torch.empty(_stream_shape(layout, rows, width), dtype=torch.float32, device=dev)
    slot = torch.arange(cap, device=dev)
    lane = torch.arange(sub, device=dev)
    step = max(1, CHUNK_RECORDS // max(1, width))
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        c = cand[r0:r1]
        live = (slot[None, :] < count[r0:r1, None]) & (c >= 0) & (c < nsub)
        j = (torch.where(live, c, 0).to(torch.int64)[:, :, None] * sub + lane).reshape(
            r1 - r0, width)
        live = live[:, :, None].expand(r1 - r0, cap, sub).reshape(r1 - r0, width)
        g = f8[j]  # (r, K, 8)
        pos = torch.where(live[..., None], g[..., :3], torch.inf)
        ids = torch.where(live, j.to(torch.int32), -1).view(torch.float32)
        rest = torch.where(live[..., None], g[..., 3:], 0.0)  # vx vy vz pm mr
        vmr = rest[..., 4] * visc  # one float32 multiply, as the kernels form it
        zero = torch.zeros_like(vmr)
        fields = (pos[..., 0], pos[..., 1], pos[..., 2], ids, rest[..., 0], rest[..., 1],
                  rest[..., 2], rest[..., 3], rest[..., 4], vmr)
        if layout == "staged":
            out[r0:r1] = torch.stack(fields + (zero, zero), dim=-1)
        else:
            out[:, r0:r1] = torch.stack(fields)
    return out


def _check_lists(f8, cand, count, sub, layout):
    if f8.dtype != torch.float32 or f8.dim() != 2 or f8.shape[1] != 8:
        raise ValueError("f8 must be (np, 8) float32")
    if f8.shape[0] % sub:
        raise ValueError(f"particle count {f8.shape[0]} is not a multiple of sub {sub}")
    if sub not in SUBS:
        raise ValueError(f"sub must be one of {SUBS}, not {sub}")
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, not {layout!r}")
    if cand.dtype != torch.int32 or cand.dim() != 2:
        raise ValueError("cand must be (rows, cap) int32")
    if count.dtype != torch.int32 or count.shape != (cand.shape[0],):
        raise ValueError("count must be (rows,) int32")
    for name, t in (("f8", f8), ("cand", cand), ("count", count)):
        if t.device != f8.device:
            raise ValueError(f"{name} is on {t.device}, f8 on {f8.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if f8.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {f8.device}")


def gather_stream(f8, cand, count, sub: int, visc: float, layout: str = "staged"):
    """The candidate stream of lists ``cand`` at ``sub`` particles a slot,
    in ``layout`` ("staged" or "planes"; see the module's docstring).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (building it at first use) or raise."""
    _check_lists(f8, cand, count, sub, layout)
    if f8.device.type == "cpu":
        return gather_stream_torch(f8, cand, count, sub, visc, layout)
    rows, cap = cand.shape
    out = torch.empty(_stream_shape(layout, rows, cap * sub), dtype=torch.float32,
                      device=f8.device)
    stream = torch.cuda.current_stream(f8.device).cuda_stream
    status = build.load_library().gather_stream_launch(
        f8.data_ptr(), cand.data_ptr(), count.data_ptr(), rows, cap, sub,
        int(layout == "planes"), f8.shape[0], float(np.float32(visc)), out.data_ptr(),
        stream)
    build.check(status, "gather_stream")
    _count(gather_stream, layout)
    return out


def _stream_candidates(stream, count, layout: str):
    """:func:`forces._force_sums_torch`'s candidates of list rows r0..r1
    read from a 32-wide stream: the f8 fields and ids of its records,
    live where the slot lies below ``count`` and holds a particle (dead
    records are zeroed, so no infinity reaches the sums)."""
    width = stream.shape[1] if layout == "staged" else stream.shape[2]
    rec = torch.arange(width, device=stream.device)

    def chunk(r0, r1):
        if layout == "staged":
            block = stream[r0:r1]  # (r, K, 12)
            fields, ids = block[..., list(F8_FIELDS)], block[..., ID_FIELD]
        else:
            block = stream[:, r0:r1]  # (10, r, K)
            fields, ids = block[list(F8_FIELDS)].permute(1, 2, 0), block[ID_FIELD]
        jid = ids.contiguous().view(torch.int32).to(torch.int64)
        live = (rec[None, :] < count[r0:r1, None] * SUB) & (jid >= 0)
        cj = torch.where(live[..., None], fields, 0.0)
        return cj[:, None], jid, live[:, None]

    return chunk


def _test_counts(f8, qids, width, candidates, h2: float):
    """Each query's live candidates with r^2 < h^2 (r^2 rounded as the
    kernels round it), chunked over list rows."""
    nrows, qrows = qids.shape
    out = torch.empty(nrows * qrows, dtype=torch.int32, device=f8.device)
    rows = max(1, CHUNK_PAIRS // (qrows * width))
    for r0 in range(0, nrows, rows):
        r1 = min(nrows, r0 + rows)
        cj, _, live = candidates(r0, r1)
        qi = f8[qids[r0:r1, :, None]]
        dx = qi[..., 0] - cj[..., 0]
        dy = qi[..., 1] - cj[..., 1]
        dz = qi[..., 2] - cj[..., 2]
        r2 = (dx * dx + dy * dy) + dz * dz
        out[r0 * qrows:r1 * qrows] = ((r2 < h2) & live).sum(dim=-1, dtype=torch.int32
                                                            ).reshape(-1)
    return out


def forces_c32_stream_torch(f8, density, real, stream, count, params: SimulationParameters,
                            layout: str = "staged", cull: bool = True, out: str = "sums"):
    """Plain PyTorch version of :func:`forces_c32_stream`: the arithmetic
    of the plain force passes (:func:`forces._forces_torch`), fed from the
    stream. ``cull`` changes no result."""
    nq = count.shape[0]
    width = stream.shape[1] if layout == "staged" else stream.shape[2]
    qids = torch.arange(nq * BLOCK, device=f8.device).reshape(nq, BLOCK)
    candidates = _stream_candidates(stream, count, layout)
    if out == "test":
        return _test_counts(f8, qids, width, candidates, _consts(params)["h2"])
    press, visc, normal, lap = _force_sums_torch(f8, params, qids, width, candidates)
    if out == "accel":
        return combine(press, visc, normal, lap, density, real, _consts(params))
    return torch.cat([press, visc, normal, lap[:, None]], dim=1)


def sums_error(got, want, rtol: float = 1e-5) -> tuple:
    """How far the ten sums ``got`` (np, 10) of :func:`forces_c32_stream`
    leave ``want``: the largest difference, and the first sum (column)
    with a difference above rtol * |want| + rtol * that sum's largest
    |want|, or -1 if none has."""
    scale = want.abs().amax(dim=0)
    diff = (got - want).abs()
    bad = (diff > rtol * want.abs() + rtol * scale).any(dim=0)
    return float(diff.max()), int(bad.nonzero()[0]) if bool(bad.any()) else -1


def _check_stream(f8, density, real, stream, count, layout, out):
    npart = f8.shape[0]
    if f8.dtype != torch.float32 or f8.dim() != 2 or f8.shape[1] != 8:
        raise ValueError("f8 must be (np, 8) float32")
    if npart % BLOCK:
        raise ValueError(f"particle count {npart} is not a multiple of {BLOCK}")
    nq = npart // BLOCK
    if count.dtype != torch.int32 or count.shape != (nq,):
        raise ValueError(f"count must be (np/{BLOCK},) int32: one 128-row list a query block")
    if stream.dtype != torch.float32 or stream.dim() != 3:
        raise ValueError("stream must be a float32 stream from gather_stream")
    width = stream.shape[1] if layout == "staged" else stream.shape[2]
    if width % SUB or stream.shape != _stream_shape(layout, nq, width):
        raise ValueError(f"stream must be the {layout} stream of np/{BLOCK} lists of "
                         f"{SUB}-particle slots, not {tuple(stream.shape)}")
    named = [("f8", f8), ("count", count), ("stream", stream)]
    if out == "accel":
        if density.dtype != torch.float32 or density.shape != (npart,):
            raise ValueError("density must be (np,) float32")
        if real.dtype != torch.bool or real.shape != (npart,):
            raise ValueError("real must be (np,) bool")
        named += [("density", density), ("real", real)]
    for name, t in named:
        if t.device != f8.device:
            raise ValueError(f"{name} is on {t.device}, f8 on {f8.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if f8.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {f8.device}")


def forces_c32_stream(f8, density, real, stream, count, params: SimulationParameters,
                      layout: str = "staged", cull: bool = True, out: str = "sums"):
    """:func:`forces.forces_q128_c32`'s sums over ``stream``, the 32-wide
    :func:`gather_stream` of one 128-row list a query block (np / 128
    rows, no query-block map). ``out``: "sums", the ten raw sums (np, 10)
    float32 (P with the r -> 0 splat in x, y, z, then V, N and the
    colour-field laplacian L); "accel", the combine fused in (np, 3)
    (``density`` and ``real`` are read only here); "test", each query's
    int32 count of candidates inside the support, the pair terms left out.
    ``cull`` False tests every candidate instead of the runs whose boxes
    lie within h. Five modes exist: (staged, cull) with each ``out``,
    (planes, cull, sums) and (staged, no cull, sums). CPU tensors take
    the plain version; CUDA tensors launch the kernel (building it at
    first use) or raise."""
    if (layout, cull, out) not in MODES:
        raise ValueError(f"forces_c32_stream has no mode (layout={layout!r}, cull={cull}, "
                         f"out={out!r}); modes: {sorted(MODES)}")
    _check_stream(f8, density, real, stream, count, layout, out)
    if f8.device.type == "cpu":
        return forces_c32_stream_torch(f8, density, real, stream, count, params, layout,
                                       cull, out)
    mode, variant = MODES[(layout, cull, out)]
    nq = count.shape[0]
    shape, dtype = {"sums": ((nq * BLOCK, 10), torch.float32),
                    "accel": ((nq * BLOCK, 3), torch.float32),
                    "test": ((nq * BLOCK,), torch.int32)}[out]
    res = torch.empty(shape, dtype=dtype, device=f8.device)
    c = _consts(params)
    ptr = lambda t: t.data_ptr() if out == "accel" else None  # noqa: E731
    status = build.load_library().forces_stream_launch(
        f8.data_ptr(), ptr(density), ptr(real), stream.data_ptr(), count.data_ptr(), nq,
        stream.shape[1 if layout == "staged" else 2] // SUB, mode,
        c["h"], c["h2"], c["eps2"], c["spiky"], c["visc"], c["pgrad"], c["lap7"],
        c["lap4"], c["mu"], c["st_threshold"], c["sigma"], c["gx"], c["gy"], c["gz"],
        res.data_ptr(), torch.cuda.current_stream(f8.device).cuda_stream)
    build.check(status, "forces_c32_stream")
    _count(forces_c32_stream, variant)
    return res


for _fn in (gather_stream, forces_c32_stream):
    _fn.launches = 0
    _fn.variants = {}
