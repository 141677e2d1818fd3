"""The exact refine's distance test on the card: the wrapper that
launches the CUDA kernel on CUDA tensors and takes the plain path of
``ops/tiles.py`` on CPU tensors, and the stage on its keys.

:func:`refine_exact_keys` is the part of the exact refine before its
row sort: for each query row, each live slot of its block list and each
subblock of that candidate block, whether one of the subblock's
particles lies within reach of one of the row's split boxes. It returns
the keys table that the row sort compacts, (nb_q, sub * M) int32 in
subblock-major columns ``s * M + k``, the surviving ids ``cand * sub +
s`` and every other slot ``REFINE_SENTINEL``, and the survivors of each
row, (nb_q,) int32. The plain version, ``tiles.refine_exact_keys_torch``,
gathers the candidate blocks' positions into a (rows, M, B, 3) stream,
chunk by chunk, and tests it: on the card about 320 launches a rebuild
over a stream of up to 1.15 GB at 1M. ``csrc/refine_exact.cu`` is one
launch that reads the lists, boxes and positions where they lie, with
the same float32 roundings, so its table equals the plain one id for id.
:func:`refine_candidates_exact` is the engine's whole stage: these keys,
then the plain row sort (``tiles.refine_exact_table``). It replaces no
TPU kernel: the JAX package leaves this stage to XLA.
"""

from __future__ import annotations

import torch

from ...utils import profiling
from .. import grid as grid_ops
from .. import tiles
from ..tiles import refine_exact_keys_torch
from . import build

BLOCKS = (64, 128, 256)  # particles a candidate block
SUBBLOCKS = (16, 32)  # particles a subblock


def _check(cand, count, qlo, qhi, pos_blocked, sub):
    if cand.dim() != 2 or qlo.dim() != 3 or pos_blocked.dim() != 3:
        raise ValueError(f"cand must be (nb_q, M), qlo (nb_q, S, 3) and pos_blocked "
                         f"(nbc, B, 3), not {tuple(cand.shape)}, {tuple(qlo.shape)} and "
                         f"{tuple(pos_blocked.shape)}")
    rows, n_boxes, b = cand.shape[0], qlo.shape[1], pos_blocked.shape[1]
    named = (("cand", cand, torch.int32, tuple(cand.shape)),
             ("count", count, torch.int32, (rows,)),
             ("qlo", qlo, torch.float32, (rows, n_boxes, 3)),
             ("qhi", qhi, torch.float32, (rows, n_boxes, 3)),
             ("pos_blocked", pos_blocked, torch.float32, (pos_blocked.shape[0], b, 3)))
    for name, t, dtype, shape in named:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} {dtype}, not {tuple(t.shape)} {t.dtype}")
        if t.device != cand.device:
            raise ValueError(f"{name} is on {t.device}, cand on {cand.device}")
    if not 1 <= n_boxes <= tiles.SPLIT_BOXES:
        raise ValueError(f"qlo must hold 1 to {tiles.SPLIT_BOXES} boxes a row, not {n_boxes}")
    if b not in BLOCKS:
        raise ValueError(f"pos_blocked must hold one of {BLOCKS} particles a block, not {b}")
    if sub <= 0 or b % sub or b // sub not in SUBBLOCKS:
        raise ValueError(f"sub must cut a block of {b} into subblocks of one of "
                         f"{SUBBLOCKS} particles, not {sub} subblocks")
    if cand.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {cand.device}")


def refine_exact_keys(cand, count, qlo, qhi, pos_blocked, h: float, sub: int):
    """The exact refine's keys and counts (see the module's docstring) for
    block lists ``cand`` (nb_q, M) int32 with ``count`` (nb_q,) int32 live
    slots, query boxes ``qlo``/``qhi`` (nb_q, S, 3) float32 (S <= 4) and
    the candidate blocks' sorted positions ``pos_blocked`` (nbc, B, 3)
    float32 (B 64, 128 or 256, any strides), cut into ``sub`` subblocks of
    16 or 32 particles, at reach ``h``. CPU tensors take the plain
    version; CUDA tensors launch the kernel (building it at first use),
    each launch counted, or raise."""
    _check(cand, count, qlo, qhi, pos_blocked, sub)
    if cand.device.type == "cpu":
        return refine_exact_keys_torch(cand, count, qlo, qhi, pos_blocked, h, sub)
    rows, m = cand.shape
    cand, count, qlo, qhi = (t.contiguous() for t in (cand, count, qlo, qhi))
    keys = torch.empty((rows, sub * m), dtype=torch.int32, device=cand.device)
    counts = torch.empty(rows, dtype=torch.int32, device=cand.device)
    # the plain test's threshold, the float32 of 1.01 h^2 rounded on the host
    h2_cut = float(grid_ops.device_scalar(float(h) * float(h) * 1.01, "cpu"))
    stream = torch.cuda.current_stream(cand.device).cuda_stream
    status = build.load_library().refine_exact_launch(
        cand.data_ptr(), count.data_ptr(), qlo.data_ptr(), qhi.data_ptr(),
        pos_blocked.data_ptr(), *pos_blocked.stride(), rows, m, pos_blocked.shape[1], sub,
        qlo.shape[1], h2_cut, keys.data_ptr(), counts.data_ptr(), stream)
    build.check(status, "refine_exact")
    refine_exact_keys.launches += 1
    profiling.count("refine.kernel")
    return keys, counts


refine_exact_keys.launches = 0


def refine_candidates_exact(cand, count, qlo, qhi, pos_blocked, h: float, sub: int,
                            max_sub: int, self_lo=None, self_width: int = 1):
    """``tiles.refine_candidates_exact`` on :func:`refine_exact_keys`'s
    keys: the same arguments and tables, one kernel launch on the card."""
    keys, count_sub = refine_exact_keys(cand, count, qlo, qhi, pos_blocked, h, sub)
    return tiles.refine_exact_table(keys, count_sub, max_sub, self_lo, self_width)
