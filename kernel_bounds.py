"""The least time a kernel's work could take on one NVIDIA H100 SXM: the
larger of the bytes it must move over the memory rate and the fp32
operations it must do over the peak rate (inputs read once, outputs
written once; operations counted for what the run's data needs).

Shared by ``chip_smoke.py`` (and ``kernel_ab.py`` through it) and the
stream probes (``experiments/torch_force_kernel_bisect.py``,
``experiments/torch_nl_kernel_variants.py``). Imports nothing, so that
importing it loads no part of the port (whose sort backend is read from
the environment at import).
"""

from __future__ import annotations

# one NVIDIA H100 SXM (data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# operations a pair, counted from the kernels' bodies (csrc/sph_pair.cuh):
# density: r^2 (3 sub, 3 mul, 2 add), h^2 - r^2 and its clamp (2), t^3
# (2), poly6 * real (1), the fma (2), the hit test (1), for the pairs
# inside the support only (a pair outside adds exactly +0 and no count,
# and the density kernels skip most of them); the dilated tile count
# adds a test for each pair within its radius
DENSITY_OPS = 16
# force, for the pairs inside the support only (a pair outside adds
# nothing, and the force kernels skip most of them): r^2 and the support
# test (9), the rsqrt, r, h - r and h^2 - r^2 with their clamps, the
# kernel weights (8 products and a sum), the P, N sums (6 fmas), V (3
# subs, 3 fmas) and L (4)
FORCE_OPS = 51
# of which r^2 and the support test
PAIR_TEST_OPS = 9
# the advection kernel (csrc/advect_collide.cu): x, v_inter and a read
# and x, v and v_inter written, 12 bytes each, a particle, and the
# 32-byte corner row of each particle inside a face box
ADVECT_PARTICLE_BYTES = 72
CORNER_ROW_BYTES = 32
# operations: v+ and x+ (12), v (6), |v|^2 and |a|^2 (10) a particle; the
# cell and the distance d (77) for a particle inside a face box; the
# normal, speed and response (136) for one that collides
ADVECT_OPS = 28
IN_BOX_OPS = 77
RESPONSE_OPS = 136
# the exact refine's kernel (csrc/refine_exact.cu): a particle against a
# box is, on each axis, two subtractions, their maximum and the two
# clamps (15), then three squares, two sums and the comparison (6)
REFINE_TEST_OPS = 21
STREAM_SUB = 32  # particles a slot of the summed streams
STREAM_ROWS = 128  # queries a list of the summed streams


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(nbytes_, ops):
    """The least time (ms) the card could take, and what sets it
    ("bytes" or "operations")."""
    t_bytes = 1e3 * nbytes_ / PEAK_BYTES
    t_ops = 1e3 * ops / PEAK_FP32
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def advect_work(n, in_box, colliding):
    """(bytes, operations) of one advance of ``n`` particles, ``in_box``
    of them inside a face box and ``colliding`` of those below the
    contact distance."""
    return (n * ADVECT_PARTICLE_BYTES + in_box * CORNER_ROW_BYTES,
            n * ADVECT_OPS + in_box * IN_BOX_OPS + colliding * RESPONSE_OPS)


def refine_exact_work(cand, count, qlo, qhi, pos_blocked, sub, live):
    """(bytes, operations) of the exact refine's keys (``kernels.
    refine_exact_keys``) on block lists ``cand`` (rows, M) with ``live``
    live slots in all, against ``qlo``/``qhi`` (rows, S, 3), over the
    candidate blocks' positions ``pos_blocked`` (nbc, B, 3) cut into
    ``sub`` subblocks. Bytes: the lists, counts, boxes and positions read
    once (12 bytes a particle, whatever the view's strides), the keys
    (rows, sub * M) and counts written. Operations: REFINE_TEST_OPS for
    each particle of each live slot against each box."""
    rows, m = cand.shape
    nbc, b, _ = pos_blocked.shape
    read = nbytes(cand, count, qlo, qhi) + nbc * b * 12
    return read + rows * (sub * m + 1) * 4, live * b * qlo.shape[1] * REFINE_TEST_OPS


def stream_works(f8, dens, real, cand, count, live, pairs_in) -> dict:
    """(bytes, operations) of the stream kernels (``ops/kernels/stream.py``)
    and of ``forces_q128_c32`` on 32-wide lists ``cand`` of 128-row blocks
    with ``live`` live records and ``pairs_in`` pairs inside the support.

    Bytes: a gather reads the f8 pack, the lists and counts once and
    writes the whole stream (48 bytes a record, 40 in planes); a sum reads
    the live records, the queries' f8 rows and the counts, and writes its
    output. Operations: FORCE_OPS for each pair inside the support, the
    only pairs whose terms the sums need (a pair outside adds nothing, and
    the box cull skips most of them); the test mode PAIR_TEST_OPS for each
    of them. Only the no-cull mode, which tests every pair of a query with
    a live candidate of its list, is charged PAIR_TEST_OPS for each."""
    np_, slots = f8.shape[0], cand.numel() * STREAM_SUB
    queries = nbytes(f8, count)
    ops = pairs_in * FORCE_OPS
    every_pair = live * STREAM_ROWS * PAIR_TEST_OPS + pairs_in * (FORCE_OPS - PAIR_TEST_OPS)
    gather = nbytes(f8, cand, count)
    return {
        "gather_stream": (gather + slots * 48, 0),
        "gather_stream planes": (gather + slots * 40, 0),
        "forces_c32_stream sums": (queries + live * 48 + np_ * 40, ops),
        "forces_c32_stream planes": (queries + live * 40 + np_ * 40, ops),
        "forces_c32_stream no cull": (queries + live * 48 + np_ * 40, every_pair),
        "forces_c32_stream test": (queries + live * 48 + np_ * 4, pairs_in * PAIR_TEST_OPS),
        "forces_c32_stream count=0": (queries + np_ * 40, 0),
        "forces_c32_stream accel": (queries + live * 48 + nbytes(dens, real) + np_ * 12, ops),
        "forces_q128_c32": (nbytes(f8, dens, real, cand, count) + np_ * 12, ops),
    }
