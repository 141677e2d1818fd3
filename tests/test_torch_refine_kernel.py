"""The exact refine's kernel (``ops/kernels/refine.py``,
``csrc/refine_exact.cu``) against its plain PyTorch path
(``tiles.refine_exact_keys_torch``: ``tiles.refine_exact_gather`` and
``tiles.refine_exact_test`` chunk by chunk).

On the card (marked ``cuda``; they skip without a GPU), id for id: the
keys table before the row sort and its counts, then the sorted table,
the clamped counts and the overflow flag of the engine's stage,
``refine.refine_candidates_exact``, against the plain path's,
``tiles.refine_candidates_exact``.
Cases: blocks of 64, 128 and 256 particles in subblocks of 16 and 32;
the split boxes of finer query blocks (q_rep 2 and 4), each row its own;
counts of 0, partial and the full width, at a cap that overflows and
one that does not; lists that name padding blocks, whose particles sit
far outside every box; positions read through a strided view of a
4-wide table, as the sharded step passes them; the scatter compaction
(``LIBCLSPH_TPU_COMPACT=scatter``), which keeps the keys' column order;
a particle whose d2 lies one ulp either side of the threshold, where a
fused multiply-add would change the verdict; NaN positions and boxes,
and an infinite position against an infinite box edge, where a maximum
that drops NaN would keep the subblock; and the engine's
``build_candidates`` at each table shape, one launch a build.

On the CPU: the wrapper takes the plain path and counts no launch and no
``refine.kernel``, on the synthetic cases and inside ``build_candidates``
at the engine's shapes; the one-ulp case's verdicts; and the wrapper
refuses each shape, type and device it does not take, naming it.

This file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_refine_kernel.py --noconftest -p no:cacheprovider -q
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from libclsph_tpu_torch.core.params import derive_parameters
from libclsph_tpu_torch.core.state import ParticleState
from libclsph_tpu_torch.engine import step
from libclsph_tpu_torch.ops import tiles
from libclsph_tpu_torch.ops.kernels import refine
from libclsph_tpu_torch.utils import profiling
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

WATER = dict(fluid_density=998.29, dynamic_viscosity=3.5, restitution=0, k=100,
             surface_tension_threshold=7.065, surface_tension=0.0728,
             particles_inside_influence_radius=20)
H = 0.05  # reach of the synthetic cases
FAR = 1000.0  # padding blocks' positions
SHAPES = [(64, 16), (64, 32), (128, 16), (128, 32), (256, 16), (256, 32)]
Q_PATH = dict(density_sub16=False, force_sub16=False, force_sub8=False)
# the engine's table shapes: name -> StepConfig keywords
ENGINE = {
    "main": {},
    "tier2": dict(tier2_frac=8),
    "q32": dict(Q_PATH, nl_query_rows=32, cand_interval=1, sort_interval=1),
    "b64": dict(Q_PATH, block_size=64),
    "b256": dict(Q_PATH, block_size=256, cand_interval=1, sort_interval=1),
}


def synthetic(seed, b, w, nb=40, nbc=48, m=16, pad_blocks=4, q_rep=1, strided=False,
              dev="cpu"):
    """Block lists made with numpy: ``nb`` query blocks, each with 0 to
    ``m`` distinct candidate blocks (its own first; row 0 empty, row 1
    full) of ``nbc`` blocks of ``b`` particles in the unit cube, the last
    ``pad_blocks`` of them padding at FAR; 4 random split boxes a row, or
    at ``q_rep`` > 1 the split boxes of each query block's b / q_rep
    particles (each of a block's q_rep rows refines its list). Returns the
    wrapper's arguments (cand, count, qlo, qhi, pos_blocked, h, sub)."""
    rng = np.random.default_rng(seed)
    pos = rng.random((nbc, b, 3)).astype(np.float32)
    pos[nbc - pad_blocks:] = FAR
    count = rng.integers(0, m + 1, nb).astype(np.int32)
    count[:2] = 0, m
    cand = np.zeros((nb, m), np.int32)
    for i in range(nb):
        others = rng.permutation(np.delete(np.arange(nbc), i))[: max(count[i] - 1, 0)]
        cand[i, : count[i]] = np.concatenate([[i], others])[: count[i]]
    centre = rng.random((nb, 4, 3)).astype(np.float32)
    half = (0.02 + 0.08 * rng.random((nb, 4, 3))).astype(np.float32)
    T = torch.as_tensor
    cand, count, qlo, qhi = T(cand), T(count), T(centre - half), T(centre + half)
    if q_rep > 1:
        rows = b // q_rep
        real = torch.ones((nb * q_rep, rows), dtype=torch.bool)
        qlo, qhi = tiles.split_block_bounds(T(pos[:nb]).reshape(nb * q_rep, rows, 3), real)
        cand = torch.repeat_interleave(cand, q_rep, dim=0)
        count = torch.repeat_interleave(count, q_rep)
    pos_b = T(pos)
    if strided:  # the sharded step's view of its (n, 4) table
        pos4 = torch.cat([pos_b.reshape(-1, 3), torch.ones(nbc * b, 1)], dim=1)
        pos_b = pos4.to(dev)[:, :3].reshape(nbc, b, 3)
        assert not pos_b.is_contiguous()
    else:
        pos_b = pos_b.to(dev)
    return (cand.to(dev), count.to(dev), qlo.to(dev), qhi.to(dev), pos_b, H, b // w)


def plain_tables(args, cap, self_lo=None, self_width=1):
    """The exact refine's tables on the plain path."""
    return tiles.refine_candidates_exact(*args, cap, self_lo=self_lo, self_width=self_width)


def kernel_keys(args):
    """The wrapper's keys and counts, one launch, against the plain path's."""
    before = refine.refine_exact_keys.launches
    got = refine.refine_exact_keys(*args)
    torch.cuda.synchronize()
    assert refine.refine_exact_keys.launches == before + 1
    return got, refine.refine_exact_keys_torch(*args)


def assert_equal(got, want, names):
    for name, g, e in zip(names, got, want):
        assert g.shape == e.shape and g.dtype == e.dtype, name
        assert torch.equal(g, e), f"{name}: {int((g != e).sum())} of {e.numel()} differ"


def assert_keys_and_tables(args, caps=None):
    """Keys and counts, then the sorted tables at each cap (by default one
    that overflows and one that does not), id for id."""
    got, want = kernel_keys(args)
    assert_equal(got, want, ("keys", "counts"))
    live = int(want[1].sum())
    assert 0 < live < want[0].numel()  # some subblocks survive, some do not
    rows, sub = args[0].shape[0], args[6]
    self_lo = torch.arange(rows, dtype=torch.int32, device=args[0].device) * sub
    for cap in caps or (max(1, int(want[1].max()) // 2), int(want[1].max()) + 3):
        t = refine.refine_candidates_exact(*args, cap, self_lo=self_lo, self_width=sub)
        assert_equal(t, plain_tables(args, cap, self_lo, sub),
                     ("cand_sub", "count_sub", "overflow"))
    return want


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,w", SHAPES)
def test_shapes_id_for_id(cuda, b, w):
    args = synthetic(1, b, w, dev=cuda)
    want = assert_keys_and_tables(args)
    counts = args[1].cpu()
    assert int(counts.min()) == 0 and int(counts.max()) == args[0].shape[1]
    assert int(want[1][0]) == 0  # the empty row


@pytest.mark.cuda
@pytest.mark.parametrize("q_rep", [2, 4])
def test_split_boxes_of_finer_query_blocks(cuda, q_rep):
    assert_keys_and_tables(synthetic(2, 128, 32, q_rep=q_rep, dev=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("b,w", [(128, 16), (128, 32)])
def test_strided_positions(cuda, b, w):
    args = synthetic(3, b, w, strided=True, dev=cuda)
    assert_keys_and_tables(args)
    contiguous = args[:4] + (args[4].contiguous(),) + args[5:]
    assert_equal(refine.refine_exact_keys(*args), refine.refine_exact_keys(*contiguous),
                 ("keys", "counts"))


@pytest.mark.cuda
def test_padding_blocks_never_survive(cuda):
    args = synthetic(4, 128, 16, pad_blocks=12, dev=cuda)
    keys, _ = refine.refine_exact_keys(*args)
    live = keys[keys != tiles.REFINE_SENTINEL] // args[6]
    assert live.numel() and int(live.max()) < args[4].shape[0] - 12
    assert_keys_and_tables(args)


@pytest.mark.cuda
def test_scatter_compaction(cuda, monkeypatch):
    monkeypatch.setenv("LIBCLSPH_TPU_COMPACT", "scatter")
    assert_keys_and_tables(synthetic(5, 128, 16, dev=cuda))


def one_ulp_case():
    """Two particles against a point box at the origin, with deficits
    (dx, 0, dz): for the first, d2 rounded as the plain test rounds it
    equals the threshold (in reach) and one fused multiply-add,
    fma(dz, dz, dx*dx), gives the next float up; for the second, d2
    rounded is one ulp above the threshold and the fused sum equals it.
    Returns ((dx, dz) twice, the threshold)."""
    cut = np.float32(H * H * 1.01)

    def round32(x: Fraction) -> np.float32:
        c = np.float32(float(x))
        near = (np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf)))
        return min(near, key=lambda v: abs(Fraction(float(v)) - x))

    up = np.nextafter(cut, np.float32(np.inf))
    found = {}
    rng = np.random.default_rng(11)
    for dx in (rng.random(4000) * 0.03 + 0.01).astype(np.float32):
        ax = dx * dx
        root = np.float32(np.sqrt(np.float64(cut) - np.float64(ax)))
        for k in range(-4, 5):
            dz = np.float32(root + np.float32(k) * np.spacing(root))
            plain = (ax + np.float32(0)) + dz * dz  # (dx*dx + dy*dy) + dz*dz
            fused = round32(Fraction(float(dz)) ** 2 + Fraction(float(ax)))
            if plain == cut and fused == up:
                found.setdefault("in", (dx, dz))
            if plain == up and fused == cut:
                found.setdefault("out", (dx, dz))
        if len(found) == 2:
            return found["in"], found["out"], cut
    raise AssertionError("no one-ulp case found")


def one_ulp_args(dev):
    """A query row with one point box at the origin and one candidate
    block whose subblock 0 holds the in-reach particle, subblock 1 the
    out-of-reach one, and every other particle far away."""
    (dxi, dzi), (dxo, dzo), _ = one_ulp_case()
    pos = torch.full((1, 128, 3), 5.0)
    pos[0, 3] = torch.tensor([dxi, 0.0, dzi])
    pos[0, 16 + 7] = torch.tensor([dxo, 0.0, dzo])
    box = torch.zeros(1, 4, 3)
    T = torch.as_tensor
    return (T([[0]], dtype=torch.int32).to(dev), T([1], dtype=torch.int32).to(dev),
            box.to(dev), box.to(dev), pos.to(dev), H, 8)


def test_one_ulp_case_on_the_plain_path():
    keys, counts = refine.refine_exact_keys(*one_ulp_args("cpu"))
    assert keys[0, 0] == 0 and keys[0, 1] == tiles.REFINE_SENTINEL and int(counts[0]) == 1


@pytest.mark.cuda
def test_threshold_one_ulp_either_side(cuda):
    got, want = kernel_keys(one_ulp_args(cuda))
    assert_equal(got, want, ("keys", "counts"))
    assert int(want[1][0]) == 1 and int(want[0][0, 0]) == 0


@pytest.mark.cuda
def test_nan_and_infinite_positions(cuda):
    """NaN in candidate particles and in query boxes, and a particle at
    -inf against a box whose lower edge is -inf (lo - p is NaN, p - hi is
    -inf: torch.maximum gives NaN, fmaxf would give -inf and keep it)."""
    cand, count, qlo, qhi, pos, h, sub = synthetic(6, 128, 16, dev=cuda)
    pos = pos.clone()
    pos[0, 5, 1] = float("nan")
    pos[1, :, 0] = float("nan")
    pos[2, 40] = float("-inf")
    qlo, qhi = qlo.clone(), qhi.clone()
    qlo[3, 2, 0] = float("nan")
    qlo[2, :, :] = float("-inf")
    qhi[2, :, :] = -1.0
    count[2] = max(int(count[2]), 3)
    cand[2, :3] = torch.tensor([2, 0, 1], dtype=torch.int32)
    args = (cand, count, qlo, qhi, pos, h, sub)
    keys, _ = assert_keys_and_tables(args)
    assert not bool((keys[2] != tiles.REFINE_SENTINEL).any())  # -inf - -inf is NaN


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ENGINE))
def test_build_candidates_one_launch(cuda, engine_cloud, name, monkeypatch):
    params, st, real = engine_cloud[name]
    st, real = st.map(lambda a: a.to(cuda)), real.to(cuda)
    cfg = step.StepConfig(**ENGINE[name])
    before = refine.refine_exact_keys.launches
    with profiling.recording():
        got = step.build_candidates(st, real, params, cfg)
        counted = profiling.snapshot()["counters"].get("refine.kernel")
    torch.cuda.synchronize()
    assert refine.refine_exact_keys.launches == before + 1 and counted == 1
    monkeypatch.setattr(refine, "refine_exact_keys", refine.refine_exact_keys_torch)
    want = step.build_candidates(st, real, params, cfg)
    assert_equal(got, want, ("cand_sub", "count_sub", "flags"))
    assert int(want[2]) == 0 and int(want[1].sum()) > 0


@pytest.fixture(scope="module")
def engine_cloud():
    """A random cloud padded and sorted on the CPU at each engine shape's
    block size: (params, state, real) by ENGINE's names."""
    n = 6000
    params = derive_parameters(WATER, dict(
        particles_count=n, particle_mass=0.05, simulation_time=1, target_fps=60,
        simulation_scale=0.1, constant_acceleration=dict(x=0, y=-9.8, z=0)))
    rng = np.random.default_rng(9)
    side = params.initial_volume ** (1 / 3) * 1.3
    pos = torch.as_tensor(((rng.random((n, 3)) - 0.5) * side).astype(np.float32))
    st = ParticleState.zeros(n, "cpu").replace(position=pos)
    out = {}
    for name, over in ENGINE.items():
        cfg = step.StepConfig(**over)
        s, real, _ = step.pad_and_sort(st, params, True, block_size=cfg.block_size)
        out[name] = (params, s, real)
    return out


@pytest.mark.parametrize("name", list(ENGINE))
def test_cpu_build_candidates_takes_the_plain_path(engine_cloud, name):
    params, st, real = engine_cloud[name]
    cfg = step.StepConfig(**ENGINE[name])
    before = refine.refine_exact_keys.launches
    with profiling.recording():
        cand_sub, count_sub, flags = step.build_candidates(st, real, params, cfg)
        counters = profiling.snapshot()["counters"]
    assert refine.refine_exact_keys.launches == before and "refine.kernel" not in counters
    assert int(flags) == 0 and int(count_sub.sum()) > 0
    assert cand_sub.shape[0] == st.n // cfg.block_size * cfg.q_rep


@pytest.mark.parametrize("b,w", SHAPES)
def test_cpu_wrapper_takes_the_plain_path(b, w):
    args = synthetic(1, b, w, strided=b == 128)
    before = refine.refine_exact_keys.launches
    with profiling.recording():
        got = refine.refine_exact_keys(*args)
        counters = profiling.snapshot()["counters"]
    assert refine.refine_exact_keys.launches == before and "refine.kernel" not in counters
    assert_equal(got, refine.refine_exact_keys_torch(*args), ("keys", "counts"))
    assert got[0].shape == (args[0].shape[0], args[6] * args[0].shape[1])


def _bad(args, which):
    cand, count, qlo, qhi, pos, h, sub = args
    if which == "cand":
        cand = cand.long()
    elif which == "count":
        count = count[:-1]
    elif which == "qlo":
        qlo = qlo.double()
    elif which == "qhi":
        qhi = qhi[:, :3]
    elif which == "boxes":
        qlo = qhi = torch.cat([qlo, qlo[:, :1]], dim=1)
    elif which == "pos_blocked":
        pos = pos[:, :32]
    elif which == "sub":
        sub = 16  # subblocks of 8
    elif which == "device":
        qlo, qhi = qlo.to("meta"), qhi.to("meta")
    return cand, count, qlo, qhi, pos, h, sub


@pytest.mark.parametrize("which", ["cand", "count", "qlo", "qhi", "boxes", "pos_blocked",
                                   "sub", "device"])
def test_wrapper_refuses(which):
    args = _bad(synthetic(1, 128, 16), which)
    with pytest.raises(ValueError, match={"boxes": "qlo", "device": "qlo"}.get(which, which)):
        refine.refine_exact_keys(*args)
