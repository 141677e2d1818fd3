"""The candidate stream and the force sums over it
(``libclsph_tpu_torch/ops/kernels/stream.py``) against the JAX package,
on the CPU (the plain versions; the CUDA kernels are held against them in
``test_torch_cuda.py``).

* The layout: ``gather_stream_torch`` at sub 8, 16 and 32 against the
  index-level contract on random lists with sentinel and dead slots, and
  the planes layout equal to the staged one transposed; then, field for
  field on every live slot, against the tiles that JAX's kernels assemble
  from gathered pack rows: the Pallas kernel of ``test_nl_layout.py:52``
  (``_tile_from_raw16`` on ``make_c16_force_pack`` rows, interpret mode)
  and ``_tile_from_raw`` on ``make_csub_packs`` + ``gather_raw``, whose
  float gid equals the stream's int32 id. Dead slots are compared by
  liveness only: JAX's dead row sits at FAR = 1e8, the stream's at +inf.
* The sums, on 4,096 particles (``clustered_state``, seed 41) over the
  q128 hit lists: ``forces_c32_stream_torch``'s ten raw sums against
  ``_nl_call(_forces_kernel ...)``'s, the call inside ``fused_forces_nl``,
  each sum within 2e-5 of its largest |value| (the port sums a_ij (x_i -
  x_j) pair by pair, JAX x_i sum(a) - sum(a x_j); ROADMAP queue 3 item
  3); their combine against ``fused_forces_nl`` within 1e-5 * max|a|.
* The modes' plain versions: accel bit for bit against
  ``forces_q128_c32_torch`` on the same lists (the same arithmetic, in
  the same chunks), planes and no-cull sums equal to the staged sums, the
  test mode's counts equal to a float32 count made with numpy, the
  zero-count control all zeros; and the wrappers' refusals.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from conftest import WATER, make_params
from libclsph_tpu.core import smoothing
from libclsph_tpu.ops.pallas import neighbor_nl as nl
from libclsph_tpu_torch import interop
from libclsph_tpu_torch.engine import step as tstep
from libclsph_tpu_torch.ops import tiles as ttiles
from libclsph_tpu_torch.ops.kernels import density, forces, stream
from test_torch_qpath import clustered_state
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

N = 4096
SEED = 41
Q128 = dict(density_sub16=False, force_sub16=False, force_sub8=False,
            force_query_rows=128, cand_interval=1, max_candidates_hit=192)
SENT = ttiles.REFINE_SENTINEL


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def cloud():
    """The sorted cloud, its q128 hit lists and force pack (the port's
    machinery), and the stream of those lists."""
    params = make_params(WATER, n=N)
    tp = interop.params_from(params)
    state = clustered_state(params, N, SEED)
    st, real, _ = tstep.pad_and_sort(interop.state_from_arrays(state, "cpu"), tp, True)
    assert st.n == N
    cfg = tstep.StepConfig(**Q128)
    cand_sub, count_sub, flags = tstep.build_candidates(st, real, tp, cfg)
    dens, hits = density.density_c32_torch(density.pos_pack(st.position, real), cand_sub,
                                           count_sub, tp, groups=1)
    cand, count, hit_flags = tstep.hit_lists(cand_sub, hits, cfg, 1)
    assert int(flags) == 0 and int(hit_flags) == 0
    pres, f8 = tstep._pressure_and_pack(st, real, dens, tp)
    st_ = stream.gather_stream_torch(f8, cand, count, 32, stream.stream_visc(tp))
    return dict(params=params, tp=tp, pos=st.position.numpy(), vel=st.velocity.numpy(),
                real=real, dens=dens, pres=pres, f8=f8, cand=cand, count=count, stream=st_)


@pytest.fixture(scope="module")
def jax_sums(cloud):
    """JAX's raw sums (nb, 10, 128) through ``_nl_call`` as
    ``fused_forces_nl`` makes them, and ``fused_forces_nl`` itself, on the
    cloud's lists, densities and pressures (interpret mode)."""
    params = cloud["params"]
    terms = params.precomputed()
    args = [jnp.asarray(cloud[k]) for k in ("pos", "vel")] + [
        jnp.asarray(cloud[k].numpy()) for k in ("dens", "pres", "real")]
    _, q_force = nl.make_query_planes(*args, 128, mass=params.particle_mass)
    _, c_force = nl.make_csub_packs(*args, mass=params.particle_mass)
    cand, count = jnp.asarray(cloud["cand"].numpy()), jnp.asarray(cloud["count"].numpy())
    cand_p, count_tiles = nl._pad_groups(cand, count)
    kernel = functools.partial(
        nl._forces_kernel, h=float(params.h), spiky=float(terms.spiky),
        visc=float(terms.viscosity), poly6_grad=float(terms.poly_6_gradient),
        poly6_lap=float(terms.poly_6_laplacian), eps=smoothing.EPSILON, r2_mxu=False)
    raw = nl._nl_call(kernel, q_force, c_force, cand_p, count_tiles, 10, True,
                      with_qrow=True)
    accel = nl.fused_forces_nl(q_force, c_force, cand, count, params, terms, args[4],
                               args[2], interpret=True)
    return np.asarray(raw), np.asarray(accel)


def _contract(f8, cand, count, sub, visc):
    """The stream by the index-level contract, in numpy: (rows, cap*sub,
    12) float32 and the live mask."""
    f8 = f8.numpy()
    cand, count = cand.numpy(), count.numpy()
    rows, cap = cand.shape
    nsub = f8.shape[0] // sub
    out = np.zeros((rows, cap * sub, 12), np.float32)
    live = np.zeros((rows, cap * sub), bool)
    for r in range(rows):
        for k in range(cap):
            for lane in range(sub):
                e = k * sub + lane
                c = int(cand[r, k])
                if k < count[r] and 0 <= c < nsub:
                    j = c * sub + lane
                    x = f8[j]
                    out[r, e, :3] = x[:3]
                    out[r, e, 3] = np.array(j, np.int32).view(np.float32)
                    out[r, e, 4:9] = x[3:8]
                    out[r, e, 9] = np.float32(visc) * x[7]
                    live[r, e] = True
                else:
                    out[r, e, :3] = np.inf
                    out[r, e, 3] = np.array(-1, np.int32).view(np.float32)
    return out, live


@pytest.mark.parametrize("sub", [8, 16, 32])
def test_gather_stream_layout_contract(sub):
    rng = np.random.default_rng(sub)
    npart = 512
    f8 = torch.as_tensor(rng.normal(size=(npart, 8)).astype(np.float32))
    rows, cap = 3, 6
    cand = rng.integers(0, npart // sub, (rows, cap)).astype(np.int32)
    cand[0, 2] = SENT  # a sentinel inside the count
    cand[1, 4:] = SENT
    count = np.array([5, 4, 0], np.int32)
    visc = 0.7123
    got = stream.gather_stream(f8, T(cand), T(count), sub, visc)
    want, live = _contract(f8, T(cand), T(count), sub, visc)
    assert got.shape == (rows, cap * sub, 12) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    planes = stream.gather_stream(f8, T(cand), T(count), sub, visc, "planes")
    assert planes.shape == (10, rows, cap * sub)
    np.testing.assert_array_equal(planes.numpy().view(np.int32),
                                  np.moveaxis(want[..., :10], -1, 0).view(np.int32))
    assert live.sum() == (4 + 4) * sub


def _pallas_tiles(assemble, raw, block_rows, fields):
    """Run ``assemble(c_ref, t)`` for the TPS tiles of each block of
    ``block_rows`` raw rows in a Pallas kernel (interpret mode, as
    test_nl_layout.py:52 runs it): (blocks, TPS, fields, 128)."""
    def kernel(c_ref, out_ref):
        for t in range(nl.TPS):
            out_ref[t] = assemble(c_ref, t)

    call = jax.jit(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((nl.TPS, fields, nl.LANES), jnp.float32),
        interpret=True))
    return np.stack([np.asarray(call(jnp.asarray(raw[b:b + block_rows])))
                     for b in range(0, raw.shape[0], block_rows)])


def _live_lists(rng, nsub, rows, cap):
    cand = rng.integers(0, nsub, (rows, cap)).astype(np.int32)
    cand[0, 3] = SENT
    count = np.array([cap - 5] + [cap] * (rows - 1), np.int32)
    return cand, count


@pytest.mark.parametrize("sub", [16, 32])
def test_gather_stream_fields_match_jax_tiles(cloud, sub):
    """Every live record holds the fields, at the lane, that JAX's tile
    assembly puts there: ``_tile_from_raw16`` (8 slots of 16 a tile, 9
    fields) or ``_tile_from_raw`` (4 slots of 32, 12 fields) on
    ``gather_raw`` rows of ``make_c16_force_pack`` / ``make_csub_packs``;
    field 8 is the float gid, equal to the stream's id."""
    params = cloud["params"]
    args = [jnp.asarray(cloud[k]) for k in ("pos", "vel")] + [
        jnp.asarray(cloud[k].numpy()) for k in ("dens", "pres", "real")]
    if sub == 16:
        pack = nl.make_c16_force_pack(*args, mass=params.particle_mass)
        per_tile, fields = nl.GROUP16, 9
        assemble = nl._tile_from_raw16
    else:
        pack = nl.make_csub_packs(*args, mass=params.particle_mass)[1]
        per_tile, fields = nl.GROUP, 12
        assemble = functools.partial(nl._tile_from_raw, nv=3)
    # the port's f8 rows from the pack's own fields (JAX rounds pm = m p /
    # rho^2 to within an ulp of force_pack's): the layout is under test
    nf = pack.shape[1] // sub
    f8 = np.asarray(pack)[:-1].reshape(N // sub, nf, sub).transpose(0, 2, 1).reshape(N, nf)
    np.testing.assert_allclose(f8[:, :8], cloud["f8"].numpy(), rtol=1e-6)
    cap = nl.TPS * per_tile  # one pallas block of raw rows a list
    cand, count = _live_lists(np.random.default_rng(sub), N // sub, 3, cap)
    raw = np.asarray(nl.gather_raw(pack, jnp.asarray(cand)))
    tiles = _pallas_tiles(assemble, raw, cap, fields)  # (rows, TPS, fields, 128)
    got = stream.gather_stream_torch(T(f8[:, :8]), T(cand), T(count), sub,
                                     stream.stream_visc(cloud["tp"])).numpy()
    k = np.arange(cap)
    live = (k[None, :] < count[:, None]) & (cand != SENT)
    # tile t = k // per_tile, lane (k % per_tile) * sub + l
    jt = tiles.reshape(3, nl.TPS, fields, per_tile, sub).transpose(0, 1, 3, 4, 2)
    jt = jt.reshape(3, cap, sub, fields)
    rec = got.reshape(3, cap, sub, 12)
    np.testing.assert_array_equal(rec[live][..., list(stream.F8_FIELDS)], jt[live][..., :8])
    np.testing.assert_array_equal(rec[live][..., 3].view(np.int32),
                                  jt[live][..., 8].astype(np.int32))
    np.testing.assert_array_equal(rec[live][..., 9], rec[live][..., 8]
                                  * np.float32(stream.stream_visc(cloud["tp"])))
    dead = rec[~live]
    assert np.isinf(dead[..., :3]).all() and (dead[..., 3].view(np.int32) == -1).all()
    assert not dead[..., 4:].any()
    # the sentinel slot resolves to JAX's dead row, at FAR
    assert (jt[0, 3, :, :3] == nl.FAR).all()


def test_stream_sums_match_jax_raw_sums(cloud, jax_sums):
    raw, _ = jax_sums
    want = raw.transpose(0, 2, 1).reshape(-1, 10)
    got = stream.forces_c32_stream(cloud["f8"], cloud["dens"], cloud["real"],
                                   cloud["stream"], cloud["count"], cloud["tp"]).numpy()
    assert got.shape == (N, 10)
    for j in range(10):
        scale = np.abs(want[:, j]).max()
        assert scale > 0
        np.testing.assert_allclose(got[:, j], want[:, j], rtol=0, atol=2e-5 * scale,
                                   err_msg=f"sum {j}")


def test_stream_combine_matches_fused_forces_nl(cloud, jax_sums):
    _, want = jax_sums
    got = stream.forces_c32_stream(cloud["f8"], cloud["dens"], cloud["real"],
                                   cloud["stream"], cloud["count"], cloud["tp"],
                                   out="accel").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_stream_modes_plain(cloud):
    """Accel bit for bit against forces_q128_c32_torch on the same lists;
    the planes' and the no-cull sums equal to the staged sums; a zero
    count sums nothing."""
    c = cloud
    args = (c["f8"], c["dens"], c["real"])
    accel = stream.forces_c32_stream_torch(*args, c["stream"], c["count"], c["tp"],
                                           out="accel")
    fused = forces.forces_q128_c32_torch(*args, c["cand"], c["count"], c["tp"])
    assert torch.equal(accel.view(torch.int32), fused.view(torch.int32))
    sums = stream.forces_c32_stream(*args, c["stream"], c["count"], c["tp"])
    planes = stream.gather_stream(c["f8"], c["cand"], c["count"], 32,
                                  stream.stream_visc(c["tp"]), "planes")
    assert torch.equal(stream.forces_c32_stream(*args, planes, c["count"], c["tp"],
                                                layout="planes"), sums)
    assert torch.equal(stream.forces_c32_stream(*args, c["stream"], c["count"], c["tp"],
                                                cull=False), sums)
    zero = stream.forces_c32_stream(*args, c["stream"], torch.zeros_like(c["count"]),
                                    c["tp"])
    assert not zero.any()


def test_stream_test_counts_equal_a_float32_count(cloud):
    got = stream.forces_c32_stream(cloud["f8"], cloud["dens"], cloud["real"],
                                   cloud["stream"], cloud["count"], cloud["tp"],
                                   out="test").numpy()
    pos = cloud["pos"]
    cand, count = cloud["cand"].numpy(), cloud["count"].numpy()
    h2 = np.float32(cloud["tp"].h * cloud["tp"].h)
    want = np.zeros(N, np.int64)
    for b in range(N // 128):
        ids = (cand[b, :count[b]].astype(np.int64)[:, None] * 32 + np.arange(32)).ravel()
        d = pos[b * 128:(b + 1) * 128, None, :] - pos[None, ids, :]
        r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        want[b * 128:(b + 1) * 128] = (r2 < h2).sum(axis=1)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert want.sum() > N  # more than the self pairs


def test_stream_wrappers_refuse_and_count_no_cpu_launch(cloud):
    c = cloud
    args = (c["f8"], c["dens"], c["real"], c["stream"], c["count"], c["tp"])
    before = (stream.gather_stream.launches, stream.forces_c32_stream.launches)
    stream.forces_c32_stream(*args)
    stream.gather_stream(c["f8"], c["cand"], c["count"], 32, 1.0)
    assert (stream.gather_stream.launches, stream.forces_c32_stream.launches) == before
    with pytest.raises(ValueError, match="no mode"):
        stream.forces_c32_stream(*args, layout="planes", out="accel")
    with pytest.raises(ValueError, match="no mode"):
        stream.forces_c32_stream(*args, cull=False, out="test")
    with pytest.raises(ValueError, match="count"):
        stream.forces_c32_stream(*args[:4], c["count"][:-1], c["tp"])
    with pytest.raises(ValueError, match="stream"):
        stream.forces_c32_stream(*args[:3], c["stream"][:, :-32], *args[4:])
    with pytest.raises(ValueError, match="sub"):
        stream.gather_stream(c["f8"], c["cand"], c["count"], 64, 1.0)
    with pytest.raises(ValueError, match="layout"):
        stream.gather_stream(c["f8"], c["cand"], c["count"], 32, 1.0, "tiles")
