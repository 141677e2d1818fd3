"""The port's point renderer (``libclsph_tpu_torch/io/render.py``)
against the JAX package's ``io/render.py`` on ``tests/test_render.py``'s
clouds, and the engine's ``device_view`` hook.

Both renderers take the same float32 inputs. The images must be equal;
where they are not, at most 1e-3 of the pixels may differ: a pixel can
move when the two frameworks round the camera's cosine and sine (libm
against XLA's own) or a projection differently by one ulp at a pixel
edge, and the test counts such pixels rather than ignore them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libclsph_tpu.io import render as jrender
from libclsph_tpu.io.geo_format import density_color_ramp
from libclsph_tpu_torch.core.params import derive_parameters
from libclsph_tpu_torch.engine.simulation import SPHSimulation
from libclsph_tpu_torch.engine.step import StepConfig
from libclsph_tpu_torch.io.render import PointRenderer, density_ramp, render_points
from libclsph_tpu_torch.models.presets import WATER, simulation_config
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

BG = (18, 18, 24)
MAX_DIFF_SHARE = 1e-3


def both(pos, dens, yaw, pitch, zoom, center, **kw):
    """(port image, JAX image) as NumPy."""
    pos, dens = np.asarray(pos, np.float32), np.asarray(dens, np.float32)
    t = render_points(torch.as_tensor(pos), torch.as_tensor(dens), np.float32(yaw),
                      np.float32(pitch), np.float32(zoom), np.asarray(center, np.float32),
                      **kw).numpy()
    j = np.asarray(jrender.render_points(
        jnp.asarray(pos), jnp.asarray(dens), jnp.float32(yaw), jnp.float32(pitch),
        jnp.float32(zoom), jnp.asarray(center, jnp.float32), **kw))
    return t, j


def assert_images_match(t, j):
    assert t.shape == j.shape and t.dtype == j.dtype == np.uint8
    differ = (t != j).any(axis=-1)
    assert differ.mean() <= MAX_DIFF_SHARE, f"{int(differ.sum())} of {differ.size} pixels"


def test_density_ramp_matches_export_ramp():
    d = np.linspace(-100.0, 2500.0, 997).astype(np.float32)
    np.testing.assert_allclose(density_ramp(torch.as_tensor(d)).numpy(),
                               density_color_ramp(d), atol=1e-6)


def test_single_point_and_depth_test_match_jax():
    t, j = both([[0.0, 0.0, 0.0]], [998.29], 0.0, 0.0, 2.0, np.zeros(3), width=64,
                height=48, splat=2)
    np.testing.assert_array_equal(t, j)
    assert (t[24:26, 32:34] == t[24, 32]).all() and (t[24, 32] != BG).any()
    # the nearer of two points on one pixel wins the scatter-min
    t, j = both([[0.0, 0.0, 0.0], [0.0, 0.0, -0.5]], [500.0, 1500.0], 0.0, 0.0, 2.0,
                np.zeros(3), width=64, height=48, splat=1)
    np.testing.assert_array_equal(t, j)
    got = t[24, 32].astype(np.float32) / 255.0
    np.testing.assert_allclose(got, density_color_ramp(np.array([1500.0]))[0], atol=1.5 / 63)


def test_sentinel_and_behind_camera_points_are_culled():
    pos = [[1.0e38, 1.0e38, 1.0e38], [np.nan, np.nan, np.nan], [0.0, 0.0, -5.0]]
    t, j = both(pos, [998.0] * 3, 0.0, 0.0, 2.0, np.zeros(3), width=32, height=32)
    np.testing.assert_array_equal(t, j)
    assert (t == np.array(BG, np.uint8)).all()


@pytest.mark.parametrize("splat", [1, 2, 3])
def test_cloud_matches_jax(splat):
    rng = np.random.default_rng(7)
    n = 512
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    dens = rng.uniform(0.0, 2000.0, n).astype(np.float32)
    t, j = both(pos, dens, 0.6, 0.35, 3.0, np.zeros(3), width=120, height=90, splat=splat)
    assert_images_match(t, j)
    assert (t != np.array(BG, np.uint8)).any(axis=-1).sum() > 0


@pytest.mark.parametrize("splat", [1, 2, 3])
def test_splat_sizes(splat):
    t, j = both(np.zeros((4, 3)), np.full(4, 998.0), 0.1, 0.2, 2.0, np.zeros(3), width=40,
                height=40, splat=splat)
    np.testing.assert_array_equal(t, j)
    assert (t != np.array(BG, np.uint8)).any(axis=-1).sum() == splat * splat


def test_point_renderer_matches_jax_renderer():
    """PointRenderer's own camera (auto-rotate, centroid of the live
    particles with a sentinel row ignored) on both sides."""
    rng = np.random.default_rng(9)
    pos = rng.normal(0.0, 0.3, (2000, 3)).astype(np.float32)
    pos[-1] = 1.0e38  # a sentinel row: out of the centroid, culled
    dens = rng.uniform(800.0, 1200.0, 2000).astype(np.float32)
    rt, rj = PointRenderer(width=160, height=120), jrender.PointRenderer(width=160, height=120)
    for _ in range(3):
        assert_images_match(rt.render(pos, dens), rj.render(jnp.asarray(pos),
                                                            jnp.asarray(dens)))
    assert rt.yaw == pytest.approx(rj.yaw)


def test_point_renderer_engine_hook():
    """device_view: the engine calls the hook with the device-resident
    state on the initial frame and after each of 3 frames."""
    sim = SPHSimulation(step_config=StepConfig(neighbor_impl="tiles", cand_interval=1),
                        device="cpu")
    sim.parameters = derive_parameters(
        dict(WATER), simulation_config(particles_count=512, simulation_time=3 / 60))
    sim.precomputed_terms = sim.parameters.precomputed()
    sim.initial_volume = sim.parameters.initial_volume
    sim.checkpoint_path = "no_checkpoint_here.npz"
    r = PointRenderer(width=80, height=60)
    images, devices = [], []

    def view(state, params, is_full_frame):
        devices.append(state.position.device)
        r.view(state, params, is_full_frame)

    r.on_image = images.append
    sim.device_view = view
    sim.simulate()
    assert len(images) == 4  # the initial view and one a frame
    assert all(d == sim.device for d in devices)
    for img in images:
        assert img.shape == (60, 80, 3) and img.dtype == np.uint8
        assert (img != np.array(BG, np.uint8)).any()


def test_per_substep_path_calls_the_hook_per_frame(tmp_path):
    """With write_all_frames (the per-substep path) the hook still runs
    once on the initial frame and once after each frame."""
    sim = SPHSimulation(step_config=StepConfig(neighbor_impl="tiles", cand_interval=1),
                        device="cpu")
    sim.parameters = derive_parameters(
        dict(WATER), simulation_config(particles_count=512, simulation_time=2 / 60,
                                       write_all_frames=True))
    sim.precomputed_terms = sim.parameters.precomputed()
    sim.initial_volume = sim.parameters.initial_volume
    sim.checkpoint_path = str(tmp_path / "none.npz")
    calls = []
    sim.device_view = lambda state, params, full: calls.append(torch.is_tensor(state.density))
    sim.simulate()
    assert calls == [True] * 3
