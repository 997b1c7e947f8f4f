"""Renderer: determinism, accumulation protocol, checkpoint/resume,
integrator carousel (montecarlo.cpp:420-476 analog)."""
import os

import numpy as np
import pytest

from montecarlo_pathtracing_tpu.scene import scenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene
from montecarlo_pathtracing_tpu.render.renderer import RenderConfig, Renderer


@pytest.fixture(scope="module")
def box_scene():
    return compile_scene(scenes.build("box_diffuse"))


def _renderer(box_scene, **kw):
    kw.setdefault("width", 32)
    kw.setdefault("height", 24)
    kw.setdefault("nb_bounces", 3)
    cfg = RenderConfig(**kw)
    return Renderer(box_scene, cfg)


def test_deterministic_across_runs(box_scene):
    r1 = _renderer(box_scene)
    r2 = _renderer(box_scene)
    img1 = r1.run(4)
    img2 = r2.run(4)
    np.testing.assert_array_equal(img1, img2)


def test_progressive_mean_is_mean_of_passes(box_scene):
    """acc/n after n passes == mean of the n individual pass images."""
    r = _renderer(box_scene)
    singles = []
    for k in range(3):
        prev = np.asarray(r._acc).copy()
        r.render_pass()
        singles.append(np.asarray(r._acc) - prev)
    img = r.image()
    want = (sum(singles) / 3.0).reshape(-1, 3)[: r._npix].reshape(24, 32, 3)
    np.testing.assert_allclose(img, want, rtol=1e-5, atol=1e-6)


def test_passes_differ(box_scene):
    """Distinct pass indices give distinct (decorrelated) noise."""
    r = _renderer(box_scene)
    r.render_pass()
    a = np.asarray(r._acc).copy()
    r.render_pass()
    b = np.asarray(r._acc) - a
    assert not np.array_equal(a, b)


def test_checkpoint_resume(box_scene, tmp_path):
    r1 = _renderer(box_scene)
    r1.run(3)
    ck = str(tmp_path / "state.npz")
    r1.save_checkpoint(ck)
    r1.run(6)

    r2 = _renderer(box_scene)
    r2.load_checkpoint(ck)
    assert r2.nb_passes == 3
    r2.run(6)
    np.testing.assert_array_equal(r1.image(), r2.image())


def test_checkpoint_config_mismatch_rejected(box_scene, tmp_path):
    r1 = _renderer(box_scene)
    r1.run(1)
    ck = str(tmp_path / "state.npz")
    r1.save_checkpoint(ck)
    r2 = _renderer(box_scene, nb_bounces=5)
    with pytest.raises(ValueError):
        r2.load_checkpoint(ck)


def test_reset_clears_accumulation(box_scene):
    r = _renderer(box_scene)
    r.run(2)
    r.reset()
    assert r.nb_passes == 0
    assert float(np.abs(np.asarray(r._acc)).max()) == 0.0


def test_batched_multipass_matches_singles(box_scene):
    """run() with passes_per_call>1 must accumulate exactly what the
    single-pass path does (same RNG pass indices)."""
    r_batched = _renderer(box_scene, passes_per_call=4)
    img_b = r_batched.run(8)
    r_single = _renderer(box_scene, passes_per_call=1)
    img_s = r_single.run(8)
    np.testing.assert_array_equal(img_b, img_s)


def test_tiled_rendering_matches_untiled(box_scene):
    cfg_small_tile = RenderConfig(width=32, height=24, nb_bounces=3,
                                  tile_rays=256)
    r_tiled = Renderer(box_scene, cfg_small_tile)
    r_flat = _renderer(box_scene)
    np.testing.assert_array_equal(r_tiled.run(2), r_flat.run(2))


def test_subsampling_halves_resolution(box_scene):
    cfg = RenderConfig(width=64, height=48, nb_bounces=1, subsampling=1)
    r = Renderer(box_scene, cfg)
    img = r.run(1)
    assert img.shape == (24, 32, 3)


def test_stub_integrators_run(box_scene):
    for name in ("montecarlo_mat", "montecarlo_mat_tr"):
        cfg = RenderConfig(width=16, height=16, integrator=name)
        img = Renderer(box_scene, cfg).run(2)
        assert np.isfinite(img).all()
        assert img.max() > 0.0


def test_light_intensity_scales_brightness():
    dim = compile_scene(scenes.build("box_diffuse", light_intensity=0.4))
    bright = compile_scene(scenes.build("box_diffuse", light_intensity=1.2))
    cfg = RenderConfig(width=24, height=24, nb_bounces=3)
    i_dim = Renderer(dim, cfg).run(8)
    i_bright = Renderer(bright, cfg).run(8)
    assert i_bright.mean() > i_dim.mean() * 1.5


def test_screen_tc_is_host_ieee(box_scene):
    """The renderer's per-pixel screen coordinates are the host's IEEE
    float32 (x+.5)/W bit for bit (W = 30: inexact divisions), whatever
    device renders: they seed each pixel's RNG stream by their bits."""
    from montecarlo_pathtracing_tpu.render.camera import camera_rays_np
    r = _renderer(box_scene, width=30, height=10)
    tc = np.asarray(r._tc).reshape(-1, 2)[: r._npix][r._inv_perm]
    _, _, want = camera_rays_np(r.proj, r.view, 30, 10)
    np.testing.assert_array_equal(tc.view(np.uint32),
                                  want.reshape(-1, 2).view(np.uint32))


def test_one_ulp_of_screen_tc_changes_the_path(box_scene):
    """Why screen_tc must be exact: one ulp in a pixel's coordinate gives
    it an unrelated random stream, so every pixel whose path reaches the
    light within 4 bounces (one in eight here) changes: a device-side
    division that is an ulp off renders a different image, not a rounding
    difference."""
    import jax.numpy as jnp
    from montecarlo_pathtracing_tpu.models.montecarlo import raytrace
    from montecarlo_pathtracing_tpu.render.camera import (
        camera_rays_np, default_rt_camera)
    proj, view = default_rt_camera(16, 12)
    o, d, tc = camera_rays_np(proj, view, 16, 12)
    d, tc = d.reshape(-1, 3), tc.reshape(-1, 2)
    tc_ulp = np.nextafter(tc, np.float32(1.0))
    kw = dict(nb_bounces=4, refract_ind=1.0, route="dense")
    a = np.asarray(raytrace(box_scene, o, jnp.asarray(d), jnp.asarray(tc),
                            0, **kw))
    b = np.asarray(raytrace(box_scene, o, jnp.asarray(d),
                            jnp.asarray(tc_ulp), 0, **kw))
    changed = np.any(np.abs(a - b) > 1e-3, axis=-1).mean()
    assert changed > 0.05, changed
