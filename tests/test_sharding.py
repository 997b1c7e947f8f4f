"""Multi-device sharding on the 8-way virtual CPU mesh (conftest sets
xla_force_host_platform_device_count=8): sharded render must be
bit-identical to single-device (per-pixel seeds are pure functions of
(uv, pass) — SURVEY.md §2.3)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from montecarlo_pathtracing_tpu.scene import scenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene
from montecarlo_pathtracing_tpu.render.camera import default_rt_camera, camera_rays
from montecarlo_pathtracing_tpu.models.registry import get_integrator
from montecarlo_pathtracing_tpu.parallel.sharding import (
    make_mesh, shard_rays, make_sharded_pass, make_sample_sharded_pass)


@pytest.fixture(scope="module")
def setup():
    assert len(jax.devices()) == 8, "conftest should give 8 CPU devices"
    dev = compile_scene(scenes.build("box_diffuse"))
    w, h = 32, 16
    proj, view = default_rt_camera(w, h)
    origin, dirs, tc = camera_rays(proj, view, w, h)
    return dev, origin, dirs.reshape(-1, 3), tc.reshape(-1, 2)


def _single_device_pass(dev, origin, dirs, tc, pass_index):
    integrator = get_integrator("montecarlo")
    return np.asarray(integrator(
        dev, origin, dirs, tc, jnp.int32(pass_index),
        nb_bounces=3, refract_ind=jnp.float32(1.0)))


def test_pixel_sharded_matches_single(setup):
    dev, origin, dirs, tc = setup
    mesh = make_mesh(8)
    sdirs, stc, pad = shard_rays(mesh, dirs, tc)
    fn = make_sharded_pass(mesh, nb_bounces=3)
    acc = jnp.zeros((pad, 3), jnp.float32,
                    device=jax.sharding.NamedSharding(
                        mesh, jax.sharding.PartitionSpec("rays")))
    acc = fn(dev, acc, sdirs, stc, origin, jnp.int32(0), jnp.float32(1.0))
    got = np.asarray(acc)[: dirs.shape[0]]
    want = _single_device_pass(dev, origin, dirs, tc, 0)
    np.testing.assert_array_equal(got, want)


def test_sample_sharded_psum_matches_sequential(setup):
    dev, origin, dirs, tc = setup
    mesh = make_mesh(8, axis_name="spp")
    fn = make_sample_sharded_pass(mesh, nb_bounces=3)
    got = np.asarray(fn(dev, dirs, tc, origin, jnp.int32(0),
                        jnp.float32(1.0)))
    want = sum(_single_device_pass(dev, origin, dirs, tc, k)
               for k in range(8))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_two_device_mesh_also_works(setup):
    dev, origin, dirs, tc = setup
    mesh = make_mesh(2)
    sdirs, stc, pad = shard_rays(mesh, dirs, tc)
    fn = make_sharded_pass(mesh, nb_bounces=2)
    acc = jnp.zeros((pad, 3), jnp.float32,
                    device=jax.sharding.NamedSharding(
                        mesh, jax.sharding.PartitionSpec("rays")))
    acc = fn(dev, acc, sdirs, stc, origin, jnp.int32(1), jnp.float32(1.0))
    assert np.isfinite(np.asarray(acc)).all()


def test_renderer_shard_devices_matches_single(setup):
    """Renderer(shard_devices=8) must produce the identical image."""
    from montecarlo_pathtracing_tpu.render.renderer import (
        RenderConfig, Renderer)
    dev, *_ = setup
    base = Renderer(dev, RenderConfig(width=32, height=16, nb_bounces=3))
    img0 = base.run(2)
    sharded = Renderer(dev, RenderConfig(width=32, height=16, nb_bounces=3,
                                         shard_devices=8))
    img1 = sharded.run(2)
    np.testing.assert_array_equal(img0, img1)


# ---------------------------------------------------------------------------
# the whole-pass kernel under pixel sharding, the route analytic GPU renders
# take (interpret mode on the CPU mesh): bit-identical to single-device
# ---------------------------------------------------------------------------

ROUTES = [
    ("megakernel", "box_diffuse",
     dict(route="megakernel", pallas_interpret=True)),
]


@pytest.mark.parametrize("label,scene_name,route",
                         ROUTES, ids=[r[0] for r in ROUTES])
def test_production_route_sharded_matches_single(label, scene_name, route):
    dev = compile_scene(scenes.build(scene_name))
    w, h = 32, 16
    proj, view = default_rt_camera(w, h)
    origin, dirs, tc = camera_rays(proj, view, w, h)
    dirs = dirs.reshape(-1, 3)
    tc = tc.reshape(-1, 2)
    mesh = make_mesh(8)
    sdirs, stc, pad = shard_rays(mesh, dirs, tc)
    fn = make_sharded_pass(mesh, nb_bounces=3, **route)
    acc = jnp.zeros((pad, 3), jnp.float32,
                    device=jax.sharding.NamedSharding(
                        mesh, jax.sharding.PartitionSpec("rays")))
    acc = fn(dev, acc, sdirs, stc, origin, jnp.int32(0), jnp.float32(1.0))
    got = np.asarray(acc)[: dirs.shape[0]]
    integrator = get_integrator("montecarlo")
    want = np.asarray(integrator(
        dev, origin, jnp.asarray(dirs), jnp.asarray(tc), jnp.int32(0),
        nb_bounces=3, refract_ind=jnp.float32(1.0), **route))
    np.testing.assert_array_equal(got, want)
