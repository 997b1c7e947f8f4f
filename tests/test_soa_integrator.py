"""SoA production integrator vs the AoS reference twin: identical images
(identical RNG draws => identical paths; component math reassociates, so
the gate is allclose with a high exact-match rate)."""
import numpy as np
import jax.numpy as jnp
import pytest

from montecarlo_pathtracing_tpu.scene import scenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene
from montecarlo_pathtracing_tpu.render.camera import default_rt_camera, camera_rays
from montecarlo_pathtracing_tpu.models.montecarlo import raytrace as soa
from montecarlo_pathtracing_tpu.models.montecarlo_aos import raytrace as aos


def _rays(scene_name, w=24, h=18):
    dev = compile_scene(scenes.build(scene_name))
    proj, view = default_rt_camera(w, h)
    origin, dirs, tc = camera_rays(proj, view, w, h)
    return dev, origin, dirs.reshape(-1, 3), tc.reshape(-1, 2)


@pytest.mark.parametrize("scene_name,ior", [
    ("box_diffuse", 1.0),
    ("box_balls", 1.3),       # all 4 material cases + inner re-trace
    ("mesh_demo", 1.0),       # triangle path
])
def test_soa_matches_aos(scene_name, ior):
    dev, origin, dirs, tc = _rays(scene_name)
    for pass_index in (0, 3):
        a = np.asarray(aos(dev, origin, dirs, tc, jnp.int32(pass_index),
                           nb_bounces=5, refract_ind=jnp.float32(ior)))
        s = np.asarray(soa(dev, origin, dirs, tc, jnp.int32(pass_index),
                           nb_bounces=5, refract_ind=jnp.float32(ior)))
        close = np.all(np.abs(a - s) <= 1e-3 + 1e-3 * np.abs(a), axis=-1)
        assert close.mean() > 0.98, (
            f"{scene_name} pass {pass_index}: match {close.mean():.3f}")
        assert abs(a.mean() - s.mean()) < 2e-3
