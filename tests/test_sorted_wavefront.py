"""Inter-bounce ray sorting (ops/sort_rays.py): the sorted wavefront must
render the same image as the unsorted one — sorting is a pure lane
permutation, so winners are unchanged. Differences are bounded by XLA
fusing fma differently between the two programs (<= a few ulp)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from montecarlo_pathtracing_tpu.scene import scenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene
from montecarlo_pathtracing_tpu.render.camera import default_rt_camera, camera_rays
from montecarlo_pathtracing_tpu.models.montecarlo import raytrace
from montecarlo_pathtracing_tpu.ops.sort_rays import (
    ray_sort_key, DEAD_KEY, PARK_Z)


def _rays(w=64, h=48):
    proj, view = default_rt_camera(w, h)
    O, D, tc = camera_rays(proj, view, w, h)
    return O, jnp.asarray(D.reshape(-1, 3)), jnp.asarray(tc.reshape(-1, 2))


@pytest.mark.parametrize("scene_name", ["box_balls", "mesh_demo"])
def test_sorted_matches_unsorted_dense(scene_name):
    dev = compile_scene(scenes.build(scene_name))
    O, D, tc = _rays()
    a = raytrace(dev, O, D, tc, 3, nb_bounces=5, refract_ind=1.3,
                 sort_rays=False)
    b = raytrace(dev, O, D, tc, 3, nb_bounces=5, refract_ind=1.3,
                 sort_rays=True)
    # the two programs differ (sort/gather ops present), so XLA contracts
    # fma differently; a 1-ulp normal difference compounds through 5
    # chaotic bounces to ~1e-5 on a few lanes (measured 6/9216 lanes)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-3, atol=1e-4)


def test_sorted_matches_unsorted_pallas_interpret():
    """On the dense route over a ~900-prim scene (colonnes): the sorted
    wavefront changes which lanes are neighbours; winners must not move."""
    dev = compile_scene(scenes.build("colonnes"))
    O, D, tc = _rays(48, 32)
    a = raytrace(dev, O, D, tc, 1, nb_bounces=3, refract_ind=1.0,
                 route="dense", sort_rays=False)
    b = raytrace(dev, O, D, tc, 1, nb_bounces=3, refract_ind=1.0,
                 route="dense", sort_rays=True)
    # XLA contracts fma differently in the two programs (the sorted one
    # carries gathers): measured 3.6e-6 on 3 of 4608 values, a few ulp
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-5, atol=1e-5)


def test_sort_key_octant_and_dead():
    n = 8
    z = jnp.zeros((n,), jnp.float32)
    o = (z, z, z)
    d = (jnp.array([1., -1., 1., -1., 1., -1., 1., -1.]),
         jnp.array([1., 1., -1., -1., 1., 1., -1., -1.]),
         jnp.array([1., 1., 1., 1., -1., -1., -1., -1.]))
    done = jnp.zeros((n,), bool).at[3].set(True)
    lo = jnp.array([-1., -1., -1.])
    hi = jnp.array([1., 1., 1.])
    key = np.asarray(ray_sort_key(o, d, done, lo, hi))
    # same origin: keys ordered by direction octant (bits z,y,x from d>0)
    octs = key >> 27
    assert octs[0] == 0b111 and octs[4] == 0b110 and octs[7] == 0b000
    assert key[3] == DEAD_KEY
    # live keys are strictly below DEAD_KEY
    assert all(k < DEAD_KEY for i, k in enumerate(key) if i != 3)


def test_parked_rays_miss_everything():
    """A parked ray (origin above every scene AABB, +z) must fail every
    slab test, so it can never hit anything."""
    dev = compile_scene(scenes.build("box_diffuse"))
    lo = np.asarray(jnp.min(dev.prim_bb_min, axis=0))
    hi = np.asarray(jnp.max(dev.prim_bb_max, axis=0))
    assert PARK_Z > hi[2]
    o = np.array([0.0, 0.0, PARK_Z])
    d = np.array([0.0, 0.0, 1.0])
    # slab parameters to reach any box are negative -> tmax < 0 <= tmin
    for bb_lo, bb_hi in ((lo, hi),):
        t1 = (bb_lo[2] - o[2]) / d[2]
        t2 = (bb_hi[2] - o[2]) / d[2]
        assert max(t1, t2) < 0.0
