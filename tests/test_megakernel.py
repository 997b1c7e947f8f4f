"""Whole-pass Pallas-Triton kernel vs the dense SoA integrator: same images.

The kernel re-implements the full bounce loop with a bit-identical RNG
draw schedule, so the only differences are float reassociation (the
kernel fuses multiply-adds differently from XLA) — gated by allclose with
a high exact-lane rate, same protocol as the SoA-vs-AoS test. On the CPU
the kernel runs in the Pallas interpreter; chip_smoke.py compares the
compiled kernel on the card.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from montecarlo_pathtracing_tpu.scene import scenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene
from montecarlo_pathtracing_tpu.render.camera import (
    default_rt_camera, camera_rays)
from montecarlo_pathtracing_tpu.models.montecarlo import raytrace as soa
from montecarlo_pathtracing_tpu.models import megakernel as mk
from montecarlo_pathtracing_tpu.models.megakernel import (
    raytrace_mega, mega_eligible)

ANALYTIC_SCENES = ("box_diffuse", "box_balls", "menger", "box_no_top",
                   "materials", "4boules", "menger_lights", "colonnes")


def _rays(scene_name, w=24, h=18):
    dev = compile_scene(scenes.build(scene_name))
    proj, view = default_rt_camera(w, h)
    origin, dirs, tc = camera_rays(proj, view, w, h)
    return dev, origin, dirs.reshape(-1, 3), tc.reshape(-1, 2)


def _close_share(ref, got):
    return np.all(np.abs(ref - got) <= 1e-3 + 1e-3 * np.abs(ref), -1).mean()


@pytest.mark.parametrize("scene_name,ior", [
    ("box_diffuse", 1.0),     # opaque: single trace per bounce
    ("box_balls", 1.3),       # all 4 material cases + inner re-trace
    ("materials", 1.5),       # sphere/cube/cylinder/cone sweep
])
def test_megakernel_matches_soa(scene_name, ior):
    dev, origin, dirs, tc = _rays(scene_name)
    assert mega_eligible(dev)
    for pass_index in (0, 3):
        ref = np.asarray(soa(dev, origin, dirs, tc, jnp.int32(pass_index),
                             nb_bounces=4, refract_ind=jnp.float32(ior),
                             route="dense"))
        got = np.asarray(raytrace_mega(
            dev, origin, dirs, tc, jnp.int32(pass_index),
            nb_bounces=4, refract_ind=jnp.float32(ior), interpret=True))
        close = _close_share(ref, got)
        assert close > 0.98, (
            f"{scene_name} pass {pass_index}: match {close:.3f}")
        assert abs(ref.mean() - got.mean()) < 2e-3


@pytest.mark.parametrize("scene_name", ANALYTIC_SCENES)
def test_megakernel_matches_dense_demo_scene(scene_name):
    """Every analytic demo scene (the kernel's whole domain) at 16x12,
    2 bounces: culled (>= MEGA_CULL_MIN_PRIMS) and unculled folds."""
    dev, origin, dirs, tc = _rays(scene_name, 16, 12)
    ref = np.asarray(soa(dev, origin, dirs, tc, jnp.int32(1), nb_bounces=2,
                         refract_ind=jnp.float32(1.3), route="dense"))
    got = np.asarray(soa(dev, origin, dirs, tc, jnp.int32(1), nb_bounces=2,
                         refract_ind=jnp.float32(1.3), route="megakernel",
                         pallas_interpret=True))
    assert got.shape == ref.shape
    assert _close_share(ref, got) > 0.98
    assert abs(ref.mean() - got.mean()) < 2e-3


def test_megakernel_routing():
    """The route rule: an analytic scene on a GPU backend takes the
    kernel, and raytrace(route="megakernel") is exactly the kernel."""
    dev, origin, dirs, tc = _rays("box_diffuse")
    assert mega_eligible(dev)
    via_route = np.asarray(soa(
        dev, origin, dirs, tc, jnp.int32(1), nb_bounces=3,
        refract_ind=jnp.float32(1.0), route="megakernel",
        pallas_interpret=True))
    direct = np.asarray(raytrace_mega(
        dev, origin, dirs, tc, jnp.int32(1), nb_bounces=3,
        refract_ind=jnp.float32(1.0), interpret=True))
    np.testing.assert_array_equal(via_route, direct)

    mesh_dev = compile_scene(scenes.build("mesh_demo"))
    assert not mega_eligible(mesh_dev)


def test_megakernel_zero_bounces_black():
    dev, origin, dirs, tc = _rays("box_diffuse", w=8, h=8)
    got = np.asarray(raytrace_mega(
        dev, origin, dirs, tc, jnp.int32(0), nb_bounces=0,
        refract_ind=jnp.float32(1.0), interpret=True))
    assert (got == 0.0).all()


def test_megakernel_pad_columns_never_hit():
    """Regression: group-padding columns carry identity transforms; before
    the ok-flag mask the kernel traced them as phantom unit prims at the
    world origin (caught as 3 bright pixels at 96x96 on box_diffuse).
    A scene whose real geometry is far from the origin must show sky, not
    a phantom, for rays through the origin."""
    from montecarlo_pathtracing_tpu.scene.scene import (
        ScenePrimitives, Material)
    from montecarlo_pathtracing_tpu.utils.transforms import translate

    sc = ScenePrimitives()
    sc.add_cube(translate(40.0, 0.0, 0.0), Material((0.9, 0.2, 0.2, 1.0)))
    sc.add_cube(translate(-40.0, 0.0, 0.0), Material((0.2, 0.9, 0.2, 1.0)))
    dev = compile_scene(sc)
    groups, total = mk._mega_meta(dev)
    assert total > dev.nb_prims, "fixture must actually have pad columns"

    n = 2 * mk.BLOCK
    # rays from above straight down through the origin: nothing real there
    D = jnp.zeros((n, 3), jnp.float32).at[:, 2].set(-1.0)
    O = jnp.array([0.0, 0.0, 50.0], jnp.float32)
    tc = jnp.zeros((n, 2), jnp.float32)
    ref = np.asarray(soa(dev, O, D, tc, jnp.int32(0), nb_bounces=2,
                         refract_ind=jnp.float32(1.0), route="dense"))
    got = np.asarray(raytrace_mega(dev, O, D, tc, jnp.int32(0),
                                   nb_bounces=2,
                                   refract_ind=jnp.float32(1.0),
                                   interpret=True))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # and the miss must be the sky for straight-down rays, not black/phantom
    sky_low = np.array([0.5, 0.5, 0.9]) * 0.8   # attenu 0.8 * sky(d.z<0)
    np.testing.assert_allclose(ref[0], sky_low, atol=1e-5)


# -- the wrapper: ray padding and table layout -----------------------------

@pytest.mark.parametrize("n", [1, 127, 129, 1000])
def test_megakernel_ray_padding(n):
    """Any ray count pads to whole BLOCKs internally and returns exactly
    n rows, equal to the dense route's for the same rays."""
    dev, origin, dirs, tc = _rays("box_balls", 40, 25)      # 1000 rays
    dirs, tc = dirs[:n], tc[:n]
    d_rows, u, v = mk._pad_rays(jnp.asarray(dirs), jnp.asarray(tc),
                                -(-n // mk.BLOCK) * mk.BLOCK)
    assert d_rows.shape[1] % mk.BLOCK == 0 and d_rows.shape[1] - n < mk.BLOCK
    np.testing.assert_array_equal(np.asarray(d_rows[:, n:]).T,
                                  np.tile([0.0, 0.0, 1.0],
                                          (d_rows.shape[1] - n, 1)))
    got = np.asarray(raytrace_mega(dev, origin, dirs, tc, jnp.int32(2),
                                   nb_bounces=2, refract_ind=1.3,
                                   interpret=True))
    ref = np.asarray(soa(dev, origin, dirs, tc, jnp.int32(2), nb_bounces=2,
                         refract_ind=1.3, route="dense"))
    assert got.shape == (n, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_megakernel_table_padding():
    """[38, P] table over the padded groups: pad columns carry ok = 0 and
    empty AABBs; super boxes cover MEGA_SUPER-prim windows with empty
    boxes past a group's end; the per-block super order is a permutation
    of each group's supers."""
    dev = compile_scene(scenes.build("materials"))
    groups, total = mk._mega_meta(dev)
    tab = np.asarray(mk._mega_table(dev))
    assert tab.shape == (mk.N_ROWS, total)
    pid = np.concatenate([np.asarray(p) for p in dev.group_prim])
    real = pid >= 0
    assert real.sum() == dev.nb_prims and (~real).any()
    assert (tab[31] == real).all()
    assert (tab[32:35, ~real] > tab[35:38, ~real]).all()      # empty boxes
    assert (tab[32:35, real] <= tab[35:38, real]).all()
    sbb = np.asarray(mk._mega_super_boxes(dev))
    n_sup = sum(-(-c // mk.MEGA_SUPER) for _, _, c, _ in groups)
    assert sbb.shape == (6, n_sup)
    d_rows, _, _ = mk._pad_rays(jnp.ones((3 * mk.BLOCK, 3)) * 0.5,
                                jnp.zeros((3 * mk.BLOCK, 2)), 3 * mk.BLOCK)
    order = np.asarray(mk._mega_super_order(
        d_rows, jnp.zeros(3), jnp.asarray(sbb), groups))
    assert order.shape == (3, n_sup)
    for _, _, count, sstart in groups:
        nsup = -(-count // mk.MEGA_SUPER)
        for row in order[:, sstart:sstart + nsup]:
            assert sorted(row) == list(range(nsup))
