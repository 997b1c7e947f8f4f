"""Differentiable path: finite-difference checks of pixel gradients w.r.t.
albedo / emissivity / roughness / IOR, and a tiny inverse-rendering fit
(SURVEY.md §4 'Gradient tests'; BASELINE config 4)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from montecarlo_pathtracing_tpu.scene import scenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene
from montecarlo_pathtracing_tpu.render.camera import default_rt_camera, camera_rays
from montecarlo_pathtracing_tpu.render.diff import (
    SceneParams, params_of, render_mean, pixel_grads, inverse_render_fit)


@pytest.fixture(scope="module")
def setup():
    dev = compile_scene(scenes.build("box_diffuse"))
    w, h = 16, 12
    proj, view = default_rt_camera(w, h)
    origin, dirs, tc = camera_rays(proj, view, w, h)
    return dev, origin, dirs.reshape(-1, 3), tc.reshape(-1, 2)


# NB: paths that exhaust the bounce cap return BLACK (the reference quirk,
# tp/montecarlo.frag:178), so in the closed box scene only paths that reach
# the light carry any signal — gradient tests need enough bounces/passes to
# be non-vacuous (asserted below).
N_PASSES, N_BOUNCES = 2, 6


def _mean_lum(dev, params, origin, dirs, tc):
    return float(render_mean(dev, params, origin, dirs, tc,
                             N_PASSES, N_BOUNCES).mean())


def _fd_check(dev, origin, dirs, tc, mutate, grad_pick, eps, rtol):
    p0 = params_of(dev)
    g = pixel_grads(dev, p0, origin, dirs, tc, n_passes=N_PASSES,
                    nb_bounces=N_BOUNCES)
    analytic = float(grad_pick(g))
    f_plus = _mean_lum(dev, mutate(p0, +eps), origin, dirs, tc)
    f_minus = _mean_lum(dev, mutate(p0, -eps), origin, dirs, tc)
    fd = (f_plus - f_minus) / (2 * eps)
    assert np.isfinite(analytic)
    assert analytic != 0.0, "vacuous gradient test (no light-carrying path)"
    assert abs(analytic - fd) <= rtol * max(abs(fd), 1e-4), (
        f"analytic {analytic} vs fd {fd}")


def test_grad_albedo(setup):
    dev, origin, dirs, tc = setup
    # red channel of the floor quad (prim after emissive sort; use a quad)
    idx = 1

    def mutate(p, e):
        return p._replace(color=p.color.at[idx, 0].add(e))

    _fd_check(dev, origin, dirs, tc, mutate,
              lambda g: g.color[idx, 0], eps=1e-2, rtol=0.05)


def test_grad_emissivity_and_light_scale(setup):
    dev, origin, dirs, tc = setup
    emissive_idx = 0   # emissives sorted first

    def mutate(p, e):
        return p._replace(mat=p.mat.at[emissive_idx, 2].add(e))

    _fd_check(dev, origin, dirs, tc, mutate,
              lambda g: g.mat[emissive_idx, 2], eps=1e-2, rtol=0.05)

    # light_scale must equal emissivity-grad x emissivity (chain rule)
    p0 = params_of(dev)
    g = pixel_grads(dev, p0, origin, dirs, tc, n_passes=N_PASSES,
                    nb_bounces=N_BOUNCES)
    assert float(g.light_scale) != 0.0


def test_grad_roughness_finite(setup):
    """Roughness grads exist through the spec exponent; with detached
    sampling the direction term is excluded, so FD only loosely brackets
    the analytic value — assert finiteness and sign-scale sanity."""
    dev, origin, dirs, tc = setup
    p0 = params_of(dev)
    g = pixel_grads(dev, p0, origin, dirs, tc, n_passes=N_PASSES,
                    nb_bounces=N_BOUNCES)
    assert np.isfinite(np.asarray(g.mat)).all()
    assert float(np.abs(np.asarray(g.mat)[:, 1]).max()) > 0.0


def test_grad_ior_finite(setup):
    dev, origin, dirs, tc = setup
    p0 = params_of(dev)
    g = pixel_grads(dev, p0, origin, dirs, tc, n_passes=N_PASSES,
                    nb_bounces=N_BOUNCES)
    assert np.isfinite(float(g.refract_ind))


def test_inverse_rendering_recovers_albedo(setup):
    """Config-4 miniature: perturb one cube's albedo, recover it."""
    dev, origin, dirs, tc = setup
    p_true = params_of(dev)
    target = render_mean(dev, p_true, origin, dirs, tc, 2, 6)

    # find a white cube prim (type CUBE = 2 in the groups)
    cube_prim = int(np.asarray(dev.group_prim[dev.group_codes.index(2)])[0])
    p_wrong = p_true._replace(
        color=p_true.color.at[cube_prim, :3].set(
            jnp.array([0.1, 0.6, 0.2])))

    p_fit, losses = inverse_render_fit(
        dev, target, origin, dirs, tc, prim_ids=[cube_prim],
        steps=60, lr=5e-2, n_passes=2, nb_bounces=6,
        seed_params=p_wrong)
    assert losses[-1] < losses[0] * 0.2, losses[::10]
    got = np.asarray(p_fit.color[cube_prim, :3])
    want = np.asarray(p_true.color[cube_prim, :3])
    assert np.abs(got - want).max() < 0.15, (got, want)


@pytest.mark.slow
def test_grad_matches_cpu_oracle_fd(setup):
    """Pixel-gradient parity vs the INDEPENDENT CPU oracle: central
    finite differences of the oracle's render w.r.t. one albedo channel
    must match the framework's AD gradient (the BASELINE 'pixel-grad
    allclose vs CPU ref' metric). Identical RNG counters mean both sides
    integrate the same paths, so FD noise cancels."""
    from montecarlo_pathtracing_tpu.scene import scenes as sc
    from montecarlo_pathtracing_tpu.testing.cpu_ref import CPUReference
    from montecarlo_pathtracing_tpu.render.camera import default_rt_camera

    w, h, spp, bounces = 12, 10, 1, 6
    prims = sc.build("box_diffuse")
    dev = compile_scene(prims)          # sorts emissives in place
    proj, view = default_rt_camera(w, h)
    origin, dirs, tc = camera_rays(proj, view, w, h)
    dirs, tc = dirs.reshape(-1, 3), tc.reshape(-1, 2)

    idx, ch = 1, 0   # a wall quad's red channel
    g = pixel_grads(dev, params_of(dev), origin, dirs, tc,
                    n_passes=spp, nb_bounces=bounces)
    analytic = float(g.color[idx, ch])

    eps = 2e-2
    vals = []
    for sign in (+1.0, -1.0):
        oracle = CPUReference(prims)
        old = prims.prims[idx].color[ch]
        prims.prims[idx].color[ch] = np.float32(old + sign * eps)
        img = oracle.render(proj, view, w, h, spp, bounces, 1.0)
        prims.prims[idx].color[ch] = old
        vals.append(float(img.mean()))
    fd = (vals[0] - vals[1]) / (2 * eps)
    assert analytic != 0.0
    assert abs(analytic - fd) <= 0.15 * max(abs(fd), 1e-3), (
        f"AD {analytic} vs oracle FD {fd}")


def test_ior_grad_keeps_geometric_term():
    """Gradients always take the dense route (the kernel has no VJP), and
    the dense trace is differentiated, so on a refractive scene the IOR
    gradient carries its geometric term through the refraction march —
    nonzero and finite, and routed dense even when a GPU is present."""
    from montecarlo_pathtracing_tpu.models.montecarlo import (
        raytrace, choose_route)

    dev = compile_scene(scenes.build("box_balls"))
    w, h = 24, 18
    proj, view = default_rt_camera(w, h)
    origin, dirs, tc = camera_rays(proj, view, w, h)
    dirs, tc = jnp.asarray(dirs.reshape(-1, 3)), jnp.asarray(
        tc.reshape(-1, 2))

    def lum(ior):
        img = raytrace(dev, origin, dirs, tc, 0, nb_bounces=6,
                       refract_ind=ior, detach_sampling=True)
        return img.mean()

    g = float(jax.grad(lum)(jnp.float32(1.35)))
    assert np.isfinite(g) and abs(g) > 1e-7, g
    import unittest.mock
    with unittest.mock.patch.object(jax, "default_backend", lambda: "gpu"):
        assert choose_route(dev, differentiable=True) == "dense"
