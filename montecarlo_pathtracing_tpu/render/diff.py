"""Differentiable rendering: pixel gradients w.r.t. scene parameters.

A brand-new capability (the reference is a forward-only GL renderer;
SURVEY.md §2.3 "Gradient/differentiability: None"). The dense integrator
(models/montecarlo.py) is pure JAX, so reverse-mode AD through the bounce
loop gives pixel gradients directly. Sampling is DETACHED
(detach_sampling=True puts stop_gradient on sampled directions): gradients
flow through the throughput/attenuation chain, the Schlick/spec factors
and emission — the detached-sampling path-replay estimator — while the
non-differentiable discrete decisions (hit selection, material case, the
mixed-case coin) replay identically because they only depend on the
RNG counters and comparisons. Gradients always take the dense route
(models/montecarlo.choose_route): the whole-pass kernel has no VJP, and
the dense trace keeps the geometric IOR term. Differentiable inputs:

  - per-prim albedo/alpha (scene.color), material vector
    (shininess, roughness, emissivity, area) (scene.mat)
  - the IOR slider (refract_ind) — including its geometric effect through
    the refraction directions
  - a global light_scale multiplying emissivity (the light-intensity knob;
    the reference bakes intensity into emissive materials at scene build)

`inverse_render_fit` is the BASELINE config-4 demo: recover one object's
material from a target render by gradient descent (optax.adam).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..models.registry import get_integrator
from ..scene.device import DeviceScene


class SceneParams(NamedTuple):
    """The differentiable leaves, separated from the frozen scene."""
    color: jnp.ndarray        # [N,4]
    mat: jnp.ndarray          # [N,4]
    refract_ind: jnp.ndarray  # scalar
    light_scale: jnp.ndarray  # scalar, multiplies emissivity


def params_of(scene: DeviceScene, refract_ind=1.0) -> SceneParams:
    return SceneParams(
        color=scene.color,
        mat=scene.mat,
        refract_ind=jnp.float32(refract_ind),
        light_scale=jnp.float32(1.0),
    )


def apply_params(scene: DeviceScene, p: SceneParams) -> DeviceScene:
    mat = p.mat * jnp.array([1.0, 1.0, 1.0, 1.0], jnp.float32)
    mat = mat.at[:, 2].mul(p.light_scale)
    return dataclasses.replace(scene, color=p.color, mat=mat)


@partial(jax.jit, static_argnames=("n_passes", "nb_bounces", "integrator"))
def render_mean(scene: DeviceScene, params: SceneParams, origin, dirs, tc,
                n_passes: int, nb_bounces: int,
                integrator: str = "montecarlo"):
    """Mean of n_passes progressive passes — the differentiable render.
    dirs/tc: [N,3]/[N,2] flattened rays. Returns [N,3]."""
    fn = get_integrator(integrator)
    scene = apply_params(scene, params)

    def body(k, acc):
        rgb = fn(scene, origin, dirs, tc, k,
                 nb_bounces=nb_bounces, refract_ind=params.refract_ind,
                 detach_sampling=True)
        return acc + rgb

    acc = jax.lax.fori_loop(0, n_passes, body,
                            jnp.zeros(dirs.shape[:-1] + (3,), jnp.float32))
    return acc / n_passes


def pixel_grads(scene, params, origin, dirs, tc, *, n_passes=1,
                nb_bounces=3, integrator="montecarlo"):
    """Gradient of the mean pixel luminance w.r.t. every scene parameter —
    the 'pixel-grad' quantity checked against the CPU reference
    (BASELINE.json metric)."""

    def mean_lum(p):
        img = render_mean(scene, p, origin, dirs, tc, n_passes, nb_bounces,
                          integrator)
        return img.mean()

    return jax.grad(mean_lum)(params)


def inverse_render_fit(scene, target, origin, dirs, tc, *, prim_ids,
                       steps=100, lr=5e-2, n_passes=2, nb_bounces=3,
                       fit_albedo=True, fit_alpha=False, fit_mat_cols=(),
                       fit_ior=False, fit_light=False,
                       seed_params=None, verbose=False):
    """BASELINE config 4: recover the albedo/roughness (and optionally IOR)
    of the prims in `prim_ids` from a target image by Adam descent.
    Only the selected prims' color/mat rows receive updates (a mask is
    applied to the gradients). Fit scope is masked per row AND per
    channel: by default only the albedo RGB moves. This matters — the
    4-case material logic branches on exact comparisons (alpha == 1,
    shininess == 0, tp/montecarlo.frag:141-169), so letting the optimizer
    drift shininess or alpha across a case boundary makes the loss
    landscape discontinuous. Opt in via fit_alpha / fit_mat_cols (columns
    of (shininess, roughness, emissivity, area)) / fit_ior / fit_light
    when the target genuinely differs in those. Returns (params, losses).
    """
    import optax

    p0 = seed_params if seed_params is not None else params_of(scene)
    row_mask = np.zeros((scene.color.shape[0], 1), np.float32)
    for i in prim_ids:
        row_mask[i] = 1.0
    row_mask = jnp.asarray(row_mask)
    color_ch = np.array(
        [[1.0 if fit_albedo else 0.0] * 3 + [1.0 if fit_alpha else 0.0]],
        np.float32)
    mat_ch = np.zeros((1, 4), np.float32)
    for c in fit_mat_cols:
        mat_ch[0, c] = 1.0
    color_mask = row_mask * jnp.asarray(color_ch)
    mat_mask = row_mask * jnp.asarray(mat_ch)

    def loss_fn(p):
        img = render_mean(scene, p, origin, dirs, tc, n_passes, nb_bounces,
                          "montecarlo")
        return jnp.mean((img - target) ** 2)

    opt = optax.adam(lr)
    opt_state = opt.init(p0)

    @jax.jit
    def step(p, opt_state):
        loss, g = jax.value_and_grad(loss_fn)(p)
        g = g._replace(
            color=g.color * color_mask,
            mat=g.mat * mat_mask,
            refract_ind=g.refract_ind if fit_ior else jnp.float32(0.0),
            light_scale=g.light_scale if fit_light else jnp.float32(0.0),
        )
        updates, opt_state = opt.update(g, opt_state)
        p = optax.apply_updates(p, updates)
        # keep parameters in their physical ranges
        p = p._replace(
            color=jnp.clip(p.color, 0.0, 1.0),
            mat=jnp.clip(p.mat, 0.0, jnp.array([1.0, 1.0, 1e6, 1e6])),
            refract_ind=jnp.clip(p.refract_ind, 1.0, 2.5),
        )
        return p, opt_state, loss

    p = p0
    losses = []
    for i in range(steps):
        p, opt_state, loss = step(p, opt_state)
        losses.append(float(loss))
        if verbose and i % 10 == 0:
            print(f"step {i}: loss {losses[-1]:.6f}")
    return p, losses
