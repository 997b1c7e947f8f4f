"""Hemisphere sampling, ONB orientation, Schlick reflectance.

Reimplements the integrator's sampling routines
(reference tp/montecarlo.frag:49-98 and tp/hsphere.vert) as vectorized
JAX functions over explicit RNG counter state. Also includes the two
deliberately-wrong samplers (tp/hsphere_wrong_sampling.vert,
tp/hsphere_wrong2_sampling.vert) kept as negative controls for the
statistics tests, exactly as the reference keeps them in its O/P carousel.

All functions take/return the uint32 [...,3] counter state from ops.rng and
draw in the exact order of the scalar GLSL so streams stay bit-identical.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from . import rng
from ..utils.transforms import normalize, PRECISION, dot3

PI = np.float32(2.0 * np.arccos(0.0))  # raytracer_func.frag:9


def sample_hemisphere(state, roughness):
    """Beckmann-like roughness-driven hemisphere sample
    (tp/montecarlo.frag:49-70).

    alpha = roughness^2;  beta = 2*pi*u1;
    tan^2(theta) = -alpha^2 * ln(1 - u2);  phi uniform.
    Draws exactly 2 randoms, in this order. Returns (dir [...,3], state).
    """
    alpha = roughness * roughness
    u1, state = rng.uniform(state)
    beta = 2.0 * PI * u1
    u2, state = rng.uniform(state)
    tan_theta2 = -(alpha * alpha) * jnp.log(1.0 - u2)
    cos_theta = 1.0 / jnp.sqrt(1.0 + tan_theta2)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    local = jnp.stack(
        [jnp.cos(beta) * sin_theta, jnp.sin(beta) * sin_theta, cos_theta],
        axis=-1,
    )
    return normalize(local), state


def orient_frame(d):
    """ONB around direction d via the fixed non-collinear
    W = normalize((D.x, D.y+5, D.z+3)) (tp/montecarlo.frag:82-86).

    Returns the 3x3 change-of-basis matrix M = [U V D] as [..., 3, 3]
    (columns U, V, D), so world = M @ local.
    """
    w = normalize(
        jnp.stack([d[..., 0], d[..., 1] + 5.0, d[..., 2] + 3.0], axis=-1)
    )
    u = normalize(jnp.cross(d, w))
    v = normalize(jnp.cross(d, u))
    return jnp.stack([u, v, d], axis=-1)


def random_ray(state, d, roughness):
    """Sample a direction about d with the given roughness param
    (tp/montecarlo.frag:72-89). Draws exactly 2 randoms.
    """
    m = orient_frame(d)
    local, state = sample_hemisphere(state, roughness)
    out = jnp.einsum("...ij,...j->...i", m, local, precision=PRECISION)
    return normalize(out), state


def schlick(i, n, refract_ind):
    """rSchlick(I, N) (tp/montecarlo.frag:91-98): r0 from the IOR slider,
    x = 1 - dot(N, I), clamp(r0 + (1-r0)*x^5, 0, 1)."""
    r0 = (refract_ind - 1.0) / (refract_ind + 1.0)
    r0 = r0 * r0
    x = 1.0 - dot3(n, i)
    x5 = x * x * x * x * x
    return jnp.clip(r0 + (1.0 - r0) * x5, 0.0, 1.0)


def sample_hemisphere_masked(state, roughness, mask):
    """Masked-lane variant: draws for every lane, advances counters only
    where `mask` — reproduces the scalar GLSL draw schedule under SIMD
    (a lane that would not reach this call keeps its counter)."""
    alpha = roughness * roughness
    u1, state = rng.uniform_masked(state, mask)
    beta = 2.0 * PI * u1
    u2, state = rng.uniform_masked(state, mask)
    tan_theta2 = -(alpha * alpha) * jnp.log(1.0 - u2)
    cos_theta = 1.0 / jnp.sqrt(1.0 + tan_theta2)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    local = jnp.stack(
        [jnp.cos(beta) * sin_theta, jnp.sin(beta) * sin_theta, cos_theta],
        axis=-1,
    )
    return normalize(local), state


def random_ray_masked(state, d, roughness, mask):
    """Masked-lane random_ray: 2 draws, advanced only where `mask`."""
    m = orient_frame(d)
    local, state = sample_hemisphere_masked(state, roughness, mask)
    out = jnp.einsum("...ij,...j->...i", m, local, precision=PRECISION)
    return normalize(out), state


# ---------------------------------------------------------------------------
# SoA variants (vec3 = tuple of [N] arrays; see ops/vec.py). Bit-equal draw
# schedule to the AoS versions; used by the SoA integrator.
# ---------------------------------------------------------------------------

def sample_hemisphere_soa(state, roughness, mask):
    """SoA masked hemisphere sample; returns (vec3, state)."""
    from . import vec
    alpha = roughness * roughness
    u1, state = rng.uniform_masked_soa(state, mask)
    beta = 2.0 * PI * u1
    u2, state = rng.uniform_masked_soa(state, mask)
    tan_theta2 = -(alpha * alpha) * jnp.log(1.0 - u2)
    cos_theta = 1.0 / jnp.sqrt(1.0 + tan_theta2)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    local = (jnp.cos(beta) * sin_theta, jnp.sin(beta) * sin_theta,
             cos_theta)
    return vec.normalize(local), state


def random_ray_soa(state, d, roughness, mask):
    """SoA masked random_ray: ONB about d (tp/montecarlo.frag:72-89)."""
    from . import vec
    w = vec.normalize((d[0], d[1] + 5.0, d[2] + 3.0))
    u = vec.normalize(vec.cross(d, w))
    v = vec.normalize(vec.cross(d, u))
    local, state = sample_hemisphere_soa(state, roughness, mask)
    out = (
        u[0] * local[0] + v[0] * local[1] + d[0] * local[2],
        u[1] * local[0] + v[1] * local[1] + d[1] * local[2],
        u[2] * local[0] + v[2] * local[1] + d[2] * local[2],
    )
    return vec.normalize(out), state


def schlick_soa(i, n, refract_ind):
    from . import vec
    r0 = (refract_ind - 1.0) / (refract_ind + 1.0)
    r0 = r0 * r0
    x = 1.0 - vec.dot(n, i)
    x5 = x * x * x * x * x
    return jnp.clip(r0 + (1.0 - r0) * x5, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Wrong-sampler foils (negative controls for the statistics tests)
# ---------------------------------------------------------------------------

def sample_hemisphere_wrong(state, roughness=None):
    """normalize(rand^3 in [0,1]^3) — tp/hsphere_wrong_sampling.vert:11."""
    v, state = rng.uniform3(state)
    return normalize(v), state


def sample_hemisphere_wrong2(state, roughness=None):
    """normalize(2*rand^3 - 1) — tp/hsphere_wrong2_sampling.vert:11."""
    v, state = rng.uniform3(state)
    return normalize(2.0 * v - 1.0), state


def random_ray_wrong(state, d, roughness=None, which=1):
    """Foil variants skip the ONB (they return the raw sample), matching
    tp/hsphere_wrong*_sampling.vert random_ray which ignores D."""
    fn = sample_hemisphere_wrong if which == 1 else sample_hemisphere_wrong2
    return fn(state)
