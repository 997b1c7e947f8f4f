"""Exercise-template integrator stubs kept in the carousel.

The reference ships two single-intersection fakes alongside the real
integrator and cycles them with O/P (MontecarloGPU/montecarlo.cpp:27):
tp/montecarlo_mat.frag returns abs(N) * random_vec3() and
tp/montecarlo_mat_tr.frag returns col.rgb * random_float(); both return
(0, 0, 0.2) on a miss. They double as debug views (normal / albedo
visualization with noise) and as carousel parity fixtures.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..ops import rng
from ..ops.trace import trace
from ..ops.shading import intersection_info
from ..utils.transforms import normalize

# numpy, not jnp: a module-level device array would initialize the XLA
# backend at import time, which breaks jax.distributed.initialize in
# multi-process launches (it must run before any backend init)
MISS_COLOR = np.array([0.0, 0.0, 0.2], np.float32)


def _first_hit(scene, O, D):
    D = normalize(D)
    hit = trace(scene, jnp.broadcast_to(O, D.shape).astype(jnp.float32), D)
    n, _p = intersection_info(scene, hit)
    prim = jnp.clip(hit.prim, 0, scene.nb_prims - 1)
    col = jnp.take(scene.color, prim, axis=0)
    return hit, n, col


def raytrace_mat(scene, O, D, screen_tc, pass_index, *, nb_bounces=0,
                 refract_ind=1.0, date=0.0, detach_sampling=False):
    """tp/montecarlo_mat.frag: abs(N) * random_vec3()."""
    state = rng.srand(screen_tc, pass_index, date)
    hit, n, _col = _first_hit(scene, O, D)
    rv, _state = rng.uniform3(state)
    out = jnp.abs(n) * rv
    return jnp.where((hit.shape >= 0)[..., None], out, MISS_COLOR)


def raytrace_mat_tr(scene, O, D, screen_tc, pass_index, *, nb_bounces=0,
                    refract_ind=1.0, date=0.0, detach_sampling=False):
    """tp/montecarlo_mat_tr.frag: col.rgb * random_float()."""
    state = rng.srand(screen_tc, pass_index, date)
    hit, _n, col = _first_hit(scene, O, D)
    rf, _state = rng.uniform(state)
    out = col[..., :3] * rf[..., None]
    return jnp.where((hit.shape >= 0)[..., None], out, MISS_COLOR)
