"""AoS reference implementation of the Monte Carlo integrator.

This is the readable [N, 3]-layout twin of models/montecarlo.py (the SoA
dense route) — kept in the carousel as "montecarlo_aos" for
cross-checking and CPU debugging; both must render identical images
(tests/test_soa_integrator.py).

Reimplements the reference's real integrator (tp/montecarlo.frag:100-188) as
one batched, jittable bounce loop over a ray SoA. Key structural insight:
the GLSL path "stack" pops one entry and pushes at most one per iteration
(tp/montecarlo.frag:109-177), so it degenerates to plain iterative path
state — here the whole integrator is a `lax.fori_loop` carrying
(O, D, attenuation, total, result, done-mask, RNG counters) for every lane,
with divergence mapped to masks instead of SIMT branches.

The reference's quirks are the spec (SURVEY.md §"Hard parts") and are all
kept, notably:
  - initial attenuation vec3(0.8) (:107)
  - sky miss: total + attenu * mix((.5,.5,.9),(1,1,.8), max(0,D.z)) (:119)
  - `total += col*0.1 + attenu*emissivity*(1-shininess)*alpha` ambient leak
    (:136); emissive threshold 0.5 terminates the path returning total
    (:139,174-175)
  - the Phong spec lobe is built from the DIFFUSE sample `ray` in every
    material case: spec = pow(max(0,dot(E, reflect(-ray,N))), mix(100,2,
    roughness)) (:131-134)
  - refraction marches through the object: refract in, re-trace from
    P - BIAS*N to find the exit, refract out with 1/IOR (:146-153); on an
    inner-trace miss the GLSL out-params keep their previous values — we
    keep (N, P) from the outer hit
  - the MIXED case's refract sub-branch re-traces with the UN-refracted D
    (:160-166) — a reference bug kept verbatim
  - bounce-cap exhaustion returns BLACK, discarding the accumulated total
    (:178)
  - `col.a == 1` / `mat.r == 0` exact float compares select the cases

RNG draw parity: each lane owns a counter (ops/rng) and masked draws advance
only lanes that would reach the corresponding random_float() in the scalar
program: 2 draws per hit (`ray`), +1 for the mixed-case coin, +2 for the
reflect-branch `random_ray` — so any sharding/tile order is bit-identical
to the scalar CPU oracle.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import rng
from ..ops.sampling import random_ray_masked, schlick
from ..ops.trace import trace
from ..ops.shading import intersection_info
from ..utils.transforms import normalize, reflect, refract_glsl, dot3, mix

BIAS = np.float32(1e-2)  # raytracer_func.frag:14

SKY_LOW = np.array([0.5, 0.5, 0.9], np.float32)   # tp/montecarlo.frag:119
SKY_HIGH = np.array([1.0, 1.0, 0.8], np.float32)


def sky_color(d):
    k = jnp.maximum(0.0, d[..., 2])[..., None]
    return (1.0 - k) * SKY_LOW + k * SKY_HIGH


def random_path(scene, O, D, state, *, nb_bounces: int, refract_ind,
                detach_sampling: bool = False):
    """One path per lane. O, D: [N,3] world rays (D normalized), state:
    uint32 [N,3] RNG counters. Returns (rgb [N,3], state)."""
    n = D.shape[0]
    O = jnp.broadcast_to(O, D.shape).astype(jnp.float32)
    unit_z = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], jnp.float32), D.shape)

    def maybe_detach(x):
        return jax.lax.stop_gradient(x) if detach_sampling else x

    def bounce(i, carry):
        O, D, attenu, total, result, done, state = carry
        del i
        hit = trace(scene, O, D)

        active = ~done
        is_hit = hit.shape >= 0
        miss_now = active & ~is_hit
        live = active & is_hit
        live3 = live[..., None]

        # sky fallback (:117-119)
        result = jnp.where(miss_now[..., None],
                           total + attenu * sky_color(D), result)
        done = done | miss_now

        n_raw, p_raw = intersection_info(scene, hit)
        # sanitize non-live lanes so no NaNs enter the masked math
        N = jnp.where(live3, n_raw, unit_z)
        P = jnp.where(live3, p_raw, O + D)

        prim = jnp.clip(hit.prim, 0, scene.nb_prims - 1)
        mat = jnp.take(scene.mat, prim, axis=0)    # [N,4] (shin, rough, emis, area)
        col = jnp.take(scene.color, prim, axis=0)  # [N,4]
        col3 = col[..., :3]
        shin, rough, emis, alpha = mat[..., 0], mat[..., 1], mat[..., 2], col[..., 3]

        # draws 1-2: the diffuse sample, for every hit lane (:127)
        ray, state = random_ray_masked(state, N, 1.0 - rough, live)
        ray = maybe_detach(ray)

        rs = schlick(D, N, refract_ind)                       # (:129)
        R = reflect(-ray, N)                                  # (:131)
        E = normalize(O - P)                                  # safe: P != O on live
        se = mix(jnp.float32(100.0), jnp.float32(2.0), rough)  # (:133)
        spec = jnp.power(jnp.maximum(0.0, dot3(E, R)), se)

        # ambient leak + emissive gather (:136)
        total = jnp.where(
            live3,
            total + col3 * 0.1
            + attenu * (emis * (1.0 - shin) * alpha)[..., None],
            total,
        )

        # emissive termination (:139,174-175)
        emissive = emis > 0.5
        result = jnp.where((live & emissive)[..., None], total, result)
        done = done | (live & emissive)
        cont = live & ~emissive

        # 4-case material logic (:141-172); exact float compares are the spec
        refl_case = (shin > 0.0) & (alpha == 1.0)
        refr_case = (alpha < 1.0) & (shin == 0.0)
        mixed_case = (alpha < 1.0) & (shin > 0.0)

        # draw 3: the mixed-case coin (:155)
        r, state = rng.uniform_masked(state, cont & mixed_case)
        choose_refl = refl_case | (mixed_case & (r > 0.5))
        refr_lane = cont & (refr_case | (mixed_case & ~(r > 0.5)))

        # draws 4-5: the reflect-branch sample (:143,158)
        rray, state = random_ray_masked(
            state, reflect(D, N), 1.0 - shin * rough, cont & choose_refl)
        rray = maybe_detach(rray)

        # refraction inner re-trace (:146-153; mixed sub-branch keeps the
        # un-refracted D, :160-166)
        d_inner = jnp.where((cont & refr_case)[..., None],
                            refract_glsl(D, N, refract_ind), D)
        d_inner = jnp.where(refr_lane[..., None], d_inner, unit_z)
        o_inner = jnp.where(refr_lane[..., None], P - BIAS * N, O)
        hit2 = trace(scene, o_inner, d_inner)
        n2_raw, p2_raw = intersection_info(scene, hit2, prev_n=N, prev_p=P)
        N2 = jnp.where(refr_lane[..., None], n2_raw, unit_z)
        P2 = jnp.where(refr_lane[..., None], p2_raw, P)
        d_exit = refract_glsl(d_inner, -N2, 1.0 / refract_ind)

        # attenuation updates (:142,147,161,170)
        base = col3 * attenu
        spec_mix = mix(attenu, col3, shin[..., None])
        att_refl = base + attenu * (alpha * rs * spec)[..., None] * spec_mix
        att_refr = base + attenu * ((1.0 - alpha) * (1.0 - rs) * spec)[..., None] * spec_mix
        att_diff = base + attenu * spec[..., None] * spec_mix

        new_attenu = jnp.where(
            refr_lane[..., None], att_refr,
            jnp.where(choose_refl[..., None], att_refl, att_diff))
        new_O = jnp.where(refr_lane[..., None], P2 + BIAS * N2, P + BIAS * N)
        new_D = jnp.where(refr_lane[..., None], d_exit,
                          jnp.where(choose_refl[..., None], rray, ray))

        cont3 = cont[..., None]
        O = jnp.where(cont3, new_O, O)
        D = jnp.where(cont3, new_D, D)
        attenu = jnp.where(cont3, new_attenu, attenu)
        return O, D, attenu, total, result, done, state

    init = (
        O, D,
        jnp.full_like(D, 0.8),               # initial attenuation (:107)
        jnp.zeros_like(D),                    # total
        jnp.zeros_like(D),                    # result
        jnp.zeros(n, bool),                   # done
        state,
    )
    carry = jax.lax.fori_loop(0, nb_bounces, bounce, init)
    _, _, _, _, result, done, state = carry
    # bounce-cap exhaustion returns black (:178)
    return jnp.where(done[..., None], result, 0.0), state


def raytrace(scene, O, D, screen_tc, pass_index, *, nb_bounces: int,
             refract_ind, date=0.0, detach_sampling: bool = False):
    """tp/montecarlo.frag:182-188: srand + one random path per lane.

    O: [3] camera origin; D: [N,3] ray dirs; screen_tc: [N,2].
    Returns rgb [N,3] — one 1-spp pass, to be accumulated progressively.
    """
    state = rng.srand(screen_tc, pass_index, date)
    rgb, _ = random_path(
        scene, O, normalize(D), state,
        nb_bounces=nb_bounces, refract_ind=refract_ind,
        detach_sampling=detach_sampling)
    return rgb
