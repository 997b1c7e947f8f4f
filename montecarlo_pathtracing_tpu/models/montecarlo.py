"""The Monte Carlo path-tracing integrator: the dense reference route.

SoA implementation: every per-ray vec3 lives as a tuple of [N] component
arrays (ops/vec.py); [N, 3] appears only at the raytrace() API boundary.
Each bounce traces through the dense XLA fold (ops/trace.py) and shades
with XLA elementwise fusions. raytrace() also chooses the route: on a GPU
an analytic scene renders through the whole-pass kernel
(models/megakernel.py) instead, with the identical draw schedule.

Semantics are the reference integrator verbatim (tp/montecarlo.frag:
100-188) — see models/montecarlo_aos.py (the readable AoS twin, kept in
the carousel as "montecarlo_aos") for the line-by-line quirk commentary:
the degenerate path "stack", the vec3(0.8) initial attenuation, the sky
mix, the ambient leak total += col*0.1, the Phong spec built from the
diffuse sample in every case, the refraction march-through with stale
(N, P) on inner miss, the mixed-case un-refracted inner trace, emissivity
> 0.5 termination, and bounce-cap exhaustion returning BLACK. RNG draw
schedule: 2 draws per hit + 1 mixed coin + 2 reflect-branch draws, masked
per lane — bit-identical streams to the scalar CPU oracle.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import rng, vec
from ..ops.sampling import random_ray_soa, schlick_soa
from ..ops.trace import trace, HitS
from ..ops.shading import intersection_info_soa
from ..utils.transforms import normalize

BIAS = np.float32(1e-2)  # raytracer_func.frag:14

SKY_LOW = (0.5, 0.5, 0.9)    # tp/montecarlo.frag:119
SKY_HIGH = (1.0, 1.0, 0.8)


def sky_color_soa(d):
    k = jnp.maximum(0.0, d[2])
    return tuple((1.0 - k) * lo + k * hi
                 for lo, hi in zip(SKY_LOW, SKY_HIGH))


ROUTES = ("megakernel", "dense")


def choose_route(scene, *, differentiable: bool = False) -> str:
    """The one routing rule: the whole-pass kernel for an analytic scene
    on a GPU backend, the dense XLA route for everything else — meshes,
    gradients (the kernel has no VJP; the dense route keeps the full IOR
    gradient, see render/diff.py) and every other backend."""
    from .megakernel import mega_eligible
    if (not differentiable and jax.default_backend() == "gpu"
            and mega_eligible(scene)):
        return "megakernel"
    return "dense"


def _trace_soa(scene, o, d):
    """SoA closest hit through the dense XLA fold."""
    h = trace(scene, vec.to_aos(o), vec.to_aos(d))
    return HitS(h.dist, h.prim, h.shape, h.dircode, h.tri,
                vec.from_aos(h.pl), vec.from_aos(h.pg))


def random_path_soa(scene, o, d, state, *, nb_bounces: int, refract_ind,
                    detach_sampling: bool = False,
                    sort_rays: bool = False):
    """One path per lane, SoA. o, d: vec3 of [N] (d normalized), state:
    (s0, s1, s2) uint32 [N]. Returns (rgb vec3, state).

    sort_rays: re-sort the wavefront between bounces by (direction
    octant, origin Morton) and park terminated rays at the tail
    (ops/sort_rays.py), so neighbouring lanes carry coherent rays. Off by
    default; kept for measuring wavefront compaction. Per-lane math is
    permutation-invariant, so results match the unsorted path up to XLA
    fusing fma differently between the two programs (the RNG streams and
    trace winners are identical)."""
    n = d[0].shape[0]
    z = jnp.zeros((n,), jnp.float32)
    one = jnp.ones((n,), jnp.float32)
    unit_z = (z, z, one)

    if sort_rays:
        from ..ops.sort_rays import (ray_sort_key, sort_wavefront, PARK_Z)
        sort_lo = jnp.min(scene.prim_bb_min, axis=0)
        sort_hi = jnp.max(scene.prim_bb_max, axis=0)

    # ONE transposed material+color table [8, Nprims]: one gather per
    # bounce instead of two
    matcol_t = jnp.concatenate([scene.mat.T, scene.color.T], axis=0)

    def maybe_detach(v):
        if detach_sampling:
            return tuple(jax.lax.stop_gradient(c) for c in v)
        return v

    def bounce(i, carry):
        o, d, attenu, total, result, done, state, lane = carry
        del i
        if sort_rays:
            # park finished rays outside every cull volume pointing away,
            # then compact the wavefront into coherent bundles
            o = vec.where(done, (z, z, jnp.full((n,), PARK_Z)), o)
            d = vec.where(done, unit_z, d)
            key = ray_sort_key(o, d, done, sort_lo, sort_hi)
            flat = [*o, *d, *attenu, *total, *result,
                    done, *state, lane]
            _, flat = sort_wavefront(key, flat)
            o, d = tuple(flat[0:3]), tuple(flat[3:6])
            attenu, total = tuple(flat[6:9]), tuple(flat[9:12])
            result = tuple(flat[12:15])
            done = flat[15]
            state = tuple(flat[16:19])
            lane = flat[19]
        hit = _trace_soa(scene, o, d)

        active = ~done
        is_hit = hit.shape >= 0
        miss_now = active & ~is_hit
        live = active & is_hit

        # sky fallback (:117-119)
        result = vec.where(miss_now,
                           vec.add(total, vec.mul(attenu, sky_color_soa(d))),
                           result)
        done = done | miss_now

        n_raw, p_raw = intersection_info_soa(scene, hit)
        # sanitize non-live lanes so no NaNs enter the masked math
        N = vec.where(live, n_raw, unit_z)
        P = vec.where(live, p_raw, vec.add(o, d))

        prim = jnp.clip(hit.prim, 0, scene.nb_prims - 1)
        mcrow = jnp.take(matcol_t, prim, axis=1)   # [8, N]
        shin, rough, emis = mcrow[0], mcrow[1], mcrow[2]
        col3 = (mcrow[4], mcrow[5], mcrow[6])
        alpha = mcrow[7]

        # draws 1-2: the diffuse sample, for every hit lane (:127)
        ray, state = random_ray_soa(state, N, 1.0 - rough, live)
        ray = maybe_detach(ray)

        rs = schlick_soa(d, N, refract_ind)                    # (:129)
        R = vec.reflect(vec.neg(ray), N)                       # (:131)
        E = vec.normalize(vec.sub(o, P), eps=1e-30)
        se = (1.0 - rough) * 100.0 + rough * 2.0               # (:133)
        # pow with a zero-base guard: forward-identical to
        # pow(max(0, dot), se) (se >= 2, so pow(0, se) == 0), but the
        # gradient of x**se w.r.t. se is x**se * log(x) = NaN at x == 0
        # and jnp.where passes untaken-branch NaNs through reverse-mode
        # — roughness flows into the exponent, so guard the base
        er = jnp.maximum(0.0, vec.dot(E, R))
        er_safe = jnp.where(er > 0.0, er, 1.0)
        spec = jnp.where(er > 0.0, jnp.power(er_safe, se), 0.0)

        # ambient leak + emissive gather (:136)
        emit = emis * (1.0 - shin) * alpha
        total = vec.where(
            live,
            vec.add(total, vec.add(vec.scale(col3, 0.1),
                                   vec.scale(attenu, emit))),
            total)

        # emissive termination (:139,174-175)
        emissive = emis > 0.5
        result = vec.where(live & emissive, total, result)
        done = done | (live & emissive)
        cont = live & ~emissive

        # 4-case material logic (:141-172); exact float compares are spec
        refl_case = (shin > 0.0) & (alpha == 1.0)
        refr_case = (alpha < 1.0) & (shin == 0.0)
        mixed_case = (alpha < 1.0) & (shin > 0.0)

        # draw 3: the mixed-case coin (:155)
        r, state = rng.uniform_masked_soa(state, cont & mixed_case)
        choose_refl = refl_case | (mixed_case & (r > 0.5))
        refr_lane = cont & (refr_case | (mixed_case & ~(r > 0.5)))

        # draws 4-5: the reflect-branch sample (:143,158)
        rray, state = random_ray_soa(
            state, vec.reflect(d, N), 1.0 - shin * rough, cont & choose_refl)
        rray = maybe_detach(rray)

        # refraction inner re-trace (:146-153; mixed keeps un-refracted D).
        # When the scene has NO transparent material (every alpha == 1,
        # static at compile), refr_lane is identically false and the whole
        # second trace is elided.
        if scene.has_transparent:
            d_inner = vec.where(cont & refr_case,
                                vec.refract_glsl(d, N, refract_ind), d)
            d_inner = vec.where(refr_lane, d_inner, unit_z)
            if sort_rays:
                # park non-refracting lanes high above the scene so the
                # inner re-trace only pays for lanes that actually
                # refract (their results are discarded below anyway);
                # keep x/y so mixed tiles' bundles stay laterally tight
                park = (o[0], o[1], jnp.full((n,), PARK_Z))
            else:
                park = o
            o_inner = vec.where(refr_lane,
                                vec.sub(P, vec.scale(N, BIAS)), park)
            hit2 = _trace_soa(scene, o_inner, d_inner)
            n2_raw, p2_raw = intersection_info_soa(scene, hit2, prev=(N, P))
            N2 = vec.where(refr_lane, n2_raw, unit_z)
            P2 = vec.where(refr_lane, p2_raw, P)
            d_exit = vec.refract_glsl(d_inner, vec.neg(N2),
                                      1.0 / refract_ind)
        else:
            N2, P2 = N, P
            d_exit = unit_z

        # attenuation updates (:142,147,161,170)
        base = vec.mul(col3, attenu)
        spec_mix = vec.mix(attenu, col3, shin)
        att_refl = vec.add(base, vec.mul(
            vec.scale(attenu, alpha * rs * spec), spec_mix))
        att_refr = vec.add(base, vec.mul(
            vec.scale(attenu, (1.0 - alpha) * (1.0 - rs) * spec), spec_mix))
        att_diff = vec.add(base, vec.mul(vec.scale(attenu, spec), spec_mix))

        new_attenu = vec.where(refr_lane, att_refr,
                               vec.where(choose_refl, att_refl, att_diff))
        new_o = vec.where(refr_lane, vec.add(P2, vec.scale(N2, BIAS)),
                          vec.add(P, vec.scale(N, BIAS)))
        new_d = vec.where(refr_lane, d_exit,
                          vec.where(choose_refl, rray, ray))

        o = vec.where(cont, new_o, o)
        d = vec.where(cont, new_d, d)
        attenu = vec.where(cont, new_attenu, attenu)
        return o, d, attenu, total, result, done, state, lane

    init = (
        o, d,
        (jnp.full((n,), 0.8, jnp.float32),) * 3,   # attenu vec3(0.8) (:107)
        (z, z, z),                                  # total
        (z, z, z),                                  # result
        jnp.zeros((n,), bool),
        state,
        jnp.arange(n, dtype=jnp.int32),             # original lane id
    )
    carry = jax.lax.fori_loop(0, nb_bounces, bounce, init)
    _, _, _, _, result, done, state, lane = carry
    # bounce-cap exhaustion returns black (:178)
    rgb = vec.where(done, result, (z, z, z))
    if sort_rays:
        # undo the accumulated bounce permutations: one row-form scatter
        # per dtype
        rgb_s = jnp.zeros((3, n), jnp.float32).at[:, lane].set(
            jnp.stack(rgb))
        rgb = (rgb_s[0], rgb_s[1], rgb_s[2])
        st_s = jnp.zeros((3, n), jnp.uint32).at[:, lane].set(
            jnp.stack(state))
        state = (st_s[0], st_s[1], st_s[2])
    return rgb, state


def raytrace(scene, O, D, screen_tc, pass_index, *, nb_bounces: int,
             refract_ind, date=0.0, detach_sampling: bool = False,
             route: str | None = None, pallas_interpret: bool = False,
             sort_rays: bool = False):
    """tp/montecarlo.frag:182-188: srand + one random path per lane.

    AoS boundary: O [3], D [N,3], screen_tc [N,2] in; rgb [N,3] out.

    route: "megakernel" or "dense"; None = choose_route(scene). The
    kernel compiles only for a GPU: pallas_interpret=True runs it in the
    Pallas interpreter (tests on the CPU), and asking for it on another
    backend without that raises.
    """
    if route is None:
        route = choose_route(scene, differentiable=detach_sampling)
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; have {ROUTES}")
    if route == "megakernel":
        if detach_sampling or sort_rays:
            raise ValueError(
                "the megakernel has no gradient rule and no wavefront "
                "sort: detach_sampling and sort_rays need route='dense'")
        from .megakernel import raytrace_mega
        return raytrace_mega(
            scene, O, D, screen_tc, pass_index, nb_bounces=nb_bounces,
            refract_ind=refract_ind, date=date, interpret=pallas_interpret)
    n = D.shape[0]
    d = normalize(D)
    o3 = jnp.broadcast_to(jnp.asarray(O, jnp.float32), (3,))
    o = (jnp.full((n,), o3[0]), jnp.full((n,), o3[1]),
         jnp.full((n,), o3[2]))

    state = rng.srand_soa(screen_tc[:, 0], screen_tc[:, 1], pass_index, date)
    rgb, _ = random_path_soa(
        scene, o, (d[:, 0], d[:, 1], d[:, 2]), state,
        nb_bounces=nb_bounces, refract_ind=refract_ind,
        detach_sampling=detach_sampling, sort_rays=sort_rays)
    return vec.to_aos(rgb)
