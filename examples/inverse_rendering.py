"""Inverse-rendering demo (BASELINE config 4).

Renders a target image of the box_balls scene (all four material cases
live there), perturbs one cube's albedo + roughness AND the global
refraction index, then recovers all three: albedo by Adam descent on
the pixel MSE with the exact detached-sampling gradients, roughness and IOR by deterministic coordinate scans on forward
renders — the loss is deterministic (fixed per-pass RNG seeds), and AD
is knowably wrong for those two scalars (the detached estimator drops
the roughness-through-sampling pathway; the clamped-Schlick quirk
zeroes most of the IOR pathway). Two interleaved stages resolve the
coupling. Writes target / initial / recovered PNGs and the loss curve
to examples/captures/.

  python examples/inverse_rendering.py            # 800x600
  python examples/inverse_rendering.py --cpu --quick
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--quick", action="store_true",
                    help="64x48, 30 steps")
    ap.add_argument("--outdir", default=os.path.join(
        os.path.dirname(__file__), "captures"))
    args = ap.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from montecarlo_pathtracing_tpu.utils.profiling import (
        enable_compilation_cache)
    enable_compilation_cache()
    from montecarlo_pathtracing_tpu.scene import scenes
    from montecarlo_pathtracing_tpu.scene.device import compile_scene
    from montecarlo_pathtracing_tpu.render.camera import (
        default_rt_camera, camera_rays)
    from montecarlo_pathtracing_tpu.render.diff import (
        params_of, render_mean, inverse_render_fit)
    from montecarlo_pathtracing_tpu.utils.image import write_png

    if args.quick:
        w, h, steps = 64, 48, 30
    else:
        w, h, steps = args.width, args.height, args.steps
    os.makedirs(args.outdir, exist_ok=True)

    dev = compile_scene(scenes.build("box_balls"))
    proj, view = default_rt_camera(w, h)
    origin, dirs, tc = camera_rays(proj, view, w, h)
    dirs, tc = dirs.reshape(-1, 3), tc.reshape(-1, 2)

    # a pure-diffuse cube of box_balls (alpha == 1, shininess == 0): a
    # pure-diffuse row keeps the fit inside one material case — see
    # inverse_render_fit's doc. (The spheres all carry shininess.)
    cubes = [int(i) for i in np.asarray(
        dev.group_prim[dev.group_codes.index(2)]) if i >= 0]
    mat = np.asarray(dev.mat)
    col = np.asarray(dev.color)
    target_prim = next(i for i in cubes
                       if col[i, 3] == 1.0 and mat[i, 0] == 0.0)

    ior_true = 1.35
    p_true = params_of(dev, refract_ind=ior_true)
    t0 = time.perf_counter()
    target = render_mean(dev, p_true, origin, dirs, tc, 4, 6)
    write_png(f"{args.outdir}/inv_target.png",
              np.asarray(target).reshape(h, w, 3))

    rng = np.random.RandomState(0)
    p0 = p_true._replace(
        color=p_true.color.at[target_prim, :3].set(
            jnp.array([0.05, 0.55, 0.3])),
        mat=p_true.mat.at[target_prim, 1].set(0.9),
        refract_ind=jnp.float32(1.05),
    )
    init_img = render_mean(dev, p0, origin, dirs, tc, 4, 6)
    write_png(f"{args.outdir}/inv_initial.png",
              np.asarray(init_img).reshape(h, w, 3))

    # Staged recovery. Why not one joint AD fit (the round-3 recipe,
    # which did NOT converge): the detached-sampling estimator drops the
    # roughness gradient's main pathway (roughness shapes the SAMPLED
    # directions, which are stop_gradient'ed), and the reference's
    # clamped-Schlick quirk zeroes most of the IOR pathway — AD descends
    # a wrong direction for those two scalars. But the loss is
    # DETERMINISTIC (fixed per-pass RNG seeds), so the two scalars are
    # recovered by exact coordinate scans with parabolic refinement on
    # forward renders (no gradients needed), interleaved
    # with albedo-only AD stages whose gradients ARE exact.
    losses = []

    def loss_of(p):
        img = render_mean(dev, p, origin, dirs, tc, 4, 6)
        return float(jnp.mean((img - target) ** 2))

    def scan_scalar(p, put, lo, hi, coarse=13, refine=3):
        """Deterministic 1-D recovery: coarse grid + golden refinement."""
        xs = np.linspace(lo, hi, coarse)
        ls = [loss_of(put(p, x)) for x in xs]
        i = int(np.argmin(ls))
        a = xs[max(i - 1, 0)]
        b = xs[min(i + 1, coarse - 1)]
        for _ in range(refine):
            m1 = a + (b - a) / 3
            m2 = b - (b - a) / 3
            if loss_of(put(p, m1)) < loss_of(put(p, m2)):
                b = m2
            else:
                a = m1
        x = 0.5 * (a + b)
        p = put(p, x)
        losses.append(loss_of(p))
        return p

    def put_rough(p, x):
        return p._replace(mat=p.mat.at[target_prim, 1].set(x))

    def put_ior(p, x):
        return p._replace(refract_ind=jnp.float32(x))

    def put_albedo(ch):
        def put(p, x):
            return p._replace(color=p.color.at[target_prim, ch].set(x))
        return put

    p_fit = p0
    ad_steps = max(10, steps // 3)
    for stage in range(2):
        # albedo via AD (exact detached-sampling gradients)
        p_fit, la = inverse_render_fit(
            dev, target, origin, dirs, tc, prim_ids=[target_prim],
            steps=ad_steps, lr=5e-2, n_passes=4, nb_bounces=6,
            fit_albedo=True, seed_params=p_fit, verbose=True)
        losses.extend(la)
        # the two scalars via deterministic scans
        p_fit = scan_scalar(p_fit, put_rough, 0.0, 1.0)
        p_fit = scan_scalar(p_fit, put_ior, 1.0, 2.5)
        # Adam plateaus within ~0.1 of the albedo optimum (small masked
        # gradients against a full-image MSE); the loss is deterministic,
        # so polish each channel with the same exact scan
        for ch in range(3):
            lo = float(p_fit.color[target_prim, ch]) - 0.25
            p_fit = scan_scalar(p_fit, put_albedo(ch),
                                max(0.0, lo), min(1.0, lo + 0.5),
                                coarse=11, refine=5)
        print(f"stage {stage}: loss {losses[-1]:.6f} "
              f"albedo {[round(float(c), 3) for c in p_fit.color[target_prim, :3]]} "
              f"rough {float(p_fit.mat[target_prim, 1]):.3f} "
              f"ior {float(p_fit.refract_ind):.3f}")

    # the parameters sit in a coupled valley (albedo <-> rough/ior trade
    # off in the MSE); two extra scan-only rounds walk the coordinate
    # descent down the valley floor — each scan is exact, so the loss
    # curve stays monotone
    for _ in range(2):
        p_fit = scan_scalar(p_fit, put_rough, 0.0, 0.4,
                            coarse=11, refine=5)
        p_fit = scan_scalar(p_fit, put_ior, 1.1, 1.7,
                            coarse=13, refine=5)
        for ch in range(3):
            lo = float(p_fit.color[target_prim, ch]) - 0.15
            p_fit = scan_scalar(p_fit, put_albedo(ch),
                                max(0.0, lo), min(1.0, lo + 0.3),
                                coarse=11, refine=5)

    final = render_mean(dev, p_fit, origin, dirs, tc, 4, 6)
    write_png(f"{args.outdir}/inv_recovered.png",
              np.asarray(final).reshape(h, w, 3))
    wall = time.perf_counter() - t0

    out = {
        "scene": "box_balls", "width": w, "height": h, "steps": steps,
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "wall_s": round(wall, 1),
        "loss_curve": [round(x, 6) for x in losses],
        "true": {
            "albedo": np.asarray(p_true.color[target_prim, :3]).tolist(),
            "roughness": float(p_true.mat[target_prim, 1]),
            "ior": ior_true,
        },
        "initial": {
            "albedo": [0.05, 0.55, 0.3], "roughness": 0.9, "ior": 1.05,
        },
        "recovered": {
            "albedo": np.asarray(p_fit.color[target_prim, :3]).tolist(),
            "roughness": float(p_fit.mat[target_prim, 1]),
            "ior": float(p_fit.refract_ind),
        },
    }
    with open(f"{args.outdir}/inverse_rendering.json", "w") as f:
        json.dump(out, f, indent=1)
    print(f"loss: {losses[0]:.6f} -> {losses[-1]:.6f}  ({wall:.0f}s)")
    print("true     ", out["true"])
    print("recovered", out["recovered"])


if __name__ == "__main__":
    main()
