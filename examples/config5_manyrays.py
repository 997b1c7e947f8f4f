"""BASELINE config 5: the 'manyrays' converged scene at scale.

Renders colonnes (the reference's 84000-ray showcase,
/root/reference/captures/manyrays.png) at 1920x1080 with progressive
accumulation to a high SPP target, exercising the checkpoint/resume
protocol mid-run exactly as a preempted pod job would: render the first
half, save the .npz checkpoint, TEAR DOWN the renderer, rebuild it from
scratch, load the checkpoint, and finish. Seeds are pure functions of
(uv, pass), so the resumed half continues the same sample sequence.

Writes examples/captures/manyrays.png + manyrays.json (wall-clock,
spp/s, rays/s, resume proof). Multi-chip scaling of the same run goes
through parallel.launcher.run_multihost_render (sample-axis DP across
processes) / Renderer(shard_devices=N) (ray DP inside one process) —
validated on the virtual CPU mesh in tests; this script records the
single-real-chip throughput.

    python examples/config5_manyrays.py [--spp 1024] [--quick]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=1024)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--bounces", type=int, default=3)
    ap.add_argument("--quick", action="store_true",
                    help="320x180 @ 32 spp smoke mode")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "captures"))
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from montecarlo_pathtracing_tpu.utils.profiling import (
        enable_compilation_cache)
    enable_compilation_cache()
    from montecarlo_pathtracing_tpu.scene import scenes
    from montecarlo_pathtracing_tpu.scene.device import compile_scene
    from montecarlo_pathtracing_tpu.render.renderer import (
        RenderConfig, Renderer)

    if args.quick:
        w, h, spp = 320, 180, 32
    else:
        w, h, spp = args.width, args.height, args.spp
    os.makedirs(args.out, exist_ok=True)
    ckpt = os.path.join(args.out, "manyrays_state.npz")
    if os.path.exists(ckpt):
        os.remove(ckpt)

    cfg = RenderConfig(width=w, height=h, nb_bounces=args.bounces,
                       refract_ind=1.0,
                       tile_rays=1 << 17, passes_per_call=8)
    scene = scenes.build("colonnes", light_intensity=1.2)
    from montecarlo_pathtracing_tpu.render.camera import default_rt_camera
    # the gallery's colonnade pose (examples/render_gallery.py POSES)
    proj, view = default_rt_camera(cfg.render_width, cfg.render_height,
                                   yaw=10.0, pitch=-5.0, zoom=0.6)

    def make():
        return Renderer(compile_scene(scene), cfg, proj, view)

    half = spp // 2
    t0 = time.perf_counter()
    r = make()
    r.run(half)
    r.save_checkpoint(ckpt)
    half_passes = r.nb_passes
    t_half = time.perf_counter() - t0

    # simulated preemption: lose the process state, resume from disk
    del r
    t1 = time.perf_counter()
    r = make()
    r.load_checkpoint(ckpt)
    assert r.nb_passes == half_passes, "resume lost the pass counter"
    r.run(spp)
    float(jnp.sum(r._acc))
    t_second = time.perf_counter() - t1
    total = time.perf_counter() - t0

    img = r.image()
    png = os.path.join(args.out, "manyrays.png")
    r.save_png(png)

    rays = w * h * spp * args.bounces
    stats = {
        "scene": "colonnes",
        "width": w, "height": h, "spp": spp, "bounces": args.bounces,
        "platform": jax.devices()[0].platform,
        "wall_s": round(total, 1),
        "first_half_s": round(t_half, 1),
        "resumed_half_s": round(t_second, 1),
        "spp_per_s": round(spp / total, 2),
        "rays_per_s": round(rays / total, 1),
        "resumed_at_pass": half_passes,
        "img_mean": round(float(img.mean()), 5),
        "checkpoint_bytes": os.path.getsize(ckpt),
    }
    with open(os.path.join(args.out, "manyrays.json"), "w") as f:
        json.dump(stats, f, indent=1)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
