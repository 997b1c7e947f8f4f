"""Large-scene scaling curve: rays/s vs analytic primitive count.

The reference's per-ray BVH walk supports ~2^27 prims (29-deep stacks,
shaders/raytracer_func.frag:644,736). This sweep renders the procedural
stress scene at prim counts out to 102400 on the route the renderer
picks (models/montecarlo.choose_route), recording throughput per count.

Usage:  python benchmarks/stress_curve.py
Writes benchmarks/stress_curve.json.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np


def main(counts=(256, 1024, 1026, 2048, 4096, 4100, 10240, 40960, 102400),
         width=640, height=480, bounces=3, passes=6):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from montecarlo_pathtracing_tpu.utils.profiling import (
        enable_compilation_cache)
    enable_compilation_cache()
    import jax
    from montecarlo_pathtracing_tpu.scene.scenes import scene_stress
    from montecarlo_pathtracing_tpu.scene.device import compile_scene
    from montecarlo_pathtracing_tpu.render.renderer import (
        RenderConfig, Renderer)
    from montecarlo_pathtracing_tpu.render.camera import default_rt_camera
    from montecarlo_pathtracing_tpu.models.montecarlo import choose_route

    platform = jax.devices()[0].platform
    results = []
    for n in counts:
        dev = compile_scene(scene_stress(n_prims=n))
        # frame the whole field from above (the field spans ~sqrt(n)*24)
        ext = np.sqrt(max(n - 2, 1)) * 12.0
        zoom = max(1.0, 2.3 * ext / 145.0)
        cfg = RenderConfig(width=width, height=height, nb_bounces=bounces,
                           tile_rays=1 << 17, passes_per_call=passes)
        proj, view = default_rt_camera(cfg.render_width, cfg.render_height,
                                       pitch=-40.0, zoom=zoom)
        r = Renderer(dev, cfg, proj, view)
        # advance() returns after block_until_ready on the accumulator
        t0 = time.perf_counter()
        r.advance(passes)
        compile_s = time.perf_counter() - t0
        wins = []
        for _ in range(5):
            t0 = time.perf_counter()
            r.advance(r.nb_passes + passes)
            wins.append(time.perf_counter() - t0)
        dt = statistics.median(wins)
        rays = width * height * passes * bounces
        row = {
            "n_prims": int(dev.nb_prims),
            "route": choose_route(dev),
            "rays_per_s": rays / dt,
            "window_times_s": wins,
            "compile_s": round(compile_s, 1),
            "img_mean": round(float(r.image().mean()), 5),
        }
        print(row, file=sys.stderr)
        results.append(row)

    out = {
        "config": {"width": width, "height": height, "bounces": bounces,
                   "passes": passes, "platform": platform,
                   "device_kind": jax.devices()[0].device_kind,
                   "scene": "scene_stress (jittered sphere/cube field)"},
        "results": results,
    }
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "stress_curve.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["results"]))


if __name__ == "__main__":
    main()
