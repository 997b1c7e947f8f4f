"""Full benchmark sweep: every demo scene + the BASELINE.json configs.

Writes benchmarks/report.json with per-scene rays/s, spp/s and image
statistics. The headline single-number benchmark stays in /bench.py (the
driver contract); this script is the complete picture.

  python benchmarks/run_all.py [--cpu] [--quick]
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
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="tiny sizes (smoke mode)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import statistics

    import jax

    from montecarlo_pathtracing_tpu.scene import scenes
    from montecarlo_pathtracing_tpu.scene.device import compile_scene
    from montecarlo_pathtracing_tpu.render.renderer import (
        RenderConfig, Renderer)
    from montecarlo_pathtracing_tpu.models.montecarlo import choose_route

    if args.quick:
        w, h, passes, bounces = 64, 48, 4, 3
    else:
        w, h, passes, bounces = 800, 600, 16, 3
    # fast scenes get longer windows so fixed per-window costs stay a
    # small fraction of the measurement; slow scenes keep short windows
    # to bound the sweep's wall time
    slow = ("mesh_demo", "mesh_hires", "stress_10k", "colonnes")

    # per-scene CPU denominators (round-2 verdict: a single-scene
    # denominator flattered the mesh scenes)
    base_path = os.path.join(os.path.dirname(__file__),
                             "baseline_per_scene.json")
    per_scene_base = {}
    base_note = "missing benchmarks/baseline_per_scene.json"
    try:
        with open(base_path) as f:
            bl = json.load(f)
        per_scene_base = {k: v.get("rays_per_s")
                          for k, v in bl["scenes"].items()}
        base_note = ("vs_baseline = rays_per_s / (10 * per-scene dense-XLA "
                     f"CPU rays/s on a {bl['host']['cpus']}-vCPU host); "
                     ">= 1.0 meets BASELINE.md's >=10x target")
    except (OSError, KeyError, ValueError):
        pass

    report = {
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "config": {"width": w, "height": h, "passes": passes,
                   "bounces": bounces},
        "baseline_note": base_note,
        "scenes": {},
    }
    for name in scenes.SCENES:
        try:
            n_passes = 2 * passes if name in slow else 4 * passes
            dev = compile_scene(scenes.build(name))
            r = Renderer(dev, RenderConfig(
                width=w, height=h, nb_bounces=bounces,
                tile_rays=1 << 17, passes_per_call=n_passes))
            # advance() returns after block_until_ready on the accumulator
            t0 = time.perf_counter()
            r.advance(n_passes)             # compile + run batched call
            compile_s = time.perf_counter() - t0
            # 5 windows, each ONE batched multi-pass call; every window
            # is recorded and rays_per_s quotes the median
            wins = []
            for _ in range(5):
                t0 = time.perf_counter()
                r.advance(r.nb_passes + n_passes)
                wins.append(time.perf_counter() - t0)
            dt = statistics.median(wins)
            img = r.image()
            rays = w * h * n_passes * bounces
            rps = rays / dt
            entry = {
                "prims": dev.nb_prims,
                "route": choose_route(dev),
                "compile_s": round(compile_s, 2),
                "rays_per_s": round(rps, 1),
                "rays_per_s_range": [round(rays / max(wins), 1),
                                     round(rps, 1)],
                "window_times_s": [round(x, 4) for x in wins],
                "window_spread": round(max(wins) / min(wins), 3),
                "spp_per_s": round(n_passes / dt, 2),
                "window_passes": n_passes,
                "img_mean": round(float(img.mean()), 5),
            }
            cpu_rps = per_scene_base.get(name)
            if cpu_rps:
                entry["cpu_rays_per_s"] = cpu_rps
                entry["vs_baseline"] = round(rps / (10.0 * cpu_rps), 3)
            report["scenes"][name] = entry
            print(name, report["scenes"][name], flush=True)
        except Exception as e:                      # keep sweeping
            report["scenes"][name] = {"error": str(e)[:200]}
            print(name, "ERROR", e, flush=True)

    out = args.out or os.path.join(os.path.dirname(__file__), "report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print("wrote", out)


if __name__ == "__main__":
    main()
