"""Run the five BASELINE.json benchmark configs at spec and record JSON.

BASELINE.md / BASELINE.json "configs":
  1. Diffuse-only scene, 256x256, 16 SPP, 4 bounces  (the CPU-reference
     config)
  2. Full 4-case materials with roughness/shininess + IOR & light
     sweep, 800x600, 64 SPP
  3. Mesh scene (two-level BVH-equivalent path), 8 bounces, 256 SPP
  4. Differentiable inverse rendering: recover a material by
     pixel-gradient descent
  5. manyrays converged scene, 1920x1080, 1024 SPP (the full run with
     mid-run teardown/resume lives in examples/config5_manyrays.py;
     --full re-runs it here)

Writes benchmarks/configs_report.json. One command reproduces every
config:    python benchmarks/configs.py [--full]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _render(name, w, h, spp, bounces, ior=1.0, light=1.2):
    from montecarlo_pathtracing_tpu.scene import scenes
    from montecarlo_pathtracing_tpu.scene.device import compile_scene
    from montecarlo_pathtracing_tpu.render.renderer import (
        RenderConfig, Renderer)

    dev = compile_scene(scenes.build(name, light))
    cfg = RenderConfig(width=w, height=h, nb_bounces=bounces,
                       refract_ind=ior, light_intensity=light)
    r = Renderer(dev, cfg)
    t0 = time.perf_counter()
    # warm up the SAME batched multi-pass call the timed run uses;
    # advance() returns after block_until_ready on the accumulator
    r.advance(min(spp, max(1, cfg.passes_per_call)))
    compile_s = time.perf_counter() - t0
    r.reset()
    t0 = time.perf_counter()
    r.advance(spp)
    dt = time.perf_counter() - t0
    img = r.image()                        # resolve outside the timing
    return {
        "scene": name, "width": w, "height": h, "spp": spp,
        "bounces": bounces, "ior": ior, "light": light,
        "compile_s": round(compile_s, 2), "seconds": round(dt, 2),
        "rays_per_s": round(w * h * spp * bounces / dt, 1),
        "spp_per_s": round(spp / dt, 2),
        "img_mean": round(float(img.mean()), 5),
        "img_std": round(float(img.std()), 5),
    }, img


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="also run config 5 at full 1920x1080x1024 spec")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    report = {"platform": jax.devices()[0].platform,
              "device_kind": jax.devices()[0].device_kind, "configs": {}}

    # --- config 1: diffuse, 256x256 @ 16 spp, 4 bounces ------------------
    c1, img1 = _render("box_diffuse", 256, 256, 16, 4)
    report["configs"]["1_diffuse_256"] = c1
    print("config 1:", c1, flush=True)

    # --- config 2: materials + IOR/light sweep, 800x600 @ 64 spp ---------
    # the shininess/roughness sweep itself is scene_materials (11x11
    # sphere grid); that scene is sky-lit with no transparency — faithful
    # to montecarlo.cpp:743-753 — so the IOR/light knobs are swept on
    # box_balls, where all four material cases (and an emissive light)
    # are live and the knobs visibly change the image
    c2, _ = _render("materials", 800, 600, 64, 6)
    print("config 2 (materials):", c2, flush=True)
    sweep = [c2]
    for ior, light in ((1.0, 0.4), (1.5, 0.4), (2.5, 0.4), (1.5, 1.2)):
        c2s, _ = _render("box_balls", 800, 600, 64, 6,
                         ior=ior, light=light)
        sweep.append(c2s)
        print("config 2 (sweep):", c2s, flush=True)
    report["configs"]["2_materials_sweep"] = sweep

    # --- config 3: mesh scene, 8 bounces, 256 spp ------------------------
    c3, _ = _render("mesh_demo", 800, 600, 256, 8)
    report["configs"]["3_mesh_256spp"] = c3
    print("config 3:", c3, flush=True)

    # --- config 4: inverse rendering fit (examples/inverse_rendering.py) -
    # in-process: a second JAX process could not get the card's memory
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    import inverse_rendering
    outdir = os.path.join(os.path.dirname(__file__), "..", "examples",
                          "captures")
    t0 = time.perf_counter()
    inverse_rendering.main(["--width", "160", "--height", "120",
                            "--steps", "120", "--outdir", outdir])
    fit_json = os.path.join(outdir, "inverse_rendering.json")
    entry = {"seconds": round(time.perf_counter() - t0, 2)}
    try:
        with open(fit_json) as f:
            fit = json.load(f)
        entry.update({
            "loss_first": fit["loss_curve"][0],
            "loss_last": fit["loss_curve"][-1],
            "true": fit["true"], "recovered": fit["recovered"],
            "artifact": "examples/captures/inverse_rendering.json",
        })
    except (OSError, KeyError, ValueError):
        pass
    report["configs"]["4_inverse_fit"] = entry
    print("config 4:", entry, flush=True)

    # --- config 5: manyrays (colonnes at scale) --------------------------
    if args.full:
        c5, _ = _render("colonnes", 1920, 1080, 1024, 6, light=0.4)
        report["configs"]["5_manyrays"] = c5
    else:
        c5, _ = _render("colonnes", 1920, 1080, 32, 6, light=0.4)
        c5["note"] = ("32-spp slice of the 1024-spp spec; the full run "
                      "with mid-run checkpoint teardown/resume is "
                      "examples/config5_manyrays.py")
        report["configs"]["5_manyrays"] = c5
    print("config 5:", report["configs"]["5_manyrays"], flush=True)

    out = args.out or os.path.join(os.path.dirname(__file__),
                                   "configs_report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print("wrote", out)


if __name__ == "__main__":
    main()
