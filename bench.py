"""Headline benchmark: progressive path-tracing throughput on one chip.

Renders the reference's default configuration (box_diffuse scene,
montecarlo integrator, 3 bounces — MontecarloGPU/montecarlo.cpp:128-130)
at 800x600 (the BASELINE.json metric resolution) and reports ray-segment
throughput.

Metric definition: rays/s = pixels x passes x nb_bounces / seconds — the
upper-bound count of path segments a pass evaluates (each
bounce iteration traces every lane once; the extra refraction inner
re-trace is NOT counted, and early-terminated lanes still occupy their
slots, so this is the honest dense-engine rate, comparable to a fragment
invocation x bounce count on the GL side).

vs_baseline: the reference publishes no numbers (BASELINE.json
published={}); its target is ">=10x llvmpipe rays/s per chip". llvmpipe
is not available here, so the measured denominator is this framework's
own dense-XLA path on CPU running the identical config — produced once
by benchmarks/measure_baseline.py and checked in as
benchmarks/baseline_cpu.json. vs_baseline =
rays_per_s / (10 * measured_cpu_rays_per_s); >= 1.0 means target met.
(Fallback if the file is missing: a 30 Mrays/s line.)

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}
with the median of six timed windows and every window kept, the route
taken and the device it ran on.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time

import jax


def target_rays_per_s() -> float:
    """10x the measured CPU software-path denominator (see module doc)."""
    p = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "benchmarks", "baseline_cpu.json")
    try:
        with open(p) as f:
            cpu = json.load(f)["rays_per_s"]
        return 10.0 * float(cpu)
    except (OSError, KeyError, ValueError):
        return 30e6


def main():
    from montecarlo_pathtracing_tpu.utils.profiling import (
        enable_compilation_cache)
    enable_compilation_cache()
    from montecarlo_pathtracing_tpu.scene import scenes
    from montecarlo_pathtracing_tpu.scene.device import compile_scene
    from montecarlo_pathtracing_tpu.render.renderer import (
        RenderConfig, Renderer)
    from montecarlo_pathtracing_tpu.models.montecarlo import choose_route

    width, height, bounces = 800, 600, 3
    timed_passes = 64

    dev = compile_scene(scenes.build("box_diffuse"))
    # passes_per_call=timed_passes: ONE jitted multi-pass call per timing
    # window, so dispatch overhead is amortised. Accumulation is
    # bit-identical to sequential passes (render/renderer.multi_pass adds
    # in pass order).
    cfg = RenderConfig(width=width, height=height, nb_bounces=bounces,
                       tile_rays=1 << 17, passes_per_call=timed_passes)
    r = Renderer(dev, cfg)
    route = choose_route(dev)

    # Renderer.advance returns after block_until_ready on the accumulator
    t0 = time.perf_counter()
    r.advance(timed_passes)          # compiles + runs the batched call
    warmup_s = time.perf_counter() - t0

    windows = []
    for _ in range(6):
        t0 = time.perf_counter()
        r.advance(r.nb_passes + timed_passes)
        windows.append(time.perf_counter() - t0)
    dt = statistics.median(windows)

    rays = width * height * timed_passes * bounces
    rays_per_s = rays / dt
    d0 = jax.devices()[0]
    detail = {
        "metric": "rays_per_s_per_chip_800x600_3bounce",
        "value": rays_per_s,
        "unit": "rays/s",
        "vs_baseline": rays_per_s / target_rays_per_s(),
        "route": route,
        "platform": d0.platform,
        "device_kind": d0.device_kind,
        "device_count": len(jax.devices()),
        "warmup_s": warmup_s,
        "window_passes": timed_passes,
        "window_times_s": windows,
        "window_rays_per_s": [rays / w for w in windows],
    }
    print(json.dumps(detail))
    # extra context on stderr (the caller reads stdout JSON only)
    print(f"# median of {len(windows)} windows of {timed_passes} passes: "
          f"{dt:.4f}s ({width}x{height}, {bounces} bounces, route={route}, "
          f"device={d0.device_kind})", file=sys.stderr)


if __name__ == "__main__":
    main()
