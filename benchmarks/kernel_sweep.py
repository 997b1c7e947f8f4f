"""Time the whole-pass kernel's tuning constants on the GPU.

    python benchmarks/kernel_sweep.py [--groups cull super block]

Every setting renders through Renderer.advance exactly as chip_smoke.py's
timing phase does (800x600, 3 bounces, cold compile then the median of 5
windows of 8 passes, every window printed with the card's name and power
limit). The constants of models/megakernel.py are module globals read
while the kernel is traced, so each setting sets them and clears JAX's
compiled-function caches before its Renderer is built. The shipped
setting is timed first and last in each group, so the spread of one
setting within the call is on the page beside the differences.

  cull   per-prim and super-box AABB culling forced on and forced off
         (MEGA_CULL_MIN_PRIMS 0 / never) on four scenes
  super  MEGA_SUPER (prims per super box) 8 / 16 / 32 on materials and
         colonnes
  block  rays per program and warps, BLOCK/NUM_WARPS 32/1, 64/2, 128/4
         on box_diffuse and colonnes
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

NEVER = 1 << 30


def _set(**consts):
    import jax
    from montecarlo_pathtracing_tpu.models import megakernel
    for k, v in consts.items():
        setattr(megakernel, k, v)
    jax.clear_caches()


def sweep(groups, card):
    import chip_smoke
    from montecarlo_pathtracing_tpu.models import megakernel
    shipped = dict(BLOCK=megakernel.BLOCK, NUM_WARPS=megakernel.NUM_WARPS,
                   MEGA_CULL_MIN_PRIMS=megakernel.MEGA_CULL_MIN_PRIMS,
                   MEGA_SUPER=megakernel.MEGA_SUPER)

    def run(label, scenes, **consts):
        _set(**{**shipped, **consts})
        for name in scenes:
            print(f"sweep {label}: ", end="", flush=True)
            chip_smoke.time_route(name, "megakernel", card)

    if "cull" in groups:
        scenes = ("box_diffuse", "box_balls", "materials", "colonnes")
        run("shipped", scenes)
        run("cull on", scenes, MEGA_CULL_MIN_PRIMS=0)
        run("cull off", scenes, MEGA_CULL_MIN_PRIMS=NEVER)
        run("shipped", scenes)
    if "super" in groups:
        scenes = ("materials", "colonnes")
        run("shipped", scenes)
        for s in (8, 16, 32):
            run(f"super {s}", scenes, MEGA_SUPER=s)
        run("shipped", scenes)
    if "block" in groups:
        scenes = ("box_diffuse", "colonnes")
        run("shipped", scenes)
        for b, w in ((32, 1), (64, 2), (128, 4)):
            run(f"block {b} warps {w}", scenes, BLOCK=b, NUM_WARPS=w)
        run("shipped", scenes)
    _set(**shipped)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", nargs="*", default=["cull", "super", "block"],
                    choices=["cull", "super", "block"])
    args = ap.parse_args(argv)
    import jax
    import chip_smoke
    from montecarlo_pathtracing_tpu.utils.profiling import (
        enable_compilation_cache)
    card = chip_smoke.card_line()
    chip_smoke.phase_device(card)
    enable_compilation_cache()
    sweep(args.groups, card)
    print(f"sweep done on {jax.devices()[0].device_kind} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
