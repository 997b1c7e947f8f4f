"""Checks that need the card: the compiled (not interpreted) whole-pass
kernel. Marked `gpu`; the gpu_device fixture skips them on other hosts,
and chip_smoke.py runs the same comparisons at full size on the card."""
import numpy as np
import pytest

import jax

from montecarlo_pathtracing_tpu.render.renderer import RenderConfig, Renderer
from montecarlo_pathtracing_tpu.scene import scenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene


@pytest.mark.gpu
@pytest.mark.parametrize("scene_name", ["box_diffuse", "box_balls",
                                        "materials", "colonnes"])
def test_compiled_kernel_matches_dense(gpu_device, scene_name):
    dev = compile_scene(scenes.build(scene_name))
    kw = dict(width=160, height=120, nb_bounces=3, passes_per_call=4)
    k = Renderer(dev, RenderConfig(route="megakernel", **kw)).run(4)
    with jax.default_matmul_precision("highest"):
        d = Renderer(dev, RenderConfig(route="dense", **kw)).run(4)
    close = np.all(np.abs(k - d) <= 1e-4 + 1e-3 * np.abs(d), -1)
    assert np.isfinite(k).all()
    assert close.mean() >= 0.99
