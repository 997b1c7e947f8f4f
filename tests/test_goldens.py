"""Golden-statistics regression oracle for all built-in scenes.

The reference's regression oracle is 26 golden screenshots in captures/
(SURVEY.md §4). The equivalent here: recorded image statistics at a fixed
tiny configuration (24x18, 2 spp, 5 bounces, default seeds — fully
deterministic), asserted exactly-close on every run. A change to any
intersector, sampler, material case, RNG stream or scene constructor
shows up here immediately."""
import json
import os

import numpy as np
import pytest

from montecarlo_pathtracing_tpu.scene import scenes
from montecarlo_pathtracing_tpu.scene.device import compile_scene
from montecarlo_pathtracing_tpu.render.renderer import RenderConfig, Renderer

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_stats.json")


@pytest.mark.parametrize("name", sorted(scenes.SCENES))
def test_scene_statistics_match_golden(name):
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert name in golden, f"regenerate golden_stats.json (missing {name})"
    dev = compile_scene(scenes.build(name))
    r = Renderer(dev, RenderConfig(width=24, height=18, nb_bounces=5))
    img = r.run(2)
    got = {
        "mean": float(img.mean()),
        "std": float(img.std()),
        "max": float(img.max()),
        "nonzero_frac": float((img.sum(-1) > 0).mean()),
    }
    for k, want in golden[name].items():
        assert abs(got[k] - want) <= 1e-4 + 1e-4 * abs(want), (
            f"{name}.{k}: got {got[k]}, golden {want}")
