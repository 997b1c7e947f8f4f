"""Integrator "models" — the analog of the reference's tp/*.frag carousel
(MontecarloGPU/montecarlo.cpp:27, keys O/P cycle the shader list). Each
integrator is a JAX-traceable function composed into the jitted pass;
swapping integrators re-jits, as the reference recompiles shaders."""
from .registry import INTEGRATORS, get_integrator  # noqa: F401
