"""Integrator registry — the SrcLoader carousel as a name table.

The reference cycles GLSL integrator sources with O/P keys and recompiles
the 3-part shader (gl_viewer.h:148-220, montecarlo.cpp:292-304). Here the
"module registry" maps names to JAX integrator functions; swapping re-jits
the render step, which is the exact analog of the shader recompile.
"""
from __future__ import annotations

from .montecarlo import raytrace as montecarlo
from .montecarlo_aos import raytrace as montecarlo_aos
from .stubs import raytrace_mat as montecarlo_mat
from .stubs import raytrace_mat_tr as montecarlo_mat_tr

# order matches the reference's carousel list (montecarlo.cpp:27);
# montecarlo_aos is the readable AoS twin of the SoA production kernel
INTEGRATORS = {
    "montecarlo": montecarlo,
    "montecarlo_mat": montecarlo_mat,
    "montecarlo_mat_tr": montecarlo_mat_tr,
    "montecarlo_aos": montecarlo_aos,
}


def get_integrator(name: str):
    if name not in INTEGRATORS:
        raise KeyError(
            f"unknown integrator {name!r}; have {sorted(INTEGRATORS)}")
    return INTEGRATORS[name]


def route_kwargs(integrator, route=None, pallas_interpret=False) -> dict:
    """The routing keywords `integrator` accepts (only the montecarlo
    integrator has routes; the others ignore them)."""
    import inspect

    params = inspect.signature(integrator).parameters
    kw = dict(route=route, pallas_interpret=pallas_interpret)
    return {k: v for k, v in kw.items() if k in params}
