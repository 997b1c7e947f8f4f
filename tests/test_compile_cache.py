"""The persistent compile cache's placement rule
(utils/profiling.enable_compilation_cache)."""
import os

import jax

from montecarlo_pathtracing_tpu.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _capture_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_env_dir_is_left_to_jax(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the program sets no cache
    directory of its own (JAX reads the variable itself)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    calls = _capture_updates(monkeypatch)
    assert profiling.enable_compilation_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls


def test_default_dir_is_fixed_checkout_path(monkeypatch):
    """Without it, the cache lives at <checkout>/.jax_cache — no host
    fingerprint or backend suffix, so every run on any host hits the
    same directory."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    calls = _capture_updates(monkeypatch)
    want = os.path.join(REPO, ".jax_cache")
    assert profiling.enable_compilation_cache() == want
    assert calls["jax_compilation_cache_dir"] == want
