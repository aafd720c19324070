"""Device compute path: batched limb field kernels, complete-formula curve
ops, vectorized GLV/Straus MSM, and the JaxEngine that plugs them into the
protocol layer (bulletproofspp_tpu.core.engine)."""

import os as _os

import jax as _jax


def compile_cache_dir():
    """Where the persistent XLA compilation cache lives: the directory
    ``JAX_COMPILATION_CACHE_DIR`` names (JAX reads it itself), else
    ``.jax_cache`` at the root of the checkout.  None with
    ``BPPP_NO_COMPILE_CACHE`` set (multi-process runs, see ops.dist)."""
    if _os.environ.get("BPPP_NO_COMPILE_CACHE"):
        return None
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
    return _os.path.join(root, ".jax_cache")


# The kernel zoo (one executable per lane bucket) compiles once per
# checkout instead of once per process.
_cache = compile_cache_dir()
if _cache is not None and not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _cache)
if _cache is not None:
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
