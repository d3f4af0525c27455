"""Global precision, compile-cache and engine configuration.

The reference runs float64 throughout (PySPH carrays are C doubles).
The GPU runs float32 far faster than float64, so the working dtype is a
process-level switch:

* ``float32`` (default) — the performance configuration,
* ``float64`` — the validation configuration (parity tests against the
  reference's float64 semantics); ``RB_X64=1`` or ``enable_x64()``.

Selecting float64 requires ``jax.config.update('jax_enable_x64', True)``
*before* any arrays are created; ``enable_x64()`` does this.

The pair engine every scheme runs is chosen here, by
:func:`select_engine`, and nowhere else.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Persistent XLA compilation cache.  A cold compile of a fused step costs
# tens of seconds, so every entry point (tests, benchmarks, case scripts)
# shares one on-disk cache.  JAX reads JAX_COMPILATION_CACHE_DIR itself;
# when it is unset the cache lives at a fixed path in the checkout (the
# path is part of the cache key, so it must not move between runs).
# ---------------------------------------------------------------------------
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
            __file__))), ".jax_cache"))
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)

_X64 = os.environ.get("RB_X64", "0") == "1"
_DTYPE = jnp.float64 if _X64 else jnp.float32
if _X64:
    jax.config.update("jax_enable_x64", True)


def enable_x64() -> None:
    """Switch the framework (and JAX) to float64. Call before building scenes."""
    global _DTYPE
    jax.config.update("jax_enable_x64", True)
    _DTYPE = jnp.float64


def set_dtype(dtype) -> None:
    global _DTYPE
    if dtype == jnp.float64:
        enable_x64()
    else:
        _DTYPE = jnp.dtype(dtype)


def float_dtype():
    """The working floating dtype for particle/body state."""
    return _DTYPE


def int_dtype():
    return jnp.int32


# ---------------------------------------------------------------------------
# Pair engine.  "cell": dense cell blocks (``ops/cellpairs.py`` and the
# ``*_cell`` ops); "nklist": padded [N, K] neighbour lists
# (``ops/neighbors.py``).  Both implement the same physics and are
# checked against each other by the tests.
# ---------------------------------------------------------------------------
ENGINES = ("cell", "nklist")

# Per-platform default.  CPU: the [N, K] gather form suits XLA:CPU.
# GPU: the faster engine on the rigid 2D contact scene at ~105k
# particles on one H100 (cell vs nklist, PERF.md "Findings").
_DEFAULT_ENGINE = {"cpu": "nklist", "gpu": "cell"}


def check_engine(name: str) -> str:
    """``name`` if it is a known engine; raises ValueError otherwise."""
    if name not in ENGINES:
        raise ValueError(f"unknown engine {name!r}; expected one of "
                         f"{', '.join(ENGINES)}")
    return name


def select_engine(platform: str | None = None) -> str:
    """The pair engine for every scheme (rigid 2D/3D, DEM, coupling).

    ``RB_ENGINE`` overrides the choice; otherwise the default for
    ``platform`` (``jax.default_backend()`` when omitted).  An unknown
    engine or platform raises."""
    env = os.environ.get("RB_ENGINE")
    if env:
        return check_engine(env)
    if platform is None:
        platform = jax.default_backend()
    if platform not in _DEFAULT_ENGINE:
        raise ValueError(f"no default engine for platform {platform!r}")
    return _DEFAULT_ENGINE[platform]
