"""Test harness setup (SURVEY.md §4.3): the CPU backend with 8 virtual
devices, so all shard_map/all-to-all logic runs without a GPU.

`JAX_PLATFORMS` picks another backend: `JAX_PLATFORMS=cuda python -m pytest
-m gpu tests/` runs the tests that need the card (the `gpu` fixture skips
them everywhere else).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

_PLATFORMS = os.environ.get("JAX_PLATFORMS") or "cpu"
jax.config.update("jax_platforms", _PLATFORMS)

# Persistent XLA compilation cache: the suite's wall time is dominated by
# CPU compiles of the trainers' jitted steps; a warm cache cuts repeat runs
# to well under half the cold time with identical coverage. Same directory
# rule as the CLI (meepoembedding_tpu/device.py). Opt out with
# MEEPO_NO_COMPILE_CACHE=1. The loader may warn about pseudo-features
# (+prefer-no-gather) when reusing AOT results; tests verify numerics
# anyway, so a bad load fails loudly.
if not os.environ.get("MEEPO_NO_COMPILE_CACHE"):
    from meepoembedding_tpu.device import enable_compile_cache  # noqa: E402

    enable_compile_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    if _PLATFORMS == "cpu":
        # XLA:GPU's kernel cache file fails a RET_CHECK in kernel_reuse_cache
        # when this is on (H100, JAX 0.9.0), so only the CPU suite uses it
        jax.config.update("jax_persistent_cache_enable_xla_caches", "all")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first device, for tests that need the card; skips elsewhere.
    Decided here, at run time, never at import or collection."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX_PLATFORMS=cuda); have {dev.platform}")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_programs_between_modules():
    """Release compiled executables after each test module. Every trainer
    instance re-jits its step closures, so a full-suite process accumulates
    hundreds of XLA:CPU LLVM-JIT'd programs; past ~200 modules' worth the
    CPU compiler segfaults mid-compilation (observed deterministically at
    the same late test, at only ~4 GB RSS on a 125 GB box — compiler/JIT
    state, not memory pressure). Per-module cache clearing keeps the live
    executable count bounded; cross-module recompiles of the shared
    module-level jits are the (measured, small) price."""
    yield
    import gc

    jax.clear_caches()
    gc.collect()
