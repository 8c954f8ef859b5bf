"""Process-level device setup shared by the CLI, the bench scripts and
`chip_smoke.py`: the persistent compile cache, and the GPU check every
measurement path makes before it reports a number.

The compile cache lives where `JAX_COMPILATION_CACHE_DIR` says (JAX reads
the variable itself, so nothing here overrides it); without it, at one fixed
path inside the checkout, `<repo>/.jax_cache` (gitignored). The path is part
of the cache key, so a fixed path is what lets a second run hit.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
COMPILE_CACHE_DIR = REPO_ROOT / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(COMPILE_CACHE_DIR))
    return str(COMPILE_CACHE_DIR)


def card_name_and_power_limit() -> str:
    """`name, power.limit` of every visible card as nvidia-smi reports them
    (one card per line), or why nvidia-smi could not say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out or "nvidia-smi reported no card"


def require_gpu():
    """The first JAX device, which must be a GPU: a measurement taken on
    any other backend is not a number of this system. Exits otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev.platform} ({dev.device_kind}); "
            "this measures the GPU path only"
        )
    return dev


def describe(dev=None) -> dict:
    """The device a result was taken on, as JAX reports it."""
    import jax

    dev = dev or jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def bench_device():
    """Start of every bench script: a GPU or exit, the compile cache on, and
    the device named on stderr with the card's power limit."""
    import jax

    dev = require_gpu()
    enable_compile_cache()
    print(f"device: {dev.device_kind} x{len(jax.devices())} "
          f"[{card_name_and_power_limit()}]", file=sys.stderr, flush=True)
    return dev
