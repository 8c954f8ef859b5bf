"""Process-level device choices: the compile cache directory rule, the GPU
requirement of measurement paths, and the ragged transport on every backend."""

import os

import jax
import pytest

from meepoembedding_tpu import device
from meepoembedding_tpu.parallel import ragged


def test_compile_cache_defaults_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert device.enable_compile_cache() == str(device.COMPILE_CACHE_DIR)
    assert jax.config.jax_compilation_cache_dir == str(device.COMPILE_CACHE_DIR)
    assert device.COMPILE_CACHE_DIR.parent == device.REPO_ROOT
    ignored = (device.REPO_ROOT / ".gitignore").read_text().split()
    assert f"{device.COMPILE_CACHE_DIR.name}/" in ignored


def test_compile_cache_env_is_left_alone(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        device.require_gpu()


def test_describe_names_the_device():
    d = device.describe()
    assert d == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                 "count": len(jax.devices())}


def test_card_query_never_raises():
    assert isinstance(device.card_name_and_power_limit(), str)


def _exchange_jaxpr() -> str:
    """The jaxpr of one ragged payload exchange over a 2-device mesh."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from meepoembedding_tpu.parallel.mesh import SHARD_AXIS, make_mesh

    def body(x):
        n = jnp.ones((2,), jnp.int32)
        off = jnp.arange(2, dtype=jnp.int32)
        return ragged._transport(x, jnp.zeros_like(x), off, n, off, n,
                                 SHARD_AXIS)

    f = jax.shard_map(body, mesh=make_mesh(2), in_specs=P(SHARD_AXIS),
                      out_specs=P(SHARD_AXIS), check_vma=False)
    return str(jax.make_jaxpr(f)(jnp.arange(4.0)))


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_ragged_transport_is_emulated_on_every_backend(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    jaxpr = _exchange_jaxpr()
    assert "ragged_all_to_all" not in jaxpr and "all_to_all" in jaxpr


def test_ragged_transport_override_uses_the_collective(monkeypatch):
    monkeypatch.setattr(ragged, "EMULATE_TRANSPORT", False)
    assert "ragged_all_to_all" in _exchange_jaxpr()


def test_package_import_leaves_platform_alone():
    """Importing the package sets no platform: JAX_PLATFORMS alone decides."""
    import subprocess
    import sys

    code = ("import jax, meepoembedding_tpu; "
            "print(jax.config.jax_platforms or '')")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, cwd=device.REPO_ROOT, check=True)
    assert out.stdout.strip() == "cpu"


def test_sharded_trainer_takes_ragged_exchange_on_gpu(monkeypatch):
    """run.a2a_ragged=true builds on a GPU backend: the transport choice
    lives in parallel/ragged.py alone."""
    from meepoembedding_tpu.config import (
        ModelConfig, RunConfig, TableConfig,
    )
    from meepoembedding_tpu.parallel.mesh import make_mesh
    from meepoembedding_tpu.parallel.trainer import ShardedTrainer

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    tr = ShardedTrainer(
        RunConfig(batch_size=64, a2a_ragged=True),
        TableConfig(dim=8, capacity=1 << 10),
        ModelConfig(kind="ctr_mlp", num_sparse_features=2,
                    embedding_dim=8, top_mlp=(8, 1)),
        mesh=make_mesh(2),
    )
    assert tr.a2a_ragged
