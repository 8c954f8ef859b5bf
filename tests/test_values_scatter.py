"""The values-plane scatters and gathers (table/xla_ops.py) against numpy.

A table's values plane is [value_rows, 128]; viewed as [capacity, dim] it is
plain row-major storage (dim < 128 packs 128 // dim slots per storage row,
dim > 128 spans dim // 128 rows per slot), which is what the references
below index. Values are dyadic (k / 1024), so every sum is exact in float32
in any order and results compare bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from meepoembedding_tpu.config import TableConfig
from meepoembedding_tpu.table import xla_ops
from meepoembedding_tpu.table.layout import TableSpec

NS = [1, 7, 256, 259, 768]
DIMS = [8, 32, 128, 256]
CAP = 1024  # slots; one power-of-two bucket count for every dim


def _spec(dim, dtype="float32"):
    return TableSpec.from_config(
        TableConfig(dim=dim, capacity=CAP, value_dtype=dtype)
    )


def _dyadic(rng, shape):
    return (rng.integers(-512, 512, size=shape) / 1024).astype(np.float32)


def _plane(rng, spec):
    return _dyadic(rng, (spec.value_rows, 128))


def _view(plane, spec):
    return np.asarray(plane, np.float32).reshape(spec.capacity, spec.dim)


# --- values_scatter_add: the raw [R, 128] row scatter-add --------------------

@pytest.mark.parametrize("n", NS)
def test_values_scatter_add_duplicate_rows_sum(rng, n):
    R = 512
    plane = _dyadic(rng, (R, 128))
    vrow = rng.integers(0, R // 4, size=n).astype(np.int32)  # many repeats
    upd = _dyadic(rng, (n, 128))
    want = plane.copy()
    np.add.at(want, vrow, upd)
    got = jax.jit(xla_ops.values_scatter_add)(
        jnp.asarray(plane), jnp.asarray(vrow), jnp.asarray(upd))
    np.testing.assert_array_equal(np.asarray(got), want)


def test_values_scatter_add_drops_out_of_range(rng):
    R = 256
    plane = _dyadic(rng, (R, 128))
    vrow = np.array([-1, 5, R, 5, 2**30, -(2**31)], np.int32)
    upd = _dyadic(rng, (len(vrow), 128))
    want = plane.copy()
    want[5] += upd[1] + upd[3]
    got = xla_ops.values_scatter_add(
        jnp.asarray(plane), jnp.asarray(vrow), jnp.asarray(upd))
    np.testing.assert_array_equal(np.asarray(got), want)


def test_values_scatter_add_all_dropped(rng):
    R = 256
    plane = _dyadic(rng, (R, 128))
    vrow = np.full((16,), -1, np.int32)
    got = xla_ops.values_scatter_add(
        jnp.asarray(plane), jnp.asarray(vrow),
        jnp.asarray(_dyadic(rng, (16, 128))))
    np.testing.assert_array_equal(np.asarray(got), plane)


def test_values_scatter_add_bf16_plane(rng):
    """bf16 planes add the update cast to bf16, one rounding per row."""
    R = 256
    plane = jnp.asarray(rng.normal(size=(R, 128)) * 0.1, jnp.bfloat16)
    vrow = rng.choice(R, size=100, replace=False).astype(np.int32)
    upd = rng.normal(size=(100, 128)).astype(np.float32)
    want = np.array(plane.astype(jnp.float32))
    want[vrow] = np.asarray(
        (plane[vrow] + jnp.asarray(upd).astype(jnp.bfloat16)).astype(jnp.float32))
    got = xla_ops.values_scatter_add(plane, jnp.asarray(vrow), jnp.asarray(upd))
    assert got.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got.astype(jnp.float32)), want)


# --- spec-level scatters and gathers over [capacity, dim] views -------------

@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("n", NS)
def test_scatter_add_values(rng, n, dim):
    """Sparse adds at unique slots; disabled slots drop. Packed slots that
    share a storage row add into disjoint lane windows."""
    spec = _spec(dim)
    plane = _plane(rng, spec)
    slot = rng.choice(spec.capacity, size=n, replace=False).astype(np.int32)
    upd = _dyadic(rng, (n, dim))
    en = rng.random(n) < 0.8
    want = _view(plane, spec).copy()
    want[slot[en]] += upd[en]
    got = jax.jit(xla_ops.scatter_add_values, static_argnums=0)(
        spec, jnp.asarray(plane), jnp.asarray(slot), jnp.asarray(upd),
        jnp.asarray(en))
    np.testing.assert_array_equal(_view(got, spec), want)


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("n", NS)
def test_scatter_set_values(rng, n, dim):
    """Row SET at unique slots; neighbors in the same storage row keep their
    lanes (disjoint-lane merge); disabled slots drop."""
    spec = _spec(dim)
    plane = _plane(rng, spec)
    slot = rng.choice(spec.capacity, size=n, replace=False).astype(np.int32)
    rows = _dyadic(rng, (n, dim))
    en = rng.random(n) < 0.8
    want = _view(plane, spec).copy()
    want[slot[en]] = rows[en]
    got = jax.jit(xla_ops.scatter_set_values, static_argnums=0)(
        spec, jnp.asarray(plane), jnp.asarray(slot), jnp.asarray(rows),
        jnp.asarray(en))
    np.testing.assert_array_equal(_view(got, spec), want)


def test_scatter_set_values_packed_neighbors(rng):
    """Every slot of some storage rows is set in one call (the combine pass
    unions their lane windows), others only partly."""
    spec = _spec(32)  # 4 slots per storage row
    plane = _plane(rng, spec)
    slot = np.array([8, 9, 10, 11, 40, 43, 100], np.int32)
    rows = _dyadic(rng, (len(slot), 32))
    want = _view(plane, spec).copy()
    want[slot] = rows
    got = xla_ops.scatter_set_values(
        spec, jnp.asarray(plane), jnp.asarray(slot), jnp.asarray(rows),
        jnp.ones(len(slot), bool))
    np.testing.assert_array_equal(_view(got, spec), want)


def test_scatter_set_values_bf16(rng):
    spec = _spec(32, "bfloat16")
    plane = jnp.asarray(_plane(rng, spec), jnp.bfloat16)
    slot = rng.choice(spec.capacity, size=64, replace=False).astype(np.int32)
    rows = (rng.integers(-128, 128, size=(64, 32)) / 256).astype(np.float32)
    want = np.array(_view(plane.astype(jnp.float32), spec))
    want[slot] = rows
    got = xla_ops.scatter_set_values(
        spec, plane, jnp.asarray(slot), jnp.asarray(rows), jnp.ones(64, bool))
    assert got.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_view(got.astype(jnp.float32), spec), want)


def test_scatter_set_values_all_disabled(rng):
    spec = _spec(32)
    plane = _plane(rng, spec)
    got = xla_ops.scatter_set_values(
        spec, jnp.asarray(plane), jnp.arange(16, dtype=jnp.int32),
        jnp.asarray(_dyadic(rng, (16, 32))), jnp.zeros(16, bool))
    np.testing.assert_array_equal(np.asarray(got), plane)


@pytest.mark.parametrize("dim", DIMS)
def test_gather_values(rng, dim):
    spec = _spec(dim)
    plane = _plane(rng, spec)
    slot = rng.integers(0, spec.capacity, size=259).astype(np.int32)
    got = jax.jit(xla_ops.gather_values, static_argnums=0)(
        spec, jnp.asarray(plane), jnp.asarray(slot))
    np.testing.assert_array_equal(np.asarray(got), _view(plane, spec)[slot])
