"""Ragged all-to-all exchange (parallel/ragged.py, SURVEY.md C13) on the
8-virtual-device CPU mesh.

The transport is the emulation on every backend (ragged.EMULATE_TRANSPORT,
ROADMAP B9), element-exact to the collective's write semantics (same
offsets/sizes/prefill behavior), so these tests run the production path:
plan negotiation, clamping, drop accounting, owner-side dedup/lookup, both
reverse legs. chip_smoke.py --four-cards checks it against one card on
GPUs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from meepoembedding_tpu.config import (
    ModelConfig, OptimizerConfig, RunConfig, TableConfig,
)
from meepoembedding_tpu.data.synthetic import SyntheticConfig, SyntheticStream
from meepoembedding_tpu.ops import dedup
from meepoembedding_tpu.parallel import ragged as rg
from meepoembedding_tpu.parallel import sharded_table as st
from meepoembedding_tpu.parallel.mesh import SHARD_AXIS, make_mesh
from meepoembedding_tpu.parallel.trainer import ShardedTrainer, alloc_stacked_shards
from meepoembedding_tpu.table import hashing
from meepoembedding_tpu.table.layout import TableSpec

S = 8


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= S, "conftest must provide 8 virtual devices"
    return make_mesh(S)


def test_emulated_transport_matches_ragged_semantics(mesh):
    """Known per-pair segment sizes: device i sends sizes[i,j] copies of
    i*100+j to device j; every receiver must see each source's chunk at its
    negotiated offset, in source order, with prefill elsewhere."""
    N = 16
    rng = np.random.default_rng(0)
    sizes = rng.integers(0, 3, size=(S, S)).astype(np.int32)
    ops = np.zeros((S, N), np.int32)
    for i in range(S):
        k = 0
        for j in range(S):
            for _ in range(sizes[i, j]):
                ops[i, k] = i * 100 + j
                k += 1

    def body(ids, send_sizes):
        ids = ids.reshape(-1)
        send = send_sizes.reshape(-1).astype(jnp.int32)
        recv = jax.lax.all_to_all(send.reshape(S, 1), SHARD_AXIS, 0, 0).reshape(-1)
        in_off = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.cumsum(send)[:-1].astype(jnp.int32)]
        )
        recv_off = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.cumsum(recv)[:-1].astype(jnp.int32)]
        )
        out_off = jax.lax.all_to_all(
            recv_off.reshape(S, 1), SHARD_AXIS, 0, 0
        ).reshape(-1)
        out = jnp.full((2 * N,), -1, ids.dtype)
        res = rg._transport(ids, out, in_off, send, out_off, recv, SHARD_AXIS)
        return res[None]

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
        out_specs=P(SHARD_AXIS), check_vma=False,
    ))
    res = np.asarray(fn(jnp.asarray(ops.reshape(-1)), jnp.asarray(sizes.reshape(-1))))
    for j in range(S):
        expect = []
        for i in range(S):
            expect += [i * 100 + j] * int(sizes[i, j])
        got = [int(x) for x in res[j] if x >= 0]
        assert got == expect, (j, expect, got)


def _exchange_fns(spec, mesh, n, dense_cap, rcap):
    def impl_dense(stacked, hi, lo, step):
        shard = st.squeeze_shard(stacked)
        uniq = dedup.unique_pairs(hi, lo, n)
        shard, emb_u, _ = st.exchange_lookup(
            spec, shard, uniq.hi, uniq.lo, uniq.valid, step, SHARD_AXIS, dense_cap
        )
        return st.unsqueeze_shard(shard), emb_u[uniq.inverse]

    def impl_ragged(stacked, hi, lo, step):
        shard = st.squeeze_shard(stacked)
        uniq = dedup.unique_pairs(hi, lo, n)
        shard, emb_u, _ = st.exchange_lookup(
            spec, shard, uniq.hi, uniq.lo, uniq.valid, step, SHARD_AXIS, rcap,
            ragged=True,
        )
        return st.unsqueeze_shard(shard), emb_u[uniq.inverse]

    def mk(impl):
        return jax.jit(jax.shard_map(
            impl, mesh=mesh,
            in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P()),
            out_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
            check_vma=False,
        ))

    return mk(impl_dense), mk(impl_ragged)


def test_ragged_exchange_bit_identical_to_dense(mesh, rng):
    """Same id stream through the dense and ragged exchanges: the owner-side
    unique sequence is sorted by key (dedup.unique_pairs), so slot
    assignment, table state and returned rows must be BIT-identical."""
    dim = 8
    cfg = TableConfig(dim=dim, capacity=1 << 14, initializer_scale=0.02)
    spec = TableSpec.from_config(cfg, num_shards=S)
    n = 1024  # per-device ids
    dense_cap = st.a2a_capacity(n, S, 1.25)
    rcap = rg.ragged_recv_cap(n, S, 1.25)
    f_dense, f_ragged = _exchange_fns(spec, mesh, n, dense_cap, rcap)
    st_d = alloc_stacked_shards(spec, mesh)
    st_r = alloc_stacked_shards(spec, mesh)
    for step in range(3):
        ids = rng.integers(0, 50_000, size=S * n, dtype=np.int64) * 2654435761 % (10**15)
        hi, lo = hashing.split_ids(ids)
        hi, lo = jnp.asarray(hi), jnp.asarray(lo)
        st_d, emb_d = f_dense(st_d, hi, lo, jnp.int32(step))
        st_r, emb_r = f_ragged(st_r, hi, lo, jnp.int32(step))
        np.testing.assert_array_equal(
            np.asarray(emb_d), np.asarray(emb_r), err_msg=f"step {step}"
        )
    for name in ("key_hi", "key_lo", "cnt"):
        np.testing.assert_array_equal(
            np.asarray(getattr(st_d, name)), np.asarray(getattr(st_r, name)),
            err_msg=name,
        )
    vals_d = np.asarray(st_d.values, np.float32)
    vals_r = np.asarray(st_r.values, np.float32)
    np.testing.assert_array_equal(vals_d, vals_r)
    drops = np.asarray(st_r.counters).sum(axis=0)[st.ROUTE_DROPS]
    assert drops == 0, f"ragged exchange dropped {drops} at production factor"


def test_ragged_trainer_matches_dense_trainer(mesh):
    """Full training: a2a_ragged=True must track the dense exchange
    step-for-step (identical owner-side math; transport only)."""
    dim = 8
    table = TableConfig(
        dim=dim, capacity=1 << 14, initializer_scale=0.02,
        optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.1),
    )
    model = ModelConfig(
        kind="ctr_mlp", num_dense_features=4, num_sparse_features=4,
        embedding_dim=dim, bottom_mlp=(16, dim), top_mlp=(32, 1),
    )
    data = SyntheticConfig(num_dense=4, num_sparse=4, batch_size=256,
                           vocab_per_feature=300)

    def run_losses(ragged):
        run = RunConfig(batch_size=256, steps=8, dense_learning_rate=3e-3,
                        seed=3, pipeline_depth=0, a2a_ragged=ragged)
        tr = ShardedTrainer(run, table, model, mesh=mesh)
        losses = [
            tr.train_step(b)["loss"]
            for b in SyntheticStream(data).batches(run.steps)
        ]
        return losses, tr

    l_dense, tr_d = run_losses(False)
    l_ragged, tr_r = run_losses(True)
    np.testing.assert_allclose(l_dense, l_ragged, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        np.asarray(tr_d.stacked.cnt), np.asarray(tr_r.stacked.cnt)
    )
    assert tr_r.counters()["route_drops"] == 0


def test_ragged_eval_path(mesh):
    dim = 8
    run = RunConfig(batch_size=256, steps=4, dense_learning_rate=3e-3,
                    pipeline_depth=0, a2a_ragged=True)
    table = TableConfig(dim=dim, capacity=1 << 14)
    model = ModelConfig(
        kind="ctr_mlp", num_dense_features=4, num_sparse_features=4,
        embedding_dim=dim, bottom_mlp=(16, dim), top_mlp=(32, 1),
    )
    data = SyntheticConfig(num_dense=4, num_sparse=4, batch_size=256,
                           vocab_per_feature=300)
    tr = ShardedTrainer(run, table, model, mesh=mesh)
    stream = SyntheticStream(data).batches(run.steps + 1)
    for _ in range(run.steps):
        tr.train_step(next(stream))
    out = tr.eval_step(next(stream))
    assert np.isfinite(out["loss"])
    assert out["route_drops"] == 0


def test_ragged_clamp_counts_drops_and_auto_resize(mesh):
    """An undersized RECEIVER buffer must clamp sender tails, count every
    clipped id exactly once, and trigger the trainer's factor auto-double."""
    dim = 8
    run = RunConfig(batch_size=4096, steps=4, dense_learning_rate=3e-3,
                    a2a_factor=0.35, a2a_ragged=True)
    table = TableConfig(dim=dim, capacity=1 << 16)
    model = ModelConfig(
        kind="ctr_mlp", num_dense_features=4, num_sparse_features=4,
        embedding_dim=dim, bottom_mlp=(16, dim), top_mlp=(32, 1),
    )
    data = SyntheticConfig(
        num_dense=4, num_sparse=4, batch_size=4096, vocab_per_feature=200000
    )
    tr = ShardedTrainer(run, table, model, mesh=mesh)
    stream = SyntheticStream(data).batches(4)
    tr.train_step(next(stream))
    tr.flush()
    drops_after_1 = tr.counters()["route_drops"]
    assert drops_after_1 > 0, "setup must overflow the ragged receiver"
    assert tr.a2a_factor > run.a2a_factor, "factor must have grown"
    for batch in stream:
        tr.train_step(batch)
    tr.flush()
    assert tr.counters()["route_drops"] == drops_after_1, "drops must stop"


def test_ragged_group_trainer_matches_dense(mesh):
    """Heterogeneous multi-table exchange over the ragged transport: the
    ShardedGroupTrainer with a2a_ragged=True must track the dense wire."""
    from meepoembedding_tpu.group_train import ShardedGroupTrainer

    tables = {
        "user": TableConfig(
            dim=16, capacity=1 << 13, initializer_scale=0.02,
            optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.05),
        ),
        "item": TableConfig(
            dim=8, capacity=1 << 12, initializer_scale=0.02,
            optimizer=OptimizerConfig(kind="ftrl", learning_rate=0.05),
        ),
    }
    feature_map = ["user", "item", "item"]
    model = ModelConfig(
        kind="ctr_mlp", num_dense_features=4, num_sparse_features=3,
        embedding_dim=16, top_mlp=(32, 1),
    )

    def batches(n):
        rng = np.random.default_rng(0)
        for _ in range(n):
            yield {
                "ids": np.stack(
                    [
                        rng.integers(0, 4000, size=128),
                        rng.integers(0, 900, size=128),
                        rng.integers(0, 900, size=128),
                    ],
                    axis=1,
                ).astype(np.int64),
                "dense": rng.normal(size=(128, 4)).astype(np.float32),
                "label": rng.integers(0, 2, size=128).astype(np.float32),
            }

    def losses(ragged):
        run = RunConfig(batch_size=128, steps=6, dense_learning_rate=3e-3,
                        seed=2, pipeline_depth=0, a2a_ragged=ragged)
        tr = ShardedGroupTrainer(run, tables, feature_map, model, mesh=mesh)
        out = [tr.train_step(b)["loss"] for b in batches(run.steps)]
        return out, tr

    l_d, tr_d = losses(False)
    l_r, tr_r = losses(True)
    np.testing.assert_allclose(l_d, l_r, rtol=1e-6, atol=1e-7)
    c_d, c_r = tr_d.counters(), tr_r.counters()
    for n in ("user", "item"):
        assert c_d[n]["rows"] == c_r[n]["rows"], (n, c_d[n], c_r[n])


def test_owner_sorted_ragged_bit_identical(mesh, rng):
    """The slimmed plan (owner-major dedup + owner_sorted=True: no [U]
    argsort in make_plan, one-round all_gather negotiation) must produce
    BIT-identical batch-order rows and table state as the standard ragged
    path (VERDICT r4 next-#8)."""
    dim = 8
    cfg = TableConfig(dim=dim, capacity=1 << 14, initializer_scale=0.02)
    spec = TableSpec.from_config(cfg, num_shards=S)
    n = 1024
    rcap = rg.ragged_recv_cap(n, S, 1.25)

    def impl_std(stacked, hi, lo, step):
        shard = st.squeeze_shard(stacked)
        uniq = dedup.unique_pairs(hi, lo, n)
        shard, emb_u, _ = st.exchange_lookup(
            spec, shard, uniq.hi, uniq.lo, uniq.valid, step, SHARD_AXIS, rcap,
            ragged=True,
        )
        return st.unsqueeze_shard(shard), emb_u[uniq.inverse]

    def impl_osort(stacked, hi, lo, step):
        shard = st.squeeze_shard(stacked)
        uniq = dedup.unique_pairs(hi, lo, n, owner_major=S)
        shard, emb_u, _ = st.exchange_lookup(
            spec, shard, uniq.hi, uniq.lo, uniq.valid, step, SHARD_AXIS, rcap,
            ragged=True, owner_sorted=True,
        )
        return st.unsqueeze_shard(shard), emb_u[uniq.inverse]

    def mk(impl):
        return jax.jit(jax.shard_map(
            impl, mesh=mesh,
            in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P()),
            out_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
            check_vma=False,
        ))

    f_std, f_os = mk(impl_std), mk(impl_osort)
    st_a = alloc_stacked_shards(spec, mesh)
    st_b = alloc_stacked_shards(spec, mesh)
    for step in range(3):
        ids = rng.integers(0, 50_000, size=S * 1024, dtype=np.int64) * 2654435761 % (10**15)
        hi, lo = hashing.split_ids(ids)
        hi, lo = jnp.asarray(hi), jnp.asarray(lo)
        st_a, emb_a = f_std(st_a, hi, lo, jnp.int32(step))
        st_b, emb_b = f_os(st_b, hi, lo, jnp.int32(step))
        np.testing.assert_array_equal(
            np.asarray(emb_a), np.asarray(emb_b), err_msg=f"step {step}"
        )
    for name in ("key_hi", "key_lo", "cnt"):
        np.testing.assert_array_equal(
            np.asarray(getattr(st_a, name)), np.asarray(getattr(st_b, name)),
            err_msg=name,
        )
    np.testing.assert_array_equal(
        np.asarray(st_a.values, np.float32), np.asarray(st_b.values, np.float32)
    )
