"""Multi-chip logic on the 8-virtual-device CPU mesh (SURVEY.md §4.3):
sharded lookup must be semantically identical to a single-shard table."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from meepoembedding_tpu.config import ModelConfig, OptimizerConfig, RunConfig, TableConfig
from meepoembedding_tpu.data.synthetic import SyntheticConfig, SyntheticStream
from meepoembedding_tpu.metrics import JsonlLogger
from meepoembedding_tpu.parallel import sharded_table as st
from meepoembedding_tpu.parallel.mesh import SHARD_AXIS, make_mesh
from meepoembedding_tpu.parallel.trainer import ShardedTrainer, alloc_stacked_shards
from meepoembedding_tpu.table import hashing
from meepoembedding_tpu.table.layout import TableSpec
from meepoembedding_tpu.table.oracle import OracleTable


def _ids(rng, n, pool=200):
    return rng.integers(0, 10**12, size=pool, dtype=np.int64)[
        rng.integers(0, pool, size=n)
    ]


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


def _sharded_lookup_fn(spec, mesh, n, cap):
    def impl(stacked, hi, lo, step):
        shard = st.squeeze_shard(stacked)
        from meepoembedding_tpu.ops import dedup

        uniq = dedup.unique_pairs(hi, lo, n)
        shard, emb_u, ctx = st.exchange_lookup(
            spec, shard, uniq.hi, uniq.lo, uniq.valid, step, SHARD_AXIS, cap
        )
        return st.unsqueeze_shard(shard), emb_u[uniq.inverse], ctx

    return jax.jit(
        jax.shard_map(
            impl,
            mesh=mesh,
            in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P()),
            out_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS)),
            check_vma=False,
        )
    )


def test_sharded_lookup_matches_oracle(mesh, rng):
    dim = 8
    cfg = TableConfig(dim=dim, capacity=128 * 64, initializer_scale=0.02)
    spec = TableSpec.from_config(cfg, num_shards=8)
    stacked = alloc_stacked_shards(spec, mesh)
    oracle = OracleTable(dim, 0.02)
    n_per_dev = 64
    cap = st.a2a_capacity(n_per_dev, 8)  # production default factor
    fn = _sharded_lookup_fn(spec, mesh, n_per_dev, cap)
    for step in range(3):
        ids = _ids(rng, 8 * n_per_dev)
        hi, lo = hashing.split_ids(ids)
        stacked, rows, _ = fn(stacked, jnp.asarray(hi), jnp.asarray(lo), jnp.int32(step))
        expect = oracle.lookup(ids, step=step)
        np.testing.assert_allclose(np.asarray(rows), expect, atol=1e-5)


def test_keys_land_on_owner_shard(mesh, rng):
    """Every inserted key must live on exactly its owner(key) shard."""
    dim = 8
    cfg = TableConfig(dim=dim, capacity=128 * 64)
    spec = TableSpec.from_config(cfg, num_shards=8)
    stacked = alloc_stacked_shards(spec, mesh)
    ids = rng.permutation(np.arange(1, 100001, dtype=np.int64) * 7919)[:512]
    n_per_dev = 64
    hi, lo = hashing.split_ids(ids)
    cap = st.a2a_capacity(n_per_dev, 8)
    fn = _sharded_lookup_fn(spec, mesh, n_per_dev, cap)
    stacked, _, _ = fn(stacked, jnp.asarray(hi), jnp.asarray(lo), jnp.int32(0))
    owners = np.asarray(hashing.owner_of(jnp.asarray(hi), jnp.asarray(lo), 8))
    kh = np.asarray(jax.device_get(stacked.key_hi))  # [8, nb, 128]
    kl = np.asarray(jax.device_get(stacked.key_lo))
    live = ~((kh == hashing.EMPTY_HI) & (kl == hashing.EMPTY_LO))
    for s in range(8):
        got = set(hashing.join_ids(kh[s][live[s]], kl[s][live[s]]))
        expect = set(ids[owners == s].tolist())
        assert got == expect, f"shard {s} holds wrong keys"


def test_sharded_trainer_learns(mesh):
    dim = 8
    run = RunConfig(batch_size=512, steps=70, dense_learning_rate=3e-3)
    table = TableConfig(
        dim=dim, capacity=1 << 15, optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.1)
    )
    model = ModelConfig(
        kind="ctr_mlp", num_dense_features=4, num_sparse_features=4,
        embedding_dim=dim, bottom_mlp=(16, dim), top_mlp=(32, 1),
    )
    data = SyntheticConfig(num_dense=4, num_sparse=4, batch_size=512, vocab_per_feature=500)
    tr = ShardedTrainer(run, table, model, mesh=mesh)
    for batch in SyntheticStream(data).batches(run.steps):
        tr.train_step(batch)
    assert tr.auc.compute() > 0.6
    c = tr.counters()
    assert c["inserts"] > 0 and c["hits"] > 0
    # keys spread across shards
    cnt = np.asarray(jax.device_get(tr.stacked.cnt)).sum(axis=(1,))
    assert (cnt > 0).all()


def test_exchange_drop_free_at_default_factor(mesh, rng):
    """VERDICT r1 #3: at the production factor (1.25) a zipf-skewed id stream
    must show route_drops == 0 — per-destination counts are binomial under
    the murmur owner hash, so 1.25x the mean is tens of sigma of headroom."""
    dim = 8
    cfg = TableConfig(dim=dim, capacity=1 << 17, initializer_scale=0.02)
    spec = TableSpec.from_config(cfg, num_shards=8)
    stacked = alloc_stacked_shards(spec, mesh)
    n_per_dev = 2048
    cap = st.a2a_capacity(n_per_dev, 8, factor=1.25)
    assert cap < n_per_dev, "capacity must be genuinely sub-lossless"
    fn = _sharded_lookup_fn(spec, mesh, n_per_dev, cap)
    for step in range(4):
        # zipf-ish: hot head + long tail; uniques close to the dedup cap
        hot = rng.integers(0, 3000, size=8 * n_per_dev // 2)
        tail = rng.integers(0, 10**9, size=8 * n_per_dev - len(hot))
        ids = (np.concatenate([hot, tail]).astype(np.int64) * 7919) + 1
        hi, lo = hashing.split_ids(ids)
        stacked, _, _ = fn(stacked, jnp.asarray(hi), jnp.asarray(lo), jnp.int32(step))
    counters = np.asarray(jax.device_get(stacked.counters)).sum(axis=0)
    assert counters[st.ROUTE_DROPS] == 0, f"drops: {counters[st.ROUTE_DROPS]}"


def test_exchange_auto_resizes_on_drops(mesh):
    """An undersized exchange capacity must be detected (route_drops) and the
    trainer must auto-double a2a_factor so drops stop."""
    dim = 8
    run = RunConfig(
        batch_size=4096, steps=4, dense_learning_rate=3e-3, a2a_factor=0.35
    )
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
    drops_after_1 = tr.counters()["route_drops"]
    assert drops_after_1 > 0, "test setup must actually overflow the exchange"
    assert tr.a2a_factor > run.a2a_factor, "factor must have grown"
    for batch in stream:
        tr.train_step(batch)
    assert tr.counters()["route_drops"] == drops_after_1, "drops must stop"


def test_sharded_matches_single_device_training(mesh):
    """Sharded training must track single-device training (same data)."""
    from meepoembedding_tpu.train import Trainer

    dim = 8
    # pipeline_depth=0: compare exact per-step losses without the fetch lag
    run = RunConfig(batch_size=256, steps=8, dense_learning_rate=3e-3, seed=3,
                    pipeline_depth=0)
    table = TableConfig(dim=dim, capacity=1 << 14, initializer_scale=0.02)
    model = ModelConfig(
        kind="ctr_mlp", num_dense_features=4, num_sparse_features=4,
        embedding_dim=dim, bottom_mlp=(16, dim), top_mlp=(32, 1),
    )
    data = SyntheticConfig(num_dense=4, num_sparse=4, batch_size=256, vocab_per_feature=300)
    t1 = Trainer(run, table, model)
    t8 = ShardedTrainer(run, table, model, mesh=mesh)
    losses1, losses8 = [], []
    for batch in SyntheticStream(data).batches(run.steps):
        losses1.append(t1.train_step(batch)["loss"])
        losses8.append(t8.train_step(batch)["loss"])
    np.testing.assert_allclose(losses1, losses8, rtol=2e-3, atol=2e-4)


def test_bf16_wire_parity_s8_vs_single_device(mesh, monkeypatch):
    """bf16 tables quantize per-unique grads to bf16 BEFORE the a2a (S>1
    only), so S>1 numerics drift from the single-device/S==1 f32-grad path
    by bf16 rounding per step (advisor r3). Assert the drift stays within
    tolerance over real training, and that MEEPO_GRAD_WIRE_BF16=0 restores
    an f32 wire that tracks at least as closely."""
    from meepoembedding_tpu.train import Trainer

    dim = 8
    run = RunConfig(batch_size=256, steps=10, dense_learning_rate=3e-3,
                    seed=3, pipeline_depth=0)
    table = TableConfig(dim=dim, capacity=1 << 14, initializer_scale=0.02,
                        value_dtype="bfloat16")
    model = ModelConfig(
        kind="ctr_mlp", num_dense_features=4, num_sparse_features=4,
        embedding_dim=dim, bottom_mlp=(16, dim), top_mlp=(32, 1),
    )
    data = SyntheticConfig(num_dense=4, num_sparse=4, batch_size=256,
                           vocab_per_feature=300)

    def sharded_losses(wire_bf16):
        monkeypatch.setattr(st, "GRAD_WIRE_BF16", wire_bf16)
        tr = ShardedTrainer(run, table, model, mesh=mesh)
        return [
            tr.train_step(b)["loss"]
            for b in SyntheticStream(data).batches(run.steps)
        ]

    single = Trainer(run, table, model)
    losses1 = [
        single.train_step(b)["loss"]
        for b in SyntheticStream(data).batches(run.steps)
    ]
    l_bf16 = sharded_losses(True)
    l_f32 = sharded_losses(False)
    err_bf16 = np.max(np.abs(np.asarray(l_bf16) - np.asarray(losses1)))
    err_f32 = np.max(np.abs(np.asarray(l_f32) - np.asarray(losses1)))
    assert err_bf16 < 1e-2, (err_bf16, l_bf16, losses1)
    assert err_f32 < 1e-2, (err_f32, l_f32, losses1)


def test_sharded_remove(mesh, rng):
    """Distributed erase: remove via the a2a owner routing must delete each
    key on exactly its owner shard and agree with single-device semantics
    (re-lookup reinserts fresh deterministic rows)."""
    run = RunConfig(batch_size=512, steps=5, dense_learning_rate=3e-3)
    table = TableConfig(dim=8, capacity=1 << 15)
    model = ModelConfig(
        kind="ctr_mlp", num_dense_features=4, num_sparse_features=4,
        embedding_dim=8, bottom_mlp=(16, 8), top_mlp=(32, 1),
    )
    data = SyntheticConfig(num_dense=4, num_sparse=4, batch_size=512, vocab_per_feature=500)
    tr = ShardedTrainer(run, table, model, mesh=mesh)
    seen = set()
    for batch in SyntheticStream(data).batches(5):
        tr.train_step(batch)
        seen.update(np.asarray(batch["ids"]).reshape(-1).tolist())
    seen = np.array(sorted(seen), np.int64)
    before = tr.counters()["inserts"] - tr.counters()["evictions"]
    victims = seen[: len(seen) // 2]
    absent = np.arange(10**13, 10**13 + 7, dtype=np.int64)
    removed = tr.remove(np.concatenate([victims, absent]))
    assert removed == len(victims)
    cnt = int(np.asarray(jax.device_get(tr.stacked.cnt)).sum())
    assert cnt == before - len(victims)
    # removed keys are gone from every shard's key planes
    kh = np.asarray(jax.device_get(tr.stacked.key_hi))
    kl = np.asarray(jax.device_get(tr.stacked.key_lo))
    live = ~((kh == hashing.EMPTY_HI) & (kl == hashing.EMPTY_LO))
    held = set()
    for s in range(kh.shape[0]):
        held.update(hashing.join_ids(kh[s][live[s]], kl[s][live[s]]).tolist())
    assert not (held & set(victims.tolist()))
    assert set(seen.tolist()) - set(victims.tolist()) <= held | set(victims.tolist())


@pytest.mark.slow
def test_sharded_online_growth(mesh, rng):
    """Distributed growth-by-rehash (SURVEY C11, sharded): start tiny, feed
    ~6x capacity in unique ids — every shard doubles in lockstep, no id is
    ever dropped, owner placement survives growth, training continues."""
    run = RunConfig(batch_size=512, steps=4, dense_learning_rate=3e-3)
    table = TableConfig(dim=8, capacity=1 << 12, grow_at_load=0.7)
    model = ModelConfig(
        kind="ctr_mlp", num_dense_features=4, num_sparse_features=4,
        embedding_dim=8, bottom_mlp=(16, 8), top_mlp=(32, 1),
    )
    tr = ShardedTrainer(run, table, model, mesh=mesh)
    cap0 = tr.spec.capacity
    seen = set()
    data = SyntheticConfig(
        num_dense=4, num_sparse=4, batch_size=512,
        vocab_per_feature=3000, zipf_a=1.01, seed=2,  # near-unique stream
    )
    for batch in SyntheticStream(data).batches(run.steps):
        tr.train_step(batch)
        seen.update(np.asarray(batch["ids"]).reshape(-1).tolist())
    assert tr.spec.capacity > cap0  # grew at least once
    c = tr.counters()
    assert c["drops"] == 0 and c["route_drops"] == 0
    live = int(np.asarray(jax.device_get(tr.stacked.cnt)).sum())
    assert live == len(seen), (live, len(seen))
    # owner placement still correct after growth
    kh = np.asarray(jax.device_get(tr.stacked.key_hi))
    kl = np.asarray(jax.device_get(tr.stacked.key_lo))
    livem = ~((kh == hashing.EMPTY_HI) & (kl == hashing.EMPTY_LO))
    for s in range(kh.shape[0]):
        ids_s = hashing.join_ids(kh[s][livem[s]], kl[s][livem[s]])
        h, l = hashing.split_ids(ids_s)
        owners = np.asarray(hashing.owner_of(jnp.asarray(h), jnp.asarray(l), kh.shape[0]))
        assert (owners == s).all()


def test_erase_after_growth_uses_fresh_geometry(mesh, rng):
    """grow() must invalidate the cached jitted erase fns (they bind the old
    spec's shapes); removing ids right after a growth has to work and hit
    the new geometry."""
    run = RunConfig(batch_size=512, steps=2, dense_learning_rate=3e-3)
    table = TableConfig(dim=8, capacity=1 << 12)
    model = ModelConfig(
        kind="ctr_mlp", num_dense_features=4, num_sparse_features=4,
        embedding_dim=8, bottom_mlp=(16, 8), top_mlp=(32, 1),
    )
    data = SyntheticConfig(num_dense=4, num_sparse=4, batch_size=512,
                           vocab_per_feature=400)
    tr = ShardedTrainer(run, table, model, mesh=mesh)
    seen = set()
    for batch in SyntheticStream(data).batches(2):
        tr.train_step(batch)
        seen.update(np.asarray(batch["ids"]).reshape(-1).tolist())
    ids = np.array(sorted(seen), np.int64)
    assert tr.remove(ids[:10]) == 10  # caches an erase fn at the old spec
    tr.grow()
    assert tr.spec.capacity == 2 * TableSpec.from_config(table, 8).capacity
    removed = tr.remove(ids[10:50])
    assert removed == 40
    assert len(tr) == len(seen) - 50


def test_pipelined_matches_synchronous(mesh):
    """pipeline_depth > 0 must change WHEN losses are fetched, never their
    values: the lagged loss stream (plus flush) equals the depth-0 stream,
    and AUC/counters agree."""
    dim = 8
    kw = dict(batch_size=256, steps=6, dense_learning_rate=3e-3, seed=11)
    table = TableConfig(dim=dim, capacity=1 << 14, initializer_scale=0.02)
    model = ModelConfig(
        kind="ctr_mlp", num_dense_features=4, num_sparse_features=4,
        embedding_dim=dim, bottom_mlp=(16, dim), top_mlp=(32, 1),
    )
    data = SyntheticConfig(num_dense=4, num_sparse=4, batch_size=256,
                           vocab_per_feature=300)
    t_sync = ShardedTrainer(RunConfig(pipeline_depth=0, **kw), table, model, mesh=mesh)
    t_pipe = ShardedTrainer(RunConfig(pipeline_depth=3, **kw), table, model, mesh=mesh)
    sync_losses, pipe_losses = [], []
    for batch in SyntheticStream(data).batches(6):
        out_s = t_sync.train_step(batch)
        assert out_s["in_flight"] == 0 and out_s["retired_step"] is not None
        sync_losses.append((out_s["retired_step"], out_s["loss"]))
        out_p = t_pipe.train_step(batch)
        if out_p["loss"] is not None:
            pipe_losses.append((out_p["retired_step"], out_p["loss"]))
    assert len(pipe_losses) == 3  # 6 steps, depth 3
    pipe_losses += t_pipe.flush()
    assert [s for s, _ in pipe_losses] == [s for s, _ in sync_losses]
    np.testing.assert_allclose(
        [l for _, l in pipe_losses], [l for _, l in sync_losses],
        rtol=1e-6, atol=1e-7,
    )
    assert t_pipe.auc.compute() == pytest.approx(t_sync.auc.compute(), abs=1e-9)
    assert t_pipe.counters() == t_sync.counters()


def test_eval_step_reports_route_drops(mesh):
    """Eval-path exchange overflow must surface as a counted drop (the
    dropped ids silently score with zero rows otherwise) — VERDICT r2 #4."""
    dim = 8
    run = RunConfig(batch_size=4096, steps=1, a2a_factor=0.35, pipeline_depth=0)
    table = TableConfig(dim=dim, capacity=1 << 16)
    model = ModelConfig(
        kind="ctr_mlp", num_dense_features=4, num_sparse_features=4,
        embedding_dim=dim, bottom_mlp=(16, dim), top_mlp=(32, 1),
    )
    data = SyntheticConfig(
        num_dense=4, num_sparse=4, batch_size=4096, vocab_per_feature=200000
    )
    tr = ShardedTrainer(run, table, model, mesh=mesh)
    batch = next(SyntheticStream(data).batches(1))
    out = tr.eval_step(batch)
    assert out["route_drops"] > 0
    assert tr.eval_route_drops == out["route_drops"]
    # eval never mutates the table: drops are reported, not accumulated there
    assert tr.counters()["route_drops"] == 0
    # and a roomy exchange reports zero
    run2 = RunConfig(batch_size=256, steps=1, pipeline_depth=0)
    data2 = SyntheticConfig(num_dense=4, num_sparse=4, batch_size=256,
                            vocab_per_feature=300)
    tr2 = ShardedTrainer(run2, table, model, mesh=mesh)
    out2 = tr2.eval_step(next(SyntheticStream(data2).batches(1)))
    assert out2["route_drops"] == 0


def test_single_device_mesh_grow_and_checkpoint(tmp_path):
    """S=1 mesh regression: XLA reports the single shard as a full-axis
    slice, which addressable_shard_trees used to read as 'replicated' —
    growth and checkpointing must work on a 1-device mesh (the one-card
    deployment of the distributed trainer)."""
    run = RunConfig(batch_size=64, steps=3, pipeline_depth=0)
    table = TableConfig(dim=8, capacity=1 << 10, grow_at_load=0.8)
    model = ModelConfig(
        kind="ctr_mlp", num_dense_features=3, num_sparse_features=4,
        embedding_dim=8, bottom_mlp=(16, 8), top_mlp=(16, 1),
    )
    tr = ShardedTrainer(run, table, model, mesh=make_mesh(1))
    rng = np.random.default_rng(0)
    for _ in range(6):
        tr.train_step({
            "ids": rng.integers(0, 5000, size=(64, 4)).astype(np.int64),
            "dense": rng.normal(size=(64, 3)).astype(np.float32),
            "label": rng.integers(0, 2, size=64).astype(np.float32),
        })
    assert tr.spec.capacity > 1 << 10  # grew
    assert len(tr) > 800
    tr.save_checkpoint(str(tmp_path / "ck"))
    tr2 = ShardedTrainer(run, table, model, mesh=make_mesh(1))
    tr2.load_checkpoint(str(tmp_path / "ck"))
    assert len(tr2) == len(tr)
    # growth gate must be seeded with the restored live count (advisor r3
    # high): an unseeded bound lets the table fill to hard capacity before
    # the first live-count fetch, silently denying inserts.
    assert tr2._live_upper == len(tr2)
    # behavioral check: feeding fresh uniques right after restore must keep
    # growing instead of filling toward hard capacity
    cap_before = tr2.spec.capacity
    limit = table.grow_at_load * cap_before
    fresh = 10**9 + np.arange(int(limit) + 512, dtype=np.int64)
    for o in range(0, len(fresh) - 256, 256):
        tr2.train_step({
            "ids": fresh[o:o + 256].reshape(64, 4),
            "dense": rng.normal(size=(64, 3)).astype(np.float32),
            "label": rng.integers(0, 2, size=64).astype(np.float32),
        })
        if tr2.spec.capacity > cap_before:
            break
    assert tr2.spec.capacity > cap_before, (
        "restored trainer never grew while absorbing fresh uniques"
    )
