"""Property tests of the XLA table ops against the dict oracle (SURVEY.md §4.1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from meepoembedding_tpu.config import OptimizerConfig, PolicyConfig, TableConfig
from meepoembedding_tpu.table import hashing, xla_ops
from meepoembedding_tpu.table.layout import TableSpec, alloc_shard
from meepoembedding_tpu.table.oracle import OracleTable
from meepoembedding_tpu.table.runtime import DynamicEmbeddingTable


def _ids(rng, n, lo=0, hi=10**12):
    return rng.integers(lo, hi, size=n, dtype=np.int64)


def make_spec(dim=16, nb=64, **kw):
    cfg = TableConfig(dim=dim, capacity=nb * 128, **kw)
    return TableSpec.from_config(cfg)


def fi(spec, shard, ids64, step=0):
    hi, lo = hashing.split_ids(ids64)
    valid = hashing.is_valid(jnp.asarray(hi), jnp.asarray(lo))
    return jax.jit(xla_ops.find_or_insert, static_argnums=(0,))(
        spec, shard, jnp.asarray(hi), jnp.asarray(lo), valid, jnp.int32(step)
    )


class TestFindOrInsert:
    def test_insert_then_hit(self, rng):
        spec = make_spec()
        shard = alloc_shard(spec)
        ids = _ids(rng, 100)
        shard, slot, found = fi(spec, shard, ids)
        assert not np.asarray(found).any()
        assert (np.asarray(slot) >= 0).all()
        shard2, slot2, found2 = fi(spec, shard, ids)
        assert np.asarray(found2).all()
        np.testing.assert_array_equal(np.asarray(slot2), np.asarray(slot))

    def test_no_slot_collisions(self, rng):
        spec = make_spec(nb=8)  # tiny: forces multi-key buckets
        shard = alloc_shard(spec)
        ids = _ids(rng, 500)
        shard, slot, _ = fi(spec, shard, ids)
        s = np.asarray(slot)
        s = s[s >= 0]
        assert len(np.unique(s)) == len(s), "two keys claimed the same slot"

    def test_cross_batch_no_collisions(self, rng):
        spec = make_spec(nb=8)
        shard = alloc_shard(spec)
        all_slots = {}
        for i in range(6):
            ids = _ids(rng, 120)
            shard, slot, found = fi(spec, shard, ids, step=i)
            for k, s in zip(ids, np.asarray(slot)):
                if s < 0:
                    continue
                if int(k) in all_slots:
                    assert all_slots[int(k)] == s
                else:
                    assert s not in set(all_slots.values()), "slot reused"
                    all_slots[int(k)] = s

    def test_default_rows_returned(self, rng):
        spec = make_spec(dim=16)
        shard = alloc_shard(spec)
        ids = _ids(rng, 32)
        hi, lo = hashing.split_ids(ids)
        shard, slot, _ = fi(spec, shard, ids)
        rows = xla_ops.lookup_rows(spec, shard, slot)
        expect = hashing.default_rows(jnp.asarray(hi), jnp.asarray(lo), 16, spec.initializer_scale)
        np.testing.assert_allclose(np.asarray(rows), np.asarray(expect), rtol=1e-4, atol=1e-8)

    def test_invalid_ids_ignored(self):
        spec = make_spec()
        shard = alloc_shard(spec)
        ids = np.array([hashing.EMPTY_ID, 5, hashing.EMPTY_ID], np.int64)
        shard, slot, found = fi(spec, shard, ids)
        s = np.asarray(slot)
        assert s[0] < 0 and s[2] < 0 and s[1] >= 0
        assert int(jnp.sum(shard.cnt)) == 1

    def test_overflow_drops_when_full(self, rng):
        spec = make_spec(nb=1, dim=16)  # 128 slots total
        shard = alloc_shard(spec)
        ids = _ids(rng, 300)
        ids = np.unique(ids)[:200]
        shard, slot, _ = fi(spec, shard, ids)
        s = np.asarray(slot)
        assert (s >= 0).sum() == 128
        assert (s < 0).sum() == len(ids) - 128
        c = np.asarray(shard.counters)
        assert c[3] == len(ids) - 128  # DROPS

    def test_dim_gt_128(self, rng):
        spec = make_spec(dim=256, nb=4)
        shard = alloc_shard(spec)
        ids = _ids(rng, 16)
        hi, lo = hashing.split_ids(ids)
        shard, slot, _ = fi(spec, shard, ids)
        rows = xla_ops.lookup_rows(spec, shard, slot)
        expect = hashing.default_rows(jnp.asarray(hi), jnp.asarray(lo), 256, spec.initializer_scale)
        np.testing.assert_allclose(np.asarray(rows), np.asarray(expect), rtol=1e-4, atol=1e-8)


class TestWindowExactness:
    @pytest.mark.parametrize("dim", [8, 32, 128])
    def test_insert_gather_roundtrip_bit_exact(self, rng, dim):
        """The window pack/unpack matmuls must be BIT-exact for f32 rows
        (default matmul precision may round f32 operands, TF32 on GPUs;
        precision=HIGHEST keeps one-hot selections exact). Exercised on
        whatever backend runs the suite; on a GPU this catches the TF32
        path."""
        spec = make_spec(dim=dim, nb=8)
        shard = alloc_shard(spec)
        ids = np.unique(_ids(rng, 64))
        n = len(ids)
        hi, lo = hashing.split_ids(ids)
        # rows with full mantissas: bf16 rounding would be visible
        rows = rng.normal(size=(n, dim)).astype(np.float32)
        valid = jnp.ones((n,), bool)
        shard, ok = jax.jit(xla_ops.insert_rows, static_argnums=(0,))(
            spec, shard, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(rows),
            valid, jnp.int32(0),
        )
        assert np.asarray(ok).all()
        pr = jax.jit(xla_ops.probe, static_argnums=(0,))(
            spec, shard, jnp.asarray(hi), jnp.asarray(lo), valid
        )
        got = np.asarray(xla_ops.lookup_rows(spec, shard, pr.slot))
        np.testing.assert_array_equal(got, rows)

    def test_bf16_insert_gather_roundtrip(self, rng):
        """bf16 value planes: stored rows are the bf16 rounding of the input,
        and gather returns them bit-exactly (VERDICT r1 weak-#4)."""
        spec = make_spec(dim=16, nb=8, value_dtype="bfloat16")
        shard = alloc_shard(spec)
        assert shard.values.dtype == jnp.bfloat16
        ids = np.unique(_ids(rng, 64))
        n = len(ids)
        hi, lo = hashing.split_ids(ids)
        rows = rng.normal(size=(n, 16)).astype(np.float32)
        valid = jnp.ones((n,), bool)
        shard, ok = jax.jit(xla_ops.insert_rows, static_argnums=(0,))(
            spec, shard, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(rows),
            valid, jnp.int32(0),
        )
        assert np.asarray(ok).all()
        pr = jax.jit(xla_ops.probe, static_argnums=(0,))(
            spec, shard, jnp.asarray(hi), jnp.asarray(lo), valid
        )
        got = np.asarray(xla_ops.lookup_rows(spec, shard, pr.slot).astype(jnp.float32))
        expect = np.asarray(jnp.asarray(rows).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(got, expect)

    @pytest.mark.parametrize("vdtype", ["float32", "bfloat16"])
    def test_evict_restores_exact_zero_dtypes(self, rng, vdtype):
        spec = make_spec(
            dim=8, nb=4, value_dtype=vdtype,
            policy=PolicyConfig(evict_policy="ttl", ttl_steps=0),
        )
        shard = alloc_shard(spec)
        ids = np.unique(_ids(rng, 64))
        hi, lo = hashing.split_ids(ids)
        valid = jnp.ones((len(ids),), bool)
        rows = rng.normal(size=(len(ids), 8)).astype(np.float32)
        shard, ok = jax.jit(xla_ops.insert_rows, static_argnums=(0,))(
            spec, shard, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(rows),
            valid, jnp.int32(0),
        )
        shard, export = jax.jit(xla_ops.evict_pass, static_argnums=(0,))(
            spec, shard, jnp.int32(10**6)
        )
        assert int(export.count) == int(np.asarray(ok).sum())
        assert np.abs(np.asarray(shard.values.astype(jnp.float32))).max() == 0.0
        assert int(jnp.sum(shard.cnt)) == 0



class TestInvariantScan:
    def test_healthy_table_scans_clean(self, rng):
        spec = make_spec(dim=16, nb=8,
                         policy=PolicyConfig(evict_policy="ttl", ttl_steps=3))
        shard = alloc_shard(spec)
        ids = np.unique(_ids(rng, 400))
        shard, slot, _ = fi(spec, shard, ids, step=0)
        # age half out, evict, reinsert some
        shard, slot2, _ = fi(spec, shard, ids[: len(ids) // 2], step=10)
        shard, _ = jax.jit(xla_ops.evict_pass, static_argnums=(0,))(
            spec, shard, jnp.int32(20)
        )
        out = jax.jit(xla_ops.check_invariants, static_argnums=(0,))(spec, shard)
        for k, v in out.items():
            assert int(v) == 0, f"{k} = {int(v)}"

    def test_scan_catches_corruption(self, rng):
        spec = make_spec(dim=16, nb=8)
        shard = alloc_shard(spec)
        ids = np.unique(_ids(rng, 100))
        shard, slot, _ = fi(spec, shard, ids)
        # duplicate a key into a free slot of a wrong bucket
        kh = np.asarray(shard.key_hi).copy()
        kl = np.asarray(shard.key_lo).copy()
        b, lane = np.argwhere(
            ~((kh == hashing.EMPTY_HI) & (kl == hashing.EMPTY_LO))
        )[0]
        free_b = 0 if b >= 4 else spec.num_buckets - 1
        free_lane = int(np.argwhere(
            (kh[free_b] == hashing.EMPTY_HI) & (kl[free_b] == hashing.EMPTY_LO)
        )[0][0])
        kh[free_b, free_lane] = kh[b, lane]
        kl[free_b, free_lane] = kl[b, lane]
        bad = shard._replace(key_hi=jnp.asarray(kh), key_lo=jnp.asarray(kl))
        out = jax.jit(xla_ops.check_invariants, static_argnums=(0,))(spec, bad)
        assert int(out["dup_keys"]) >= 1
        assert int(out["cnt_mismatch"]) >= 1  # cnt not updated for the forgery


class TestProbeChains:
    def test_probe_past_full_bucket(self, rng):
        """Keys overflowing a full bucket land in the next; lookups find them."""
        spec = make_spec(nb=4, dim=16)
        shard = alloc_shard(spec)
        # fill heavily: 300 keys over 512 slots -> some buckets overflow
        ids = np.unique(_ids(rng, 600))[:400]
        shard, slot, _ = fi(spec, shard, ids)
        shard, slot2, found2 = fi(spec, shard, ids)
        ok = np.asarray(slot) >= 0
        assert np.asarray(found2)[ok].all()
        np.testing.assert_array_equal(np.asarray(slot2)[ok], np.asarray(slot)[ok])


class TestOracleParity:
    @pytest.mark.parametrize("opt", ["sgd", "momentum", "rowwise_adagrad", "adagrad", "adam", "ftrl"])
    def test_train_sequence_matches_oracle(self, rng, opt):
        dim = 8
        cfg = TableConfig(
            dim=dim,
            capacity=128 * 64,
            optimizer=OptimizerConfig(kind=opt, learning_rate=0.1),
            initializer_scale=0.02,
        )
        table = DynamicEmbeddingTable(cfg)
        oracle = OracleTable(dim, 0.02, cfg.optimizer)
        pool = _ids(rng, 50)
        for step in range(5):
            ids = rng.choice(pool, size=40)
            rows_dev = np.asarray(table.lookup(ids))
            rows_ora = oracle.lookup(ids, step=step)
            # atol: f32 vs f64 oracle + reassociated sums (sorted_run_sums)
            np.testing.assert_allclose(rows_dev, rows_ora, atol=5e-5)
            grads = rng.normal(size=(40, dim)).astype(np.float32)
            table.apply_grads(jnp.asarray(grads))
            oracle.apply_grads(ids, grads)
        assert len(table) == len(oracle)
        c = table.counters()
        assert c["hits"] == oracle.hits and c["misses"] == oracle.misses

    def test_online_growth_by_rehash(self, rng):
        """VERDICT r1 #4 (SURVEY C11/M1): start at 2^10 capacity, insert 10x
        that many unique ids while training — the table grows by rehash, no
        id is ever dropped, and device state tracks the oracle throughout."""
        dim = 8
        cfg = TableConfig(
            dim=dim,
            capacity=1 << 10,
            optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.1),
            initializer_scale=0.02,
            grow_at_load=0.8,
        )
        table = DynamicEmbeddingTable(cfg)
        oracle = OracleTable(dim, 0.02, cfg.optimizer)
        total = 10 * (1 << 10)
        all_ids = rng.permutation(np.arange(1, total + 1, dtype=np.int64) * 7919)
        step = 0
        for o in range(0, total, 512):
            fresh = all_ids[o : o + 512]
            seen = all_ids[: o + 512]
            ids = np.concatenate(
                [fresh, rng.choice(seen, size=128)]  # new ids + re-touches
            )
            rows_dev = np.asarray(table.lookup(ids))
            rows_ora = oracle.lookup(ids, step=step)
            np.testing.assert_allclose(rows_dev, rows_ora, atol=5e-5)
            grads = rng.normal(size=(len(ids), dim)).astype(np.float32)
            table.apply_grads(jnp.asarray(grads))
            oracle.apply_grads(ids, grads)
            step += 1
        assert len(table) == len(oracle) == total
        assert table.spec.capacity >= total  # grew from 1024
        c = table.counters()
        assert c["drops"] == 0, f"ids dropped despite growth: {c['drops']}"

    @pytest.mark.parametrize("dim", [8, 256])
    def test_bf16_table_tracks_oracle(self, rng, dim):
        """bf16 value planes follow the f64 oracle within bf16 rounding
        accumulation (VERDICT r1 #8)."""
        cfg = TableConfig(
            dim=dim,
            capacity=128 * 64,
            optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.1),
            initializer_scale=0.02,
            value_dtype="bfloat16",
        )
        table = DynamicEmbeddingTable(cfg)
        oracle = OracleTable(dim, 0.02, cfg.optimizer)
        pool = _ids(rng, 50)
        for step in range(5):
            ids = rng.choice(pool, size=40)
            rows_dev = np.asarray(table.lookup(ids).astype(jnp.float32))
            rows_ora = oracle.lookup(ids, step=step)
            np.testing.assert_allclose(rows_dev, rows_ora, atol=2e-2)
            grads = rng.normal(size=(40, dim)).astype(np.float32)
            table.apply_grads(jnp.asarray(grads))
            oracle.apply_grads(ids, grads)
        assert len(table) == len(oracle)


class TestErase:
    def test_remove_matches_oracle_and_reinserts_fresh(self, rng):
        """remove() frees slots exactly: lookups after removal re-insert
        deterministic fresh rows (insert-order-independent init), matching
        an oracle that performed the same removal; the invariant scan stays
        clean (freed slots back to exact zero / sentinel)."""
        dim = 8
        cfg = TableConfig(
            dim=dim, capacity=128 * 32,
            optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.1),
            initializer_scale=0.02,
        )
        table = DynamicEmbeddingTable(cfg)
        oracle = OracleTable(dim, 0.02, cfg.optimizer)
        ids = _ids(rng, 300)
        table.lookup(ids)
        oracle.lookup(ids, step=0)
        grads = rng.normal(size=(300, dim)).astype(np.float32)
        table.apply_grads(jnp.asarray(grads))
        oracle.apply_grads(ids, grads)

        victims = np.unique(ids[:100])
        absent = _ids(rng, 5, lo=10**13, hi=10**14)  # never inserted
        n_dev = table.remove(np.concatenate([victims, absent]))
        n_ora = oracle.remove(np.concatenate([victims, absent]))
        assert n_dev == n_ora == len(victims)
        assert table.counters()["erases"] == len(victims)
        assert len(table) == len(oracle)

        out = jax.jit(xla_ops.check_invariants, static_argnums=(0,))(
            table.spec, table.shard
        )
        for k, v in out.items():
            assert int(v) == 0, f"{k} = {int(v)}"
        # removed keys now re-insert with FRESH deterministic rows
        rows_dev = np.asarray(table.lookup(ids))
        rows_ora = oracle.lookup(ids, step=1)
        np.testing.assert_allclose(rows_dev, rows_ora, atol=5e-5)

    def test_remove_is_noop_for_absent_and_invalid(self, rng):
        cfg = TableConfig(dim=8, capacity=128 * 8)
        table = DynamicEmbeddingTable(cfg)
        ids = _ids(rng, 50)
        table.lookup(ids)
        before = np.asarray(table.shard.values).copy()
        n = table.remove(np.array([hashing.EMPTY_ID, 10**15, 10**15 + 1]))
        assert n == 0
        np.testing.assert_array_equal(np.asarray(table.shard.values), before)


def test_fuzz_lifecycle_against_oracle(rng):
    """Randomized interaction test: interleave train lookups, sparse updates,
    explicit removals, TTL evictions and growth-by-rehash, checking row
    content and table size against the oracle after every op. Catches
    cross-feature interactions (remove -> reinsert, evict -> grow, ...) that
    the per-feature tests cannot."""
    dim = 8
    cfg = TableConfig(
        dim=dim, capacity=1 << 9, grow_at_load=0.8,
        optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.1),
        initializer_scale=0.02,
        policy=PolicyConfig(evict_policy="ttl", ttl_steps=12),
    )
    table = DynamicEmbeddingTable(cfg)
    oracle = OracleTable(dim, 0.02, cfg.optimizer, cfg.policy)
    pool = _ids(rng, 4000)
    for step in range(30):
        op = rng.choice(["train", "train", "train", "remove", "evict"])
        if op == "train":
            ids = rng.choice(pool, size=64)
            rows_dev = np.asarray(table.lookup(ids))
            rows_ora = oracle.lookup(ids, step=table.step)
            np.testing.assert_allclose(rows_dev, rows_ora, atol=5e-5,
                                       err_msg=f"step {step} lookup")
            g = rng.normal(size=(64, dim)).astype(np.float32)
            table.apply_grads(jnp.asarray(g))
            oracle.apply_grads(ids, g)
        elif op == "remove":
            victims = rng.choice(pool, size=32)
            assert table.remove(victims) == oracle.remove(victims)
        else:
            # oracle ignores capacity; sync the step-based TTL clock
            oracle.evict(table.step)
            table.evict()
        assert len(table) == len(oracle), f"step {step} after {op}"
    assert table.spec.capacity > 1 << 9  # growth happened along the way
