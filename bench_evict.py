"""Maintenance-sweep cost at scale (VERDICT r2 #9): how long does one
`evict_pass` take on a full-capacity table, in the common no-candidates case
(every tick pays the scan) and with a candidate-rich plane (the scan PLUS the
export gathers / clearing scatters)?

Env: MEEPO_BENCH_CAP (1<<25), MEEPO_BENCH_DTYPE (float32), MEEPO_BENCH_DIM
(32), MEEPO_EVICT_FILL (0.8), MEEPO_EVICT_REPS (10).
"""

import json
import os
import sys
import time
from functools import partial

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from meepoembedding_tpu.device import bench_device

    bench_device()
    import jax
    import jax.numpy as jnp

    from meepoembedding_tpu.config import OptimizerConfig, PolicyConfig, TableConfig
    from meepoembedding_tpu.ops import optim
    from meepoembedding_tpu.table import hashing, xla_ops
    from meepoembedding_tpu.table.layout import TableSpec, alloc_shard

    cap = int(os.environ.get("MEEPO_BENCH_CAP", 1 << 25))
    dim = int(os.environ.get("MEEPO_BENCH_DIM", 32))
    dtype = os.environ.get("MEEPO_BENCH_DTYPE", "float32")
    fill = float(os.environ.get("MEEPO_EVICT_FILL", 0.8))
    reps = int(os.environ.get("MEEPO_EVICT_REPS", 10))

    cfg = TableConfig(
        dim=dim, capacity=cap, value_dtype=dtype,
        optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.05),
        policy=PolicyConfig(evict_policy="lfu_ttl", ttl_steps=1 << 20,
                            lfu_min_freq=0, max_evict_per_pass=1 << 14),
        max_probe_rounds=2,
    )
    spec = TableSpec.from_config(cfg, num_shards=1)
    log(f"cap={cap} dim={dim} {dtype}")

    shard = jax.jit(lambda: alloc_shard(spec))()
    jax.block_until_ready(shard.values)
    n_live = int(cap * fill)
    key_mult = np.int64(0x9E3779B97F4A7C15 & 0x7FFFFFFFFFFFFFFF)

    @partial(jax.jit, donate_argnums=(0,))
    def prefill_step(shard, hi, lo, step):
        valid = hashing.is_valid(hi, lo)
        shard, ctx = xla_ops.lookup_train(spec, shard, hi, lo, valid, step)
        return optim.apply_sparse_grads_ctx(spec, shard, ctx,
                                            jnp.zeros_like(ctx.g128))

    pb = 1 << 20
    t0 = time.perf_counter()
    for i in range(0, n_live, pb):
        n = min(pb, n_live - i)
        ids = np.arange(i, i + n, dtype=np.int64) * key_mult
        if n < pb:
            ids = np.concatenate([ids, np.full(pb - n, hashing.EMPTY_ID)])
        hi, lo = hashing.split_ids(ids)
        shard = prefill_step(shard, jnp.asarray(hi), jnp.asarray(lo), jnp.int32(1))
        if (i // pb) % 4 == 3:
            jax.block_until_ready(shard.counters)
    jax.block_until_ready(shard.counters)
    log(f"prefill {n_live} rows in {time.perf_counter()-t0:.1f}s")

    evict = jax.jit(xla_ops.evict_pass, static_argnums=(0,), donate_argnums=(1,))

    def timed(name, step_val):
        nonlocal shard
        times = []
        total = 0
        for _ in range(reps):
            t0 = time.perf_counter()
            shard, export = evict(spec, shard, jnp.int32(step_val))
            n = int(export.count)  # host fetch == completion barrier
            times.append(time.perf_counter() - t0)
            total += n
        best = min(times) * 1e3
        log(f"{name:34s} best {best:8.2f} ms  (evicted {total} over {reps} reps)")
        return best, total

    # common case: nothing cold -> pure scan cost (every maintenance tick)
    scan_ms, n0 = timed("evict_pass, 0 candidates", 2)
    assert n0 == 0, n0
    # candidate-rich: TTL expires everything -> scan + E-row export/clear
    rich_ms, n1 = timed("evict_pass, full candidates", (1 << 20) + 10)

    # rotating K-bucket window (policy.evict_scan_buckets): the production
    # maintenance configuration for big tables
    import dataclasses as _dc

    K = int(os.environ.get("MEEPO_EVICT_WINDOW", 1 << 13))
    spec_w = _dc.replace(
        spec, policy=_dc.replace(spec.policy, evict_scan_buckets=K)
    )
    evict_w = jax.jit(xla_ops.evict_pass, static_argnums=(0,),
                      donate_argnums=(1,))
    times, cursor, got = [], 0, 0
    for _ in range(reps):
        t0 = time.perf_counter()
        shard, export = evict_w(spec_w, shard, jnp.int32(3), jnp.int32(cursor))
        got += int(export.count)
        times.append(time.perf_counter() - t0)
        cursor = xla_ops.next_evict_cursor(spec_w, cursor)
    win_ms = min(times) * 1e3
    log(f"{'evict_pass, K=' + str(K) + ' window':34s} best {win_ms:8.2f} ms "
        f"(evicted {got})")

    print(json.dumps({
        "metric": "evict_pass_ms",
        "capacity": cap, "dim": dim, "dtype": dtype, "live_rows": n_live,
        "scan_only_ms": round(scan_ms, 2),
        "with_exports_ms": round(rich_ms, 2),
        "windowed_ms": round(win_ms, 2),
        "window_buckets": K,
        "max_evict_per_pass": cfg.policy.max_evict_per_pass,
        "evicted_rich": n1,
    }))


if __name__ == "__main__":
    main()
