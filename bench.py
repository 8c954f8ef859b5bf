"""Headline benchmark (SURVEY.md C20, BASELINE.json metric).

Measures steady-state dynamic-table throughput on one chip: each timed step
is the full hot path — dedup -> probe/insert -> gather -> rowwise-AdaGrad
scatter-update — over a zipf-like id stream against a prefilled table.

Prints ONE JSON line:
  metric  "lookup_update_ids_per_sec_per_chip"
  value   ids processed per second (lookup + in-place update per id)
  vs_baseline  ratio vs a raw static gather + scatter-add on the SAME value
    geometry with precomputed slots (no hashing/probe/dedup) — i.e. the
    speed-of-light for a non-dynamic table on this chip. The reference
    publishes no numbers, so this hardware-derived bound is the honest
    denominator. NOTE: this arm touches all `batch` rows; at a
    33%-unique stream the deduped dynamic path legitimately beats it (>1).
  vs_sol_unique  ratio vs the DEDUP-AWARE speed-of-light: gather+scatter over
    only the U unique rows with precomputed slots AND precomputed inverse
    (plus the irreducible [n]-expand / segment-sum the training math needs).
    This is the true remaining-distance number — 1.0 == the hashing/probe/
    on-device-dedup machinery is completely free.

Env knobs: MEEPO_BENCH_CAP (rows, default 2^25), MEEPO_BENCH_BATCH (ids/step,
default 2^19), MEEPO_BENCH_DIM (default 32), MEEPO_BENCH_STEPS (default 20).
"""

import json
from functools import partial
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from meepoembedding_tpu.device import bench_device

    dev = bench_device()
    import jax
    import jax.numpy as jnp

    from meepoembedding_tpu.config import OptimizerConfig, TableConfig
    from meepoembedding_tpu.device import describe
    from meepoembedding_tpu.ops import dedup, optim
    from meepoembedding_tpu.table import hashing, xla_ops
    from meepoembedding_tpu.table.layout import TableSpec, alloc_shard

    cap = int(os.environ.get("MEEPO_BENCH_CAP", 1 << 25))
    batch = int(os.environ.get("MEEPO_BENCH_BATCH", 1 << 19))
    dim = int(os.environ.get("MEEPO_BENCH_DIM", 32))
    steps = int(os.environ.get("MEEPO_BENCH_STEPS", 20))
    fill = float(os.environ.get("MEEPO_BENCH_FILL", 0.8))
    vdtype = os.environ.get("MEEPO_BENCH_DTYPE", "float32")

    log(f"cap={cap}, batch={batch}, dim={dim}")

    # max_probe_rounds=2: pair-probing (one 256-slot group per key) halves
    # probe traffic to ONE [n,512] gather. At 0.8 load, pair overflow is
    # P(Poisson(204.8) > 256) ~ 1.6e-4 per insert — those inserts are
    # DROPPED and counted (printed below); a dynamic table with admission
    # tolerates this by design. Set MEEPO_BENCH_ROUNDS=4 for zero drops.
    rounds = int(os.environ.get("MEEPO_BENCH_ROUNDS", 2))
    cfg = TableConfig(
        dim=dim, capacity=cap,
        optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.05),
        initializer_scale=0.01,
        value_dtype=vdtype,
        max_probe_rounds=rounds,
        # admission throttling: steady-state steps have a handful of misses;
        # capping admitted inserts per step keeps insert planning at the cap
        # instead of the batch (prefill below uses an uncapped spec)
        insert_cap=1 << 15,
    )
    spec = TableSpec.from_config(cfg, num_shards=1)
    import dataclasses as _dc

    spec_prefill = _dc.replace(spec, insert_cap=None)
    log(f"hbm bytes: {spec.hbm_bytes()/1e9:.2f} GB, buckets={spec.num_buckets}")

    shard = jax.jit(lambda: alloc_shard(spec))()
    jax.block_until_ready(shard.values)

    # --- prefill to `fill` load factor --------------------------------------
    n_live = int(spec.capacity * fill)
    key_mult = np.int64(0x9E3779B97F4A7C15 & 0x7FFFFFFFFFFFFFFF)

    def ids_for(lo_idx, n):
        idx = (np.arange(lo_idx, lo_idx + n, dtype=np.int64)) * key_mult
        return idx

    @partial(jax.jit, donate_argnums=(0,))
    def prefill_step(shard, hi, lo, step):
        valid = hashing.is_valid(hi, lo)
        if spec.dim <= 128:
            # fused path: values land via the size-dispatched scatter (the
            # find_or_insert cond would carry the values plane and force XLA
            # to double-buffer it -> OOM for >HBM/2 tables)
            shard, ctx = xla_ops.lookup_train(spec_prefill, shard, hi, lo, valid, step)
            shard = optim.apply_sparse_grads_ctx(
                spec_prefill, shard, ctx, jnp.zeros_like(ctx.g128)
            )
        else:
            shard, _, _ = xla_ops.find_or_insert(
                spec_prefill, shard, hi, lo, valid, step
            )
        return shard

    prefill_batch = min(batch, 1 << 20)
    t0 = time.perf_counter()
    for i in range(0, n_live, prefill_batch):
        n = min(prefill_batch, n_live - i)
        ids = ids_for(i, n)
        if n < prefill_batch:
            ids = np.concatenate([ids, np.full(prefill_batch - n, hashing.EMPTY_ID)])
        hi, lo = hashing.split_ids(ids)
        shard = prefill_step(shard, jnp.asarray(hi), jnp.asarray(lo), jnp.int32(0))
        if (i // prefill_batch) % 4 == 3:
            jax.block_until_ready(shard.counters)  # cap in-flight work
    jax.block_until_ready(shard.values)
    log(f"prefill {n_live} rows in {time.perf_counter()-t0:.1f}s, "
        f"load={float(jnp.sum(shard.cnt))/spec.capacity:.3f}")

    # --- steady-state id stream: bounded Zipf over the live keys -------------
    # CTR id traffic is heavy-tailed: a small head of ids dominates. s=1.05
    # gives ~0.35 uniques/id per 512K batch at 26.8M live keys. (Round 1 used
    # a two-uniform mixture that came out 94% unique — an unrealistically
    # dedup-hostile stream; MEEPO_BENCH_ZIPF=0 restores it for comparison.)
    zipf_s = float(os.environ.get("MEEPO_BENCH_ZIPF", 1.05))
    rng = np.random.default_rng(0)

    def stream_batch():
        if zipf_s <= 0:
            hot = rng.integers(0, max(1, n_live // 10), size=int(batch * 0.8))
            cold = rng.integers(0, n_live, size=batch - len(hot))
            return np.concatenate([hot, cold]) * key_mult
        t = 1.0 - zipf_s  # inverse CDF of p(k) ~ k^-s over [1, n_live]
        u = rng.random(batch)
        k = ((float(n_live) ** t - 1.0) * u + 1.0) ** (1.0 / t)
        k = np.minimum(k.astype(np.int64), n_live) - 1
        return k * key_mult

    # Dedup capacity (static): sized from the MEASURED stream — every U-sized
    # op in the step (probe gather, window matmuls, update scatters; the
    # values scatter is row-DMA issue-bound at ~68ns/row) scales with this
    # cap, so slack directly costs throughput. Production systems size it
    # from traffic stats exactly like this; the run HARD-VERIFIES no overflow
    # on every timed step (asserts below) — an overflow would alias ids.
    # Host-side np.unique over sample batches is exact and instant.
    if "MEEPO_BENCH_UCAP" in os.environ:
        ucap = int(os.environ["MEEPO_BENCH_UCAP"])
    elif zipf_s <= 0:
        ucap = batch  # the 94%-unique mixture: lossless cap
    else:
        u_obs = max(
            len(np.unique(stream_batch())) for _ in range(5)
        )
        rng = np.random.default_rng(0)  # reset: samples must not skew timing
        ucap = min(batch, -(-int(u_obs * 1.15) // 128) * 128)
        log(f"ucap auto-sized: {u_obs} observed uniques -> cap {ucap} (1.15x)")

    @partial(jax.jit, donate_argnums=(0,))
    def train_cycle(shard, hi, lo, grad_seed, step):
        uniq = dedup.unique_pairs(hi, lo, ucap)
        if spec.dim <= 128:
            # fused 128-lane window-space path: lookup_train leaves the
            # values plane untouched (fresh inits fold into the ONE update
            # scatter — XLA scatters materialize the whole plane)
            shard, ctx = xla_ops.lookup_train(
                spec, shard, uniq.hi, uniq.lo, uniq.valid, step
            )
            out = xla_ops.rows_for_batch(spec, ctx.g128, ctx.sub, uniq.inverse)
            g = out * 1e-3 + grad_seed  # synthetic model grads at [n, dim]
            g_u = xla_ops.grads_to_window(
                spec, g, ctx.sub, uniq.inverse, ucap
            )
            shard = optim.apply_sparse_grads_ctx(spec, shard, ctx, g_u)
        else:
            shard, slot, _ = xla_ops.find_or_insert(
                spec, shard, uniq.hi, uniq.lo, uniq.valid, step
            )
            rows = xla_ops.lookup_rows(spec, shard, slot)
            out = rows[uniq.inverse]
            g = out * 1e-3 + grad_seed
            g_u = dedup.segment_sum_grads(g, uniq.inverse, ucap)
            shard = optim.apply_sparse_grads(spec, shard, slot, g_u)
        return shard, jnp.sum(out), uniq.count

    # warmup/compile
    ids = stream_batch()
    hi, lo = hashing.split_ids(ids)
    hi, lo = jnp.asarray(hi), jnp.asarray(lo)
    gseed = jnp.float32(1e-4)
    shard, s0, ucount = train_cycle(shard, hi, lo, gseed, jnp.int32(1))
    jax.block_until_ready(s0)
    assert ucap >= batch or int(ucount) < ucap, (
        f"dedup capacity overflow: {int(ucount)} uniques >= ucap {ucap}; "
        f"raise MEEPO_BENCH_UCAP"
    )
    log(f"uniques/step ~{int(ucount)} (ucap {ucap})")

    batches = [hashing.split_ids(stream_batch()) for _ in range(steps)]
    batches = [
        (jax.device_put(jnp.asarray(h)), jax.device_put(jnp.asarray(l)))
        for h, l in batches
    ]
    jax.block_until_ready(batches)
    # Pipelined windows (async dispatch, one block per window), best of R:
    # training runs pipelined, so steady-state throughput is the metric; host
    # stalls can only inflate a window, so the best window is the reading.
    # Dispatch depth is capped at d steps in flight (waiting on step i-d):
    # overlapping transients of many in-flight steps exhaust device memory
    # on big tables.
    windows = []
    d = int(os.environ.get("MEEPO_BENCH_DEPTH", 2))
    ucnts = []  # every timed step's unique count; ONE max+fetch after timing
    for _w in range(3):
        t0 = time.perf_counter()
        accs = []
        for i, (h, l) in enumerate(batches):
            shard, acc, ucnt = train_cycle(shard, h, l, gseed, jnp.int32(2 + i))
            accs.append(acc)
            ucnts.append(ucnt)
            if i >= d:
                jax.block_until_ready(accs[i - d])
        jax.block_until_ready((shard, accs[-1]))
        windows.append((time.perf_counter() - t0) / steps)
    dt = min(windows)
    ucnt_max = int(jnp.max(jnp.stack(ucnts)))
    assert ucap >= batch or ucnt_max < ucap, (
        f"dedup capacity overflow during timing: {ucnt_max} >= {ucap}; "
        f"the run is invalid — raise MEEPO_BENCH_UCAP"
    )
    ids_per_sec = batch / dt
    log(f"dynamic: {ids_per_sec/1e6:.2f}M ids/s (best {dt*1e3:.2f} ms/step, "
        f"windows {[f'{w*1e3:.1f}' for w in windows]})")
    c = np.asarray(shard.counters)
    log(f"counters: hits={c[0]} misses={c[1]} inserts={c[2]} drops={c[3]} "
        f"(drop rate {c[3]/max(1, c[2]+c[3]):.2e})")

    # --- speed-of-light baseline: static gather + scatter-add, same geometry -
    values = shard.values  # reuse allocation

    @partial(jax.jit, donate_argnums=(0,))
    def static_cycle(values, slot, grad_seed):
        rows = xla_ops.gather_values(spec, values, slot)
        g = rows * 1e-3 + grad_seed
        values = xla_ops.scatter_add_values(spec, values, slot, -0.05 * g,
                                            jnp.ones(slot.shape, bool))
        return values, jnp.sum(rows)

    slots_np = rng.integers(0, n_live, size=(steps, batch))
    slot0 = jnp.asarray(slots_np[0], jnp.int32)
    values, s1 = static_cycle(values, slot0, gseed)
    jax.block_until_ready(s1)
    slots = [jax.device_put(jnp.asarray(s, jnp.int32)) for s in slots_np]
    jax.block_until_ready(slots)
    windows = []
    for _w in range(3):
        t0 = time.perf_counter()
        accs = []
        for i, s in enumerate(slots):
            values, acc = static_cycle(values, s, gseed)
            accs.append(acc)
            if i >= d:
                jax.block_until_ready(accs[i - d])  # depth cap (see above)
        jax.block_until_ready((values, accs[-1]))
        windows.append((time.perf_counter() - t0) / steps)
    dt_sol = min(windows)
    sol_ids_per_sec = batch / dt_sol
    log(f"static SOL: {sol_ids_per_sec/1e6:.2f}M ids/s (best {dt_sol*1e3:.2f} ms/step)")

    # --- dedup-aware speed-of-light (VERDICT r4 missing #3): the honest ----
    # residual. The arm above touches ALL `batch` rows — the dynamic path
    # beats it at a 33%-unique stream by paying dedup machinery to touch only
    # ~U rows, so vs_baseline > 1 stops measuring distance to the north-star.
    # This arm is what a static table WITH precomputed dedup would do: gather
    # the U unique rows, expand by the [n] inverse (the forward output must
    # still be [n, dim]), segment-sum the [n] grads back to U (the backward
    # must combine duplicates), one scatter-add over U rows. No hashing, no
    # probe, no on-device unique — slots and inverses are precomputed host-
    # side. vs_sol_unique == 1.0 means the dynamic machinery is truly free.
    ones_u = jnp.ones((ucap,), bool)

    @partial(jax.jit, donate_argnums=(0,))
    def static_unique_cycle(values, slot_u, inverse, grad_seed):
        rows_u = xla_ops.gather_values(spec, values, slot_u)
        out = rows_u[inverse]
        g = out * 1e-3 + grad_seed
        g_u = dedup.segment_sum_grads(g, inverse, ucap)
        values = xla_ops.scatter_add_values(
            spec, values, slot_u, -0.05 * g_u, ones_u
        )
        return values, jnp.sum(out)

    rng_u = np.random.default_rng(0)  # the SAME stream the dynamic arm saw
    uslots, uinvs = [], []
    for _ in range(steps):
        if zipf_s <= 0:
            hot = rng_u.integers(0, max(1, n_live // 10), size=int(batch * 0.8))
            cold = rng_u.integers(0, n_live, size=batch - len(hot))
            k = np.concatenate([hot, cold])
        else:
            t = 1.0 - zipf_s
            u = rng_u.random(batch)
            k = ((float(n_live) ** t - 1.0) * u + 1.0) ** (1.0 / t)
            k = np.minimum(k.astype(np.int64), n_live) - 1
        uk, inv = np.unique(k, return_inverse=True)
        su = np.zeros((ucap,), np.int32)
        su[: len(uk)] = uk[:ucap]
        uslots.append(jax.device_put(jnp.asarray(su)))
        uinvs.append(jax.device_put(jnp.asarray(inv.astype(np.int32))))
    jax.block_until_ready([uslots, uinvs])
    values, s2 = static_unique_cycle(values, uslots[0], uinvs[0], gseed)
    jax.block_until_ready(s2)
    windows = []
    for _w in range(3):
        t0 = time.perf_counter()
        accs = []
        for i in range(steps):
            values, acc = static_unique_cycle(values, uslots[i], uinvs[i], gseed)
            accs.append(acc)
            if i >= d:
                jax.block_until_ready(accs[i - d])
        jax.block_until_ready((values, accs[-1]))
        windows.append((time.perf_counter() - t0) / steps)
    dt_sol_u = min(windows)
    sol_u_ids_per_sec = batch / dt_sol_u
    log(f"static SOL (dedup-aware, U~{ucnt_max} rows): "
        f"{sol_u_ids_per_sec/1e6:.2f}M ids/s (best {dt_sol_u*1e3:.2f} ms/step)")

    print(json.dumps({
        "device": describe(dev),
        "metric": "lookup_update_ids_per_sec_per_chip",
        "value": round(ids_per_sec, 1),
        "unit": "ids/s",
        "vs_baseline": round(ids_per_sec / sol_ids_per_sec, 4),
        "vs_sol_unique": round(ids_per_sec / sol_u_ids_per_sec, 4),
    }))


if __name__ == "__main__":
    main()
