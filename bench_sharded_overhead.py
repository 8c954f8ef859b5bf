"""Distributed-step overhead: ShardedTrainer at S=1 vs the fused
single-device train step (VERDICT r2 #1 measurement gate).

Same model (DLRM-small), same table geometry, same Zipf id stream, same
depth-capped pipelined timing as bench.py. The S=1 sharded step
pays everything the multi-card step pays EXCEPT the actual transfer
(owner routing, send-buffer placement, a2a ops that XLA lowers to copies on
a 1-device mesh, owner-side re-dedup, the window re-transforms) — so
  overhead = sharded_ms / fused_ms - 1
is the per-step cost of the distribution machinery, the part of multi-card
scaling that software controls. Needs a GPU; MEEPO_OVERHEAD_DEVICES=4 runs
the sharded arms over four local cards.

Env: MEEPO_OVERHEAD_CAP (1<<25), MEEPO_OVERHEAD_BATCH (16384 examples),
MEEPO_OVERHEAD_FEATURES (32 -> 524288 ids/step), MEEPO_OVERHEAD_STEPS (20),
MEEPO_OVERHEAD_PREFILL (40), MEEPO_OVERHEAD_DEVICES (1),
MEEPO_BENCH_DEPTH (2).
"""

import gc
import json
import os
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from meepoembedding_tpu.device import bench_device

    bench_device()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from meepoembedding_tpu.config import (
        ModelConfig,
        OptimizerConfig,
        RunConfig,
        TableConfig,
    )

    cap = int(os.environ.get("MEEPO_OVERHEAD_CAP", 1 << 25))
    batch = int(os.environ.get("MEEPO_OVERHEAD_BATCH", 16384))
    feats = int(os.environ.get("MEEPO_OVERHEAD_FEATURES", 32))
    steps = int(os.environ.get("MEEPO_OVERHEAD_STEPS", 20))
    prefill = int(os.environ.get("MEEPO_OVERHEAD_PREFILL", 40))
    S = int(os.environ.get("MEEPO_OVERHEAD_DEVICES", 1))
    d = int(os.environ.get("MEEPO_BENCH_DEPTH", 2))
    dim = 32
    ids_per_step = batch * feats
    log(f"cap={cap} batch={batch} "
        f"feats={feats} ({ids_per_step} ids/step) S={S}")

    run = RunConfig(
        batch_size=batch, steps=steps, dense_learning_rate=1e-3,
        unique_cap=max(1024, ids_per_step // 2), pipeline_depth=d,
    )
    table = TableConfig(
        dim=dim, capacity=cap, max_probe_rounds=2, insert_cap=1 << 15,
        optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.05),
    )
    model = ModelConfig(
        kind="dlrm", num_dense_features=13, num_sparse_features=feats,
        embedding_dim=dim, bottom_mlp=(64, dim), top_mlp=(64, 1),
    )

    # bounded-Zipf(1.05) stream over half the capacity, bench.py's shape
    rng = np.random.default_rng(0)
    n_live = cap // 2
    key_mult = np.int64(0x9E3779B97F4A7C15 & 0x7FFFFFFFFFFFFFFF)

    def ids_batch():
        t = 1.0 - 1.05
        u = rng.random(ids_per_step)
        k = ((float(n_live) ** t - 1.0) * u + 1.0) ** (1.0 / t)
        k = np.minimum(k.astype(np.int64), n_live) - 1
        return (k * key_mult).reshape(batch, feats)

    def mk_batch():
        return {
            "ids": ids_batch(),
            "dense": rng.normal(size=(batch, 13)).astype(np.float32),
            "label": (rng.random(batch) < 0.3).astype(np.float32),
        }

    pre_batches = [mk_batch() for _ in range(prefill)]
    timed_batches = [mk_batch() for _ in range(steps)]

    def run_fused():
        from meepoembedding_tpu.table import hashing
        from meepoembedding_tpu.train import Trainer

        tr = Trainer(run, table, model)
        dev = []
        for b in timed_batches:
            hi, lo = hashing.split_ids(b["ids"])
            dev.append((
                jnp.asarray(b["dense"]), jnp.asarray(hi), jnp.asarray(lo),
                jnp.asarray(b["label"]),
            ))
        jax.block_until_ready(dev)
        t0 = time.perf_counter()
        for b in pre_batches:
            tr.train_step(b)  # sync; prefill is not timed
        log(f"fused prefill {len(tr.shard.cnt) and int(jnp.sum(tr.shard.cnt))} "
            f"rows in {time.perf_counter()-t0:.1f}s")
        windows = []
        for _w in range(3):
            t0 = time.perf_counter()
            losses = []
            for i, (dense, hi, lo, label) in enumerate(dev):
                tr.shard, tr.params, tr.opt_state, loss, _ = tr._step_fn(
                    tr.shard, tr.params, tr.opt_state, dense, hi, lo, label,
                    jnp.int32(tr.step), None,
                )
                tr.step += 1
                losses.append(loss)
                if i >= d:
                    jax.block_until_ready(losses[i - d])
            jax.block_until_ready(losses[-1])
            windows.append((time.perf_counter() - t0) / steps)
        del tr, dev
        gc.collect()
        return min(windows), windows

    def run_sharded(force_exchange=False, ragged=False):
        import dataclasses

        from meepoembedding_tpu.parallel import sharded_table as st
        from meepoembedding_tpu.parallel.mesh import make_mesh
        from meepoembedding_tpu.parallel.trainer import ShardedTrainer

        st.FORCE_EXCHANGE = force_exchange
        run_local = dataclasses.replace(run, a2a_ragged=ragged)
        tr = ShardedTrainer(run_local, table, model, mesh=make_mesh(S))
        t0 = time.perf_counter()
        for b in pre_batches:
            tr.train_step(b)
        tr.flush()
        log(f"sharded prefill {len(tr)} rows in {time.perf_counter()-t0:.1f}s")
        # pre-shard the timed batches so host batch prep stays out of the loop
        dev = [tr._device_batch(b) for b in timed_batches]
        from jax.sharding import PartitionSpec as P

        from meepoembedding_tpu.parallel import multihost
        from meepoembedding_tpu.parallel.mesh import SHARD_AXIS

        lq = multihost.shard_batch(
            np.zeros(batch, np.float32), tr.mesh, P(SHARD_AXIS)
        )
        jax.block_until_ready(dev)
        windows = []
        for _w in range(3):
            t0 = time.perf_counter()
            losses = []
            for i, (dense, hi, lo, label) in enumerate(dev):
                (
                    tr.stacked, tr.params, tr.opt_state, loss, _lg, _dr, _mo,
                ) = tr._step_fn(
                    tr.stacked, tr.params, tr.opt_state, dense, hi, lo, label,
                    jnp.int32(tr.step), lq,
                )
                tr.step += 1
                losses.append(loss)
                if i >= d:
                    jax.block_until_ready(losses[i - d])
            jax.block_until_ready(losses[-1])
            windows.append((time.perf_counter() - t0) / steps)
        drops = tr.counters()["route_drops"]
        st.FORCE_EXCHANGE = False
        del tr, dev
        gc.collect()
        return min(windows), windows, drops

    def run_group(sharded: bool):
        """Heterogeneous 4-table group over the SAME id volume (feats
        columns round-robin onto 4 tables of cap/4): single-device
        GroupTrainer vs ShardedGroupTrainer at S — the distribution tax of
        the per-table a2a path (VERDICT r2 #4 flagship)."""
        from meepoembedding_tpu.group_train import GroupTrainer, ShardedGroupTrainer

        names = [f"t{i}" for i in range(4)]
        tables = {
            n: TableConfig(
                dim=dim, capacity=cap // 4, max_probe_rounds=2,
                insert_cap=1 << 13,
                optimizer=OptimizerConfig(kind="rowwise_adagrad",
                                          learning_rate=0.05),
            )
            for n in names
        }
        fmap = [names[i % 4] for i in range(feats)]
        gmodel = ModelConfig(
            kind="ctr_mlp", num_dense_features=13,
            num_sparse_features=feats, top_mlp=(64, 1),
        )
        if sharded:
            from meepoembedding_tpu.parallel.mesh import make_mesh

            tr = ShardedGroupTrainer(run, tables, fmap, gmodel,
                                     mesh=make_mesh(S))
        else:
            tr = GroupTrainer(run, tables, fmap, gmodel)
        t0 = time.perf_counter()
        for b in pre_batches:
            tr.train_step(b)
        if sharded:
            tr.flush()
        log(f"group{'-sharded' if sharded else ''} prefill in "
            f"{time.perf_counter()-t0:.1f}s")
        from meepoembedding_tpu.table import hashing

        if sharded:
            dev = [tr._device_batch(b) for b in timed_batches]
        else:
            dev = []
            for b in timed_batches:
                hi, lo = hashing.split_ids(b["ids"])
                dev.append((
                    jnp.asarray(b["dense"]), jnp.asarray(hi),
                    jnp.asarray(lo), jnp.asarray(b["label"]),
                ))
        jax.block_until_ready(dev)
        windows = []
        for _w in range(3):
            t0 = time.perf_counter()
            losses = []
            for i, (dense, hi, lo, label) in enumerate(dev):
                if sharded:
                    (tr.stacked, tr.params, tr.opt_state, loss, _lg, _dr,
                     _mo) = tr._step_fn(
                        tr.stacked, tr.params, tr.opt_state, dense, hi, lo,
                        label, jnp.int32(tr.step),
                    )
                else:
                    (tr.shards, tr.params, tr.opt_state, loss, _lg,
                     _mo) = tr._step_fn(
                        tr.shards, tr.params, tr.opt_state, dense, hi, lo,
                        label, jnp.int32(tr.step),
                    )
                tr.step += 1
                losses.append(loss)
                if i >= d:
                    jax.block_until_ready(losses[i - d])
            jax.block_until_ready(losses[-1])
            windows.append((time.perf_counter() - t0) / steps)
        del tr, dev
        gc.collect()
        return min(windows), windows

    # arm selection: comma list of {fast,exchange,ragged,group}
    arms = set(
        os.environ.get("MEEPO_OVERHEAD_ARMS", "fast,exchange,ragged").split(",")
    )
    fused_ms, fw = run_fused()
    log(f"fused:            {fused_ms*1e3:8.2f} ms/step  "
        f"[{','.join(f'{w*1e3:.0f}' for w in fw)}]")
    out = {
        "metric": "sharded_step_overhead_vs_fused",
        "devices": S,
        "ids_per_step": ids_per_step,
        "fused_ms": round(fused_ms * 1e3, 2),
    }
    if "fast" in arms:
        sharded_ms, sw, drops = run_sharded()
        log(f"sharded (S=1 fast path): {sharded_ms*1e3:8.2f} ms/step  "
            f"[{','.join(f'{w*1e3:.0f}' for w in sw)}]  route_drops={drops}")
        out.update(
            sharded_ms=round(sharded_ms * 1e3, 2),
            overhead=round(sharded_ms / fused_ms - 1.0, 4),
            route_drops=int(drops),
        )
    if S == 1 and "exchange" in arms:
        # price the exchange machinery itself: routing sort + send-buffer
        # scatter + a2a + owner re-dedup + emb re-gather, sans real transfer
        ex_ms, ew, ex_drops = run_sharded(force_exchange=True)
        log(f"sharded (forced exchange): {ex_ms*1e3:8.2f} ms/step  "
            f"[{','.join(f'{w*1e3:.0f}' for w in ew)}]  route_drops={ex_drops}")
        out["exchange_forced_ms"] = round(ex_ms * 1e3, 2)
        out["exchange_overhead"] = round(ex_ms / fused_ms - 1.0, 4)
    if S == 1 and "ragged" in arms:
        # ragged transport (parallel/ragged.py), same forced-exchange
        # harness
        rex_ms, rew, rex_drops = run_sharded(force_exchange=True, ragged=True)
        log(f"sharded (forced RAGGED exchange): {rex_ms*1e3:8.2f} ms/step  "
            f"[{','.join(f'{w*1e3:.0f}' for w in rew)}]  route_drops={rex_drops}")
        out["exchange_ragged_ms"] = round(rex_ms * 1e3, 2)
        out["exchange_ragged_overhead"] = round(rex_ms / fused_ms - 1.0, 4)
    if "group" in arms:
        g_ms, gw = run_group(sharded=False)
        log(f"group (4-table, single-device): {g_ms*1e3:8.2f} ms/step  "
            f"[{','.join(f'{w*1e3:.0f}' for w in gw)}]")
        sg_ms, sgw = run_group(sharded=True)
        log(f"group (4-table, sharded S={S}): {sg_ms*1e3:8.2f} ms/step  "
            f"[{','.join(f'{w*1e3:.0f}' for w in sgw)}]")
        out["group_ms"] = round(g_ms * 1e3, 2)
        out["group_sharded_ms"] = round(sg_ms * 1e3, 2)
        out["group_overhead"] = round(sg_ms / g_ms - 1.0, 4)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
