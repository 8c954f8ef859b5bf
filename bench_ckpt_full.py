"""Full-scale checkpoint: save + elastic restore of the config-5-class table
(default 2^27 slots bf16, 100.66M live rows) on one chip (VERDICT r2 #7).

The save streams resumable part files (checkpoint.save_shard_streamed) with
bf16 values as raw 2-byte bits, so the device->host payload is ~84 B/row
(~8.4 GB at 100.66M rows) instead of the r2 format's ~13+ GB of f32 npz.
If the run is interrupted, RE-RUNNING IT RESUMES: the prefill is
deterministic (same table state), the generation dir name repeats until the
manifest commits, and completed parts are skipped without device re-fetch.

After the save: restore onto a fresh table, compare N sampled rows
bit-exactly against the pre-save state, and report timings + bytes.

Env: MEEPO_BENCH_CAP (1<<27), MEEPO_BENCH_DTYPE (bfloat16), MEEPO_BENCH_DIM
(32), MEEPO_CKPT_DIR (/tmp/meepo_full_ckpt), MEEPO_CKPT_SAMPLE (200000),
MEEPO_CKPT_CHUNK_ROWS (2^22), MEEPO_CKPT_RESTORE (1; 0 = save only).
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

    from meepoembedding_tpu import checkpoint
    from meepoembedding_tpu.config import OptimizerConfig, TableConfig
    from meepoembedding_tpu.ops import optim
    from meepoembedding_tpu.table import hashing, xla_ops
    from meepoembedding_tpu.table.layout import TableSpec, alloc_shard

    cap = int(os.environ.get("MEEPO_BENCH_CAP", 1 << 27))
    dim = int(os.environ.get("MEEPO_BENCH_DIM", 32))
    dtype = os.environ.get("MEEPO_BENCH_DTYPE", "bfloat16")
    ckpt_dir = os.environ.get("MEEPO_CKPT_DIR", "/tmp/meepo_full_ckpt")
    n_sample = int(os.environ.get("MEEPO_CKPT_SAMPLE", 200_000))
    fill = 0.75 if cap >= (1 << 27) else 0.8  # f32 at 2^27 can't fit HBM

    cfg = TableConfig(
        dim=dim, capacity=cap, value_dtype=dtype,
        optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.05),
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
        # nonzero grads so sampled rows carry trained state, not just init
        return optim.apply_sparse_grads_ctx(
            spec, shard, ctx, ctx.g128.astype(jnp.float32) * 0.01 + 1e-3
        )

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
    prefill_s = time.perf_counter() - t0
    log(f"prefill {n_live} rows in {prefill_s:.1f}s")

    # pre-save sample (host copy for the bit-exactness check)
    rng = np.random.default_rng(0)
    sample_ids = rng.choice(n_live, size=n_sample, replace=False).astype(np.int64) * key_mult
    sh, sl = hashing.split_ids(sample_ids)

    @jax.jit
    def read_rows(shard, hi, lo):
        pr = xla_ops.probe(spec, shard, hi, lo, hashing.is_valid(hi, lo))
        slot = jnp.where(pr.found, pr.slot, -1)
        rows = xla_ops.lookup_rows(spec, shard, slot)
        acc = (xla_ops.gather_bucket_plane(shard.opt_rowwise[0], pr.slot)
               if shard.opt_rowwise else jnp.zeros_like(hi, jnp.float32))
        return rows, acc, pr.found

    pre_rows, pre_acc, pre_found = map(np.asarray, read_rows(shard, jnp.asarray(sh), jnp.asarray(sl)))
    # prefill at 0.75 load with max_probe_rounds=2 drops a handful of inserts
    # (~4e-6, same as bench.py's counted drops) — sample only live rows, and
    # sanity-bound the miss rate so a real lookup bug can't hide behind it
    n_missing = int((~pre_found).sum())
    assert n_missing <= max(8, int(n_sample * 1e-4)), (
        f"{n_missing}/{n_sample} sampled ids missing — beyond insert-drop noise"
    )
    if n_missing:
        log(f"sample: {n_missing} ids were insert-drops at prefill; "
            f"checking the {n_sample - n_missing} live rows")
        keep = pre_found
        sh, sl = sh[keep], sl[keep]
        pre_rows, pre_acc, pre_found = pre_rows[keep], pre_acc[keep], pre_found[keep]
        n_sample = int(pre_found.shape[0])

    t0 = time.perf_counter()
    manifest = checkpoint.save(ckpt_dir, spec, [shard], step=1)
    save_s = time.perf_counter() - t0
    gdir = os.path.join(ckpt_dir, manifest["dir"])
    nbytes = sum(
        os.path.getsize(os.path.join(gdir, f)) for f in os.listdir(gdir)
    )
    log(f"save: {save_s:.1f}s, {nbytes/2**30:.2f} GiB on disk, "
        f"{manifest['counts']} rows, parts={len(os.listdir(gdir))}")

    out = {
        "metric": "full_scale_checkpoint",
        "capacity": cap, "dtype": dtype, "rows": int(sum(manifest["counts"])),
        "save_s": round(save_s, 1), "gib": round(nbytes / 2**30, 2),
        "mib_per_s": round(nbytes / 2**20 / save_s, 2),
    }
    if os.environ.get("MEEPO_CKPT_RESTORE", "1") == "1":
        del shard  # free HBM for the restored copy
        t0 = time.perf_counter()
        shards, m2 = checkpoint.restore_shards(spec, ckpt_dir, 1)
        restore_s = time.perf_counter() - t0
        log(f"elastic restore: {restore_s:.1f}s")
        post_rows, post_acc, post_found = map(
            np.asarray, read_rows(shards[0], jnp.asarray(sh), jnp.asarray(sl))
        )
        assert post_found.all(), "restored table lost sampled ids"
        np.testing.assert_array_equal(pre_rows, post_rows)
        np.testing.assert_array_equal(pre_acc, post_acc)
        log(f"sampled {n_sample} rows bit-exact after restore")
        out["restore_s"] = round(restore_s, 1)
        out["sample_bit_exact"] = True
    print(json.dumps(out))


if __name__ == "__main__":
    main()
