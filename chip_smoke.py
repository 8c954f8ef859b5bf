#!/usr/bin/env python3
"""Smoke test of the main path on one NVIDIA GPU, through the entry points a
user calls, with every result checked against a plain reference.

    python chip_smoke.py               # phases 1-3 on one card
    python chip_smoke.py --four-cards  # only the row-sharded phase, 4 cards

Phases (one line each, with the card's name and power limit):

1. table step: dedup.unique_pairs -> xla_ops.lookup_train -> rows_for_batch
   -> grads_to_window -> optim.apply_sparse_grads_ctx at 2^25 slots, f32,
   dim 32, rowwise AdaGrad, prefilled to 0.8 load, on a Zipf(1.05) stream of
   2^19 ids per step with fresh ids mixed in. For 4096 sampled ids the rows
   and accumulators read after every step are checked against a float64
   host replay (see `_replay_check` for what is bit-exact and what is held
   to 1e-6 relative), and the counters against the unique counts.
2. card-filling table: the same step at 2^28 slots (a 32 GiB values plane).
   The compiled step must alias the donated plane (memory_analysis), the
   process's peak device memory must stay below table + step transients,
   and the XLA scatter-add/scatter-set are timed against their bytes bound.
3. DLRM trainer and scorer through the CLI (`train --data synthetic` at the
   default widths, then `serve --ckpt` and `eval --ckpt`); the GPU loss is
   compared with a CPU run of the same seed.
4. (--four-cards) the row-sharded table exchange, dense and ragged, against
   a one-card run on the same stream, and `train --distributed` on 4 cards
   against 1.

Exits non-zero, printing no result, unless JAX's first device is a GPU.
The last line of stdout is the JSON result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import shutil
import sys
import time
import traceback
from functools import partial
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SMOKE_DIR = ROOT / ".smoke"  # gitignored scratch for checkpoints

KEY_MULT = np.int64(0x9E3779B97F4A7C15 & 0x7FFFFFFFFFFFFFFF)
DIM = 32
LR = 0.05
ZIPF_S = 1.05
ROW_RTOL = 1e-6
# Phases 3 and 4 hold the mean training loss to this relative distance from
# a reference run of the same seed (the towers' float32 matmuls run in TF32
# on the GPU). Readings on H100s: GPU vs CPU 4.0e-6 to 7.5e-6, four cards vs
# one 3.1e-6 to 3.7e-6 (PERF.md). An untrained model is about 4.5e-3 away.
LOSS_RTOL = 1e-4
# HBM bandwidth by device_kind (NVIDIA data sheets), for the scatter bound.
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}  # H100 SXM


@dataclasses.dataclass(frozen=True)
class Sizes:
    table_cap: int = 1 << 25
    big_cap: int = 1 << 28
    batch: int = 1 << 19
    fresh_per_step: int = 4096
    steps: int = 5
    big_steps: int = 3
    sample: int = 4096
    prefill_batch: int = 1 << 20
    fill: float = 0.8
    dlrm_cap: int = 1 << 25
    dlrm_batch: int = 4096
    dlrm_steps: int = 20
    serve_batches: int = 4
    mesh_cap: int = 1 << 25
    timing_iters: int = 20
    # full size: the plane dwarfs the batch, so the step's scratch must stay
    # far below it (at TINY sizes they are comparable)
    full: bool = True


FULL = Sizes()
# CPU rehearsal of the same code paths (tests/test_chip_smoke.py)
TINY = Sizes(
    table_cap=1 << 14, big_cap=1 << 15, batch=1 << 11, fresh_per_step=64,
    steps=3, big_steps=2, sample=256, prefill_batch=1 << 12,
    dlrm_cap=1 << 14, dlrm_batch=128, dlrm_steps=4, serve_batches=2,
    mesh_cap=1 << 14, timing_iters=2, full=False,
)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _check(ok, msg):
    """An assertion that `python -O` keeps."""
    if not ok:
        raise AssertionError(msg)


# --- the table step and its plain reference ---------------------------------

def _grad_q(xp, pos, lanes):
    """Integer grad numerators in [-4, 4] hashed from (batch position, lane);
    identical in numpy and jax.numpy (uint32 wraparound)."""
    h = (pos.astype(xp.uint32)[:, None] * xp.uint32(0x9E3779B1)
         + lanes.astype(xp.uint32)[None, :] * xp.uint32(0x85EBCA77))
    h = h ^ (h >> xp.uint32(15))
    h = h * xp.uint32(0x2C1B3C6D)
    h = h ^ (h >> xp.uint32(13))
    return (h % xp.uint32(9)).astype(xp.int32) - 4


GRAD_UNIT = 2.0 ** -16  # grads are q * 2^-16: every per-id sum is exact in f32


def synthetic_grads(n: int, dim: int, offset=0):
    """[n, dim] per-occurrence grads for the batch positions offset..offset+n.
    Multiples of 2^-16 below 2^-13, so any summation order is exact."""
    import jax.numpy as jnp

    pos = jnp.arange(n, dtype=jnp.uint32) + jnp.asarray(offset, jnp.uint32)
    q = _grad_q(jnp, pos, jnp.arange(dim, dtype=jnp.uint32))
    return q.astype(jnp.float32) * jnp.float32(GRAD_UNIT)


def table_spec(capacity: int, num_shards: int = 1, insert_cap=1 << 15):
    from meepoembedding_tpu.config import OptimizerConfig, TableConfig
    from meepoembedding_tpu.table.layout import TableSpec

    cfg = TableConfig(
        dim=DIM, capacity=capacity, initializer_scale=0.01,
        optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=LR),
        max_probe_rounds=2, insert_cap=insert_cap,
    )
    return TableSpec.from_config(cfg, num_shards=num_shards)


def make_table_step(spec, ucap: int):
    """The headline step (bench.py's cycle) with the synthetic grads."""
    import jax
    import jax.numpy as jnp

    from meepoembedding_tpu.ops import dedup, optim
    from meepoembedding_tpu.table import xla_ops

    def step(shard, hi, lo, pos, t):
        uniq = dedup.unique_pairs(hi, lo, ucap)
        shard, ctx = xla_ops.lookup_train(
            spec, shard, uniq.hi, uniq.lo, uniq.valid, t
        )
        out = xla_ops.rows_for_batch(spec, ctx.g128, ctx.sub, uniq.inverse)
        g = synthetic_grads(hi.shape[0], spec.dim)
        g_u = xla_ops.grads_to_window(spec, g, ctx.sub, uniq.inverse, ucap)
        shard = optim.apply_sparse_grads_ctx(spec, shard, ctx, g_u)
        return shard, jnp.take(out, pos, axis=0), jnp.sum(out), uniq.count

    return jax.jit(step, donate_argnums=(0,))


def make_reader(spec):
    """Probe-only read of (found, row, accumulator) for a few ids."""
    import jax
    import jax.numpy as jnp

    from meepoembedding_tpu.table import hashing, xla_ops

    @jax.jit
    def read(shard, hi, lo):
        pr = xla_ops.probe(spec, shard, hi, lo, hashing.is_valid(hi, lo))
        slot = jnp.where(pr.found, pr.slot, -1)
        rows = xla_ops.lookup_rows(spec, shard, slot)
        acc = xla_ops.gather_bucket_plane(shard.opt_rowwise[0], slot)
        return pr.found, rows, jnp.where(pr.found, acc, 0.0)

    def run(shard, keys):
        from meepoembedding_tpu.table.hashing import split_ids

        hi, lo = split_ids(keys)
        f, r, a = read(shard, jnp.asarray(hi), jnp.asarray(lo))
        return np.asarray(f), np.asarray(r), np.asarray(a)

    return run


def init_rows_reference(keys: np.ndarray) -> np.ndarray:
    """The oracle's hash-derived initializer (table/oracle.py), computed on
    the CPU backend so the device's own arithmetic is not its reference."""
    import jax
    import jax.numpy as jnp

    from meepoembedding_tpu.table import hashing

    hi, lo = hashing.split_ids(keys)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        r = hashing.default_rows(jnp.asarray(hi), jnp.asarray(lo), DIM, 0.01)
        return np.asarray(r)


def keys_of(k) -> np.ndarray:
    return np.asarray(k, np.int64) * KEY_MULT


def zipf_batch(rng, n_live: int, n: int) -> np.ndarray:
    """Bounded Zipf(1.05) ranks over [0, n_live) by inverse CDF (bench.py)."""
    t = 1.0 - ZIPF_S
    u = rng.random(n)
    k = ((float(n_live) ** t - 1.0) * u + 1.0) ** (1.0 / t)
    return np.minimum(k.astype(np.int64), n_live) - 1


def make_stream(sz: Sizes, n_live: int, steps: int, seed: int):
    """Host key batches: Zipf over the prefilled keys, plus fresh keys drawn
    from a small pool past them (so some are inserted, then hit again)."""
    rng = np.random.default_rng(seed)
    pool = n_live + np.arange(2 * sz.fresh_per_step, dtype=np.int64)
    out = []
    for _ in range(steps):
        k = zipf_batch(rng, n_live, sz.batch)
        at = rng.choice(sz.batch, size=sz.fresh_per_step, replace=False)
        k[at] = rng.choice(pool, size=sz.fresh_per_step)
        out.append(keys_of(k))
    return out, keys_of(pool)


def pick_sample(sz: Sizes, batches, fresh_keys, n_live: int, seed: int):
    """sz.sample distinct keys: the hottest, fresh ones, prefilled ones no
    batch touches, and the rest drawn from the batches."""
    rng = np.random.default_rng(seed + 1)
    seen = np.unique(np.concatenate(batches))
    hot = keys_of(np.arange(min(64, n_live)))
    fresh = np.intersect1d(fresh_keys, seen)[: sz.sample // 4]
    untouched = np.setdiff1d(
        keys_of(rng.choice(n_live, size=sz.sample, replace=False)), seen
    )[: sz.sample // 8]
    chosen = np.unique(np.concatenate([hot, fresh, untouched]))
    rest = np.setdiff1d(seen, chosen)
    rest = rng.choice(rest, size=min(len(rest), sz.sample - len(chosen)),
                      replace=False)
    return np.sort(np.concatenate([chosen, rest]))


def sample_grads(sample: np.ndarray, batch_keys: np.ndarray):
    """Per sampled key: (in batch?, first position, exact grad sum / unit)."""
    idx = np.clip(np.searchsorted(sample, batch_keys), 0, len(sample) - 1)
    match = sample[idx] == batch_keys
    pos = np.nonzero(match)[0]
    sid = idx[match]
    q = _grad_q(np, pos.astype(np.uint32), np.arange(DIM, dtype=np.uint32))
    gsum = np.zeros((len(sample), DIM), np.int64)
    np.add.at(gsum, sid, q.astype(np.int64))
    first = np.full(len(sample), len(batch_keys), np.int64)
    np.minimum.at(first, sid, pos)
    present = first < len(batch_keys)
    return present, np.where(present, first, 0).astype(np.int32), gsum


def _rel_err(got, want):
    """max |got - want| over max |want|, per row (rows of zeros count 0)."""
    scale = np.maximum(np.abs(want).max(axis=-1), 1e-30)
    return float((np.abs(got - want).max(axis=-1) / scale).max(initial=0.0))


def _replay_check(before, after, out, present, gsum, init, opt_init: float):
    """One step of rowwise AdaGrad replayed in float64 from the device's own
    pre-step state, for the sampled keys. Returns stats; raises on a miss.

    Bit-exact: keys absent from the batch keep row and accumulator; the
    forward rows equal the pre-step rows (fresh keys: the initializer).
    To 1e-6 relative: the updated rows (per row, against its largest
    element) and accumulators, since the device's rsqrt and float32
    products round differently from the float64 replay."""
    f0, r0, a0 = before
    f1, r1, a1 = after
    _check(not np.any(f0 & ~f1), "a live key vanished during the step")
    idle = ~present
    _check(np.array_equal(f1[idle], f0[idle]), "untouched key changed state")
    _check(np.array_equal(r1[idle], r0[idle]), "untouched row changed")
    _check(np.array_equal(a1[idle], a0[idle]),
           "untouched accumulator changed")
    live = present & f1  # looked up and holding a slot after the step
    dropped = present & ~f1
    fresh = live & ~f0
    base = np.where(fresh[:, None], init, r0)
    _check(np.array_equal(out[live], base[live]), "forward rows differ")
    _check(not np.any(out[dropped]), "a dropped key returned a non-zero row")
    g = gsum[live].astype(np.float64) * GRAD_UNIT
    a_old = np.where(fresh[live], opt_init, a0[live].astype(np.float64))
    a_new = a_old + (g * g).sum(axis=1) / DIM
    want = base[live].astype(np.float64) - (LR / np.sqrt(a_new + 1e-8))[:, None] * g
    row_err = _rel_err(r1[live].astype(np.float64), want)
    acc_err = float(np.max(np.abs(a1[live] - a_new) / a_new, initial=0.0))
    _check(row_err <= ROW_RTOL, f"row rel err {row_err:.3g} > {ROW_RTOL}")
    _check(acc_err <= ROW_RTOL,
           f"accumulator rel err {acc_err:.3g} > {ROW_RTOL}")
    return {"live": int(live.sum()), "fresh": int(fresh.sum()),
            "dropped": int(dropped.sum()), "row_err": row_err,
            "acc_err": acc_err}


def compile_table_step(spec, ucap: int, batch: int, n_sample: int):
    """The table step compiled from shapes alone (no table allocated), and
    XLA's memory analysis of it."""
    import jax
    import jax.numpy as jnp

    from meepoembedding_tpu.table.layout import alloc_shard

    abstract = jax.eval_shape(lambda: alloc_shard(spec))
    i32 = partial(jax.ShapeDtypeStruct, dtype=jnp.int32)
    compiled = make_table_step(spec, ucap).lower(
        abstract, i32((batch,)), i32((batch,)), i32((n_sample,)), i32(())
    ).compile()
    return compiled, compiled.memory_analysis()


def check_aliasing(spec, ma, sz: Sizes) -> dict:
    """The donated values plane is updated in place: XLA aliases it to the
    output, and the step's scratch stays far below the plane."""
    plane = spec.value_rows * 128 * spec.dtype.itemsize
    alias, temp = _bytes(ma.alias_size_in_bytes), _bytes(ma.temp_size_in_bytes)
    _check(alias >= plane, f"values plane not aliased ({alias} < {plane})")
    if sz.full:
        _check(temp < plane / 4, (
            f"step temp {temp} not far below the {plane}-byte plane"))
    return {"plane_GiB": round(plane / 2**30, 3), "step_alias_bytes": alias,
            "step_temp_bytes": temp}


def prefill(spec, shard, n_live: int, batch: int):
    """Insert keys_of(0..n_live) with their initial rows (zero grads)."""
    import jax
    import jax.numpy as jnp

    from meepoembedding_tpu.ops import optim
    from meepoembedding_tpu.table import hashing, xla_ops

    spec_p = dataclasses.replace(spec, insert_cap=None)

    @partial(jax.jit, donate_argnums=(0,))
    def fill(shard, hi, lo):
        valid = hashing.is_valid(hi, lo)
        shard, ctx = xla_ops.lookup_train(spec_p, shard, hi, lo, valid,
                                          jnp.int32(0))
        return optim.apply_sparse_grads_ctx(spec_p, shard, ctx,
                                            jnp.zeros_like(ctx.g128))

    for j, i in enumerate(range(0, n_live, batch)):
        ids = keys_of(np.arange(i, min(i + batch, n_live)))
        ids = np.concatenate([ids, np.full(batch - len(ids), hashing.EMPTY_ID)])
        hi, lo = hashing.split_ids(ids)
        shard = fill(shard, jnp.asarray(hi), jnp.asarray(lo))
        if j % 8 == 7:  # bound the steps in flight
            jax.block_until_ready(shard.counters)
    jax.block_until_ready(shard)
    return shard, fill


def run_table_phase(sz: Sizes, capacity: int, steps: int, seed: int):
    """Prefill, run `steps` checked steps; returns (info, shard, extras)."""
    import jax
    import jax.numpy as jnp

    from meepoembedding_tpu.table import hashing
    from meepoembedding_tpu.table.layout import (
        DENIED, DROPS, HITS, INSERTS, MISSES, alloc_shard,
    )

    spec = table_spec(capacity)
    n_live = int(spec.capacity * sz.fill)
    batches, fresh_keys = make_stream(sz, n_live, steps, seed)
    ucap = max(len(np.unique(b)) for b in batches) + 1
    ucap = -(-ucap // 128) * 128
    sample = pick_sample(sz, batches, fresh_keys, n_live, seed)
    init = init_rows_reference(sample)
    read = make_reader(spec)
    t0 = time.perf_counter()
    compiled, ma = compile_table_step(spec, ucap, sz.batch, len(sample))
    t_compile = time.perf_counter() - t0

    t0 = time.perf_counter()
    shard = jax.jit(lambda: alloc_shard(spec))()
    shard, fill = prefill(spec, shard, n_live, sz.prefill_batch)
    t_prefill = time.perf_counter() - t0
    c0 = np.asarray(shard.counters)
    load = float(jnp.sum(shard.cnt)) / spec.capacity

    state = read(shard, sample)
    # before any step, sampled prefilled keys hold the initializer's bits and
    # the initial accumulator exactly (zero-grad prefill)
    f0, r0, a0 = state
    opt_init = spec.optimizer.initial_accumulator
    _check(f0.any(), "no sampled key was prefilled")
    _check(np.array_equal(r0[f0], init[f0]),
           "prefilled rows differ from the initializer")
    _check(np.all(a0[f0] == np.float32(opt_init)), "prefilled accumulators")
    stats, times, ucounts = [], [], []
    checksum = 0.0
    for t, keys in enumerate(batches):
        hi, lo = hashing.split_ids(keys)
        present, pos, gsum = sample_grads(sample, keys)
        hi, lo, pos_d = jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(pos)
        jax.block_until_ready((hi, lo, pos_d))
        t0 = time.perf_counter()
        shard, out, s, ucount = compiled(shard, hi, lo, pos_d, jnp.int32(t + 1))
        jax.block_until_ready((shard, out, s, ucount))
        times.append(time.perf_counter() - t0)
        checksum += float(s)
        ucounts.append(int(ucount))
        _check(ucounts[-1] < ucap, "dedup capacity overflow")
        after = read(shard, sample)
        stats.append(_replay_check(state, after, np.asarray(out), present,
                                   gsum, init, opt_init))
        state = after
    _check(math.isfinite(checksum), "non-finite forward rows")
    c1 = np.asarray(shard.counters)
    dc = (c1 - c0).astype(np.int64)
    _check(dc[HITS] + dc[MISSES] == sum(ucounts), (
        f"hits+misses {dc[HITS] + dc[MISSES]} != uniques {sum(ucounts)}"))
    _check(dc[INSERTS] + dc[DROPS] + dc[DENIED] == dc[MISSES],
           "misses != inserts + drops + denied")
    _check(sum(s["dropped"] for s in stats) <= dc[DROPS] + dc[DENIED],
           "more sampled keys dropped than the drop counters say")
    info = {
        "slots": spec.capacity, "table_GB": round(spec.hbm_bytes() / 1e9, 3),
        "load": round(load, 4), "prefill_s": round(t_prefill, 3),
        "compile_s": round(t_compile, 3),
        "step_ms": [round(x * 1e3, 3) for x in times],
        "ids_per_step": sz.batch, "uniques": ucounts,
        "hits": int(dc[HITS]), "misses": int(dc[MISSES]),
        "inserts": int(dc[INSERTS]), "drops": int(dc[DROPS]),
        "prefill_drops": int(c0[DROPS]),
        "sampled": len(sample),
        "checked_live": sum(s["live"] for s in stats),
        "checked_fresh": sum(s["fresh"] for s in stats),
        "max_row_rel_err": max(s["row_err"] for s in stats),
        "max_acc_rel_err": max(s["acc_err"] for s in stats),
    }
    extras = {"spec": spec, "ma": ma, "fill": fill,
              "ucount": int(np.mean(ucounts))}
    return info, shard, extras


def phase_table(sz: Sizes) -> dict:
    return run_table_phase(sz, sz.table_cap, sz.steps, seed=0)[0]


def _bytes(x) -> int:
    return int(x or 0)


def time_scatters(sz: Sizes, shard, spec, n_rows: int) -> dict:
    """XLA scatter-add and scatter-set of n_rows unique storage rows into
    the donated values plane, against rows * 128 lanes * itemsize * 2 bytes
    over HBM bandwidth."""
    import jax
    import jax.numpy as jnp

    from meepoembedding_tpu.table import xla_ops

    values = shard.values
    R, lanes = values.shape
    rng = np.random.default_rng(7)
    vrow = jnp.asarray(rng.choice(R, size=n_rows, replace=False), jnp.int32)
    upd = jnp.asarray(rng.standard_normal((n_rows, lanes)) * 1e-3, values.dtype)
    slot = vrow * spec.pack + jnp.asarray(rng.integers(0, spec.pack, n_rows),
                                          jnp.int32)
    rows = upd[:, : spec.dim]
    on = jnp.ones((n_rows,), bool)

    kernels = {
        "scatter_add": lambda p: xla_ops.values_scatter_add(p, vrow, upd),
        "scatter_set_rows": lambda p: p.at[vrow].set(
            upd, mode="drop", unique_indices=True),
        "scatter_set_values": lambda p: xla_ops.scatter_set_values(
            spec, p, slot, rows, on),
    }
    kind = jax.devices()[0].device_kind
    bw = HBM_BYTES_PER_S.get(kind)
    bound_s = n_rows * lanes * values.dtype.itemsize * 2 / bw if bw else None
    out = {"rows": n_rows, "bound_us": round(bound_s * 1e6, 3) if bw else
           f"no HBM bandwidth on record for {kind!r}"}
    for name, fn in kernels.items():
        f = jax.jit(fn, donate_argnums=(0,))
        c = f.lower(values).compile()
        ma = c.memory_analysis()
        values = c(values)
        jax.block_until_ready(values)
        t0 = time.perf_counter()
        for _ in range(sz.timing_iters):
            values = c(values)
        jax.block_until_ready(values)
        dt = (time.perf_counter() - t0) / sz.timing_iters
        plane = values.size * values.dtype.itemsize
        out[name] = {
            "us": round(dt * 1e6, 3),
            "x_bound": round(dt / bound_s, 3) if bw else None,
            "alias_bytes": _bytes(ma.alias_size_in_bytes),
            "temp_bytes": _bytes(ma.temp_size_in_bytes),
        }
        _check(out[name]["alias_bytes"] >= plane, f"{name}: plane not aliased")
    _check(bool(jnp.all(jnp.isfinite(values[:8]))), "non-finite plane")
    return out


def phase_big_table(sz: Sizes) -> dict:
    import jax

    info, shard, extras = run_table_phase(sz, sz.big_cap, sz.big_steps, seed=1)
    spec = extras["spec"]
    table = spec.hbm_bytes()
    ma = extras["ma"]
    info.update(check_aliasing(spec, ma, sz))
    stats = jax.devices()[0].memory_stats()
    if stats and "peak_bytes_in_use" in stats:
        fill_ma = extras["fill"].lower(
            shard, *(jax.ShapeDtypeStruct((sz.prefill_batch,), "int32"),) * 2
        ).compile().memory_analysis()
        transient = max(_bytes(ma.temp_size_in_bytes),
                        _bytes(fill_ma.temp_size_in_bytes))
        peak = int(stats["peak_bytes_in_use"])
        info.update(peak_bytes_in_use=peak, transient_bytes=transient,
                    bytes_limit=stats.get("bytes_limit"))
        # table + the largest step's transients + ids, samples and reads
        _check(peak <= table + transient + (2 << 30), (
            f"peak {peak} above table {table} + transients {transient}"))
    else:
        info["peak_bytes_in_use"] = "not reported by this backend"
    info["scatter"] = time_scatters(sz, shard, spec, extras["ucount"])
    return info


# --- phase 3: DLRM through the CLI ------------------------------------------

def run_cli(argv) -> tuple:
    """cli.main(argv) in this process; returns (JSON lines printed, seconds)."""
    import jax

    from meepoembedding_tpu import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    lines = []
    for line in buf.getvalue().splitlines():
        try:
            lines.append(json.loads(line))
        except ValueError:
            pass
    jax.effects_barrier()
    _check(rc == 0, f"cli {argv[0]} exited {rc}")
    return lines, time.perf_counter() - t0


def _last(lines, key):
    got = [ln for ln in lines if isinstance(ln, dict) and key in ln]
    _check(got, f"no line with {key!r}")
    return got[-1]


def phase_dlrm(sz: Sizes) -> dict:
    import jax

    ckpt = SMOKE_DIR / "dlrm_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    sets = ["--set", f"table.capacity={sz.dlrm_cap}",
            f"run.batch_size={sz.dlrm_batch}", f"run.steps={sz.dlrm_steps}",
            "run.log_every=1"]
    train = ["train", "--data", "synthetic", *sets]
    lines, t_train = run_cli(train + ["--ckpt-dir", ckpt])
    dev = _last(lines, "loss")
    first = float(next(ln for ln in lines if "loss" in ln)["loss"])
    with jax.default_device(jax.devices("cpu")[0]):
        ref_lines, t_cpu = run_cli(train)
    ref = _last(ref_lines, "loss")
    loss, ref_loss = float(dev["loss"]), float(ref["loss"])
    _check(math.isfinite(loss), f"loss {loss}")
    rel = abs(loss - ref_loss) / abs(ref_loss)
    _check(rel <= LOSS_RTOL,
           f"GPU loss {loss} vs CPU {ref_loss}: rel {rel:.3g}")
    # the mean over the run fell from the first step's loss: the model learned
    fell = (first - loss) / first
    _check(fell > LOSS_RTOL, f"loss {first} -> mean {loss}: did not fall")
    _check(dev["ctr_inserts"] == ref["ctr_inserts"], "insert counts differ")

    view = ["--set", f"table.capacity={sz.dlrm_cap}",
            f"run.batch_size={sz.dlrm_batch}", f"run.steps={sz.serve_batches}"]
    served, t_serve = run_cli(["serve", "--ckpt", ckpt, *view])
    scores = [s for ln in served if "scores" in ln for s in ln["scores"]]
    _check(sum("scores" in ln for ln in served) == sz.serve_batches,
           "serve scored the wrong number of batches")
    _check(scores and all(0.0 <= s <= 1.0 for s in scores), "bad scores")
    ev, t_eval = run_cli(["eval", "--ckpt", ckpt, *view])
    ev = _last(ev, "auc")
    _check(0.0 <= ev["auc"] <= 1.0 and math.isfinite(ev["mean_loss"]),
           f"eval {ev}")
    shutil.rmtree(ckpt, ignore_errors=True)
    return {
        "steps": sz.dlrm_steps, "batch": sz.dlrm_batch,
        "slots": sz.dlrm_cap, "first_step_loss": first, "loss": loss,
        "loss_fell_rel": fell, "cpu_loss": ref_loss,
        "loss_rel_diff": rel, "loss_rtol": LOSS_RTOL, "train_auc": dev["auc"],
        "rows_inserted": dev["ctr_inserts"], "train_s": round(t_train, 3),
        "cpu_train_s": round(t_cpu, 3), "serve_s": round(t_serve, 3),
        "eval_auc": ev["auc"], "eval_loss": ev["mean_loss"],
        "eval_s": round(t_eval, 3),
    }


# --- phase 4: the row-sharded exchange on four cards ------------------------

def run_sharded_table(sz: Sizes, mesh, batches, sample, ragged: bool):
    """Exchange step over `mesh`: each device dedups its slice of the global
    batch, the exchange routes ids to owners, grads ride back. Returns
    (rows, accumulators-free found flags, summed counters)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from meepoembedding_tpu.ops import dedup
    from meepoembedding_tpu.parallel import ragged as rg
    from meepoembedding_tpu.parallel import sharded_table as st
    from meepoembedding_tpu.parallel.mesh import SHARD_AXIS
    from meepoembedding_tpu.parallel.trainer import alloc_stacked_shards
    from meepoembedding_tpu.table import hashing

    S = mesh.shape[SHARD_AXIS]
    # no insert throttle: one card and four must admit the same keys
    spec = table_spec(sz.mesh_cap, num_shards=S, insert_cap=None)
    n_local = sz.batch // S
    ucap = -(-n_local // 128) * 128
    cap = (rg.ragged_recv_cap(ucap, S, 2.0) if ragged
           else st.a2a_capacity(ucap, S, 2.0))

    def step_body(stacked, hi, lo, t):
        shard = st.squeeze_shard(stacked)
        uniq = dedup.unique_pairs(hi, lo, ucap, owner_major=S if ragged else 0)
        shard, emb_u, ctx = st.exchange_lookup(
            spec, shard, uniq.hi, uniq.lo, uniq.valid, t, SHARD_AXIS, cap,
            train=True, ragged=ragged, owner_sorted=ragged,
        )
        offset = jax.lax.axis_index(SHARD_AXIS) * n_local
        g = synthetic_grads(n_local, spec.dim, offset)
        g_u = jnp.zeros((ucap, spec.dim), jnp.float32).at[uniq.inverse].add(g)
        shard = st.exchange_apply_grads(spec, shard, ctx, g_u, SHARD_AXIS, cap)
        return st.unsqueeze_shard(shard), jnp.sum(emb_u)[None]

    def read_body(stacked, hi, lo):
        shard = st.squeeze_shard(stacked)
        valid = hashing.is_valid(hi, lo)
        _, emb_u, _ = st.exchange_lookup(
            spec, shard, hi, lo, valid, jnp.int32(0), SHARD_AXIS,
            st.a2a_capacity(hi.shape[0], S, float(S)), train=False,
        )
        return emb_u

    d = P(SHARD_AXIS)
    step = jax.jit(jax.shard_map(step_body, mesh=mesh, in_specs=(d, d, d, P()),
                                 out_specs=(d, d), check_vma=False),
                   donate_argnums=(0,))
    read = jax.jit(jax.shard_map(read_body, mesh=mesh, in_specs=(d, d, d),
                                 out_specs=d, check_vma=False))
    put = lambda x: jax.device_put(x, NamedSharding(mesh, d))  # noqa: E731

    stacked = alloc_stacked_shards(spec, mesh)
    t0 = time.perf_counter()
    for t, keys in enumerate(batches):
        hi, lo = hashing.split_ids(keys)
        stacked, s = step(stacked, put(hi), put(lo), jnp.int32(t + 1))
    jax.block_until_ready(stacked)
    dt = time.perf_counter() - t0
    hi, lo = hashing.split_ids(sample)
    rows = np.asarray(read(stacked, put(hi), put(lo)))
    counters = np.asarray(stacked.counters).sum(axis=0)
    return rows, counters, dt


def phase_four_cards(sz: Sizes) -> dict:
    import jax

    from meepoembedding_tpu.parallel.mesh import make_mesh
    from meepoembedding_tpu.parallel.sharded_table import ROUTE_DROPS
    from meepoembedding_tpu.table.layout import HITS, INSERTS, MISSES

    _check(len(jax.devices()) >= 4,
           f"needs 4 devices, have {len(jax.devices())}")
    one, four = make_mesh(1), make_mesh(4)
    n_keys = int(sz.mesh_cap * 0.5)
    rng = np.random.default_rng(3)
    batches = [keys_of(zipf_batch(rng, n_keys, sz.batch)) for _ in range(sz.steps)]
    seen = np.unique(np.concatenate(batches))
    sample = np.sort(rng.choice(seen, size=min(sz.sample, len(seen)),
                                replace=False))
    sample = sample[: len(sample) // 4 * 4]
    ref_rows, ref_c, t1 = run_sharded_table(sz, one, batches, sample, False)
    info = {"one_card_s": round(t1, 3)}

    def compare(name, ragged):
        rows, c, t4 = run_sharded_table(sz, four, batches, sample, ragged)
        err = _rel_err(rows.astype(np.float64), ref_rows.astype(np.float64))
        info[name] = {"s": round(t4, 3), "row_rel_err": err,
                      "bit_equal": bool(np.array_equal(rows, ref_rows)),
                      "zero_rows": int((~rows.any(axis=1)).sum()),
                      "route_drops": int(c[ROUTE_DROPS]),
                      **{k: int(c[i]) for k, i in
                         (("hits", HITS), ("misses", MISSES),
                          ("inserts", INSERTS))}}
        ok = err <= ROW_RTOL and c[ROUTE_DROPS] == 0 and all(
            c[k] == ref_c[k] for k in (HITS, MISSES, INSERTS))
        return ok

    for name, ragged in (("dense", False), ("ragged", True)):
        _check(compare(name, ragged), f"{name} exchange differs: {info[name]}")

    sets = ["--set", f"table.capacity={sz.dlrm_cap}",
            f"run.batch_size={sz.dlrm_batch}", f"run.steps={sz.dlrm_steps}",
            f"run.log_every={sz.dlrm_steps}", "run.pipeline_depth=0"]
    train = ["train", "--distributed", "--data", "synthetic", *sets]
    l4, t4 = run_cli(train)
    l1, t1 = run_cli(train + ["run.mesh_shape=1"])
    a, b = _last(l4, "loss"), _last(l1, "loss")
    rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    _check(math.isfinite(a["loss"]) and rel <= LOSS_RTOL, (
        f"4-card loss {a['loss']} vs 1-card {b['loss']}"))
    _check(a["route_drops"] == 0, f"{a['route_drops']} route drops")
    for k in ("rows", "hits", "misses", "inserts"):
        _check(a[k] == b[k], f"trainer {k}: 4 cards {a[k]} != 1 card {b[k]}")
    info["trainer"] = {"loss_4": a["loss"], "loss_1": b["loss"],
                       "loss_rel_diff": rel, "rows": a["rows"],
                       "hits": a["hits"], "inserts": a["inserts"],
                       "s_4": round(t4, 3), "s_1": round(t1, 3)}
    return info


# --- driver -----------------------------------------------------------------

PHASES = (("table_2^25", phase_table), ("table_2^28", phase_big_table),
          ("dlrm_cli", phase_dlrm))


def main(argv=None, require_device=None, sizes: Sizes = FULL) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the row-sharded phase, on 4 local cards")
    args = p.parse_args(argv)

    import jax

    from meepoembedding_tpu import device

    dev = (require_device or device.require_gpu)()
    cache = device.enable_compile_cache()
    card = device.card_name_and_power_limit().replace("\n", "; ")
    log(f"device {dev.device_kind} x{len(jax.devices())}, jax "
        f"{jax.__version__}, compile cache {cache}")
    phases = ((("four_cards", phase_four_cards),) if args.four_cards
              else PHASES)
    SMOKE_DIR.mkdir(exist_ok=True)
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            info, ok = fn(sizes), True
        except Exception:  # noqa: BLE001 — report every phase, then fail
            info, ok = {"error": traceback.format_exc(limit=6)}, False
            failed.append(name)
        dt = time.perf_counter() - t0
        print(f"phase {name}: {'PASS' if ok else 'FAIL'} {dt:.3f} s "
              f"[{card}] {json.dumps(info, default=str)}", flush=True)
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    if failed:
        log(f"failed phases: {failed}")
        return 1
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": device.describe(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
