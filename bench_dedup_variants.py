"""Micro-bench dedup variants on the chip (r4 perf work).

Current unique_pairs (r3): sort#1 (5 operands, 2 keys) + matmul prefix sum +
sort#2 (inverse) + sort#3 (compaction).  Candidates:
  A. 3-operand sort#1: carry only (bh, bl, iota); reconstruct ids by XOR
     (the key transform is bijective, EMPTY maps to the unsigned max).
  B. searchsorted compaction: rank r's run start position found by binary
     search over the sorted group ids (gid0 is nondecreasing), replacing
     the 3-operand flag sort with two 1-D gathers.
  C. A + B combined.
Each timed with the depth-lagged fetch discipline from bench.py.
"""
import os
import time

import numpy as np

import jax
import jax.numpy as jnp

from meepoembedding_tpu.ops import dedup
from meepoembedding_tpu.table import hashing

N = int(os.environ.get("N", 1 << 19))
UCAP = int(os.environ.get("UCAP", 198784))
STEPS = int(os.environ.get("STEPS", 30))


def make_stream(seed=0):
    rng = np.random.default_rng(seed)
    # zipf-ish over 26.8M keys, ~33% unique like the headline bench
    ranks = np.minimum(
        rng.zipf(1.05, size=N).astype(np.int64) % (26843545), 26843544
    )
    ids = ranks * 2654435761 + 12345
    return hashing.split_ids(ids)


def timeit(fn, args, label):
    outs = [fn(*args) for _ in range(3)]
    jax.block_until_ready(outs[-1])
    depth = 8
    buf = []
    t0 = time.perf_counter()
    for i in range(STEPS):
        buf.append(fn(*args))
        if len(buf) > depth:
            o = buf.pop(0)
            np.asarray(o[4])  # count scalar fetch (real barrier)
    for o in buf:
        np.asarray(o[4])
    dt = (time.perf_counter() - t0) / STEPS * 1e3
    print(f"{label:28s} {dt:7.2f} ms")
    return dt


BIAS_H = jnp.uint32(np.uint32(np.int64(hashing.EMPTY_HI) & 0xFFFFFFFF) ^ np.uint32(0xFFFFFFFF))
BIAS_L = jnp.uint32(np.uint32(np.int64(hashing.EMPTY_LO) & 0xFFFFFFFF) ^ np.uint32(0xFFFFFFFF))


def unique_A(hi, lo, size):
    """3-operand sort#1; ids reconstructed by XOR; flag-sort compaction
    runs on the transformed keys and reconstructs after the slice."""
    n = hi.shape[0]
    bh = hi.astype(jnp.uint32) ^ BIAS_H
    bl = lo.astype(jnp.uint32) ^ BIAS_L
    iota = jnp.arange(n, dtype=jnp.int32)
    sbh, sbl, order = jax.lax.sort((bh, bl, iota), num_keys=2, is_stable=True)
    is_new = jnp.concatenate(
        [jnp.ones((1,), bool), (sbh[1:] != sbh[:-1]) | (sbl[1:] != sbl[:-1])]
    )
    gid0 = dedup.prefix_sum_i32(is_new.astype(jnp.int32)) - 1
    num_runs = gid0[-1] + 1
    gid = jnp.minimum(gid0, size - 1)
    _, inverse = jax.lax.sort((order, gid), num_keys=1, is_stable=False)
    tag = jnp.where(is_new, jnp.int32(0), jnp.int32(1))
    _, ch, cl = jax.lax.sort((tag, sbh, sbl), num_keys=1, is_stable=True)
    keep = jnp.arange(size, dtype=jnp.int32) < num_runs
    uh = jnp.where(keep, (ch[:size] ^ BIAS_H).astype(jnp.int32), hashing.EMPTY_HI)
    ul = jnp.where(keep, (cl[:size] ^ BIAS_L).astype(jnp.int32), hashing.EMPTY_LO)
    valid = hashing.is_valid(uh, ul)
    count = jnp.sum(valid).astype(jnp.int32)
    return dedup.Unique(hi=uh, lo=ul, inverse=inverse, valid=valid, count=count)


def unique_B(hi, lo, size):
    """Current 5-operand sort#1, searchsorted compaction (no sort#3)."""
    n = hi.shape[0]
    inval = ~hashing.is_valid(hi, lo)
    bh = hi.astype(jnp.uint32) ^ jnp.uint32(0x80000000)
    bh = jnp.where(inval, jnp.uint32(0xFFFFFFFF), bh)
    bl = lo.astype(jnp.uint32) ^ jnp.uint32(0x80000000)
    iota = jnp.arange(n, dtype=jnp.int32)
    sbh, sbl, order, sh, sl = jax.lax.sort(
        (bh, bl, iota, hi, lo), num_keys=2, is_stable=True
    )
    is_new = jnp.concatenate(
        [jnp.ones((1,), bool), (sbh[1:] != sbh[:-1]) | (sbl[1:] != sbl[:-1])]
    )
    gid0 = dedup.prefix_sum_i32(is_new.astype(jnp.int32)) - 1
    num_runs = gid0[-1] + 1
    gid = jnp.minimum(gid0, size - 1)
    _, inverse = jax.lax.sort((order, gid), num_keys=1, is_stable=False)
    pos = jnp.searchsorted(gid0, jnp.arange(size, dtype=jnp.int32))
    keep = jnp.arange(size, dtype=jnp.int32) < num_runs
    uh = jnp.where(keep, sh[jnp.minimum(pos, n - 1)], hashing.EMPTY_HI)
    ul = jnp.where(keep, sl[jnp.minimum(pos, n - 1)], hashing.EMPTY_LO)
    valid = hashing.is_valid(uh, ul)
    count = jnp.sum(valid).astype(jnp.int32)
    return dedup.Unique(hi=uh, lo=ul, inverse=inverse, valid=valid, count=count)


def unique_C(hi, lo, size):
    """A + B: 3-operand sort#1 + searchsorted compaction."""
    n = hi.shape[0]
    bh = hi.astype(jnp.uint32) ^ BIAS_H
    bl = lo.astype(jnp.uint32) ^ BIAS_L
    iota = jnp.arange(n, dtype=jnp.int32)
    sbh, sbl, order = jax.lax.sort((bh, bl, iota), num_keys=2, is_stable=True)
    is_new = jnp.concatenate(
        [jnp.ones((1,), bool), (sbh[1:] != sbh[:-1]) | (sbl[1:] != sbl[:-1])]
    )
    gid0 = dedup.prefix_sum_i32(is_new.astype(jnp.int32)) - 1
    num_runs = gid0[-1] + 1
    gid = jnp.minimum(gid0, size - 1)
    _, inverse = jax.lax.sort((order, gid), num_keys=1, is_stable=False)
    pos = jnp.minimum(jnp.searchsorted(gid0, jnp.arange(size, dtype=jnp.int32)), n - 1)
    keep = jnp.arange(size, dtype=jnp.int32) < num_runs
    uh = jnp.where(keep, (sbh[pos] ^ BIAS_H).astype(jnp.int32), hashing.EMPTY_HI)
    ul = jnp.where(keep, (sbl[pos] ^ BIAS_L).astype(jnp.int32), hashing.EMPTY_LO)
    valid = hashing.is_valid(uh, ul)
    count = jnp.sum(valid).astype(jnp.int32)
    return dedup.Unique(hi=uh, lo=ul, inverse=inverse, valid=valid, count=count)


def main():
    from meepoembedding_tpu.device import bench_device

    bench_device()
    hi_np, lo_np = make_stream()
    hi, lo = jnp.asarray(hi_np), jnp.asarray(lo_np)
    print(f"n={N}, ucap={UCAP}")

    cur = jax.jit(lambda h, l: dedup.unique_pairs(h, l, UCAP))
    fA = jax.jit(lambda h, l: unique_A(h, l, UCAP))
    fB = jax.jit(lambda h, l: unique_B(h, l, UCAP))
    fC = jax.jit(lambda h, l: unique_C(h, l, UCAP))

    # correctness vs current (set semantics: same unique ID SET, inverse
    # maps each input to a slot holding its own id)
    ref = jax.device_get(cur(hi, lo))
    for name, f in [("A", fA), ("B", fB), ("C", fC)]:
        out = jax.device_get(f(hi, lo))
        assert int(out.count) == int(ref.count), (name, out.count, ref.count)
        ids_ref = set(hashing.join_ids(ref.hi[ref.valid], ref.lo[ref.valid]).tolist())
        ids_out = set(hashing.join_ids(out.hi[out.valid], out.lo[out.valid]).tolist())
        assert ids_out == ids_ref, name
        back = hashing.join_ids(out.hi[out.inverse], out.lo[out.inverse])
        orig = hashing.join_ids(hi_np, lo_np)
        assert (back == orig).all(), name
        print(f"variant {name}: correct (U={int(out.count)})")

    timeit(cur, (hi, lo), "current (r3)")
    timeit(fA, (hi, lo), "A: 3-operand sort#1")
    timeit(fB, (hi, lo), "B: searchsorted compaction")
    timeit(fC, (hi, lo), "C: A+B")


if __name__ == "__main__":
    main()
