"""Batch ID deduplication with inverse index (SURVEY.md C5).

The reference class dedups ids on GPU before the table lookup and uses the
inverse index to segment-sum gradients (BASELINE.json north-star: "all-to-all
ID exchange and dedup before lookup"). Ids are (hi, lo) int32 pairs (JAX
runs without x64 by default), so uniqueness is computed by lexicographic
sort + neighbor compare — one fused XLA sort, static output size `size`
(jit-friendly).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from meepoembedding_tpu.table import hashing


class Unique(NamedTuple):
    hi: jax.Array  # i32 [U] unique ids (padded with the invalid sentinel)
    lo: jax.Array  # i32 [U]
    inverse: jax.Array  # i32 [n] position of each input id in (hi, lo)
    valid: jax.Array  # bool [U] slot holds a real unique id
    count: jax.Array  # i32 scalar: number of uniques


def sorted_run_sums(ks: jax.Array, vs: jax.Array, disjoint: bool = False):
    """Sum equal-key runs of an ALREADY-SORTED (ks, vs) stream without any
    scatter-add: prefix-sum + end-of-run differencing + unique-index
    compaction. Returns (key_of_rank [n], totals [n, d], live [n]) where rank
    r < num_runs holds run r's key and total.

    Everything here is sorts, cumsums and unique-index sets (ROADMAP C4
    re-prices these against direct scatters on the GPU).

    Exactness: integer runs are BIT-EXACT for any run content — int32 cumsum
    wraps mod 2^32 and the end-of-run differencing cancels the wrap, so even
    overflowing prefixes recover exact in-range totals. Plain float runs
    carry cumsum rounding ~ULP(global prefix). `disjoint=True` declares that
    within every run each column has AT MOST ONE nonzero contributor (the
    table-write case: unique slots -> disjoint lane windows); float values
    are then split bitwise into four byte planes and summed on the exact
    integer path, making float combines bit-exact too."""
    n = ks.shape[0]
    if disjoint and not jnp.issubdtype(vs.dtype, jnp.integer):
        d = vs.shape[-1]
        # canonicalize -0.0 -> +0.0: masked/window-expanded updates produce
        # negative zeros (x * 0.0 == -0.0), which are bitwise 0x80000000 and
        # would violate the one-nonzero-contributor-per-column contract by
        # adding 128 into another contributor's sign byte
        f = vs.astype(jnp.float32)
        f = jnp.where(f == 0.0, 0.0, f)
        u = jax.lax.bitcast_convert_type(f, jnp.uint32)
        planes = jnp.concatenate(
            [((u >> jnp.uint32(8 * j)) & jnp.uint32(0xFF)).astype(jnp.int32)
             for j in range(4)],
            axis=-1,
        )  # [n, 4d]; per-column run totals <= 255 (single contributor)
        key_of_rank, tot, live = sorted_run_sums(ks, planes)
        bits = jnp.zeros((n, d), jnp.uint32)
        for j in range(4):
            bits = bits | (tot[..., j * d : (j + 1) * d].astype(jnp.uint32)
                           << jnp.uint32(8 * j))
        totals = jax.lax.bitcast_convert_type(bits, jnp.float32)
        return key_of_rank, totals, live
    if not jnp.issubdtype(vs.dtype, jnp.integer):
        # float path accumulates in f32; int planes (keys!) stay exact in i32
        vs = vs.astype(jnp.float32)
    prefix = jnp.cumsum(vs, axis=0)
    is_last = jnp.concatenate([ks[1:] != ks[:-1], jnp.ones((1,), bool)])
    rank = (jnp.cumsum(is_last) - 1).astype(jnp.int32)
    num_runs = jnp.sum(is_last).astype(jnp.int32)
    at_rank = jnp.where(is_last, rank, n)
    ends = jnp.zeros_like(prefix).at[at_rank].set(prefix, mode="drop", unique_indices=True)
    key_of_rank = jnp.zeros_like(ks).at[at_rank].set(ks, mode="drop", unique_indices=True)
    prev = jnp.concatenate([jnp.zeros_like(ends[:1]), ends[:-1]], axis=0)
    totals = ends - prev
    live = jnp.arange(n, dtype=jnp.int32) < num_runs
    return key_of_rank, totals, live


# numpy, NOT jnp: a module-level jax Array constant can be hoisted as a
# leading program parameter ahead of donated buffers
_SENT = np.int32(2**31 - 1)


def combine_rows_by_vrow(vrow: jax.Array, rowupd: jax.Array, enabled: jax.Array):
    """Combine duplicate storage-row updates (slots sharing a packed row) so
    unique-index scatters are race-free. Returns (uvrow [n], combined
    [n, 128]): group g's total update at position g, disabled groups / tail
    slots marked uvrow == -1. Scatter-add-free (see sorted_run_sums).

    Callers guarantee lane-DISJOINT contributions within a group (slots are
    unique, and slots sharing a storage row own disjoint lane windows), which
    makes the float combine BIT-EXACT (byte-plane integer summation) — table
    writes carry no batch-global cumsum rounding."""
    key = jnp.where(enabled, vrow, _SENT)
    order = jnp.argsort(key)
    ks = jnp.take(key, order)
    us = jnp.take(rowupd, order, axis=0)
    gkey, combined, live = sorted_run_sums(ks, us, disjoint=True)
    return jnp.where(live & (gkey != _SENT), gkey, -1), combined


def sorted_segment_sum(values: jax.Array, seg: jax.Array, num_segments: int) -> jax.Array:
    """Scatter-add-free segment_sum: sort by segment, sum runs, one
    unique-index set into the output."""
    order = jnp.argsort(seg)
    ss = jnp.take(seg, order)
    vs = jnp.take(values, order, axis=0)
    key_of_rank, totals, live = sorted_run_sums(ss, vs)
    out = jnp.zeros((num_segments,) + totals.shape[1:], jnp.float32)
    return out.at[jnp.where(live, key_of_rank, num_segments)].set(
        totals, mode="drop", unique_indices=True
    )


def prefix_sum_i32(x: jax.Array) -> jax.Array:
    """Inclusive prefix sum of an i32 [n] stream (n a multiple of 128; pad
    otherwise) via two triangular matmuls instead of `jnp.cumsum` (ROADMAP
    C4 re-prices the choice). Rows of [n/128, 128] cumsum by matmul; row
    totals cumsum the same way at n/128; exact in f32 for totals < 2^24
    (flag streams)."""
    n = x.shape[0]
    if n % 128 or n < 128:
        pad = -(-n // 128) * 128 - n
        return prefix_sum_i32(jnp.pad(x, (0, pad)))[:n]
    tri = jnp.tril(jnp.ones((128, 128), jnp.float32))
    rows = x.reshape(-1, 128).astype(jnp.float32)
    # HIGHEST: exact f32 accumulation (default precision may round the
    # operands — TF32 on GPUs — which would corrupt prefix totals)
    within = jax.lax.dot(rows, tri.T, precision=jax.lax.Precision.HIGHEST)
    totals = within[:, -1]
    m = totals.shape[0]
    if m > 1:
        offs = prefix_sum_i32(totals.astype(jnp.int32)).astype(jnp.float32) - totals
        within = within + offs[:, None]
    return within.reshape(-1).astype(jnp.int32)


def unique_pairs(hi: jax.Array, lo: jax.Array, size: int,
                 owner_major: int = 0) -> Unique:
    """Deduplicate id pairs to static capacity `size`.

    `owner_major=S` (ragged-exchange callers) makes the PRIMARY sort key
    `hashing.owner_of(id, S)` with the id itself secondary: the unique
    output comes out already grouped by owner shard in ascending order
    (invalid ids still last), so the ragged plan's separate [U] owner
    argsort disappears — the step's one dedup sort does double duty
    (VERDICT r4 next-#8). Costs one extra sort operand; uniqueness and
    inverse semantics are unchanged (an id has one owner, so id runs stay
    contiguous inside owner groups).

    Invalid/pad ids (the reserved sentinel) sort together and come out as a
    single "unique" whose `valid` flag is False; their inverse entries point
    at it, and downstream lookups return zero rows for it.

    If the true unique count exceeds `size`, the overflow ids alias the last
    slot (counted, never out-of-bounds) — callers size `size` to the batch.

    Every O(n) step is expressed as a SORT or a matmul — no 1-D scatters,
    no `jnp.cumsum` (ROADMAP C4 re-prices these against the direct
    primitives on the GPU):
      1. one multi-operand lexicographic sort groups duplicates;
      2. group ids come from a 2-level matmul prefix sum of the run flags;
      3. the inverse permutation is a second 2-operand sort by `order`
         (instead of a unique-index 1-D scatter);
      4. the unique keys compact by a stable 3-operand flag sort: run
         starts (flag 0) float to the front IN ID ORDER, then slice [:size]
         (instead of two 1-D scatters for hi and lo)."""
    n = hi.shape[0]
    with jax.named_scope("meepo.dedup"):
        # Bias keys for unsigned comparison of two's-complement halves;
        # invalid ids sort LAST so truncation under overflow drops them first.
        inval = ~hashing.is_valid(hi, lo)
        bh = hi.astype(jnp.uint32) ^ jnp.uint32(0x80000000)
        bh = jnp.where(inval, jnp.uint32(0xFFFFFFFF), bh)
        bl = lo.astype(jnp.uint32) ^ jnp.uint32(0x80000000)
        iota = jnp.arange(n, dtype=jnp.int32)
        if owner_major:
            ow = hashing.owner_of(hi, lo, owner_major).astype(jnp.uint32)
            ow = jnp.where(inval, jnp.uint32(owner_major), ow)
            sow, sbh, sbl, order, sh, sl = jax.lax.sort(
                (ow, bh, bl, iota, hi, lo), num_keys=3, is_stable=True
            )
        else:
            sbh, sbl, order, sh, sl = jax.lax.sort(
                (bh, bl, iota, hi, lo), num_keys=2, is_stable=True
            )
        is_new = jnp.concatenate(
            [jnp.ones((1,), bool), (sbh[1:] != sbh[:-1]) | (sbl[1:] != sbl[:-1])]
        )
        gid0 = prefix_sum_i32(is_new.astype(jnp.int32)) - 1  # group id, sorted
        num_runs = gid0[-1] + 1
        gid = jnp.minimum(gid0, size - 1)  # overflow aliases the last slot
        # inverse[order[j]] = gid[j]: invert the permutation by sorting the
        # (order, gid) pairs back into input order (keys are distinct)
        _, inverse = jax.lax.sort((order, gid), num_keys=1, is_stable=False)
        # compact each run's first occurrence: stable flag sort floats run
        # starts to the front, preserving their (already sorted) id order
        tag = jnp.where(is_new, jnp.int32(0), jnp.int32(1))
        _, ch, cl = jax.lax.sort((tag, sh, sl), num_keys=1, is_stable=True)
        if size > n:  # cap can exceed the batch (e.g. caller-chosen caps)
            ch = jnp.pad(ch, (0, size - n), constant_values=hashing.EMPTY_HI)
            cl = jnp.pad(cl, (0, size - n), constant_values=hashing.EMPTY_LO)
        keep = jnp.arange(size, dtype=jnp.int32) < num_runs
        uh = jnp.where(keep, ch[:size], hashing.EMPTY_HI)
        ul = jnp.where(keep, cl[:size], hashing.EMPTY_LO)
        valid = hashing.is_valid(uh, ul)
        count = jnp.sum(valid).astype(jnp.int32)
        return Unique(hi=uh, lo=ul, inverse=inverse, valid=valid, count=count)


def segment_sum_grads(grads: jax.Array, inverse: jax.Array, num_unique: int) -> jax.Array:
    """[n, dim] per-occurrence grads -> [U, dim] per-unique-id grads
    (the backward half of dedup, SURVEY.md §3.3).

    Implemented as ONE duplicate-tolerant row scatter-add in 128-lane space
    (a sort-based segment sum would pay an argsort plus a gather)."""
    n, d = grads.shape
    dpad = -(-d // 128) * 128
    g = grads.astype(jnp.float32)
    if dpad != d:
        g = jnp.pad(g, ((0, 0), (0, dpad - d)))
    out = jnp.zeros((num_unique, dpad), jnp.float32).at[inverse].add(g, mode="drop")
    return out[:, :d]
