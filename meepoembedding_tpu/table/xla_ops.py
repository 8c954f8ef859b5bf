"""Table storage ops as vectorized XLA programs (SURVEY.md C2/C3/C10, L0).

The reference class implements these as CUDA kernels (probe/insert, gather,
scatter-update over a device hash table). Here every op is a *batched,
fully vectorized* XLA program over the whole lookup batch, with no
per-thread control flow:

  probe          R unrolled rounds of linear bucket probing; one round ==
                 one row-gather of the key planes + one 128-wide compare.
  plan_insert    assigns free lanes to missed keys without collisions by
                 ranking keys per bucket (sort + segmented rank) against the
                 bucket's actual free-lane order, tracking per-bucket claims
                 across probing rounds. Hole-safe after evictions.
  gather/scatter row-granular value access: logical rows are packed
                 128//dim per storage row, gathered as whole rows and
                 packed/unpacked lane-locally.

Everything is jittable with static shapes; `jax.jit` donation of the shard
gives in-place device-memory updates (XLA aliases the donated planes).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from meepoembedding_tpu.config import LANES
from meepoembedding_tpu.table import hashing
from meepoembedding_tpu.table.layout import (
    DENIED,
    DROPS,
    ERASES,
    EVICTIONS,
    HITS,
    INSERTS,
    MISSES,
    TableShard,
    TableSpec,
    live_mask,
)


class ProbeResult(NamedTuple):
    slot: jax.Array  # i32 [n], -1 if not found
    found: jax.Array  # bool [n]


def probe_bucket(spec: TableSpec, r: int, b0) -> jax.Array:
    """Bucket visited at probing round r: XOR probing (b0 ^ r). XOR keeps the
    sequence inside the power-of-two table AND keeps rounds 2g/2g+1 within
    one aligned bucket PAIR, so the probe fetches two rounds per gather."""
    return b0 ^ jnp.int32(r)


def probe(spec: TableSpec, shard: TableShard, uh, ul, valid) -> ProbeResult:
    """Find slots for (deduped) keys: `max_probe_rounds` UNCONDITIONAL rounds
    of bucketized XOR probing. A key is found iff some round's bucket holds
    it; missing keys simply match nothing (insert also never places a key
    beyond `max_probe_rounds`, so non-membership is decided without any
    chain-termination bookkeeping).

    Shaped deliberately:
    - NO dynamic control flow: every round runs (ROADMAP C5 re-prices a
      lax.cond against an unconditional round on the GPU).
    - ONE [n, 512] gather per TWO rounds: both key planes of bucket pair
      {2p, 2p+1} ride a single 2 KiB row (XOR probing keeps rounds 2g/2g+1
      in one pair), halving gather ops and doubling DMA row width."""
    nb = spec.num_buckets
    b0 = hashing.bucket_of(uh, ul, nb)
    n = uh.shape[0]
    rounds = min(spec.max_probe_rounds, nb)

    slot = jnp.full((n,), -1, jnp.int32)
    found = jnp.zeros((n,), bool)
    # Gather geometry: one [n,512] gather of a concat'd [hi|lo] pair plane
    # instead of two [n,256] gathers of the separate planes (fewer, wider
    # rows). The concat materializes 2x the key bytes each step, so for very
    # large tables (where that transient threatens device-memory headroom)
    # the two-gather form is used instead.
    concat_ok = shard.key_hi.size * 8 <= (512 << 20)
    if nb >= 2:
        hi_pair = shard.key_hi.reshape(nb // 2, 2 * LANES)
        lo_pair = shard.key_lo.reshape(nb // 2, 2 * LANES)
        if concat_ok:
            keys_pair = jnp.concatenate([hi_pair, lo_pair], axis=1)
        p0 = b0 >> 1
        for g in range((rounds + 1) // 2):
            # probing one extra round when `rounds` is odd is harmless: no
            # key is ever stored beyond its insert rounds, so it can't match
            pg = p0 ^ g
            if concat_ok:
                row = jnp.take(keys_pair, pg, axis=0)  # [n, 512]
                row_h, row_l = row[:, : 2 * LANES], row[:, 2 * LANES :]
            else:
                row_h = jnp.take(hi_pair, pg, axis=0)  # [n, 256]
                row_l = jnp.take(lo_pair, pg, axis=0)  # [n, 256]
            m_e = (row_h[:, :LANES] == uh[:, None]) & (
                row_l[:, :LANES] == ul[:, None]
            )
            m_o = (row_h[:, LANES:] == uh[:, None]) & (
                row_l[:, LANES:] == ul[:, None]
            )
            # invalid (sentinel) ids would match empty lanes -> mask by valid
            hit_e = m_e.any(axis=1) & valid
            hit_o = m_o.any(axis=1) & valid
            lane_e = jnp.argmax(m_e, axis=1).astype(jnp.int32)
            lane_o = jnp.argmax(m_o, axis=1).astype(jnp.int32)
            slot_g = jnp.where(
                hit_e, pg * 2 * LANES + lane_e, (pg * 2 + 1) * LANES + lane_o
            )
            hit = hit_e | hit_o  # a key exists in at most one slot
            newly = hit & ~found
            slot = jnp.where(newly, slot_g, slot)
            found = found | hit
    else:
        kh, kl = shard.key_hi, shard.key_lo  # nb == 1: single bucket
        m = (kh[0][None, :] == uh[:, None]) & (kl[0][None, :] == ul[:, None])
        hit = m.any(axis=1) & valid
        slot = jnp.where(hit, jnp.argmax(m, axis=1).astype(jnp.int32), -1)
        found = hit
    return ProbeResult(slot=slot, found=found)


class InsertPlan(NamedTuple):
    slot: jax.Array  # i32 [n], -1 if dropped/not wanted
    ok: jax.Array  # bool [n]
    cnt: jax.Array  # updated [nb]
    ovf: jax.Array  # updated [nb]


def _segmented_rank(sort_key: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Given per-item integer keys, return (order, rank-within-equal-key)
    in sorted order. Stable, fully vectorized."""
    n = sort_key.shape[0]
    order = jnp.argsort(sort_key, stable=True)
    ks = jnp.take(sort_key, order)
    idx = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate([jnp.ones((1,), bool), ks[1:] != ks[:-1]])
    seg_first = jax.lax.cummax(jnp.where(is_start, idx, 0))
    rank = idx - seg_first
    return order, rank


def _plan_insert_impl(spec: TableSpec, shard: TableShard, uh, ul, want):
    """The taken path of plan_insert (some key actually needs a slot)."""
    nb = spec.num_buckets
    n = uh.shape[0]
    b0 = hashing.bucket_of(uh, ul, nb)

    def round_step(r, pending, slot, cnt, ovf, claimed):
        b = probe_bucket(spec, r, b0)  # XOR sequence, must match probe()
        sort_key = jnp.where(pending, b, nb)  # nb == "not pending" sentinel
        order, rank_sorted = _segmented_rank(sort_key)
        rank = jnp.zeros((n,), jnp.int32).at[order].set(rank_sorted)
        # Free lanes of each key's bucket: pick the (eff_rank+1)-th free lane
        # via a lane cumsum + argmax (a [n,128] lane argsort would cost every
        # step that has >= 1 miss far more).
        kh = jnp.take(shard.key_hi, b, axis=0)
        kl = jnp.take(shard.key_lo, b, axis=0)
        free = (kh == hashing.EMPTY_HI) & (kl == hashing.EMPTY_LO)  # [n,128]
        cum = jnp.cumsum(free.astype(jnp.int32), axis=1)  # [n,128]
        num_free = cum[:, -1]
        eff_rank = rank + jnp.take(claimed, b)
        islane = free & (cum == jnp.clip(eff_rank + 1, 1, LANES)[:, None])
        lane = jnp.argmax(islane, axis=1).astype(jnp.int32)
        ok = pending & (eff_rank < num_free)
        fail = pending & ~ok
        slot = jnp.where(ok, b * LANES + lane, slot)
        claimed = claimed.at[jnp.where(ok, b, nb)].add(1, mode="drop")
        cnt = cnt.at[jnp.where(ok, b, nb)].add(1, mode="drop")
        ovf = ovf.at[jnp.where(fail, b, nb)].max(1, mode="drop")
        return (fail, slot, cnt, ovf, claimed)

    state = (
        want,
        jnp.full((n,), -1, jnp.int32),
        shard.cnt,
        shard.ovf,
        jnp.zeros((nb,), jnp.int32),
    )
    for r in range(min(spec.max_probe_rounds, nb)):
        state = jax.lax.cond(
            state[0].any(),
            lambda state, r=r: round_step(jnp.int32(r), *state),
            lambda state: state,
            state,
        )
    _, slot, cnt, ovf, _ = state
    return slot, cnt, ovf


def plan_insert(spec: TableSpec, shard: TableShard, uh, ul, want) -> InsertPlan:
    """Assign a free (bucket, lane) to each wanted key. Collision-free within
    the batch: keys targeting the same bucket get distinct ranks, and ranks
    index into the bucket's deterministic free-lane order; a per-bucket
    `claimed` tally keeps later probing rounds consistent with earlier ones.

    Rounds are UNROLLED, each guarded by a lax.cond on whether anything is
    still pending (the steady-state all-hit step skips them).

    spec.insert_cap bounds ADMITTED inserts per call: pending keys are
    compacted to that static size, so the planning sorts/gathers run at the
    cap, not the batch — steady-state steps with a handful of misses stay
    cheap. Overflowing keys are deferred (slot -1, counted as drops); they
    simply retry the next time they appear."""
    n = uh.shape[0]
    C = spec.insert_cap
    if C is None or C >= n:
        slot, cnt, ovf = _plan_insert_impl(spec, shard, uh, ul, want)
        return InsertPlan(slot=slot, ok=want & (slot >= 0), cnt=cnt, ovf=ovf)

    def taken(args):
        uh, ul, want = args
        (cidx,) = jnp.nonzero(want, size=C, fill_value=n)
        sel = cidx < n
        ci = jnp.clip(cidx, 0, n - 1)
        slot_c, cnt, ovf = _plan_insert_impl(
            spec, shard, jnp.take(uh, ci), jnp.take(ul, ci), sel
        )
        slot = jnp.full((n,), -1, jnp.int32).at[
            jnp.where(sel, ci, n)
        ].set(slot_c, mode="drop")
        return slot, cnt, ovf

    slot, cnt, ovf = jax.lax.cond(
        want.any(),
        taken,
        lambda args: (jnp.full((n,), -1, jnp.int32), shard.cnt, shard.ovf),
        (uh, ul, want),
    )
    return InsertPlan(slot=slot, ok=want & (slot >= 0), cnt=cnt, ovf=ovf)


# --- value storage access (row-granular; pack/unpack is lane-local) ---------

def _window_select_mats(spec: TableSpec):
    """Constant [128, dim] matrices E_p extracting lane window p, and their
    transposes for the reverse (expand) direction. Lane-window pack/unpack as
    masked matmuls keeps everything in 128-lane space instead of a
    reshape-to-[n, pack, dim] relayout (ROADMAP C3 re-prices that choice)."""
    d, p = spec.dim, spec.pack
    eye = jnp.eye(LANES, dtype=jnp.float32)
    return [eye[:, i * d : (i + 1) * d] for i in range(p)]


def gather_values(spec: TableSpec, plane: jax.Array, slot: jax.Array) -> jax.Array:
    """[n] slots -> [n, dim] rows from a value-shaped plane. Caller masks
    invalid slots (clip-mode gather reads row 0 for them)."""
    n = slot.shape[0]
    s = jnp.clip(slot, 0)
    if spec.dim == LANES:
        return jnp.take(plane, s, axis=0).astype(plane.dtype)
    if spec.dim < LANES:
        vrow, sub = s // spec.pack, s % spec.pack
        g = jnp.take(plane, vrow, axis=0).astype(jnp.float32)  # [n, 128]
        out = jnp.zeros((n, spec.dim), jnp.float32)
        for p, ep in enumerate(_window_select_mats(spec)):
            m = (sub == p).astype(jnp.float32)[:, None]
            # HIGHEST: default matmul precision may round f32 operands (TF32
            # on GPUs), silently truncating rows; one-hot selections are
            # bit-exact under HIGHEST.
            out = out + jnp.dot(g * m, ep, preferred_element_type=jnp.float32,
                                precision=jax.lax.Precision.HIGHEST)
        return out.astype(plane.dtype)
    rps = spec.rows_per_slot
    idx = s[:, None] * rps + jnp.arange(rps, dtype=jnp.int32)[None, :]
    g = jnp.take(plane, idx.reshape(-1), axis=0)  # [n*rps, 128]
    return g.reshape(n, spec.dim)


def _expand_row_update(spec: TableSpec, slot, upd):
    """[n, dim] per-slot updates -> ([m] storage rows, [m, 128] row updates)
    with zeros outside each slot's lane window. Safe for `.add` scatters."""
    n = slot.shape[0]
    s = jnp.clip(slot, 0)
    if spec.dim == LANES:
        return s, upd
    if spec.dim < LANES:
        vrow, sub = s // spec.pack, s % spec.pack
        upd = upd.astype(jnp.float32)
        rowupd = jnp.zeros((n, LANES), jnp.float32)
        for p, ep in enumerate(_window_select_mats(spec)):
            m = (sub == p).astype(jnp.float32)[:, None]
            rowupd = rowupd + jnp.dot(upd * m, ep.T, preferred_element_type=jnp.float32,
                                      precision=jax.lax.Precision.HIGHEST)
        return vrow, rowupd
    rps = spec.rows_per_slot
    idx = s[:, None] * rps + jnp.arange(rps, dtype=jnp.int32)[None, :]
    return idx.reshape(-1), upd.reshape(n * rps, LANES)


def values_scatter_add(plane, vrow, upd) -> jax.Array:
    """plane[vrow[j]] += upd[j] for an [R, 128] values plane. Duplicate rows
    sum; vrow outside [0, R) drops the row. On a donated plane XLA updates
    the buffer in place."""
    R = plane.shape[0]
    idx = jnp.where((vrow >= 0) & (vrow < R), vrow, R)
    return plane.at[idx].add(upd.astype(plane.dtype), mode="drop")


def scatter_add_values(spec: TableSpec, plane, slot, upd, enabled) -> jax.Array:
    """plane[slot rows] += upd, row-granular (duplicate storage rows OK)."""
    vrow, rowupd = _expand_row_update(spec, slot, upd.astype(plane.dtype))
    if spec.dim <= LANES:
        vrow = jnp.where(enabled, vrow, plane.shape[0])
    else:
        en = jnp.repeat(enabled, spec.rows_per_slot)
        vrow = jnp.where(en, vrow, plane.shape[0])
    return values_scatter_add(plane, vrow, rowupd)


def scatter_set_values(spec: TableSpec, plane, slot, rows, enabled) -> jax.Array:
    """plane[slot] = rows. Row-granular read-modify-write: expand each row
    into its 128-lane window, combine slots sharing a storage row (windows
    are disjoint), merge with the gathered old rows, scatter-SET unique."""
    from meepoembedding_tpu.ops.dedup import combine_rows_by_vrow

    n = slot.shape[0]
    s = jnp.clip(slot, 0)
    if spec.dim > LANES:
        rps = spec.rows_per_slot
        idx = s[:, None] * rps + jnp.arange(rps, dtype=jnp.int32)[None, :]
        idx = jnp.where(enabled[:, None], idx, plane.shape[0]).reshape(-1)
        rr = rows.astype(plane.dtype).reshape(n * rps, LANES)
        return plane.at[idx].set(rr, mode="drop", unique_indices=True)
    vrow, rowvals = _expand_row_update(spec, slot, rows.astype(jnp.float32))
    sub = s % spec.pack
    d = spec.dim
    window = (jax.lax.broadcasted_iota(jnp.int32, (n, LANES), 1) // d) == sub[:, None]
    marks = jnp.where(window, 1.0, 0.0)
    both = jnp.concatenate([rowvals, marks], axis=1)
    ub, comb = combine_rows_by_vrow(vrow, both, enabled)
    new_vals, mask = comb[:, :LANES], comb[:, LANES:] > 0
    old = jnp.take(plane, jnp.clip(ub, 0), axis=0).astype(jnp.float32)
    merged = jnp.where(mask, new_vals, old).astype(plane.dtype)
    idx = jnp.where(ub >= 0, ub, plane.shape[0])
    return plane.at[idx].set(merged, mode="drop", unique_indices=True)


def scatter_bucket_plane(plane, slot, val, enabled):
    """plane[(slot // 128, slot %% 128)] = val for a [nb, 128] plane
    (keys/freq/last/accum), as a bucket-row read-modify-write:

      expand each (lane, val) to a one-hot 128-lane row, combine rows of the
      same bucket (slots are unique, so lanes never collide), gather the live
      bucket rows, merge, scatter-SET with unique indices.

    XLA lowers 2-D elementwise scatters to a serialized per-element loop
    (~200ns/element — the dominant cost of the naive hot path); this
    formulation is sorts/gathers/vector-selects only."""
    n = slot.shape[0]
    b, lane = slot // LANES, slot % LANES
    onehot = jax.lax.broadcasted_iota(jnp.int32, (n, LANES), 1) == lane[:, None]
    # accumulate in the plane's own dtype: int planes (keys) must stay exact
    acc_dtype = plane.dtype if jnp.issubdtype(plane.dtype, jnp.integer) else jnp.float32
    val = jnp.broadcast_to(val, (n,)).astype(acc_dtype)
    rows = jnp.where(onehot, val[:, None], jnp.zeros((), acc_dtype))
    marks = jnp.where(onehot, jnp.ones((), acc_dtype), jnp.zeros((), acc_dtype))
    both = jnp.concatenate([rows, marks], axis=1)  # combine in one pass
    from meepoembedding_tpu.ops.dedup import combine_rows_by_vrow

    ub, comb = combine_rows_by_vrow(b, both, enabled)
    new_vals, mask = comb[:, :LANES], comb[:, LANES:] > 0
    old = jnp.take(plane, jnp.clip(ub, 0), axis=0).astype(acc_dtype)
    merged = jnp.where(mask, new_vals, old).astype(plane.dtype)
    idx = jnp.where(ub >= 0, ub, plane.shape[0])
    return plane.at[idx].set(merged, mode="drop", unique_indices=True)


def scatter_add_bucket_plane(plane, slot, val, enabled):
    """plane[(slot // 128, slot %% 128)] += val via one-hot row expansion +
    a duplicate-tolerant row scatter-add. Slots are unique, so per ELEMENT
    there is at most one nonzero contribution — the add is exact."""
    n = slot.shape[0]
    b, lane = slot // LANES, slot % LANES
    onehot = jax.lax.broadcasted_iota(jnp.int32, (n, LANES), 1) == lane[:, None]
    acc_dtype = plane.dtype if jnp.issubdtype(plane.dtype, jnp.integer) else jnp.float32
    val = jnp.broadcast_to(val, (n,)).astype(acc_dtype)
    rows = jnp.where(onehot, val[:, None], jnp.zeros((), acc_dtype)).astype(plane.dtype)
    idx = jnp.where(enabled, b, plane.shape[0])
    return plane.at[idx].add(rows, mode="drop")


def gather_bucket_plane(plane, slot):
    """plane[(slot // 128, slot %% 128)] as a row gather + lane-mask reduce
    (elementwise 2-D advanced indexing hits XLA's slow scatter/gather path)."""
    b, lane = jnp.clip(slot, 0) // LANES, jnp.clip(slot, 0) % LANES
    rows = jnp.take(plane, b, axis=0)  # [n, 128]
    onehot = jax.lax.broadcasted_iota(jnp.int32, rows.shape, 1) == lane[:, None]
    return jnp.sum(jnp.where(onehot, rows, 0), axis=1)


# --- composite ops -----------------------------------------------------------

def touch(shard: TableShard, slot, enabled, step) -> TableShard:
    """Record hits: freq += 1, last = step (SURVEY.md C10 score maintenance)."""
    freq = scatter_add_bucket_plane(shard.freq, slot, 1, enabled)
    last = scatter_bucket_plane(shard.last, slot, step, enabled)
    return shard._replace(freq=freq, last=last)


def cms_admit(spec: TableSpec, cms, uh, ul, miss) -> Tuple[jax.Array, jax.Array]:
    """Count-min-sketch frequency admission (SURVEY.md C10). Returns
    (updated cms, admit mask). Threshold <= 1 admits everything."""
    thresh = spec.policy.admit_threshold
    if thresh <= 1 or cms.shape[1] == 0:
        return cms, miss
    w = cms.shape[1]
    ests = []
    for j in range(4):
        col = (hashing.hash_pair(uh, ul, hashing.SALT_CMS[j]) % jnp.uint32(w)).astype(jnp.int32)
        col_upd = jnp.where(miss, col, w)
        cms = cms.at[j, col_upd].add(1, mode="drop")
        ests.append(cms[j, jnp.clip(col, 0, w - 1)])
    est = jnp.minimum(jnp.minimum(ests[0], ests[1]), jnp.minimum(ests[2], ests[3]))
    return cms, miss & (est >= thresh)


def find_or_insert(
    spec: TableSpec, shard: TableShard, uh, ul, valid, step
) -> Tuple[TableShard, jax.Array, jax.Array]:
    """The hot-path composite (SURVEY.md §3.2): probe, admit, claim slots,
    default-init fresh rows, maintain scores/counters. Returns
    (shard', slot[n] (-1 == denied/dropped), found[n])."""
    pr = probe(spec, shard, uh, ul, valid)
    miss = valid & ~pr.found
    cms, admit = cms_admit(spec, shard.cms, uh, ul, miss)
    plan = plan_insert(spec, shard, uh, ul, admit)

    def do_insert_writes(planes):
        # Every write is an exact ADD over the zeroed free-slot state (see
        # alloc_shard invariant): keys land as `key - EMPTY` on the EMPTY
        # sentinel (int32 wraparound cancels exactly), values/accumulators
        # land on zeros. ADD scatters tolerate duplicate bucket rows, so no
        # combine pass is needed. Fresh full-dim optimizer state is zero by
        # invariant — no write at all.
        key_hi, key_lo, freq, last, values, opt_rowwise, opt_fulldim = planes
        key_hi = scatter_add_bucket_plane(key_hi, plan.slot, uh - hashing.EMPTY_HI, plan.ok)
        key_lo = scatter_add_bucket_plane(key_lo, plan.slot, ul - hashing.EMPTY_LO, plan.ok)
        freq = scatter_add_bucket_plane(freq, plan.slot, jnp.ones_like(uh), plan.ok)
        last = scatter_add_bucket_plane(last, plan.slot, jnp.full_like(uh, step), plan.ok)
        init_rows = hashing.default_rows(
            uh, ul, spec.dim, spec.initializer_scale, spec.dtype,
            lane_offset=spec.lane_offset(), kind=spec.initializer,
        )
        values = scatter_add_values(spec, values, plan.slot, init_rows, plan.ok)
        opt_rowwise = tuple(
            scatter_add_bucket_plane(
                p, plan.slot, jnp.float32(spec.optimizer.initial_accumulator), plan.ok
            )
            for p in opt_rowwise
        )
        return key_hi, key_lo, freq, last, values, opt_rowwise, opt_fulldim

    # All-hit batches (the steady serving/training state) skip the whole
    # insert-write block at runtime.
    key_hi, key_lo, freq, last, values, opt_rowwise, opt_fulldim = jax.lax.cond(
        plan.ok.any(),
        do_insert_writes,
        lambda planes: planes,
        (
            shard.key_hi,
            shard.key_lo,
            shard.freq,
            shard.last,
            shard.values,
            shard.opt_rowwise,
            shard.opt_fulldim,
        ),
    )

    n_hit = jnp.sum(pr.found).astype(jnp.int32)
    n_miss = jnp.sum(miss).astype(jnp.int32)
    n_ins = jnp.sum(plan.ok).astype(jnp.int32)
    n_drop = jnp.sum(admit & ~plan.ok).astype(jnp.int32)
    n_denied = jnp.sum(miss & ~admit).astype(jnp.int32)
    counters = (
        shard.counters.at[HITS].add(n_hit)
        .at[MISSES].add(n_miss)
        .at[INSERTS].add(n_ins)
        .at[DROPS].add(n_drop)
        .at[DENIED].add(n_denied)
    )

    shard = shard._replace(
        key_hi=key_hi,
        key_lo=key_lo,
        cnt=plan.cnt,
        ovf=plan.ovf,
        freq=freq,
        last=last,
        values=values,
        opt_rowwise=opt_rowwise,
        opt_fulldim=opt_fulldim,
        counters=counters,
        cms=cms,
    )
    slot = jnp.where(pr.found, pr.slot, plan.slot)
    if spec.policy.needs_scores:  # skip score upkeep when nothing consumes it
        shard = touch(shard, jnp.where(pr.found, pr.slot, -1), pr.found, step)
    return shard, slot, pr.found


def lookup_rows(spec: TableSpec, shard: TableShard, slot) -> jax.Array:
    """[n] slots -> [n, dim] embedding rows; denied/dropped slots -> zeros."""
    rows = gather_values(spec, shard.values, slot)
    return jnp.where((slot >= 0)[:, None], rows, 0)


class LookupCtx(NamedTuple):
    """Training-lookup context threaded from `lookup_train` to
    `optim.apply_sparse_grads_window` (SURVEY.md §3.2-3.3 fused hot path)."""

    slot: jax.Array  # i32 [U]; -1 == denied/dropped
    found: jax.Array  # bool [U] key pre-existed
    fresh: jax.Array  # bool [U] inserted this step
    g128: jax.Array  # f32 [U, 128] window-space rows (fresh -> init rows)
    sub: jax.Array  # i32 [U] window index of each slot


def lookup_train(
    spec: TableSpec, shard: TableShard, uh, ul, valid, step
) -> Tuple[TableShard, LookupCtx]:
    """Fused training lookup: probe + admission + insert planning + side-plane
    writes, WITHOUT touching the values plane. Fresh keys' rows come straight
    from the deterministic initializer; the values table receives
    init + optimizer-delta in apply_sparse_grads_window's SINGLE scatter.

    Why: one values-plane write per step. Reading values BEFORE any write
    keeps the plane single-use, so XLA can update the donated plane in
    place; and with no lax.cond around the insert block there is no
    conditional pass-through of the big plane either. Side planes
    ([nb,128]) are small, so their ADD-scatter passes are cheap."""
    with jax.named_scope("meepo.probe"):
        pr = probe(spec, shard, uh, ul, valid)
    miss = valid & ~pr.found
    with jax.named_scope("meepo.admit"):
        cms, admit = cms_admit(spec, shard.cms, uh, ul, miss)
    with jax.named_scope("meepo.plan_insert"):
        plan = plan_insert(spec, shard, uh, ul, admit)
    slot = jnp.where(pr.found, pr.slot, plan.slot)
    fresh = plan.ok

    # window rows: gather found keys' rows from the PRE-write values plane;
    # fresh keys take their initializer window (never materialized in HBM)
    with jax.named_scope("meepo.gather"):
        g128, sub = lookup_rows128(spec, shard, slot)
        init_rows = hashing.default_rows(
            uh, ul, spec.dim, spec.initializer_scale, spec.dtype,
            lane_offset=spec.lane_offset(), kind=spec.initializer,
        )
        init_win = window_place(spec, init_rows, sub)
        g128 = jnp.where(fresh[:, None], init_win.astype(g128.dtype), g128)

    # Side-plane writes (exact ADDs over zeroed free slots). The fresh-only
    # writes sit under a lax.cond that steady-state all-hit steps skip — the
    # cond carries ONLY the small planes, never the values plane.
    fresh_i = fresh.astype(jnp.int32)  # bool operands pay packed-layout costs

    def do_fresh_writes(planes):
        key_hi, key_lo, freq, last = planes
        fr = fresh_i > 0
        key_hi = scatter_add_bucket_plane(key_hi, slot, uh - hashing.EMPTY_HI, fr)
        key_lo = scatter_add_bucket_plane(key_lo, slot, ul - hashing.EMPTY_LO, fr)
        freq = scatter_add_bucket_plane(freq, slot, jnp.ones_like(uh), fr)
        last = scatter_add_bucket_plane(last, slot, jnp.full_like(uh, step), fr)
        return key_hi, key_lo, freq, last

    with jax.named_scope("meepo.side_writes"):
        key_hi, key_lo, freq, last = jax.lax.cond(
            fresh.any(),
            do_fresh_writes,
            lambda planes: planes,
            (shard.key_hi, shard.key_lo, shard.freq, shard.last),
        )
    if spec.policy.needs_scores:
        # score upkeep touches FOUND keys every step: unconditional
        touched = fresh | pr.found
        freq = scatter_add_bucket_plane(freq, slot, jnp.ones_like(uh), touched & ~fresh)
        last_old = gather_bucket_plane(last, slot)
        last = scatter_add_bucket_plane(
            last, slot, jnp.where(fresh, 0, step - last_old), touched
        )

    n_hit = jnp.sum(pr.found).astype(jnp.int32)
    n_miss = jnp.sum(miss).astype(jnp.int32)
    n_ins = jnp.sum(fresh).astype(jnp.int32)
    n_drop = jnp.sum(admit & ~fresh).astype(jnp.int32)
    n_denied = jnp.sum(miss & ~admit).astype(jnp.int32)
    counters = (
        shard.counters.at[HITS].add(n_hit)
        .at[MISSES].add(n_miss)
        .at[INSERTS].add(n_ins)
        .at[DROPS].add(n_drop)
        .at[DENIED].add(n_denied)
    )
    shard = shard._replace(
        key_hi=key_hi, key_lo=key_lo, cnt=plan.cnt, ovf=plan.ovf,
        freq=freq, last=last, counters=counters, cms=cms,
    )
    return shard, LookupCtx(slot=slot, found=pr.found, fresh=fresh, g128=g128, sub=sub)


# --- 128-lane window-space hot path (dim < 128) -------------------------------
#
# The training hot path keeps rows in their PACKED 128-lane storage form
# ("window space": a slot's dim values live at lanes [sub*dim, (sub+1)*dim))
# through lookup, gradient collection and the optimizer update; the
# [*, dim] view only materializes at U-level via window extract/place
# matmuls (ROADMAP C3 asks whether the direct [cap, dim] layout is faster).

def lookup_rows128(spec: TableSpec, shard: TableShard, slot):
    """[U] slots -> ([U, 128] masked storage rows, [U] window index)."""
    s = jnp.clip(slot, 0)
    vrow = s // spec.pack
    g = jnp.take(shard.values, vrow, axis=0)
    g = jnp.where((slot >= 0)[:, None], g, 0)
    return g, s % spec.pack


def window_extract(spec: TableSpec, g128, sub) -> jax.Array:
    """[n, 128] window-space rows + [n] window index -> [n, dim]."""
    if spec.dim == LANES:
        return g128.astype(jnp.float32)
    n = g128.shape[0]
    g = g128.astype(jnp.float32)
    out = jnp.zeros((n, spec.dim), jnp.float32)
    for p, ep in enumerate(_window_select_mats(spec)):
        m = (sub == p).astype(jnp.float32)[:, None]
        out = out + jnp.dot(g * m, ep, preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)
    return out


def window_place(spec: TableSpec, x, sub) -> jax.Array:
    """[n, dim] + [n] window index -> [n, 128] window-space rows (zeros
    outside each row's window). Adjoint of window_extract."""
    if spec.dim == LANES:
        return x.astype(jnp.float32)
    n = x.shape[0]
    x = x.astype(jnp.float32)
    out = jnp.zeros((n, LANES), jnp.float32)
    for p, ep in enumerate(_window_select_mats(spec)):
        m = (sub == p).astype(jnp.float32)[:, None]
        out = out + jnp.dot(x * m, ep.T, preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)
    return out


def rows_for_batch(spec: TableSpec, g128, sub, inverse) -> jax.Array:
    """[U, 128] window rows + [U] window index + [n] inverse -> [n, dim] rows
    in batch order. Every heavy op is U-level: window extract at U (cheap
    [U,128]x[128,dim] matmuls), then ONE narrow [n, dim] row gather instead
    of the n-level window_extract(g128[inverse], sub[inverse]).
    Differentiable: the VJP is a narrow [n,dim]->[U,dim] row scatter-add
    -> window_place."""
    rows_u = window_extract(spec, g128, sub)  # [U, dim] f32
    return jnp.take(rows_u, inverse, axis=0)


def grads_to_window(spec: TableSpec, g, sub, inverse, num_unique) -> jax.Array:
    """[n, dim] per-occurrence grads -> [U, 128] window-space per-slot grads:
    the explicit adjoint of rows_for_batch (for hand-written backward paths
    like bench.py). One duplicate-tolerant [n, dim] row scatter-add, then
    U-level window_place."""
    g = g.astype(jnp.float32)
    if spec.dim == LANES:
        return jnp.zeros((num_unique, LANES), jnp.float32).at[inverse].add(
            g, mode="drop"
        )
    g0 = jnp.zeros((num_unique, spec.dim), jnp.float32).at[inverse].add(
        g, mode="drop"
    )
    return window_place(spec, g0, sub)


def lookup_rows_expand(
    spec: TableSpec, shard: TableShard, slot, inverse
) -> jax.Array:
    """[U] slots + [n] inverse -> [n, dim] rows in batch order: window
    extract at U (matmuls scale with U, not n), then one narrow [n, dim]
    row gather."""
    if spec.dim >= LANES:
        rows = lookup_rows(spec, shard, slot)
        return rows[inverse]
    g, sub = lookup_rows128(spec, shard, slot)
    rows_u = window_extract(spec, g, sub)  # [U, dim]
    return jnp.take(rows_u, inverse, axis=0).astype(spec.dtype)


def segment_sum_grads_window(spec: TableSpec, g, sub_n, inverse, num_unique):
    """[n, dim] per-occurrence grads -> [U, 128] WINDOW-SPACE per-slot grads:
    place each grad into its row's lane window, then one duplicate-tolerant
    row scatter-add. All traffic stays at 128 lanes."""
    gw = window_place(spec, g, sub_n)  # [n, 128]
    return jnp.zeros((num_unique, LANES), jnp.float32).at[inverse].add(gw, mode="drop")


class EvictExport(NamedTuple):
    hi: jax.Array  # i32 [E]
    lo: jax.Array  # i32 [E]
    rows: jax.Array  # [E, dim]
    freq: jax.Array  # i32 [E]
    accum: jax.Array  # f32 [E] rowwise optimizer state (zeros if none)
    fulldim: Tuple[jax.Array, ...]  # each [E, dim] full-dim optimizer slots
    count: jax.Array  # i32 scalar: number of valid entries


def evict_pass(spec: TableSpec, shard: TableShard, step,
               bucket_off=None) -> Tuple[TableShard, EvictExport]:
    """Periodic eviction sweep (SURVEY.md §3.4): select cold rows by policy,
    export up to `max_evict_per_pass` of them (for the spill tier), and free
    their slots. Off the step critical path.

    With `policy.evict_scan_buckets = K` set, only buckets
    [bucket_off, bucket_off + K) are SCANNED per pass (the caller rotates
    `bucket_off` across ticks, wrapping at num_buckets) — the full-plane
    candidate scan grows with capacity, while a K-bucket window costs ~K/nb
    of it and the export/clear machinery is unchanged (global slot indices
    throughout).
    `bucket_off=None` (or K=None) scans everything."""
    pol = spec.policy
    E = pol.max_evict_per_pass
    K = pol.evict_scan_buckets
    nb = shard.key_hi.shape[0]
    if K is None or K >= nb or bucket_off is None:
        K, off = nb, jnp.int32(0)
    else:
        off = jnp.asarray(bucket_off, jnp.int32) % nb
    # Wrapped window: bucket rows [off, off+K) mod nb. A bucket-row gather
    # (instead of dynamic_slice) lets the final window WRAP instead of clamp,
    # so when K doesn't divide nb consecutive windows still tile the ring and
    # every bucket is scanned exactly once per lap of nb bucket-scans (a
    # clamped tail would double-scan buckets near nb - K). Off the step critical path, so the gather's extra cost over a
    # contiguous slice is irrelevant.
    wrows = (off + jnp.arange(K, dtype=jnp.int32)) % nb

    def win(plane):
        if K == nb:
            return plane
        return plane[wrows]

    kh, kl = win(shard.key_hi), win(shard.key_lo)
    lm = ~((kh == hashing.EMPTY_HI) & (kl == hashing.EMPTY_LO))
    cold = jnp.zeros_like(lm)
    if pol.evict_policy in ("lfu", "lfu_ttl"):
        cold = cold | (win(shard.freq) < pol.lfu_min_freq)
    if pol.evict_policy in ("ttl", "lfu_ttl"):
        cold = cold | ((step - win(shard.last)) > pol.ttl_steps)
    mask = (lm & cold).reshape(-1)  # [K*128]
    (idx,) = jnp.nonzero(mask, size=E, fill_value=K * LANES)
    sel = idx < K * LANES
    idx_c = jnp.where(sel, idx.astype(jnp.int32), 0)
    # window-local flat index -> global slot, through the wrapped bucket map
    gslot = wrows[idx_c // LANES] * LANES + idx_c % LANES
    slot = jnp.where(sel, gslot, spec.capacity)
    slot_c = jnp.where(sel, slot, 0)

    hi = gather_bucket_plane(shard.key_hi, slot_c)
    lo = gather_bucket_plane(shard.key_lo, slot_c)
    rows = gather_values(spec, shard.values, slot_c)
    freq = gather_bucket_plane(shard.freq, slot_c)
    last_g = gather_bucket_plane(shard.last, slot_c)
    if shard.opt_rowwise:
        accum = gather_bucket_plane(shard.opt_rowwise[0], slot_c)
    else:
        accum = jnp.zeros_like(freq, jnp.float32)
    fulldim = tuple(gather_values(spec, p, slot_c) for p in shard.opt_fulldim)
    count = jnp.sum(sel).astype(jnp.int32)

    # Clear freed slots by EXACT subtraction back to the free-slot zero state
    # (alloc_shard invariant): keys return to the EMPTY sentinel via int32
    # wraparound; values/optimizer planes return to exact 0 (x - x == +0).
    key_hi = scatter_add_bucket_plane(shard.key_hi, slot, hashing.EMPTY_HI - hi, sel)
    key_lo = scatter_add_bucket_plane(shard.key_lo, slot, hashing.EMPTY_LO - lo, sel)
    freq_p = scatter_add_bucket_plane(shard.freq, slot, -freq, sel)
    last_p = scatter_add_bucket_plane(shard.last, slot, -last_g, sel)
    values_p = scatter_add_values(spec, shard.values, slot, -rows, sel)
    opt_rowwise = shard.opt_rowwise
    if shard.opt_rowwise:
        opt_rowwise = (
            scatter_add_bucket_plane(shard.opt_rowwise[0], slot, -accum, sel),
        ) + shard.opt_rowwise[1:]
    opt_fulldim = tuple(
        scatter_add_values(spec, p, slot, -f, sel)
        for p, f in zip(shard.opt_fulldim, fulldim)
    )
    b = jnp.where(sel, slot // LANES, shard.cnt.shape[0])
    cnt = shard.cnt.at[b].add(-1, mode="drop")
    counters = shard.counters.at[EVICTIONS].add(count)
    shard = shard._replace(
        key_hi=key_hi, key_lo=key_lo, freq=freq_p, last=last_p, values=values_p,
        opt_rowwise=opt_rowwise, opt_fulldim=opt_fulldim, cnt=cnt, counters=counters,
    )
    export = EvictExport(
        hi=jnp.where(sel, hi, hashing.EMPTY_HI),
        lo=jnp.where(sel, lo, hashing.EMPTY_LO),
        rows=jnp.where(sel[:, None], rows, 0),
        freq=jnp.where(sel, freq, 0),
        accum=jnp.where(sel, accum, 0.0),
        fulldim=tuple(jnp.where(sel[:, None], f, 0) for f in fulldim),
        count=count,
    )
    return shard, export


def next_evict_cursor(spec: TableSpec, cursor: int) -> int:
    """Host-side rotation of the evict-scan window (policy.evict_scan_buckets):
    advance by K buckets modulo nb. evict_pass's window wraps, so successive
    windows [c, c+K) mod nb tile the bucket ring exactly — every bucket is
    scanned exactly once per lap of nb bucket-scans even when K doesn't
    divide nb."""
    K = spec.policy.evict_scan_buckets
    nb = spec.num_buckets
    if K is None or K >= nb:
        return 0
    return (cursor + K) % nb


def erase_keys(
    spec: TableSpec, shard: TableShard, uh, ul, valid
) -> Tuple[TableShard, jax.Array]:
    """Explicit key removal (the KV `erase` half of SURVEY.md C6's semantics,
    at the table level): probe the UNIQUE keys, free every found slot by the
    same exact-subtraction-to-zero the eviction sweep uses, and return the
    found mask. Absent keys are a no-op. `ovf` is untouched — probing runs
    its rounds unconditionally, so freed mid-chain slots never break lookup
    of other keys. Keys MUST be deduplicated (duplicate exact-subtracts
    would corrupt the zero-restore invariant); runtime.remove dedups."""
    pr = probe(spec, shard, uh, ul, valid)
    sel = pr.found
    slot = jnp.where(sel, pr.slot, -1)
    slot_c = jnp.where(sel, pr.slot, 0)

    hi = gather_bucket_plane(shard.key_hi, slot_c)
    lo = gather_bucket_plane(shard.key_lo, slot_c)
    rows = gather_values(spec, shard.values, slot_c)
    freq = gather_bucket_plane(shard.freq, slot_c)
    last_g = gather_bucket_plane(shard.last, slot_c)

    key_hi = scatter_add_bucket_plane(shard.key_hi, slot, hashing.EMPTY_HI - hi, sel)
    key_lo = scatter_add_bucket_plane(shard.key_lo, slot, hashing.EMPTY_LO - lo, sel)
    freq_p = scatter_add_bucket_plane(shard.freq, slot, -freq, sel)
    last_p = scatter_add_bucket_plane(shard.last, slot, -last_g, sel)
    values_p = scatter_add_values(spec, shard.values, slot, -rows, sel)
    opt_rowwise = shard.opt_rowwise
    if shard.opt_rowwise:
        accum = gather_bucket_plane(shard.opt_rowwise[0], slot_c)
        opt_rowwise = (
            scatter_add_bucket_plane(shard.opt_rowwise[0], slot, -accum, sel),
        ) + shard.opt_rowwise[1:]
    opt_fulldim = tuple(
        scatter_add_values(spec, p, slot, -gather_values(spec, p, slot_c), sel)
        for p in shard.opt_fulldim
    )
    b = jnp.where(sel, slot_c // LANES, shard.cnt.shape[0])
    cnt = shard.cnt.at[b].add(-1, mode="drop")
    count = jnp.sum(sel).astype(jnp.int32)
    counters = shard.counters.at[ERASES].add(count)
    shard = shard._replace(
        key_hi=key_hi, key_lo=key_lo, freq=freq_p, last=last_p, values=values_p,
        opt_rowwise=opt_rowwise, opt_fulldim=opt_fulldim, cnt=cnt,
        counters=counters,
    )
    return shard, sel


def check_invariants(spec: TableSpec, shard: TableShard) -> dict:
    """Debug-mode on-device invariant scan (SURVEY.md §5 race/sanitizer
    mechanism): returns violation counts, all zero on a healthy shard.

      cnt_mismatch      per-bucket live-row count != shard.cnt
      bad_placement     a live key stored outside its XOR probe window
      dup_keys          the same (hi, lo) key in more than one slot
      free_values_resid nonzero values lanes under free slots (the ADD-form
                        write invariant every hot-path scatter relies on)
      load_overflow     cnt > 128 anywhere

    One jitted pass over the shard; meant for tests and --debug ticks, not
    the hot path."""
    nb = spec.num_buckets
    lm = live_mask(shard)  # [nb, 128]
    cnt_mismatch = jnp.sum(
        jnp.abs(lm.sum(axis=1).astype(jnp.int32) - shard.cnt)
    ).astype(jnp.int32)
    b0 = hashing.bucket_of(shard.key_hi, shard.key_lo, nb)  # [nb,128]
    here = jax.lax.broadcasted_iota(jnp.int32, (nb, LANES), 0)
    r = b0 ^ here  # XOR probe round that would reach this bucket
    bad_placement = jnp.sum(
        lm & (r >= min(spec.max_probe_rounds, nb))
    ).astype(jnp.int32)
    # duplicate keys: sort all capacity slots' (hi, lo), count equal live
    # neighbors (O(cap log cap) — debug only)
    kh = jnp.where(lm, shard.key_hi, hashing.EMPTY_HI).reshape(-1)
    kl = jnp.where(lm, shard.key_lo, hashing.EMPTY_LO).reshape(-1)
    bh = kh.astype(jnp.uint32) ^ jnp.uint32(0x80000000)
    bl = kl.astype(jnp.uint32) ^ jnp.uint32(0x80000000)
    sh, sl = jax.lax.sort((bh, bl), num_keys=2)
    eq = (sh[1:] == sh[:-1]) & (sl[1:] == sl[:-1])
    live_sorted = ~(
        (sh == (jnp.uint32(hashing.EMPTY_HI) ^ jnp.uint32(0x80000000)))
        & (sl == (jnp.uint32(hashing.EMPTY_LO) ^ jnp.uint32(0x80000000)))
    )
    dup_keys = jnp.sum(eq & live_sorted[1:]).astype(jnp.int32)
    # free-slot zero residue in the values plane
    if spec.dim <= LANES:
        slot_live = lm.reshape(-1)  # [cap]
        vrow_live = slot_live.reshape(-1, spec.pack)  # [vrows, pack]
        d = spec.dim
        win = jax.lax.broadcasted_iota(jnp.int32, (1, LANES), 1) // d  # window idx
        lane_live = jnp.take_along_axis(
            vrow_live, jnp.broadcast_to(win, (vrow_live.shape[0], LANES)), axis=1
        )
        resid = jnp.sum(
            jnp.where(lane_live, 0.0, jnp.abs(shard.values.astype(jnp.float32)))
        )
    else:
        rps = spec.rows_per_slot
        row_live = jnp.repeat(lm.reshape(-1), rps)[:, None]
        resid = jnp.sum(
            jnp.where(row_live, 0.0, jnp.abs(shard.values.astype(jnp.float32)))
        )
    free_values_resid = (resid > 0).astype(jnp.int32)
    load_overflow = jnp.sum(shard.cnt > LANES).astype(jnp.int32)
    return {
        "cnt_mismatch": cnt_mismatch,
        "bad_placement": bad_placement,
        "dup_keys": dup_keys,
        "free_values_resid": free_values_resid,
        "load_overflow": load_overflow,
    }


def insert_rows(
    spec: TableSpec, shard: TableShard, hi, lo, rows, valid, step, freq=None,
    accum=None, fulldim=None, last=None,
) -> Tuple[TableShard, jax.Array]:
    """Bulk insert/overwrite of explicit rows (restore, promotion from spill
    tiers, `table.assign`). Existing keys are overwritten in place; optimizer
    state is set from `accum`/`fulldim` when given, else reset to fresh-row
    defaults (never left stale). `last` carries a saved last-touched clock
    (restore), defaulting to `step`. Returns (shard', ok mask)."""
    pr = probe(spec, shard, hi, lo, valid)
    plan = plan_insert(spec, shard, hi, lo, valid & ~pr.found)
    slot = jnp.where(pr.found, pr.slot, plan.slot)
    ok = valid & (slot >= 0)

    key_hi = scatter_bucket_plane(shard.key_hi, slot, hi, ok & ~pr.found)
    key_lo = scatter_bucket_plane(shard.key_lo, slot, lo, ok & ~pr.found)
    values = scatter_set_values(spec, shard.values, slot, rows, ok)
    f = freq if freq is not None else jnp.ones_like(hi)
    freq_p = scatter_bucket_plane(shard.freq, slot, f, ok)
    l = last if last is not None else jnp.full_like(hi, step)
    last_p = scatter_bucket_plane(shard.last, slot, l, ok)
    opt_rowwise = shard.opt_rowwise
    if shard.opt_rowwise:
        a = accum if accum is not None else jnp.full_like(
            hi, spec.optimizer.initial_accumulator, jnp.float32
        )
        opt_rowwise = (
            scatter_bucket_plane(shard.opt_rowwise[0], slot, a, ok),
        ) + shard.opt_rowwise[1:]
    opt_fulldim = shard.opt_fulldim
    if shard.opt_fulldim:
        fd = fulldim if fulldim is not None else tuple(
            jnp.zeros_like(rows, p.dtype) for p in shard.opt_fulldim
        )
        opt_fulldim = tuple(
            scatter_set_values(spec, p, slot, r, ok)
            for p, r in zip(shard.opt_fulldim, fd)
        )
    counters = shard.counters.at[INSERTS].add(jnp.sum(ok & ~pr.found).astype(jnp.int32))
    return (
        shard._replace(
            key_hi=key_hi,
            key_lo=key_lo,
            cnt=plan.cnt,
            ovf=plan.ovf,
            values=values,
            freq=freq_p,
            last=last_p,
            opt_rowwise=opt_rowwise,
            opt_fulldim=opt_fulldim,
            counters=counters,
        ),
        ok,
    )
