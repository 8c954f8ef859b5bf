import jax
import jax.numpy as jnp
import numpy as np

from meepoembedding_tpu.ops import dedup
from meepoembedding_tpu.table import hashing


def _run(ids64, size):
    hi, lo = hashing.split_ids(np.asarray(ids64, np.int64))
    return jax.jit(dedup.unique_pairs, static_argnums=(2,))(
        jnp.asarray(hi), jnp.asarray(lo), size
    )


def test_unique_basic():
    ids = [5, 3, 5, 9, 3, 3]
    u = _run(ids, size=6)
    assert int(u.count) == 3
    got = hashing.join_ids(np.asarray(u.hi), np.asarray(u.lo))
    assert set(got[np.asarray(u.valid)]) == {3, 5, 9}
    # inverse reconstructs input
    recon = got[np.asarray(u.inverse)]
    np.testing.assert_array_equal(recon, ids)


def test_unique_with_invalid_pad():
    ids = [7, hashing.EMPTY_ID, 7, hashing.EMPTY_ID]
    u = _run(ids, size=4)
    assert int(u.count) == 1
    valid = np.asarray(u.valid)
    got = hashing.join_ids(np.asarray(u.hi), np.asarray(u.lo))
    # pad entries map to a unique whose valid flag is False
    inv = np.asarray(u.inverse)
    assert valid[inv[0]] and not valid[inv[1]]
    assert got[inv[0]] == 7


def test_unique_large_random(rng):
    ids = rng.integers(-(2**62), 2**62, size=512, dtype=np.int64)
    ids = rng.choice(ids[:100], size=512)  # force duplicates
    u = _run(ids, size=512)
    expect = np.unique(ids)
    assert int(u.count) == len(expect)
    got = hashing.join_ids(np.asarray(u.hi), np.asarray(u.lo))
    recon = got[np.asarray(u.inverse)]
    np.testing.assert_array_equal(recon, ids)


def test_segment_sum_matches_dense():
    inv = jnp.asarray(np.array([0, 1, 0, 2, 2, 2]))
    g = jnp.asarray(np.arange(18, dtype=np.float32).reshape(6, 3))
    out = dedup.segment_sum_grads(g, inv, 4)
    expect = np.zeros((4, 3), np.float32)
    for i, j in enumerate([0, 1, 0, 2, 2, 2]):
        expect[j] += np.arange(18).reshape(6, 3)[i]
    np.testing.assert_allclose(np.asarray(out), expect)


def test_disjoint_combine_negative_zero_exact():
    """-0.0 contributors (x * 0.0 masking) are bitwise 0x80000000 and must
    NOT pollute another contributor's sign byte in the disjoint byte-plane
    combine (r2 regression: a masked-row -0.0 flipped co-row signs)."""
    import jax.numpy as jnp

    from meepoembedding_tpu.ops.dedup import sorted_run_sums

    ks = jnp.asarray(np.array([5, 5, 9], np.int32))
    vs = np.zeros((3, 4), np.float32)
    vs[0, 0] = -0.75  # row A owns column 0
    vs[1, 0] = -0.0  # row B's masked-out lane: negative zero
    vs[1, 1] = 2.5  # row B owns column 1
    vs[2, 2] = -1.0
    _, tot, _ = sorted_run_sums(ks, jnp.asarray(vs), disjoint=True)
    np.testing.assert_array_equal(
        np.asarray(tot[0]), np.array([-0.75, 2.5, 0.0, 0.0], np.float32)
    )
    np.testing.assert_array_equal(
        np.asarray(tot[1]), np.array([0.0, 0.0, -1.0, 0.0], np.float32)
    )


def test_unique_pairs_cap_larger_than_batch():
    """size > n must pad, not break (regression: the r3 sort-compaction
    sliced ch[:size] past the batch length)."""
    import jax.numpy as jnp

    from meepoembedding_tpu.ops.dedup import unique_pairs
    from meepoembedding_tpu.table import hashing

    ids = np.array([5, 7, 5, 9], np.int64)
    hi, lo = hashing.split_ids(ids)
    u = unique_pairs(jnp.asarray(hi), jnp.asarray(lo), size=16)
    assert int(u.count) == 3
    got = sorted(hashing.join_ids(
        np.asarray(u.hi)[np.asarray(u.valid)], np.asarray(u.lo)[np.asarray(u.valid)]
    ).tolist())
    assert got == [5, 7, 9]
    back = hashing.join_ids(
        np.asarray(u.hi)[np.asarray(u.inverse)],
        np.asarray(u.lo)[np.asarray(u.inverse)],
    )
    np.testing.assert_array_equal(back, ids)


def test_unique_pairs_owner_major(rng):
    """owner_major=S: same unique SET and inverse semantics as the standard
    sort, but uniques grouped by owner shard ascending (invalids last) and
    key-sorted within each owner group (VERDICT r4 next-#8)."""
    import jax.numpy as jnp

    from meepoembedding_tpu.ops.dedup import unique_pairs
    from meepoembedding_tpu.table import hashing

    S = 8
    ids = rng.integers(1, 5000, size=512).astype(np.int64)
    ids[500:] = hashing.EMPTY_ID  # pad tail
    hi, lo = hashing.split_ids(ids)
    hi, lo = jnp.asarray(hi), jnp.asarray(lo)
    u0 = unique_pairs(hi, lo, 512)
    u1 = unique_pairs(hi, lo, 512, owner_major=S)
    assert int(u0.count) == int(u1.count)
    k0 = set(np.asarray(u0.hi)[np.asarray(u0.valid)].tolist())
    k1 = set(np.asarray(u1.hi)[np.asarray(u1.valid)].tolist())
    # same unique set (hi alone may collide; compare joined ids)
    j0 = hashing.join_ids(np.asarray(u0.hi), np.asarray(u0.lo))[np.asarray(u0.valid)]
    j1 = hashing.join_ids(np.asarray(u1.hi), np.asarray(u1.lo))[np.asarray(u1.valid)]
    assert set(j0.tolist()) == set(j1.tolist())
    # inverse maps every input id to ITS unique slot
    for u in (u0, u1):
        uh, ul, inv = np.asarray(u.hi), np.asarray(u.lo), np.asarray(u.inverse)
        np.testing.assert_array_equal(uh[inv], np.asarray(hi))
        np.testing.assert_array_equal(ul[inv], np.asarray(lo))
    # owner-major ordering: valid uniques non-decreasing in owner; invalid last
    own = np.asarray(hashing.owner_of(u1.hi, u1.lo, S))
    v = np.asarray(u1.valid)
    ow_v = own[v]
    assert (np.diff(ow_v) >= 0).all()
    assert not v[int(u1.count):].any()
    # within each owner group, key-sorted ascending (uint64 order on join)
    j = hashing.join_ids(np.asarray(u1.hi), np.asarray(u1.lo))[v]
    for s in range(S):
        seg = j[ow_v == s]
        assert (np.diff(seg.astype(np.uint64).view(np.int64)) > 0).all() or len(seg) <= 1


def test_combine_rows_by_vrow_disjoint_exact(rng):
    """The float combine is bit-exact for lane-disjoint contributions (the
    byte-plane integer path), regardless of batch-global magnitudes."""
    from meepoembedding_tpu.ops.dedup import combine_rows_by_vrow

    n, pack = 64, 4
    vrow = rng.integers(0, 8, size=n).astype(np.int32)
    sub = rng.integers(0, pack, size=n)
    # give each (vrow, sub) pair at most one contributor -> lane-disjoint runs
    seen = set()
    enabled = np.zeros(n, bool)
    for i in range(n):
        if (int(vrow[i]), int(sub[i])) not in seen:
            seen.add((int(vrow[i]), int(sub[i])))
            enabled[i] = True
    rows = np.zeros((n, 128), np.float32)
    d = 128 // pack
    vals = (rng.normal(size=(n, d)) * 1e4).astype(np.float32)  # large magnitudes
    for i in range(n):
        rows[i, sub[i] * d : (sub[i] + 1) * d] = vals[i]
    uv, comb = jax.jit(combine_rows_by_vrow)(
        jnp.asarray(vrow), jnp.asarray(rows), jnp.asarray(enabled)
    )
    uv, comb = np.asarray(uv), np.asarray(comb)
    expect: dict = {}
    for i in range(n):
        if enabled[i]:
            expect.setdefault(int(vrow[i]), np.zeros(128, np.float32))
            expect[int(vrow[i])] += rows[i]
    got = {int(v): comb[j] for j, v in enumerate(uv) if v >= 0}
    assert set(got) == set(expect)
    for k in expect:
        np.testing.assert_array_equal(got[k], expect[k])  # BIT-exact
