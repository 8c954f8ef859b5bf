"""Stateless uint32 hashing for 64-bit feature ids (SURVEY.md C1/C2).

JAX runs without 64-bit types by default, so a feature id `k` (arbitrary
int64, README.md:2 "lookuptable-style") lives on device as a pair of int32
planes (hi = k >> 32, lo = k & 0xffffffff). All hashing is uint32
arithmetic (wrapping multiply/xor/shift).

The int64 value INT64_MIN is reserved as the invalid/padding id; user ids
must never equal it (the data pipeline guarantees this by remapping).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Reserved sentinel: int64 min == (hi=-2**31, lo=0).
EMPTY_HI = np.int32(-(2**31))
EMPTY_LO = np.int32(0)
EMPTY_ID = np.int64(-(2**63))

# Distinct salts decorrelate the different hash uses.
SALT_BUCKET = np.uint32(0x2545F491)
SALT_OWNER = np.uint32(0x9E3779B9)
SALT_INIT = np.uint32(0x85EBCA6B)
SALT_CMS = (
    np.uint32(0xC2B2AE35),
    np.uint32(0x27D4EB2F),
    np.uint32(0x165667B1),
    np.uint32(0xD3A2646C),
)


def split_ids(ids64: np.ndarray):
    """Host-side: int64 ids -> (hi, lo) int32 numpy arrays."""
    ids64 = np.asarray(ids64, dtype=np.int64)
    hi = (ids64 >> np.int64(32)).astype(np.int32)
    lo = (ids64 & np.int64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return hi, lo


def join_ids(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Host-side inverse of split_ids."""
    hi = np.asarray(hi, dtype=np.int64) << np.int64(32)
    lo = np.asarray(lo, dtype=np.int32).view(np.uint32).astype(np.int64)
    return hi | lo


def fmix32(h):
    """murmur3 finalizer: full avalanche on uint32."""
    h = h.astype(jnp.uint32)
    h ^= h >> 16
    h *= jnp.uint32(0x85EBCA6B)
    h ^= h >> 13
    h *= jnp.uint32(0xC2B2AE35)
    h ^= h >> 16
    return h


def hash_pair(hi, lo, salt) -> jnp.ndarray:
    """uint32 hash of an (hi, lo) id pair under a salt. Elementwise ops only."""
    uhi = hi.astype(jnp.uint32)
    ulo = lo.astype(jnp.uint32)
    h = (ulo * jnp.uint32(0xCC9E2D51)) ^ (uhi * jnp.uint32(0x1B873593)) ^ jnp.uint32(salt)
    return fmix32(h ^ (fmix32(uhi) >> 1))


def bucket_of(hi, lo, num_buckets: int) -> jnp.ndarray:
    """Home bucket (num_buckets must be a power of two) as int32."""
    h = hash_pair(hi, lo, SALT_BUCKET)
    return (h & jnp.uint32(num_buckets - 1)).astype(jnp.int32)


def owner_of(hi, lo, num_shards: int) -> jnp.ndarray:
    """Owning shard of an id (SURVEY.md C12: owner = hash(key) % nshards)."""
    h = hash_pair(hi, lo, SALT_OWNER)
    if num_shards & (num_shards - 1) == 0:
        shift = 32 - num_shards.bit_length() + 1
        return (h >> jnp.uint32(shift)).astype(jnp.int32) if num_shards > 1 else jnp.zeros_like(h, jnp.int32)
    return (h % jnp.uint32(num_shards)).astype(jnp.int32)


def is_valid(hi, lo) -> jnp.ndarray:
    """False for the reserved invalid/pad id."""
    return ~((hi == EMPTY_HI) & (lo == EMPTY_LO))


INITIALIZERS = ("uniform", "normal", "truncated_normal", "constant")


def default_rows(
    hi, lo, dim: int, scale: float, dtype=jnp.float32, lane_offset: int = 0,
    kind: str = "uniform",
) -> jnp.ndarray:
    """Deterministic fresh-row initializer derived from the key hash alone
    (TF-table initializer parity, SURVEY.md C11). Insert-order independent,
    which makes elastic reshard/restore (SURVEY.md §3.5) bit-stable.
    scale==0 -> zeros for every kind.

      uniform           Uniform(-scale, scale)
      normal            Normal(0, scale) via inverse-CDF (erfinv)
      truncated_normal  Normal(0, scale) truncated to +-2 sigma — EXACT
                        (inverse-CDF over the truncated interval, not clip
                        or resample), still one hash stream per lane
      constant          every element == scale

    `lane_offset` shifts the per-lane hash stream: a column-sharded table
    (parallel/colsharded.py) holding lanes [off, off+dim) of a wider logical
    row reproduces EXACTLY the bits a full-width table would put there, so
    concatenating column shards is bit-identical to the unsharded init.
    """
    n = hi.shape[0]
    if scale == 0.0:
        return jnp.zeros((n, dim), dtype)
    if kind == "constant":
        return jnp.full((n, dim), scale, dtype)
    h0 = hash_pair(hi, lo, SALT_INIT)  # [n]
    # offset may be a traced scalar (column shard under shard_map)
    d = jnp.arange(dim, dtype=jnp.uint32)[None, :] + jnp.uint32(lane_offset)
    bits = fmix32(h0[:, None] + d * jnp.uint32(0x9E3779B9))
    # top 24 bits -> uniform [0, 1)
    u = (bits >> jnp.uint32(8)).astype(jnp.float32) * (1.0 / (1 << 24))
    if kind == "uniform":
        return ((u * 2.0 - 1.0) * scale).astype(dtype)
    if kind in ("normal", "truncated_normal"):
        import jax

        if kind == "truncated_normal":
            # map u into (Phi(-2), Phi(2)) then invert: exact truncation
            p_lo = 0.02275013194817921  # Phi(-2)
            uu = p_lo + u * (1.0 - 2.0 * p_lo)
        else:
            uu = jnp.clip(u, 1e-7, 1.0 - 1e-7)
        z = jnp.sqrt(jnp.float32(2.0)) * jax.scipy.special.erfinv(2.0 * uu - 1.0)
        return (z * scale).astype(dtype)
    raise ValueError(f"initializer must be one of {INITIALIZERS}, got {kind!r}")
