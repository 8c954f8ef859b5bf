"""Elastic sharded checkpoints (SURVEY.md C19, §3.5; BASELINE config 5).

The reference class checkpoints its native KV tables by streaming (key, value,
optimizer-slot) tuples per shard (README.md:2 "distributed ... systems"); this
build streams each shard's LIVE rows to one `.npz` of flat arrays plus a
JSON manifest, then restores by REHASHING every key to its new owner — so a
checkpoint written with N shards loads onto M devices (elastic reshard).

Layout of a checkpoint directory:

  manifest.json       {"format", "num_shards", "dim", "capacity", "step",
                       "value_dtype", "optimizer", "counts", "counters",
                       "dir", "extras"}
  step-N[.k]/         one GENERATION directory per save; the manifest's "dir"
    shard-00000.npz   ids i64[n], values f32[n,dim], freq i32[n], last i32[n],
                      accum f32[n] (rowwise slot), full0.. f32[n,dim] (fulldim
                      slots: adagrad accumulator / adam moments)
    shard-*.counters.npy  per-shard lifetime device counters; the manifest
                      carries their global sum and restore re-seats it (on
                      shard 0, other shards zeroed) so hit/miss/evict/spill
                      history survives save -> elastic restore
    dense-*.npz       optional dense pytrees (tower params, optimizer state)

Every save writes into a FRESH generation directory and commits by writing
the manifest (atomic rename) last — a crash mid-save leaves the previous
manifest pointing at its own untouched generation (ADVICE r1: in-place
shard overwrites corrupted the prior checkpoint during periodic saves).
Stale generations are pruned by the coordinator after commit.

Restore is bit-stable regardless of shard count because row placement inside
a shard is a pure function of the key (table/hashing.py) and row payloads are
carried verbatim.
"""

from __future__ import annotations

import json
import os
import tempfile
from functools import partial
from typing import Iterator, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from meepoembedding_tpu.table import hashing, xla_ops
from meepoembedding_tpu.table.layout import TableShard, TableSpec, alloc_shard, live_mask

FORMAT_VERSION = 1
_RESTORE_BATCH = 1 << 16


# --- shard export ------------------------------------------------------------

def _live_slot_index(spec: TableSpec, shard: TableShard, n_live: int):
    """Padded on-device index of every live slot (stable order). One nonzero
    pass; the caller slices chunks out of it."""
    cap = spec.capacity
    e_pad = 1 << max(10, (n_live - 1).bit_length())

    @partial(jax.jit, static_argnums=(0, 1))
    def live_slots(spec, e_pad, shard):
        lm = live_mask(shard).reshape(-1)
        (idx,) = jnp.nonzero(lm, size=e_pad, fill_value=cap)
        return idx.astype(jnp.int32)

    return live_slots(spec, e_pad, shard), e_pad


def _fetch_chunk(spec: TableSpec, shard: TableShard, idx_all, e_pad: int,
                 o: int, n: int, chunk: int) -> dict:
    """Device->host fetch of live rows [o, o+n) in RAW dtypes: a bf16 table's
    values cross the device link as 2-byte rows, not widened f32 — half the
    checkpoint bytes for the dominant payload.

    The device-side gather is bounded to MEEPO_FETCH_SUB_ROWS (2^19) rows
    per dispatch regardless of the part-file chunk size: gather_values
    widens its [n, 128] window gather to f32, so a 2^22-row part would
    stage ~2 GB of temporaries per op next to a nearly full table (the
    bound is re-sized when the checkpoint cell exists, ROADMAP A10)."""
    sub = int(os.environ.get("MEEPO_FETCH_SUB_ROWS", 1 << 19))
    if n > sub:
        parts = [
            _fetch_chunk(spec, shard, idx_all, e_pad, o + s,
                         min(sub, n - s), sub)
            for s in range(0, n, sub)
        ]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    cap = spec.capacity
    slots = jax.lax.dynamic_slice(idx_all, (o,), (min(chunk, e_pad - o),))[:n]
    slots_c = jnp.clip(slots, 0, cap - 1)
    hi = xla_ops.gather_bucket_plane(shard.key_hi, slots_c)
    lo = xla_ops.gather_bucket_plane(shard.key_lo, slots_c)
    part = {
        "ids": hashing.join_ids(np.asarray(hi), np.asarray(lo)),
        "values": np.asarray(xla_ops.gather_values(spec, shard.values, slots_c)),
        "freq": np.asarray(xla_ops.gather_bucket_plane(shard.freq, slots_c)),
        "last": np.asarray(xla_ops.gather_bucket_plane(shard.last, slots_c)),
    }
    if shard.opt_rowwise:
        part["accum"] = np.asarray(
            xla_ops.gather_bucket_plane(shard.opt_rowwise[0], slots_c),
            np.float32,
        )
    for j, plane in enumerate(shard.opt_fulldim):
        part[f"full{j}"] = np.asarray(xla_ops.gather_values(spec, plane, slots_c))
    return part


def _encode_arrays(arrs: dict) -> dict:
    """npz-storable encoding: bfloat16 arrays ride as their raw uint16 bits
    under a `<name>@bf16` key (numpy's npz has no bf16 dtype)."""
    import ml_dtypes

    out = {}
    for k, a in arrs.items():
        if a.dtype == ml_dtypes.bfloat16:
            out[f"{k}@bf16"] = a.view(np.uint16)
        else:
            out[k] = np.asarray(a, np.float32) if a.dtype == np.float64 else a
    return out


def _decode_arrays(z) -> dict:
    """Inverse of _encode_arrays over a loaded npz; bf16 widens to exact f32."""
    import ml_dtypes

    out = {}
    for k in z.files:
        a = z[k]
        if k.endswith("@bf16"):
            out[k[:-5]] = a.view(ml_dtypes.bfloat16).astype(np.float32)
        else:
            out[k] = a
    return out


def export_shard_arrays(
    spec: TableSpec, shard: TableShard, chunk_buckets: int = 8192
) -> dict:
    """All live rows of one shard as host numpy arrays (the §3.5 stream).

    Compaction happens ON DEVICE: live slots are enumerated with one
    nonzero pass and their state gathered into dense arrays, so the host
    transfer carries exactly the live data in a few bulk fetches. (The
    previous formulation fetched whole bucket-plane slices and compacted on
    host — ~4x the bytes and hundreds of small transfers, which is
    prohibitive over slow device links.) Fetches are chunked so the staged
    dense rows never exceed ~0.5 GB of extra HBM. Values come back f32
    regardless of table dtype (legacy eager-export path; the streamed
    part-file path keeps raw dtypes)."""
    cap = spec.capacity
    n_live = int(jnp.sum(shard.cnt))
    parts: List[dict] = []
    if n_live:
        idx_all, e_pad = _live_slot_index(spec, shard, n_live)
        # 4M slots/chunk: ~0.5 GB of staged f32 rows at dim 32
        chunk = int(os.environ.get("MEEPO_EXPORT_CHUNK", 1 << 22))
        for o in range(0, n_live, chunk):
            n = min(chunk, n_live - o)
            part = _fetch_chunk(spec, shard, idx_all, e_pad, o, n, chunk)
            part["values"] = np.asarray(part["values"], np.float32)
            for j in range(len(shard.opt_fulldim)):
                part[f"full{j}"] = np.asarray(part[f"full{j}"], np.float32)
            parts.append(part)
    if not parts:
        return _empty_shard_arrays(spec)
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _empty_shard_arrays(spec: TableSpec) -> dict:
    out = {
        "ids": np.zeros((0,), np.int64),
        "values": np.zeros((0, spec.dim), np.float32),
        "freq": np.zeros((0,), np.int32),
        "last": np.zeros((0,), np.int32),
    }
    if spec.optimizer.num_rowwise_slots():
        out["accum"] = np.zeros((0,), np.float32)
    for j in range(spec.optimizer.num_fulldim_slots()):
        out[f"full{j}"] = np.zeros((0, spec.dim), np.float32)
    return out


def _part_name(i: int, p: int) -> str:
    return f"shard-{i:05d}.part{p:04d}.npz"


def _counters_name(i: int) -> str:
    # sidecar, deliberately NOT matching _shard_files' part glob: lifetime
    # device counters travel with the checkpoint (soak finding, r5: restore
    # previously reset them and counted its own re-inserts as history)
    return f"shard-{i:05d}.counters.npy"


def _write_counters_sidecar(gdir: str, i: int, counters) -> None:
    c = np.asarray(counters)
    _atomic_write(
        os.path.join(gdir, _counters_name(i)),
        lambda f, c=c: np.save(f, c),
    )


def _read_counters(gdir: str, num_shards: int):
    """Sum of all shards' counter sidecars, or None for pre-r5 checkpoints."""
    total = None
    for i in range(num_shards):
        p = os.path.join(gdir, _counters_name(i))
        if not os.path.exists(p):
            return None
        c = np.load(p)
        total = c if total is None else total + c
    return total


def _shard_files(d: str, i: int) -> List[str]:
    """This shard's data files in row order: either the legacy single
    shard-SSSSS.npz or the streamed shard-SSSSS.partPPPP.npz sequence."""
    single = os.path.join(d, f"shard-{i:05d}.npz")
    if os.path.exists(single):
        return [single]
    parts = sorted(
        f for f in os.listdir(d)
        if f.startswith(f"shard-{i:05d}.part") and f.endswith(".npz")
    )
    return [os.path.join(d, f) for f in parts]


def save_shard_streamed(
    gdir: str,
    shard_id: int,
    spec: TableSpec,
    shard: TableShard,
    chunk_rows: int,
    compress: bool = False,
) -> int:
    """Write one shard as a sequence of independently-committed part files
    (VERDICT r2 #7: resumable full-scale saves).

    Each part covers a fixed row range of the shard's live-slot enumeration
    and lands via atomic rename, so an interrupted save leaves a prefix of
    valid parts in the (uncommitted) generation dir. Re-running the SAME save
    — same table state, same step — skips existing parts WITHOUT re-fetching
    them from the device: over a slow device link the fetch is the entire
    cost, so a crash at part k resumes at part k. The caller owns the
    unchanged-state contract; each part records the live count it was cut
    from and the resume aborts on mismatch rather than mixing states.

    Values (and a bf16 table's full-dim slots) are stored in their RAW dtype
    — a bf16 table's dominant payload is 2 bytes/lane on the wire and on
    disk. `compress=True` additionally zlib-deflates every part
    (np.savez_compressed): ids/freq/last compress well, trained values
    barely — worth it only when disk, not link, is the bound."""
    n_live = int(jnp.sum(shard.cnt))
    expected = -(-n_live // chunk_rows) if n_live else 0
    idx_all = None
    e_pad = 0
    savez = np.savez_compressed if compress else np.savez
    for p in range(expected):
        path = os.path.join(gdir, _part_name(shard_id, p))
        if os.path.exists(path):
            with np.load(path) as z:
                got = int(z["n_live"])
                # parts cut at a different chunk size cover different row
                # ranges; mixing them duplicates/drops rows silently
                # (advisor r3 medium). Parts from before this field carry
                # no chunk_rows and are conservatively rejected.
                got_chunk = int(z["chunk_rows"]) if "chunk_rows" in z.files else -1
            if got != n_live or got_chunk != chunk_rows:
                raise RuntimeError(
                    f"resume mismatch: {path} was cut from a table with "
                    f"{got} live rows at chunk_rows={got_chunk}, current "
                    f"save has {n_live} live rows at chunk_rows="
                    f"{chunk_rows}; delete the stale generation dir to "
                    f"start a fresh save"
                )
            continue
        if idx_all is None:
            idx_all, e_pad = _live_slot_index(spec, shard, n_live)
        o = p * chunk_rows
        n = min(chunk_rows, n_live - o)
        arrs = _encode_arrays(_fetch_chunk(spec, shard, idx_all, e_pad, o, n,
                                           chunk_rows))
        arrs["n_live"] = np.int64(n_live)
        arrs["chunk_rows"] = np.int64(chunk_rows)
        arrs["row_off"] = np.int64(o)
        _atomic_write(path, lambda f, arrs=arrs: savez(f, **arrs))
    if expected == 0:
        # empty shard: one empty part keeps the reader contract uniform
        path = os.path.join(gdir, _part_name(shard_id, 0))
        if not os.path.exists(path):
            arrs = _encode_arrays(_empty_shard_arrays(spec))
            arrs["n_live"] = np.int64(0)
            arrs["chunk_rows"] = np.int64(chunk_rows)
            arrs["row_off"] = np.int64(0)
            _atomic_write(path, lambda f, arrs=arrs: savez(f, **arrs))
    # drop stale higher-index parts (e.g. a prior attempt at a smaller
    # chunk size wrote more parts): _shard_files concatenates EVERY
    # part-file for this shard, so leftovers would silently append rows.
    prefix = f"shard-{shard_id:05d}.part"
    for name in os.listdir(gdir):
        if name.startswith(prefix) and name.endswith(".npz"):
            try:
                idx = int(name[len(prefix):-4])
            except ValueError:
                continue
            if idx >= max(expected, 1):
                os.unlink(os.path.join(gdir, name))
    return n_live


def _atomic_write(path: str, write_fn):
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-ckpt-")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _gen_name(path: str, step: int) -> str:
    """Deterministic fresh generation-dir name for this save. Never reuses the
    name the committed manifest references (same-step re-saves get a .k
    suffix), so the in-flight save can't clobber the live checkpoint. Pure
    function of (manifest, step): every process picks the same name."""
    base = f"step-{int(step)}"
    try:
        cur = read_manifest(path).get("dir", "")
    except (FileNotFoundError, json.JSONDecodeError):
        return base
    if cur == base:
        return base + ".1"
    if cur.startswith(base + "."):
        try:
            return f"{base}.{int(cur.rsplit('.', 1)[1]) + 1}"
        except ValueError:
            return base + ".1"
    return base


def _data_dir(path: str, manifest: dict) -> str:
    """Directory holding the manifest's shard/dense files ("" = legacy root)."""
    return os.path.join(path, manifest.get("dir", ""))


def _prune_generations(path: str, keep: str) -> None:
    """Remove stale step-* generation dirs (crashed or superseded saves)."""
    import shutil

    for name in os.listdir(path):
        if name.startswith("step-") and name != keep:
            full = os.path.join(path, name)
            if os.path.isdir(full):
                shutil.rmtree(full, ignore_errors=True)


def save(
    path: str,
    spec: TableSpec,
    shards: Sequence[TableShard],
    step: int,
    extras: Optional[dict] = None,
    dense: Optional[dict] = None,
) -> dict:
    """Write a checkpoint directory from an in-process list of shards
    (single-process convenience over `save_sharded`)."""
    return save_sharded(
        path, spec, dict(enumerate(shards)), len(shards), step,
        extras=extras, dense=dense,
    )


class AsyncCheckpointer:
    """Non-blocking checkpointing (SURVEY.md §5 "Checkpoint/resume"; the
    orbax-style async-save pattern). The caller's thread pays only the
    device->host snapshot (`export_shard_arrays`, already minimized by the
    on-device compaction); file writes and the manifest commit run on a
    background thread. At most one save is in flight: a new `save()` joins
    the previous one first, and `wait()` re-raises any background failure.

    Single-process only: the multi-process protocol's barriers must run on
    the main thread in step order (collectives may not interleave across
    threads), so `ShardedTrainer` keeps synchronous saves under
    `jax.process_count() > 1`."""

    def __init__(self):
        import threading

        self._threading = threading
        self._thread = None
        self._err = None
        self.saves = 0

    def save(self, path, spec, shards, step, extras=None, dense=None) -> None:
        self.wait()
        arrs_by_id = {
            i: dict(export_shard_arrays(spec, sh),
                    counters=np.asarray(sh.counters))
            for i, sh in enumerate(shards)
        }
        dense_np = None
        if dense is not None:
            dense_np = jax.tree_util.tree_map(np.asarray, dense)

        def work():
            try:
                save_sharded(
                    path, spec, arrs_by_id, len(arrs_by_id), step,
                    extras=extras, dense=dense_np,
                )
            except BaseException as e:  # surfaced by the next wait()/save()
                self._err = e

        self._thread = self._threading.Thread(
            target=work, name="meepo-async-ckpt", daemon=True
        )
        self._thread.start()
        self.saves += 1

    def wait(self) -> None:
        """Join the in-flight save (if any); re-raise its failure."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err


def save_sharded(
    path: str,
    spec: TableSpec,
    shards_by_id: dict,
    num_shards: int,
    step: int,
    extras: Optional[dict] = None,
    dense: Optional[dict] = None,
    is_coordinator: bool = True,
    barrier=lambda name="": None,
) -> dict:
    """Multi-process checkpoint protocol (SURVEY.md C19, §3.5): every process
    writes its own shards' files; after a barrier the coordinator writes the
    manifest — the COMMIT POINT (a crashed save never corrupts an existing
    checkpoint: all files land via rename, manifest last). `dense` pytrees
    are replicated, so only the coordinator writes them."""
    os.makedirs(path, exist_ok=True)
    gen = _gen_name(path, step)
    gdir = os.path.join(path, gen)
    os.makedirs(gdir, exist_ok=True)
    chunk_rows = int(os.environ.get("MEEPO_CKPT_CHUNK_ROWS", 1 << 22))
    compress = os.environ.get("MEEPO_CKPT_COMPRESS", "0") == "1"
    for i, shard in shards_by_id.items():
        if isinstance(shard, dict):
            # the caller already exported (AsyncCheckpointer's snapshot):
            # legacy single-file write of the in-memory arrays
            arrs = dict(shard)
            counters = arrs.pop("counters", None)
            if counters is not None:
                _write_counters_sidecar(gdir, i, counters)
            _atomic_write(
                os.path.join(gdir, f"shard-{i:05d}.npz"),
                lambda f, arrs=arrs: np.savez(f, **arrs),
            )
        else:
            # streamed part files: resumable, raw-dtype payload (bf16 tables
            # checkpoint at 2 bytes/lane), optional compression
            save_shard_streamed(gdir, i, spec, shard, chunk_rows,
                                compress=compress)
            _write_counters_sidecar(gdir, i, shard.counters)
    dense = dense or {}
    if is_coordinator:
        for name, tree in dense.items():
            leaves, _ = jax.tree_util.tree_flatten(tree)
            flat = {f"leaf{j}": np.asarray(x) for j, x in enumerate(leaves)}
            _atomic_write(
                os.path.join(gdir, f"dense-{name}.npz"),
                lambda f, flat=flat: np.savez(f, **flat),
            )
    barrier("ckpt-shards-written")
    if is_coordinator:
        counts = []
        for i in range(num_shards):
            n = 0
            for f in _shard_files(gdir, i):
                with np.load(f) as z:
                    n += int(z["ids"].shape[0])
            counts.append(n)
        manifest = {
            "format": FORMAT_VERSION,
            "num_shards": num_shards,
            "dim": spec.dim,
            "capacity_per_shard": spec.capacity,
            "step": int(step),
            "value_dtype": spec.value_dtype,
            "optimizer": {
                "kind": spec.optimizer.kind,
                "rowwise_slots": spec.optimizer.num_rowwise_slots(),
                "fulldim_slots": spec.optimizer.num_fulldim_slots(),
            },
            "counts": counts,
            "dir": gen,
            "dense": sorted(dense),
            "extras": extras or {},
        }
        saved_counters = _read_counters(gdir, num_shards)
        if saved_counters is not None:
            manifest["counters"] = [int(x) for x in saved_counters]
        _atomic_write(
            os.path.join(path, "manifest.json"),
            lambda f: f.write(json.dumps(manifest, indent=1).encode()),
        )
    barrier("ckpt-manifest-committed")
    if is_coordinator:
        _prune_generations(path, keep=gen)
    barrier("ckpt-pruned")
    if not is_coordinator:
        manifest = read_manifest(path)
    return manifest


def save_sharded2d(
    path: str,
    spec_local: TableSpec,
    global_dim: int,
    shards_by_sc: dict,
    num_shards: int,
    num_cols: int,
    step: int,
    extras: Optional[dict] = None,
    dense: Optional[dict] = None,
    is_coordinator: bool = True,
    barrier=lambda name="": None,
) -> dict:
    """Checkpoint a column-sharded (row x dim) table (parallel/colsharded.py).

    Each (row-shard s, column c) device state exports its OWN lane block to
    shard-SSSSS.colCC.npz (host memory stays one block per fetch, same as the
    1-D path); `iter_rows` merges columns into canonical full-dim rows at
    read time, so the checkpoint restores onto ANY layout — single device,
    row-sharded (restore_shards), or a different (S', C') grid. Same
    generation-dir commit protocol as save_sharded."""
    os.makedirs(path, exist_ok=True)
    gen = _gen_name(path, step)
    gdir = os.path.join(path, gen)
    os.makedirs(gdir, exist_ok=True)
    dl = spec_local.dim
    for (s, c), shard in shards_by_sc.items():
        arrs = export_shard_arrays(spec_local, shard)
        arrs["lane_offset"] = np.int32(c * dl)
        _atomic_write(
            os.path.join(gdir, f"shard-{s:05d}.col{c:02d}.npz"),
            lambda f, arrs=arrs: np.savez(f, **arrs),
        )
    dense = dense or {}
    if is_coordinator:
        for name, tree in dense.items():
            leaves, _ = jax.tree_util.tree_flatten(tree)
            flat = {f"leaf{j}": np.asarray(x) for j, x in enumerate(leaves)}
            _atomic_write(
                os.path.join(gdir, f"dense-{name}.npz"),
                lambda f, flat=flat: np.savez(f, **flat),
            )
    barrier("ckpt-shards-written")
    if is_coordinator:
        counts = []
        for i in range(num_shards):
            with np.load(os.path.join(gdir, f"shard-{i:05d}.col00.npz")) as z:
                counts.append(int(z["ids"].shape[0]))
        manifest = {
            "format": FORMAT_VERSION,
            "num_shards": num_shards,
            "col_shards": num_cols,
            "dim": int(global_dim),
            "capacity_per_shard": spec_local.capacity,
            "step": int(step),
            "value_dtype": spec_local.value_dtype,
            "optimizer": {
                "kind": spec_local.optimizer.kind,
                "rowwise_slots": spec_local.optimizer.num_rowwise_slots(),
                "fulldim_slots": spec_local.optimizer.num_fulldim_slots(),
            },
            "counts": counts,
            "dir": gen,
            "dense": sorted(dense),
            "extras": extras or {},
        }
        _atomic_write(
            os.path.join(path, "manifest.json"),
            lambda f: f.write(json.dumps(manifest, indent=1).encode()),
        )
    barrier("ckpt-manifest-committed")
    if is_coordinator:
        _prune_generations(path, keep=gen)
    barrier("ckpt-pruned")
    if not is_coordinator:
        manifest = read_manifest(path)
    return manifest


# --- restore -----------------------------------------------------------------

def read_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    assert m["format"] <= FORMAT_VERSION, f"checkpoint from a newer format: {m['format']}"
    return m


def iter_rows(path: str) -> Iterator[dict]:
    """Stream the checkpoint's shard files one at a time (bounded memory).

    Column-sharded checkpoints (save_sharded2d) store per-column lane blocks
    in shard-SSSSS.colCC.npz files; they are merged here into canonical
    full-dim rows, so every consumer (elastic restore onto any layout,
    ckpt-inspect, serve) reads one format."""
    m = read_manifest(path)
    d = _data_dir(path, m)
    C = int(m.get("col_shards", 1))
    for i in range(m["num_shards"]):
        if C <= 1:
            files = _shard_files(d, i)
            assert files, f"checkpoint {path}: no data files for shard {i}"
            for fp in files:
                with np.load(fp) as z:
                    out = _decode_arrays(z)
                for meta in ("n_live", "chunk_rows", "row_off"):
                    out.pop(meta, None)  # part-file resume metadata
                yield out
            continue
        cols = []
        for c in range(C):
            with np.load(os.path.join(d, f"shard-{i:05d}.col{c:02d}.npz")) as z:
                cols.append({k: z[k] for k in z.files})
        # column lockstep guarantees identical export order: ids must match
        for c in range(1, C):
            assert np.array_equal(cols[0]["ids"], cols[c]["ids"]), (
                f"shard {i}: column {c} export out of lockstep"
            )
        merged = {
            k: v for k, v in cols[0].items()
            if k not in ("values",) and not k.startswith("full")
        }
        merged.pop("lane_offset", None)
        order = np.argsort([int(c["lane_offset"]) for c in cols])
        merged["values"] = np.concatenate(
            [cols[int(j)]["values"] for j in order], axis=1
        )
        fulls = [k for k in cols[0] if k.startswith("full")]
        for k in fulls:
            merged[k] = np.concatenate([cols[int(j)][k] for j in order], axis=1)
        yield merged


def load_dense(path: str, name: str, template):
    """Restore a dense pytree saved under `name`, shaped like `template`."""
    leaves, treedef = jax.tree_util.tree_flatten(template)
    d = _data_dir(path, read_manifest(path))
    with np.load(os.path.join(d, f"dense-{name}.npz")) as z:
        assert len(z.files) == len(leaves), (
            f"dense '{name}': {len(z.files)} leaves in file, template has {len(leaves)}"
        )
        new = []
        for j in range(len(leaves)):
            a = z[f"leaf{j}"]
            if tuple(a.shape) != tuple(np.shape(leaves[j])):
                # a silent shape swap means the restore-side model config
                # disagrees with the training config — scores would be
                # garbage with no error downstream
                raise ValueError(
                    f"dense '{name}' leaf {j}: checkpoint shape {a.shape} != "
                    f"model config shape {np.shape(leaves[j])} — the model "
                    "geometry at restore must match the one trained"
                )
            new.append(jnp.asarray(a, leaves[j].dtype))
    return jax.tree_util.tree_unflatten(treedef, new)


@partial(jax.jit, static_argnums=(0,), donate_argnums=(1,))
def _restore_insert(spec, shard, hi, lo, rows, valid, step, freq, last, accum, fulldim):
    return xla_ops.insert_rows(
        spec, shard, hi, lo, rows, valid, step, freq=freq, accum=accum,
        fulldim=fulldim if fulldim else None, last=last,
    )


def restore_shards(
    spec: TableSpec,
    path: str,
    num_shards: int,
    batch: int = _RESTORE_BATCH,
    only_ids: Optional[set] = None,
    lane_slice: Optional[Tuple[int, int]] = None,
) -> Tuple[List[Optional[TableShard]], dict]:
    """Rebuild `num_shards` fresh shards from a checkpoint written with ANY
    shard count (elastic reshard, §3.5): every saved key is rehashed to its
    new owner and bulk-inserted. `only_ids` restricts materialization to this
    process's shards (multi-process restore) — others stay None.
    `lane_slice=(off, d)` restores only lanes [off, off+d) of each saved row
    into a dim-d local spec (one COLUMN of a 2-D layout; full-dim optimizer
    slots are sliced the same way, rowwise slots are lane-independent).
    Returns (shards, manifest)."""
    m = read_manifest(path)
    if lane_slice is None:
        assert m["dim"] == spec.dim, f"dim mismatch: ckpt {m['dim']} vs spec {spec.dim}"
    else:
        off, dl = lane_slice
        assert dl == spec.dim and off + dl <= m["dim"], (lane_slice, m["dim"], spec.dim)
    assert m["optimizer"]["kind"] == spec.optimizer.kind, (
        f"optimizer mismatch: ckpt {m['optimizer']['kind']} vs {spec.optimizer.kind}"
    )
    if m.get("counts"):
        # right-size the insert batch: tiny checkpoints shouldn't pay a
        # 64K-padded compile+insert (dominant restore cost for small tables)
        total = max(1, sum(m["counts"]))
        b = 1024
        while b < min(batch, total):
            b *= 2
        batch = min(batch, b)
    wanted = set(range(num_shards)) if only_ids is None else set(only_ids)
    shards: List[Optional[TableShard]] = [
        alloc_shard(spec) if i in wanted else None for i in range(num_shards)
    ]
    n_full = spec.optimizer.num_fulldim_slots()
    step = m["step"]

    for data in iter_rows(path):
        ids = data["ids"]
        if ids.shape[0] == 0:
            continue
        hi_np, lo_np = hashing.split_ids(ids)
        owner = np.asarray(hashing.owner_of(jnp.asarray(hi_np), jnp.asarray(lo_np), num_shards))
        for s in wanted:
            sel = np.nonzero(owner == s)[0]
            for o0 in range(0, len(sel), batch):
                idx = sel[o0 : o0 + batch]
                n = len(idx)
                pad = batch - n
                def pick(a, fill=0):
                    x = a[idx]
                    if pad:
                        x = np.concatenate(
                            [x, np.full((pad,) + x.shape[1:], fill, x.dtype)]
                        )
                    return jnp.asarray(x)
                hi = pick(hi_np, hashing.EMPTY_HI)
                lo = pick(lo_np, hashing.EMPTY_LO)
                valid = jnp.arange(batch) < n
                accum = pick(data["accum"]) if "accum" in data else None

                def lanes(a):
                    if lane_slice is None:
                        return a
                    off, dl = lane_slice
                    return a[:, off : off + dl]

                fulldim = tuple(pick(lanes(data[f"full{j}"])) for j in range(n_full))
                shards[s], ok = _restore_insert(
                    spec, shards[s], hi, lo, pick(lanes(data["values"])), valid,
                    jnp.int32(step), pick(data["freq"]), pick(data["last"]),
                    accum, fulldim,
                )
                lost = int(jnp.sum(valid & ~ok))
                if lost:
                    # never silently truncate a checkpoint: a restore target
                    # smaller than the saved live set is a config error
                    raise RuntimeError(
                        f"restore dropped {lost} rows on shard {s}: the "
                        f"target capacity ({spec.capacity}/shard x "
                        f"{num_shards}) cannot hold the checkpoint's "
                        f"{sum(m.get('counts', []))} live rows — raise "
                        f"table.capacity (or set table.grow_at_load so the "
                        f"trainer pre-grows on load)"
                    )
    # Lifetime counters travel with the checkpoint (r5): the restore's own
    # insert churn is NOT history, so wanted shards reset to zero and the
    # saved GLOBAL totals land on shard 0 (summing over shards — the one
    # counters read every consumer performs — then equals the saved state).
    # Pre-r5 checkpoints carry no "counters" and keep the old fresh-zeros
    # (plus churn) behavior.
    saved_c = m.get("counters")
    if saved_c is not None and lane_slice is None:
        for s in wanted:
            if shards[s] is None:
                continue
            c = jnp.zeros_like(shards[s].counters)
            if s == 0:
                vec = np.zeros((int(c.shape[0]),), np.int32)
                vals = np.asarray(saved_c, np.int64)[: len(vec)]
                vec[: len(vals)] = vals.astype(np.int32)
                c = jnp.asarray(vec)
            shards[s] = shards[s]._replace(counters=c)
    return shards, m
