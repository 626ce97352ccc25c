"""Sort-based k-mer counting and spectra — north-star kernel #1.

Replaces the reference's parcel/hash-block parallel kmerize-sort-kernel
executor (ref: src/kmers/naif_kmer/NaifKmerizer.cc `naif_kmerize`,
KernelKmerStorer; src/kmers/kmer_parcels/KmerParcelsBuilder) with one fused
device program: extract → canonicalize → multi-word sort → run-length count.
Invalid windows carry the all-ones sentinel key, which sorts last and is
excluded by masking (a canonical key is never all-ones, see kmer/bits.py).

Device shape of the hot path: counting is sort + two scans (cummax/cummin) —
no scatters, no segment ids, no gathers — so the cost is the sort itself.
Scatter-based segment ops only appear in the optional table-compaction and
quality-sum paths used by error correction.

A `CountedKmers` is a fixed-size padded table: sorted unique canonical keys
at the front, sentinel padding behind, counts aligned. Batches merge by
concat+re-sort, so huge read sets stream through in fixed-size chunks (the
reference's multi-pass parcels become streamed device batches).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from allpathslg_tpu.kmer import bits, kmerize
from allpathslg_tpu.ops import sort as ops_sort
from allpathslg_tpu.ops import segmented


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CountedKmers:
    """Padded sorted unique canonical kmer table with counts."""

    words: List[jax.Array]     # W × uint32 [M]; sentinel-padded tail
    counts: jax.Array          # int32 [M]; 0 on padding
    qsum: Optional[jax.Array]  # int32 [M]; summed min-base-qual support (or None)
    n_unique: jax.Array        # int32 scalar

    @property
    def capacity(self) -> int:
        return self.counts.shape[0]


def window_min_qual(codes, quals, K: int):
    """Min base quality per K-window (the reference's quality support for
    strong/weak kmer calls, ref: src/paths/FindErrorsCore.cc)."""
    N, L = codes.shape
    P = L - K + 1
    q = jnp.where(codes >= 4, 255, quals).astype(jnp.int32)
    wq = q[:, 0:P]
    for j in range(1, K):
        wq = jnp.minimum(wq, q[:, j : j + P])
    return wq


def count_sorted(flat_words) -> Tuple[list, jnp.ndarray, jnp.ndarray]:
    """Sort flat canonical keys; return (sorted_words, counts_at_starts,
    starts). Pure sort+scan — the fast path."""
    skeys = lax.sort(list(flat_words), num_keys=len(flat_words),
                     dimension=0, is_stable=False)
    if not isinstance(skeys, (list, tuple)):
        skeys = [skeys]
    skeys = list(skeys)
    starts = ops_sort.run_starts(skeys)
    counts = segmented.run_lengths(starts)
    real = ~bits.is_sentinel(skeys)
    counts = jnp.where(real, counts, 0)
    return skeys, counts, starts


@functools.partial(jax.jit, static_argnames=("max_freq",))
def spectrum_from_counts(counts: jnp.ndarray, max_freq: int = 255) -> jnp.ndarray:
    """Histogram of run counts: spec[f] = # distinct kmers with count f.

    Comparison-reduce histogram, not scatter-add. The bin axis is scanned
    in chunks of 32 so the intermediate stays [M, 32] even when a caller is
    not under jit (an eager [M, 256] compare OOMed at ~50M rows)."""
    c = jnp.clip(counts, 0, max_freq)
    CH = 32
    nch = (max_freq + CH - 1) // CH
    parts = []
    for i in range(nch):  # static unroll: shard_map-safe (no loop carry)
        bins = jnp.arange(1 + i * CH, 1 + (i + 1) * CH, dtype=c.dtype)
        parts.append(jnp.sum((c[:, None] == bins[None, :]).astype(jnp.int32),
                             axis=0))
    spec = jnp.concatenate(parts)[:max_freq]
    return jnp.concatenate([jnp.zeros(1, jnp.int32), spec])


@functools.partial(jax.jit, static_argnames=("K",))
def count_reads(codes: jnp.ndarray, K: int,
                quals: Optional[jnp.ndarray] = None) -> CountedKmers:
    """Canonical K-mer counts of one read batch as a compact padded table.

    If `quals` is given, also accumulates per-kmer quality support (sum of
    window-min base quals over occurrences)."""
    canon, valid = kmerize.kmer_windows(codes, K)
    flat, vmask = kmerize.flatten_kmers(canon, valid, K)
    if quals is None:
        skeys, counts, starts = count_sorted(flat)
        return compact_table(skeys, counts, starts)
    wq = window_min_qual(codes, quals, K)
    wq = jnp.where(vmask, wq.reshape(-1), 0)
    skeys, spay = ops_sort.sort_by_words(flat, [wq])
    starts = ops_sort.run_starts(skeys)
    counts = segmented.run_lengths(starts)
    real = ~bits.is_sentinel(skeys)
    counts = jnp.where(real, counts, 0)
    qsum = _sum_per_run(spay[0], starts, counts)
    return compact_table(skeys, counts, starts, qsum)


@functools.partial(jax.jit, static_argnames=("L", "K"))
def count_reads_packed(words, nmask, L: int, K: int,
                       qnib=None, qpal=None) -> CountedKmers:
    """count_reads over a 2-bit PACKED batch (dtypes/packed.pack_codes /
    pack_quals): the host->device transfer shrinks ~4x and the unpack
    fuses into this program. Ref: the reference streams feudal BaseVecs —
    2-bit on disk and in RAM — for the same reason (src/feudal/BaseVec.h)."""
    from allpathslg_tpu.dtypes import packed as pk

    codes = pk.unpack_codes(words, nmask, L)
    quals = None if qnib is None and qpal is None \
        else pk.unpack_quals(qnib, qpal, L)
    return count_reads(codes, K, quals)


def _sum_per_run(values, starts, counts):
    """Sum of `values` over each run, placed at run starts (0 elsewhere).
    One cumsum + one gather; no scatters."""
    cs = jnp.cumsum(values.astype(jnp.int64)
                    if values.dtype == jnp.int64 else values.astype(jnp.int32))
    T = values.shape[0]
    idx = jnp.arange(T, dtype=jnp.int32)
    last = jnp.clip(idx + counts - 1, 0, T - 1)
    total_to_last = cs[last]
    before = jnp.where(idx > 0, cs[jnp.maximum(idx - 1, 0)], 0)
    return jnp.where(counts > 0, total_to_last - before, 0)


def compact_table(skeys, counts, starts, qsum=None) -> CountedKmers:
    """Move unique keys to the front via a sentinel-keyed re-sort."""
    sent = jnp.uint32(0xFFFFFFFF)
    is_real = counts > 0
    keyed = [jnp.where(is_real, w, sent) for w in skeys]
    pay = [counts] + ([qsum] if qsum is not None else [])
    uwords, upay = ops_sort.sort_by_words(keyed, pay)
    n_unique = jnp.sum(is_real.astype(jnp.int32))
    return CountedKmers(words=uwords, counts=upay[0],
                        qsum=upay[1] if qsum is not None else None,
                        n_unique=n_unique)


@functools.partial(jax.jit, static_argnames=("K", "max_freq"))
def spectrum_reads(codes: jnp.ndarray, K: int, max_freq: int = 255):
    """Fast path: spectrum + n_unique without building the compact table."""
    canon, valid = kmerize.kmer_windows(codes, K)
    flat, _ = kmerize.flatten_kmers(canon, valid, K)
    _, counts, _ = count_sorted(flat)
    spec = spectrum_from_counts(counts, max_freq)
    return spec, jnp.sum((counts > 0).astype(jnp.int32))


def spectrum_reads_auto(codes: jnp.ndarray, K: int, max_freq: int = 255):
    """Spectrum + n_unique via the TUNED counting engine (tuning.py
    "count_engine"): "bucketed" routes through ops/bucket_count.py (batched
    row sorts; falls back to the flat path on slab overflow), "flat" is
    `spectrum_reads`. Host-level wrapper (the overflow check syncs once).
    """
    from allpathslg_tpu import tuning

    if tuning.get("count_engine") != "bucketed":
        return spectrum_reads(codes, K, max_freq)
    from allpathslg_tpu.ops import bucket_count

    flat = _kmer_flat_jit(codes, K)
    N, R, B, S = bucket_count.grouping_plan(int(flat[0].shape[0]))
    words = bucket_count._pad_to(list(flat), N)
    spec, nu, ok = bucket_count.spectrum_grouped(words, R, B, S, max_freq)
    if bool(ok):
        return spec, nu
    return spectrum_reads(codes, K, max_freq)


@functools.partial(jax.jit, static_argnames=("K",))
def _kmer_flat_jit(codes, K: int):
    canon, valid = kmerize.kmer_windows(codes, K)
    flat, _ = kmerize.flatten_kmers(canon, valid, K)
    return list(flat)


@jax.jit
def recount_table(words, counts, qsum=None) -> CountedKmers:
    """Re-aggregate a (possibly duplicated, unsorted) kmer table: sum counts
    on equal keys and compact."""
    pay = [counts] + ([qsum] if qsum is not None else [])
    skeys, spay = ops_sort.sort_by_words(words, pay)
    starts = ops_sort.run_starts(skeys)
    rl = segmented.run_lengths(starts)  # runs of table rows, not kmer counts
    real = ~bits.is_sentinel(skeys) & (spay[0] > 0)
    csum = jnp.where(real, _sum_per_run(spay[0], starts, rl), 0)
    qs = jnp.where(real, _sum_per_run(spay[1], starts, rl), 0) if qsum is not None else None
    return compact_table(skeys, csum, starts, qs)


@jax.jit
def merge_counted(a: CountedKmers, b: CountedKmers) -> CountedKmers:
    """Merge two counted tables (same K), summing counts on equal keys."""
    words = [jnp.concatenate([wa, wb]) for wa, wb in zip(a.words, b.words)]
    counts = jnp.concatenate([a.counts, b.counts])
    have_q = a.qsum is not None and b.qsum is not None
    qsum = jnp.concatenate([a.qsum, b.qsum]) if have_q else None
    return recount_table(words, counts, qsum)


def count_reads_streaming(codes: "np.ndarray", K: int,
                          quals: "np.ndarray" = None,
                          batch_size: int = 65536,
                          device_budget_bytes: int = 3 << 30,
                          min_count: int = 0,
                          min_qsum: int = 0,
                          spectrum_max_freq: int = None,
                          merge_group: int = 8,
                          acc_budget_bytes: int = 2 << 30):
    """Host driver for large read sets: count per fixed-size batch on device,
    re-aggregate (the reference's multi-pass parcels, ref:
    KmerParcelsBuilder / naif_kmerize hash-block passes).

    Three regimes by size:
      * fits `device_budget_bytes` of HBM → batches stay DEVICE-RESIDENT
        (no host round-trips, no per-batch sync);
      * larger → INCREMENTAL DEVICE MERGE: every `merge_group` batch tables
        are folded into a device-resident accumulator (concat + recount),
        whose capacity is re-quantized to the next power of two above its
        true unique count — bounded HBM, zero per-batch host transfers,
        O(log) distinct compiled merge shapes;
      * accumulator beyond `acc_budget_bytes` → spill it to host and finish
        with the RANGE-PARTITIONED multi-pass merge (the parcels pattern):
        key-range slices stream through bounded device recounts.

    min_count/min_qsum filter the RETURNED table in every regime (0 = keep
    all). Callers that need genome-scale strong/graph tables from huge read
    sets should pass their thresholds so the giant raw table never
    materializes in one piece.

    spectrum_max_freq: when set, also accumulate the spectrum of ALL counts
    (pre-filter) and return (CountedKmers, spectrum np.ndarray) —
    the ValidateAllPathsInputs path without retaining the raw table.
    """
    n = codes.shape[0]
    L = codes.shape[1]
    W = bits.n_words(K)
    n_batches = (n + batch_size - 1) // batch_size
    rows_per_batch = batch_size * max(L - K + 1, 1)
    n_arrays = W + 1 + (1 if quals is not None else 0)
    total_bytes = n_batches * rows_per_batch * n_arrays * 4
    if total_bytes <= device_budget_bytes:
        ck = _count_reads_device_resident(codes, K, quals, batch_size)
        if spectrum_max_freq is not None:
            spec = np.asarray(spectrum_from_counts(ck.counts,
                                                   spectrum_max_freq))
            return _filter_counted(ck, min_count, min_qsum), spec
        return _filter_counted(ck, min_count, min_qsum)

    def parts():
        from allpathslg_tpu.dtypes import packed as pk

        for s in range(0, n, batch_size):
            e = min(s + batch_size, n)
            cb = np.asarray(codes[s:e])
            qb = None if quals is None else np.asarray(quals[s:e])
            if e - s < batch_size:  # pad the tail batch to the static shape
                pad = batch_size - (e - s)
                cb = np.concatenate([cb,
                                     np.full((pad, cb.shape[1]), 4, cb.dtype)])
                if qb is not None:
                    qb = np.concatenate(
                        [qb, np.zeros((pad, qb.shape[1]), qb.dtype)])
            # 2-bit packed transfer (see count_reads_packed): link bytes,
            # not device compute, bound genome-scale streaming throughput
            w, m, Lb = pk.pack_codes(cb)
            if qb is None:
                yield count_reads_packed(jnp.asarray(w), jnp.asarray(m),
                                         Lb, K)
            else:
                qn, qp, _ = pk.pack_quals(qb)
                yield count_reads_packed(
                    jnp.asarray(w), jnp.asarray(m), Lb, K,
                    None if qn is None else jnp.asarray(qn), jnp.asarray(qp))

    return count_parts_streaming(parts(), n_arrays, min_count, min_qsum,
                                 spectrum_max_freq=spectrum_max_freq,
                                 merge_group=merge_group,
                                 acc_budget_bytes=acc_budget_bytes)


def count_parts_streaming(parts_iter, n_arrays: int,
                          min_count: int = 0, min_qsum: int = 0,
                          spectrum_max_freq: int = None,
                          merge_group: int = 8,
                          acc_budget_bytes: int = 2 << 30):
    """Fold an iterator of per-batch CountedKmers into one table (the
    incremental device-merge + host-spill machinery of
    count_reads_streaming, usable with DEVICE-RESIDENT batch sources —
    dtypes/devcache.DeviceBatches — where re-packing on host would cost
    an upload per pass)."""
    acc: Optional[CountedKmers] = None          # device-resident, quantized
    group: List[CountedKmers] = []
    spilled_parts = []                          # host fallback (huge tables)

    def fold_group():
        nonlocal acc, group, spilled_parts
        if not group:
            return
        tabs = ([acc] if acc is not None else []) + group
        group = []
        merged = _concat_recount(tabs)
        nu = int(merged.n_unique)               # one scalar sync per group
        cap = _quantize_capacity(nu)
        acc = _slice_table(merged, cap)         # compact front slice
        if cap * n_arrays * 4 > acc_budget_bytes:
            t = trim_to_host(acc)
            spilled_parts.append(
                (np.stack([np.asarray(w) for w in t.words]),
                 np.asarray(t.counts),
                 None if t.qsum is None else np.asarray(t.qsum)))
            acc = None

    for part in parts_iter:
        group.append(part)
        if len(group) >= merge_group:
            fold_group()
    fold_group()

    if spilled_parts:
        if acc is not None:
            t = trim_to_host(acc)
            spilled_parts.append(
                (np.stack([np.asarray(w) for w in t.words]),
                 np.asarray(t.counts),
                 None if t.qsum is None else np.asarray(t.qsum)))
        return _merge_host_parts(spilled_parts, min_count, min_qsum,
                                 spectrum_max_freq=spectrum_max_freq)
    if spectrum_max_freq is not None:
        spec = np.asarray(spectrum_from_counts(acc.counts, spectrum_max_freq))
        return _filter_counted(acc, min_count, min_qsum), spec
    return _filter_counted(acc, min_count, min_qsum)


def count_resident_streaming(db, K: int, use_quals: bool = True,
                             min_count: int = 0, min_qsum: int = 0,
                             spectrum_max_freq: int = None,
                             merge_group: int = 8,
                             acc_budget_bytes: int = 2 << 30):
    """count_reads_streaming over a DeviceBatches cache: zero uploads —
    every batch is already resident in HBM (dtypes/devcache)."""
    W = bits.n_words(K)
    hq = use_quals and db.qpal and db.qpal[0] is not None
    n_arrays = W + 1 + (1 if hq else 0)

    def parts():
        for i in range(db.n_batches):
            if hq:
                yield count_reads_packed(db.words[i], db.nmask[i], db.L, K,
                                         db.qnib[i], db.qpal[i])
            else:
                yield count_reads_packed(db.words[i], db.nmask[i], db.L, K)

    return count_parts_streaming(parts(), n_arrays, min_count, min_qsum,
                                 spectrum_max_freq=spectrum_max_freq,
                                 merge_group=merge_group,
                                 acc_budget_bytes=acc_budget_bytes)


def _quantize_capacity(n: int, floor: int = 1 << 20) -> int:
    """Next power of two >= n (>= floor): O(log) distinct merge shapes."""
    return max(floor, 1 << max(int(n) - 1, 1).bit_length())


class StreamingCounter:
    """Generic device-resident streaming aggregator of CountedKmers parts
    (any word width — kmer keys, (context, base) stack keys, ...).

    add() folds every `merge_group` tables into a quantized device
    accumulator (one scalar sync per fold, no per-batch host transfers);
    beyond `acc_budget_bytes` the accumulator spills to host and finish()
    completes with the range-partitioned multi-pass merge. Mirrors the
    regimes of count_reads_streaming (ref: KmerParcelsBuilder multi-pass)."""

    def __init__(self, merge_group: int = 8,
                 acc_budget_bytes: int = 2 << 30):
        self.merge_group = merge_group
        self.acc_budget = acc_budget_bytes
        self.acc: Optional[CountedKmers] = None
        self.group: List[CountedKmers] = []
        self.spilled = []

    def add(self, part: CountedKmers):
        self.group.append(part)
        if len(self.group) >= self.merge_group:
            self._fold()

    def _n_arrays(self, ck: CountedKmers) -> int:
        return len(ck.words) + 1 + (1 if ck.qsum is not None else 0)

    def _fold(self):
        if not self.group:
            return
        tabs = ([self.acc] if self.acc is not None else []) + self.group
        self.group = []
        merged = _concat_recount(tabs)
        nu = int(merged.n_unique)
        cap = _quantize_capacity(nu)
        self.acc = _slice_table(merged, cap)
        if cap * self._n_arrays(self.acc) * 4 > self.acc_budget:
            t = trim_to_host(self.acc)
            self.spilled.append(
                (np.stack([np.asarray(w) for w in t.words]),
                 np.asarray(t.counts),
                 None if t.qsum is None else np.asarray(t.qsum)))
            self.acc = None

    def finish(self, min_count: int = 0, min_qsum: int = 0) -> CountedKmers:
        self._fold()
        if self.spilled:
            if self.acc is not None:
                t = trim_to_host(self.acc)
                self.spilled.append(
                    (np.stack([np.asarray(w) for w in t.words]),
                     np.asarray(t.counts),
                     None if t.qsum is None else np.asarray(t.qsum)))
                self.acc = None
            return _merge_host_parts(self.spilled, min_count, min_qsum)
        if self.acc is None:
            raise ValueError("finish() before any add()")
        return _filter_counted(self.acc, min_count, min_qsum)


@jax.jit
def _concat_recount(tabs: List[CountedKmers]) -> CountedKmers:
    """Concatenate compact tables and re-aggregate on device."""
    W = len(tabs[0].words)
    words = [jnp.concatenate([t.words[w] for t in tabs]) for w in range(W)]
    counts = jnp.concatenate([t.counts for t in tabs])
    have_q = all(t.qsum is not None for t in tabs)
    qsum = jnp.concatenate([t.qsum for t in tabs]) if have_q else None
    return recount_table(words, counts, qsum)


def _slice_table(ck: CountedKmers, cap: int) -> CountedKmers:
    """Device slice of the compact front (cap >= n_unique required)."""
    return CountedKmers(words=[w[:cap] for w in ck.words],
                        counts=ck.counts[:cap],
                        qsum=None if ck.qsum is None else ck.qsum[:cap],
                        n_unique=ck.n_unique)


def merge_tables(tabs: List[CountedKmers]) -> CountedKmers:
    """Merge finished tables entirely on device: concat + recount +
    compact front slice. With disjoint key sets (hash-block partitions,
    ec/precorrect pass 1) this is a pure sorted merge; duplicate keys
    across tabs sum counts/qsums."""
    merged = _concat_recount(tabs)
    cap = _quantize_capacity(int(merged.n_unique))
    return _slice_table(merged, cap)


def _filter_counted(ck: CountedKmers, min_count: int, min_qsum: int
                    ) -> CountedKmers:
    if min_count <= 1 and min_qsum <= 0:
        return ck
    keep = ck.counts >= max(min_count, 1)
    if ck.qsum is not None and min_qsum > 0:
        keep = keep & (ck.qsum >= min_qsum)
    return compact_table([jnp.where(keep, w, jnp.uint32(0xFFFFFFFF))
                          for w in ck.words],
                         jnp.where(keep, ck.counts, 0), None,
                         jnp.where(keep, ck.qsum, 0)
                         if ck.qsum is not None else None)


def _merge_host_parts(parts, min_count: int, min_qsum: int,
                      rows_budget_bytes: int = 6 << 30,
                      spectrum_max_freq: int = None):
    """Merge sorted per-batch host tables via key-range partitioned device
    recounts (exact per-kmer totals: a kmer's copies share its w0 range)."""
    W = parts[0][0].shape[0]
    have_q = parts[0][2] is not None
    n_arrays = W + 1 + (1 if have_q else 0)
    total = sum(p[1].shape[0] for p in parts)
    rows_per_pass = max(rows_budget_bytes // (n_arrays * 4 * 3), 1 << 20)
    n_pass = max(1, int(np.ceil(total / rows_per_pass)))
    spec_acc = (np.zeros(spectrum_max_freq + 1, np.int64)
                if spectrum_max_freq is not None else None)

    def run_one(words_np, counts_np, qsum_np):
        T = counts_np.shape[0]
        bucket = 1 << 20
        Tq = ((T + bucket - 1) // bucket) * bucket
        if Tq != T:
            pad = Tq - T
            words_np = [np.concatenate(
                [w, np.full(pad, 0xFFFFFFFF, np.uint32)]) for w in words_np]
            counts_np = np.concatenate([counts_np,
                                        np.zeros(pad, counts_np.dtype)])
            if qsum_np is not None:
                qsum_np = np.concatenate([qsum_np,
                                          np.zeros(pad, qsum_np.dtype)])
        ck = recount_table([jnp.asarray(w) for w in words_np],
                           jnp.asarray(counts_np),
                           None if qsum_np is None else jnp.asarray(qsum_np))
        if spec_acc is not None:
            spec_acc[:] += np.asarray(
                spectrum_from_counts(ck.counts, spectrum_max_freq))
        return _filter_counted(ck, min_count, min_qsum)

    def finish(ck):
        if spec_acc is not None:
            return ck, spec_acc.astype(np.int64)
        return ck

    if n_pass == 1:
        words_np = [np.concatenate([p[0][w] for p in parts])
                    for w in range(W)]
        counts_np = np.concatenate([p[1] for p in parts])
        qsum_np = np.concatenate([p[2] for p in parts]) if have_q else None
        if len(parts) == 1 and min_count <= 1 and min_qsum <= 0:
            ck = CountedKmers(
                words=[jnp.asarray(w) for w in words_np],
                counts=jnp.asarray(counts_np),
                qsum=None if qsum_np is None else jnp.asarray(qsum_np),
                n_unique=jnp.asarray(counts_np.shape[0], jnp.int32))
            if spec_acc is not None:
                spec_acc[:] += np.asarray(
                    spectrum_from_counts(ck.counts, spectrum_max_freq))
            return finish(ck)
        return finish(run_one(words_np, counts_np, qsum_np))

    # range boundaries from a w0 sample (canonical-form skew safe)
    samp = np.concatenate([p[0][0][::997] for p in parts])
    samp.sort()
    qs = np.linspace(0, len(samp), n_pass + 1)[1:-1].astype(np.int64)
    bounds = samp[np.minimum(qs, len(samp) - 1)] if len(samp) else \
        np.zeros(0, np.uint32)
    bounds = np.unique(bounds)
    edges = [np.uint32(0)] + list(bounds) + [None]

    merged = []
    for pi in range(len(edges) - 1):
        lo, hi = edges[pi], edges[pi + 1]
        ws = [[] for _ in range(W)]
        cs, qs_ = [], []
        for p in parts:
            w0 = p[0][0]
            a = np.searchsorted(w0, lo, side="left")
            b = np.searchsorted(w0, hi, side="left") if hi is not None \
                else len(w0)
            if b <= a:
                continue
            for w in range(W):
                ws[w].append(p[0][w][a:b])
            cs.append(p[1][a:b])
            if have_q:
                qs_.append(p[2][a:b])
        if not cs:
            continue
        words_np = [np.concatenate(x) for x in ws]
        counts_np = np.concatenate(cs)
        qsum_np = np.concatenate(qs_) if have_q else None
        ck = trim_to_host(run_one(words_np, counts_np, qsum_np))
        merged.append((np.stack([np.asarray(w) for w in ck.words]),
                       np.asarray(ck.counts),
                       None if ck.qsum is None else np.asarray(ck.qsum)))
    # parts cover disjoint increasing key ranges -> concatenation is the
    # globally sorted merged table
    words = [jnp.asarray(np.concatenate([m[0][w] for m in merged]))
             for w in range(W)]
    counts = jnp.asarray(np.concatenate([m[1] for m in merged]))
    qsum = jnp.asarray(np.concatenate([m[2] for m in merged])) \
        if have_q else None
    return finish(CountedKmers(words=words, counts=counts, qsum=qsum,
                               n_unique=jnp.asarray(counts.shape[0],
                                                    jnp.int32)))


def _count_reads_device_resident(codes, K: int, quals, batch_size: int
                                 ) -> CountedKmers:
    """All per-batch padded tables stay in HBM; one concat + recount at the
    end (quantized size so recount_table compiles once per bucket)."""
    n = codes.shape[0]
    L = codes.shape[1]
    parts = []
    for s in range(0, n, batch_size):
        e = min(s + batch_size, n)
        cb = np.asarray(codes[s:e])
        qb = None if quals is None else np.asarray(quals[s:e])
        if e - s < batch_size:
            pad = batch_size - (e - s)
            cb = np.concatenate([cb, np.full((pad, L), 4, cb.dtype)])
            if qb is not None:
                qb = np.concatenate([qb, np.zeros((pad, L), qb.dtype)])
        parts.append(count_reads(jnp.asarray(cb), K,
                                 None if qb is None else jnp.asarray(qb)))
    if len(parts) == 1:
        return parts[0]
    W = len(parts[0].words)
    have_q = parts[0].qsum is not None
    T = sum(p.counts.shape[0] for p in parts)
    bucket = 1 << 20
    Tq = ((T + bucket - 1) // bucket) * bucket
    padn = Tq - T
    words = [jnp.concatenate([p.words[w] for p in parts]
                             + ([jnp.full(padn, 0xFFFFFFFF, jnp.uint32)]
                                if padn else []))
             for w in range(W)]
    counts = jnp.concatenate([p.counts for p in parts]
                             + ([jnp.zeros(padn, jnp.int32)] if padn else []))
    qsum = None
    if have_q:
        qsum = jnp.concatenate([p.qsum for p in parts]
                               + ([jnp.zeros(padn, jnp.int32)] if padn else []))
    return recount_table(words, counts, qsum)


def pad_table_quantized(ck: CountedKmers, floor: int = 1 << 20
                        ) -> CountedKmers:
    """Pad a compact table to the next power-of-two capacity (sentinel
    keys, zero counts): callers that jit over the table then compile once
    per size bucket instead of once per exact row count."""
    n = ck.counts.shape[0]
    cap = _quantize_capacity(n, floor)
    if cap == n:
        return ck
    pad = cap - n
    sent = jnp.uint32(0xFFFFFFFF)
    return CountedKmers(
        words=[jnp.concatenate([w, jnp.full(pad, sent, jnp.uint32)])
               for w in ck.words],
        counts=jnp.concatenate([ck.counts, jnp.zeros(pad, ck.counts.dtype)]),
        qsum=None if ck.qsum is None else
        jnp.concatenate([ck.qsum, jnp.zeros(pad, ck.qsum.dtype)]),
        n_unique=ck.n_unique)


def trim_to_host(ck: CountedKmers) -> CountedKmers:
    """Host-side: slice the padded table down to its true size."""
    n = int(ck.n_unique)
    return CountedKmers(words=[w[:n] for w in ck.words],
                        counts=ck.counts[:n],
                        qsum=None if ck.qsum is None else ck.qsum[:n],
                        n_unique=ck.n_unique)


def spectrum(ck: CountedKmers, max_freq: int = 255) -> jnp.ndarray:
    """Spectrum from a compact table (ref: KmerSpectra)."""
    return spectrum_from_counts(ck.counts, max_freq)
