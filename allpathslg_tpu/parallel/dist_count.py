"""Hash-sharded distributed k-mer counting — the central multi-chip kernel.

Device replacement for the reference's single-host hash-partitioned
parcels (ref: src/kmers/kmer_parcels/KmerParcelsBuilder.cc,
src/kmers/naif_kmer/NaifKmerizer.cc multi-pass hash blocks): read batches are
data-parallel across the mesh axis; every device kmerizes its shard, routes
each canonical kmer to its owner shard ``hash(kmer) % n`` through a
fixed-capacity `all_to_all`, and owners sort+count their partition. Spectra
merge with `psum`. The owned kmer table stays resident, sharded across HBM.

Fixed-shape routing: per-destination capacity buckets padded with sentinel
keys; overflowed kmers are counted in `dropped` (capacity is sized from
expected balance + slack; hash mixing makes skew binomial, SURVEY.md §7.4).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from allpathslg_tpu.kmer import bits, kmerize
from allpathslg_tpu.kmer import count as kcount
from allpathslg_tpu.ops import sort as ops_sort
from allpathslg_tpu.ops import segmented
from allpathslg_tpu.parallel.mesh import AXIS

SENT = np.uint32(0xFFFFFFFF)


def _route_local(flat_words, vmask, n_shards: int, capacity: int,
                 extra=()):
    """Bucket local kmers by owner shard into [n_shards*capacity] slots.

    `extra`: additional uint32 payload arrays routed alongside the key
    words (e.g. window-min quality); their buffers pad with 0 rather than
    the sentinel."""
    h = bits.hash_words(flat_words)
    owner = (h % jnp.uint32(n_shards)).astype(jnp.int32)
    owner = jnp.where(vmask, owner, n_shards)  # invalid routed past the end
    sowner, spay = ops_sort.sort_by_words(
        [owner.astype(jnp.uint32)], list(flat_words) + list(extra))
    sowner = sowner[0].astype(jnp.int32)
    starts = ops_sort.run_starts([sowner])
    rank = segmented.position_in_run(starts)
    ok = (rank < capacity) & (sowner < n_shards)
    slot = jnp.where(ok, sowner * capacity + rank, n_shards * capacity)
    nw = len(flat_words)
    buf = []
    for i, w in enumerate(spay):
        fill = SENT if i < nw else jnp.uint32(0)
        b = jnp.full((n_shards * capacity,), fill, dtype=jnp.uint32)
        buf.append(b.at[slot].set(w, mode="drop"))
    dropped = jnp.sum((~ok) & (sowner < n_shards))
    return buf, dropped


def _spectrum_step_local(codes_blk, K: int, capacity: int, max_freq: int):
    """Per-shard body (runs under shard_map over AXIS)."""
    n = lax.axis_size(AXIS)
    canon, valid = kmerize.kmer_windows(codes_blk, K)
    flat, vmask = kmerize.flatten_kmers(canon, valid, K)
    buf, dropped = _route_local(flat, vmask, n, capacity)

    # exchange: row i of the reshaped buffer goes to shard i
    recv = [lax.all_to_all(b.reshape(n, capacity), AXIS, 0, 0).reshape(-1)
            for b in buf]
    skeys, counts, starts = kcount.count_sorted(recv)
    ck = kcount.compact_table(skeys, counts, starts)
    spec_local = kcount.spectrum_from_counts(counts, max_freq)
    spec = lax.psum(spec_local, AXIS)
    dropped_tot = lax.psum(dropped, AXIS)
    # per-shard owned table (padded); n_unique as [1] so it shards cleanly
    return (spec, dropped_tot, ck.words, ck.counts, ck.n_unique[None])


def distributed_spectrum(mesh: Mesh, codes, K: int, capacity_factor: float = 2.0,
                        max_freq: int = 255):
    """Count kmers of `codes` (uint8 [N, L], N divisible by mesh size) with
    the kmer table sharded by hash across `mesh`.

    Returns (spectrum [max_freq+1], dropped scalar, table_words, table_counts,
    n_unique_per_shard) — table arrays are globally [n * n * capacity] but
    physically sharded; rows of shard s hold only kmers with hash%n == s.
    """
    n = mesh.devices.size
    N, L = codes.shape
    P_ = L - K + 1
    per_shard = (N // n) * P_
    capacity = int(capacity_factor * per_shard / n) + 16
    capacity = -(-capacity // 8) * 8  # round up to 8

    fn = functools.partial(_spectrum_step_local, K=K, capacity=capacity,
                           max_freq=max_freq)
    mapped = jax.shard_map(
        fn, mesh=mesh,
        in_specs=P(AXIS),
        out_specs=(P(), P(), [P(AXIS)] * bits.n_words(K), P(AXIS), P(AXIS)),
    )
    return mapped(codes)


# ---------------------------------------------------------------------------
# Product-pipeline integration (VERDICT r3 Next #3): counting stages route
# through the mesh, producing tables BYTE-IDENTICAL to the 1-device path.
# ---------------------------------------------------------------------------


def _count_step_local(codes_blk, quals_blk, K: int, capacity: int,
                      with_quals: bool):
    """Per-shard body: kmerize the local read shard, hash-route kmers (and
    window-min quals) to owner shards, sort+count the owned partition."""
    n = lax.axis_size(AXIS)
    canon, valid = kmerize.kmer_windows(codes_blk, K)
    flat, vmask = kmerize.flatten_kmers(canon, valid, K)
    extra = []
    if with_quals:
        wq = kcount.window_min_qual(codes_blk, quals_blk, K)
        extra = [jnp.where(vmask, wq.reshape(-1), 0).astype(jnp.uint32)]
    buf, dropped = _route_local(flat, vmask, n, capacity, extra=extra)
    recv = [lax.all_to_all(b.reshape(n, capacity), AXIS, 0, 0).reshape(-1)
            for b in buf]
    W = len(flat)
    if with_quals:
        skeys, spay = ops_sort.sort_by_words(recv[:W], [recv[W].astype(jnp.int32)])
        starts = ops_sort.run_starts(skeys)
        counts = segmented.run_lengths(starts)
        real = ~bits.is_sentinel(skeys)
        counts = jnp.where(real, counts, 0)
        qsum = kcount._sum_per_run(spay[0], starts, counts)
        ck = kcount.compact_table(skeys, counts, starts, qsum)
        qout = ck.qsum
    else:
        skeys, counts, starts = kcount.count_sorted(recv)
        ck = kcount.compact_table(skeys, counts, starts)
        qout = jnp.zeros_like(ck.counts)
    dropped_tot = lax.psum(dropped, AXIS)
    return (ck.words, ck.counts, qout, ck.n_unique[None], dropped_tot)


def count_reads_streaming_dist(mesh: Mesh, codes, K: int, quals=None,
                               batch_size: int = 65536,
                               min_count: int = 0, min_qsum: int = 0,
                               spectrum_max_freq: int = None,
                               capacity_factor: float = 3.0):
    """Mesh-distributed drop-in for kmer.count.count_reads_streaming.

    Each host batch is data-parallel across the mesh; kmers hash-route to
    owner shards (all_to_all) and owners sort+count (ref: the reference's
    hash-parcel partitioning, src/kmers/kmer_parcels/KmerParcelsBuilder.cc
    — SURVEY.md §2.7 P3). Per-shard per-batch compact tables return to the
    host and merge through the SAME range-partitioned merge as the
    1-device path, so the final table (and spectrum) is byte-identical to
    a 1-device run over the same reads.
    """
    import numpy as np
    from allpathslg_tpu.parallel import mesh as pmesh

    n = codes.shape[0]
    L = codes.shape[1]
    nsh = mesh.devices.size
    bs = max(batch_size // nsh, 1) * nsh          # divisible by mesh size
    P_ = L - K + 1
    per_shard = (bs // nsh) * P_
    capacity = int(capacity_factor * per_shard / nsh) + 16
    capacity = -(-capacity // 8) * 8
    with_quals = quals is not None

    fn = functools.partial(_count_step_local, K=K, capacity=capacity,
                           with_quals=with_quals)
    mapped = jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS)),
        out_specs=([P(AXIS)] * bits.n_words(K), P(AXIS), P(AXIS),
                   P(AXIS), P()),
    ))
    sh = pmesh.sharded(mesh)

    parts = []
    recv_cap = nsh * capacity     # rows owned per shard (padded)
    # interconnect byte accounting (docs/scaling.md): the all_to_all
    # moves the FIXED routing buffers — per batch, per shard: n_shards*capacity rows ×
    # (key words + optional qual) × 4 B, of which (n_shards-1)/n_shards
    # crosses links. Deterministic by construction (static shapes), so
    # the byte model below IS the measurement.
    n_words_total = bits.n_words(K) + (1 if with_quals else 0)
    link_bytes_per_batch_per_shard = (
        nsh * capacity * n_words_total * 4 * (nsh - 1) // nsh)
    for s in range(0, n, bs):
        e = min(s + bs, n)
        cb = np.asarray(codes[s:e])
        qb = np.asarray(quals[s:e]) if with_quals else \
            np.zeros((e - s, L), np.uint8)
        if e - s < bs:
            pad = bs - (e - s)
            cb = np.concatenate([cb, np.full((pad, L), 4, cb.dtype)])
            qb = np.concatenate([qb, np.zeros((pad, L), qb.dtype)])
        out = mapped(jax.device_put(jnp.asarray(cb), sh),
                     jax.device_put(jnp.asarray(qb), sh))
        words, counts, qsum, nu, dropped = out
        if int(np.asarray(dropped)) != 0:
            raise RuntimeError(
                f"distributed count capacity overflow (batch {s}): raise "
                f"capacity_factor above {capacity_factor}")
        wnp = [np.asarray(w) for w in words]
        cnp = np.asarray(counts)
        qnp = np.asarray(qsum)
        nunp = np.asarray(nu)
        for i in range(nsh):
            m = int(nunp[i])
            if m == 0:
                continue
            lo = i * recv_cap
            parts.append((
                np.stack([w[lo:lo + m] for w in wnp]),
                cnp[lo:lo + m],
                qnp[lo:lo + m] if with_quals else None))
    n_batches = (n + bs - 1) // bs
    count_reads_streaming_dist.last_link_bytes = (
        link_bytes_per_batch_per_shard * n_batches)
    if not parts:
        W = bits.n_words(K)
        empty = kcount.CountedKmers(
            words=[jnp.zeros(0, jnp.uint32)] * W,
            counts=jnp.zeros(0, jnp.int32),
            qsum=jnp.zeros(0, jnp.int32) if with_quals else None,
            n_unique=jnp.asarray(0, jnp.int32))
        if spectrum_max_freq is not None:
            return empty, np.zeros(spectrum_max_freq + 1, np.int64)
        return empty
    return kcount._merge_host_parts(parts, min_count, min_qsum,
                                    spectrum_max_freq=spectrum_max_freq)


def _count_step_local_packed(words_blk, nmask_blk, q1, q2,
                             L: int, K: int, capacity: int,
                             qual_mode: str):
    """_count_step_local over a 2-bit packed read shard: unpack fuses into
    the per-shard program, so resident packed batches (dtypes/devcache)
    feed the distributed counter with ZERO host round-trips.

    qual_mode: 'palette' (q1=nibbles, q2=palette), 'raw' (q1=qual matrix),
    or 'none' (q1/q2 ignored)."""
    from allpathslg_tpu.dtypes import packed as pk

    codes_blk = pk.unpack_codes(words_blk, nmask_blk, L)
    if qual_mode == "palette":
        quals_blk = pk.unpack_quals(q1, q2, L)
    elif qual_mode == "raw":
        quals_blk = q1
    else:
        quals_blk = jnp.zeros(codes_blk.shape, jnp.uint8)
    return _count_step_local(codes_blk, quals_blk, K=K, capacity=capacity,
                             with_quals=qual_mode != "none")


def count_resident_streaming_dist(mesh: Mesh, db, K: int,
                                  min_count: int = 0, min_qsum: int = 0,
                                  spectrum_max_freq: int = None,
                                  capacity_factor: float = 3.0):
    """Mesh-distributed count over a DeviceBatches resident cache (VERDICT
    r4 weak 4 / Next 6): the mesh find_errors path previously downloaded
    the whole read set every EC round; here each resident packed batch
    enters the shard_map directly (rows resharded over the mesh axis by
    GSPMD), kmers hash-route to owner shards, and per-shard compact tables
    merge through the SAME host merge as every other path — tables stay
    byte-identical to the 1-device run."""
    import numpy as np
    from allpathslg_tpu.parallel import mesh as pmesh

    nsh = mesh.devices.size
    if db.batch % nsh:
        raise ValueError(f"batch_reads={db.batch} not divisible by "
                         f"mesh size {nsh}")
    L = db.L
    P_ = L - K + 1
    per_shard = (db.batch // nsh) * P_
    capacity = int(capacity_factor * per_shard / nsh) + 16
    capacity = -(-capacity // 8) * 8
    have_q = bool(db.qpal) and db.qpal[0] is not None
    qual_mode = ("none" if not have_q
                 else "palette" if db.qnib[0] is not None else "raw")
    with_quals = qual_mode != "none"

    fn = functools.partial(_count_step_local_packed, L=L, K=K,
                           capacity=capacity, qual_mode=qual_mode)
    q2_spec = P() if qual_mode == "palette" else P(AXIS)
    mapped = jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), q2_spec),
        out_specs=([P(AXIS)] * bits.n_words(K), P(AXIS), P(AXIS),
                   P(AXIS), P()),
    ))

    parts = []
    recv_cap = nsh * capacity
    n_words_total = bits.n_words(K) + (1 if with_quals else 0)
    link_bytes_per_batch_per_shard = (
        nsh * capacity * n_words_total * 4 * (nsh - 1) // nsh)
    dummy1 = jnp.zeros((db.batch, 1), jnp.uint32)
    dummy2 = jnp.zeros((db.batch, 1), jnp.uint32)
    for i in range(db.n_batches):
        if qual_mode == "palette":
            q1, q2 = db.qnib[i], db.qpal[i]
        elif qual_mode == "raw":
            q1, q2 = db.qpal[i], dummy2
        else:
            q1, q2 = dummy1, dummy2
        out = mapped(db.words[i], db.nmask[i], q1, q2)
        words, counts, qsum, nu, dropped = out
        if int(np.asarray(dropped)) != 0:
            raise RuntimeError(
                f"resident distributed count capacity overflow (batch {i}):"
                f" raise capacity_factor above {capacity_factor}")
        wnp = [np.asarray(w) for w in words]
        cnp = np.asarray(counts)
        qnp = np.asarray(qsum)
        nunp = np.asarray(nu)
        for s in range(nsh):
            m = int(nunp[s])
            if m == 0:
                continue
            lo = s * recv_cap
            parts.append((
                np.stack([w[lo:lo + m] for w in wnp]),
                cnp[lo:lo + m],
                qnp[lo:lo + m] if with_quals else None))
    count_resident_streaming_dist.last_link_bytes = (
        link_bytes_per_batch_per_shard * db.n_batches)
    if not parts:
        W = bits.n_words(K)
        empty = kcount.CountedKmers(
            words=[jnp.zeros(0, jnp.uint32)] * W,
            counts=jnp.zeros(0, jnp.int32),
            qsum=jnp.zeros(0, jnp.int32) if with_quals else None,
            n_unique=jnp.asarray(0, jnp.int32))
        if spectrum_max_freq is not None:
            return empty, np.zeros(spectrum_max_freq + 1, np.int64)
        return empty
    return kcount._merge_host_parts(parts, min_count, min_qsum,
                                    spectrum_max_freq=spectrum_max_freq)


def table_via_sample_sort(mesh: Mesh, codes, K: int,
                          batch_size: int = 65536, min_count: int = 0):
    """K-mer table build through the distributed sample sort (SURVEY.md
    §2.7 P6; VERDICT r3 Next #3's K=96 path): every shard kmerizes its read
    shard, the (canonical kmer) records sample-sort globally across the
    mesh, and the globally-sorted shards concatenate into one run-length
    counted table. Byte-identical to the 1-device table."""
    import numpy as np
    from allpathslg_tpu.parallel import mesh as pmesh
    from allpathslg_tpu.parallel.sample_sort import sample_sort

    n = codes.shape[0]
    L = codes.shape[1]
    nsh = mesh.devices.size
    bs = max(batch_size // nsh, 1) * nsh
    W = bits.n_words(K)
    sh = pmesh.sharded(mesh)

    kz = jax.jit(jax.shard_map(
        functools.partial(_kmerize_local, K=K), mesh=mesh,
        in_specs=(P(AXIS),), out_specs=[P(AXIS)] * W))

    host_parts = []
    for s in range(0, n, bs):
        e = min(s + bs, n)
        cb = np.asarray(codes[s:e])
        if e - s < bs:
            cb = np.concatenate(
                [cb, np.full((bs - (e - s), L), 4, cb.dtype)])
        flat = kz(jax.device_put(jnp.asarray(cb), sh))
        sw, _, n_real, n_drop = sample_sort(mesh, flat, [])
        if int(np.asarray(n_drop)) != 0:
            raise RuntimeError("sample_sort capacity overflow")
        nr = np.asarray(n_real)
        swnp = [np.asarray(w) for w in sw]
        cap_rows = swnp[0].shape[0] // nsh
        for i in range(nsh):
            m = int(nr[i])
            if m == 0:
                continue
            lo = i * cap_rows
            host_parts.append((
                np.stack([w[lo:lo + m] for w in swnp]),
                np.ones(m, np.int32), None))
    if not host_parts:
        return kcount.CountedKmers(
            words=[jnp.zeros(0, jnp.uint32)] * W,
            counts=jnp.zeros(0, jnp.int32), qsum=None,
            n_unique=jnp.asarray(0, jnp.int32))
    return kcount._merge_host_parts(host_parts, min_count, 0)


def _kmerize_local(codes_blk, K: int):
    canon, valid = kmerize.kmer_windows(codes_blk, K)
    flat, _ = kmerize.flatten_kmers(canon, valid, K)
    return list(flat)
