"""Bucketed k-mer grouping: group equal keys without one global flat sort.

Motivation: a flat `lax.sort` of N=2^24 2-word keys streams the whole
array through device memory at every merge level. Counting does not need a
total order, only all copies of each key adjacent. This module restructures
the problem so every sort XLA sees is a BATCHED ROW SORT of short rows:

  1. reshape the flat keys to [T, R] tiles; sort each row (dimension=1)
  2. pick bucket edges from a per-tile strided sample (quantile splitters
     on the leading word — canonical-form skew safe)
  3. per tile, locate each bucket's contiguous run (vmapped searchsorted)
     and gather the runs into fixed slabs [T, B, S] (sentinel padded)
  4. transpose to [B, T*S] and row-sort again: now every bucket holds ALL
     copies of its keys, grouped and sorted

Bucket-major order of sorted buckets is globally sorted (edges ascend), so
the output is a sentinel-interleaved sorted sequence: run-length counting
works unchanged, and a compaction pass (cumsum + one gather) recovers the
dense sorted table.

Overflow safety: slabs hold S = ceil(N/(B*T) * slack) elements per
(tile, bucket). The kernel also returns the max run length actually seen;
`count_grouped` (the host wrapper) retries with a larger slack, and callers
can fall back to the flat-sort path (kmer/count.count_sorted) on repeated
overflow. With sampled quantile edges the default slack is generous.

(ref: the hash-block parcel decomposition of naif_kmerize,
src/kmers/naif_kmer/NaifKmerizer.cc — the same two-level group-then-count
shape, re-cast for on-chip residency instead of L2 cache.)
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

SENT = np.uint32(0xFFFFFFFF)


@functools.partial(jax.jit, static_argnames=("tile_rows", "n_buckets",
                                             "slots"))
def group_keys(words: Sequence[jnp.ndarray], tile_rows: int,
               n_buckets: int, slots: int):
    """Group equal multi-word keys adjacently.

    Args:
      words: W uint32 arrays, flat [N] (N % tile_rows == 0 required;
        pad with the all-ones sentinel first).
      tile_rows: R, elements per tile row (a power of two; e.g. 2^17).
      n_buckets: B bucket count.
      slots: S slab slots per (tile, bucket).

    Returns (grouped_words [B*T*S] with sentinel padding interspersed,
             max_run: int32 scalar — max (tile,bucket) occupancy for
             overflow detection; valid grouping iff max_run <= slots).
    """
    W = len(words)
    N = words[0].shape[0]
    R = tile_rows
    T = N // R
    B = n_buckets
    S = slots

    tiles = [w.reshape(T, R) for w in words]
    srt = lax.sort(tiles, num_keys=W, dimension=1, is_stable=False)
    if not isinstance(srt, (list, tuple)):
        srt = [srt]
    srt = list(srt)

    # quantile edges from a strided sample of every sorted tile row (w0)
    P = max(R // 256, B)
    samp = srt[0][:, :: R // P].reshape(-1)
    samp = lax.sort([samp], num_keys=1, is_stable=False)[0]
    M = samp.shape[0]
    qi = (jnp.arange(1, B, dtype=jnp.int32) * M) // B
    edges = samp[qi]                                   # [B-1] ascending

    # sentinels (all-ones keys: padding + invalid windows) sort to each
    # row's end; bucket spans are clipped to the real-key prefix so
    # sentinels never occupy slab slots (they'd all crowd one bucket and
    # force overflow on N-rich inputs)
    sent_row = srt[0] == SENT
    for w in srt[1:]:
        sent_row = sent_row & (w == SENT)
    nreal = (R - jnp.sum(sent_row, axis=1)).astype(jnp.int32)  # [T]

    # per-tile bucket boundaries on the leading word
    starts = jax.vmap(lambda row: jnp.searchsorted(row, edges,
                                                   side="left"))(srt[0])
    starts = jnp.concatenate(
        [jnp.zeros((T, 1), starts.dtype), starts,
         jnp.full((T, 1), R, starts.dtype)], axis=1)   # [T, B+1]
    starts = jnp.minimum(starts, nreal[:, None]).astype(starts.dtype)
    cnt = starts[:, 1:] - starts[:, :-1]               # [T, B]
    max_run = cnt.max().astype(jnp.int32)

    # slab gather: idx[t, b, s] = starts[t, b] + s (masked beyond cnt)
    s_iota = jnp.arange(S, dtype=jnp.int32)
    idx = starts[:, :-1, None] + s_iota[None, None, :]         # [T, B, S]
    valid = s_iota[None, None, :] < cnt[:, :, None]
    idx_c = jnp.minimum(idx, R - 1).reshape(T, B * S)
    out = []
    for w in srt:
        g = jnp.take_along_axis(w, idx_c, axis=1).reshape(T, B, S)
        g = jnp.where(valid, g, SENT)
        # [T, B, S] -> [B, T, S] -> rows per bucket
        out.append(g.transpose(1, 0, 2).reshape(B, T * S))

    final = lax.sort(out, num_keys=W, dimension=1, is_stable=False)
    if not isinstance(final, (list, tuple)):
        final = [final]
    return [f.reshape(-1) for f in final], max_run


def _pad_to(words: List[jnp.ndarray], n: int):
    N0 = words[0].shape[0]
    if N0 == n:
        return words
    pad = n - N0
    return [jnp.concatenate([w, jnp.full((pad,), SENT, jnp.uint32)])
            for w in words]


def count_grouped(flat_words: Sequence[jnp.ndarray],
                  tile_rows: int = 1 << 17, n_buckets: int = 128,
                  slack: float = 1.5):
    """Drop-in alternative to kmer/count.count_sorted built on group_keys:
    returns (grouped_words, counts_at_starts, starts_mask) with sentinel
    padding interspersed (excluded from counts). Host wrapper: retries with
    doubled slack on slab overflow, then falls back to the flat sort."""
    from allpathslg_tpu.ops import sort as ops_sort
    from allpathslg_tpu.ops import segmented

    words = list(flat_words)
    N0 = words[0].shape[0]
    R = tile_rows
    while R > N0:
        R >>= 1
    R = max(R, 1024)
    N = ((N0 + R - 1) // R) * R
    words = _pad_to(words, N)
    T = N // R
    B = min(n_buckets, max(T, 8))
    for attempt in range(2):
        S = int(np.ceil(N / (B * T) * slack))
        g, max_run = group_keys(words, R, B, S)
        if int(max_run) <= S:
            starts = ops_sort.run_starts(g)
            counts = segmented.run_lengths(starts)
            from allpathslg_tpu.kmer import bits
            real = ~bits.is_sentinel(g)
            counts = jnp.where(real, counts, 0)
            return g, counts, starts
        slack *= 2.0
    # pathological key distribution: fall back to the flat sort
    from allpathslg_tpu.kmer import count as kcount
    return kcount.count_sorted(words)


@functools.partial(jax.jit, static_argnames=("tile_rows", "n_buckets",
                                             "slots", "max_freq"))
def spectrum_grouped(words: Sequence[jnp.ndarray], tile_rows: int,
                     n_buckets: int, slots: int, max_freq: int = 255):
    """Jittable spectrum via bucketed grouping (no flat global sort).

    Returns (spec [max_freq+1], n_unique, ok) — ok False means a
    (tile, bucket) slab overflowed and the result is INVALID; the caller
    must re-run with larger slots or use the flat path. Padding sentinels
    are excluded from both spec and n_unique.
    """
    from allpathslg_tpu.kmer import bits
    from allpathslg_tpu.kmer import count as kcount
    from allpathslg_tpu.ops import sort as ops_sort
    from allpathslg_tpu.ops import segmented

    g, max_run = group_keys(list(words), tile_rows, n_buckets, slots)
    starts = ops_sort.run_starts(g)
    counts = segmented.run_lengths(starts)
    counts = jnp.where(~bits.is_sentinel(g), counts, 0)
    spec = kcount.spectrum_from_counts(counts, max_freq)
    n_unique = jnp.sum((counts > 0).astype(jnp.int32))
    return spec, n_unique, max_run <= slots


def grouping_plan(n_rows: int, tile_rows: int = 1 << 17,
                  n_buckets: int = 128, slack: float = 1.5):
    """Static (padded_n, tile_rows, n_buckets, slots) for a flat key count,
    shared by spectrum_grouped callers so shapes (and compiles) coincide."""
    R = tile_rows
    while R > n_rows:
        R >>= 1
    R = max(R, 1024)
    N = ((n_rows + R - 1) // R) * R
    T = N // R
    B = min(n_buckets, max(T, 8))
    S = int(np.ceil(N / (B * T) * slack))
    return N, R, B, S
