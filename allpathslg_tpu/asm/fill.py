"""FillFragments: merge overlapping fragment pairs into filled super-reads.

Behavior contract (ref: src/paths/FillFragments.cc, SURVEY.md §2.5 row 6):
fragment inserts (~180bp) are shorter than two read lengths, so each pair
overlaps in the middle; validate the overlap against the insert-size
distribution, merge into one double-quality "filled" read, and pass
unfillable pairs through unchanged. Filled reads are what the K=96 pather
consumes — raw 100bp reads only cover each 96-mer ~(L-K+1)/L as often.

Device shape: all candidate insert sizes are scored at once as shifted
elementwise comparisons (one [N, n_offsets, L] compare), best and runner-up
offsets picked with top-k semantics, merged bases/quals built by gather.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from allpathslg_tpu.dtypes.reads import PAD_CODE


@dataclasses.dataclass(frozen=True)
class FillConfig:
    insert_lo: int = 120        # smallest insert size to try
    insert_hi: int = 260        # largest insert size to try
    max_mismatch: int = 2       # allowed mismatches in the overlap
    min_overlap: int = 12       # minimum overlap bases
    min_margin: int = 3         # runner-up must have this many more mismatches


@functools.partial(jax.jit, static_argnames=("cfg", "out_len"))
def fill_pairs(codes1, quals1, len1, codes2, quals2, len2,
               cfg: FillConfig, out_len: int):
    """Merge r1 with rc(r2) across candidate insert sizes.

    codes1/codes2: uint8 [N, L] (r2 as sequenced; rc applied internally).
    Returns (filled_codes [N, out_len], filled_quals, filled_len, ok [N]).
    """
    N, L = codes1.shape
    # reverse-complement read 2 (padding-aware: flip the valid prefix)
    idx = jnp.arange(L, dtype=jnp.int32)[None, :]
    src = len2[:, None] - 1 - idx
    srcc = jnp.clip(src, 0, L - 1)
    r2 = jnp.take_along_axis(codes2, srcc, axis=1)
    r2 = jnp.where((src >= 0) & (r2 < 4), 3 - r2, PAD_CODE).astype(jnp.uint8)
    q2 = jnp.take_along_axis(quals2, srcc, axis=1)
    q2 = jnp.where(src >= 0, q2, 0).astype(jnp.uint8)

    # candidate inserts d: r2rc starts at offset o = d - len2
    ds = jnp.arange(cfg.insert_lo, cfg.insert_hi + 1, dtype=jnp.int32)
    D = ds.shape[0]
    o = ds[None, :] - len2[:, None]                      # [N, D]
    # overlap = [o, len1) in merged coords; r1[j] vs r2[j - o]
    j = jnp.arange(L, dtype=jnp.int32)[None, None, :]     # positions in r1
    k = j - o[:, :, None]                                 # positions in r2
    in_ov = (j < len1[:, None, None]) & (k >= 0) & (k < len2[:, None, None])
    kc = jnp.clip(k, 0, L - 1)
    r2_at = jnp.take_along_axis(r2[:, None, :].repeat(D, 1).reshape(N * D, L),
                                kc.reshape(N * D, L), axis=1).reshape(N, D, L)
    mism = ((codes1[:, None, :] != r2_at) & in_ov).sum(-1)
    ov_len = in_ov.sum(-1)
    valid_d = (o >= 0) & (ov_len >= cfg.min_overlap) & (ds[None, :] >= len1[:, None])
    score = jnp.where(valid_d, mism, 10**6)

    best = jnp.argmin(score, axis=1)
    best_mm = jnp.take_along_axis(score, best[:, None], 1)[:, 0]
    second = jnp.where(jnp.arange(D)[None, :] == best[:, None], 10**6, score)
    second_mm = second.min(axis=1)
    ok = (best_mm <= cfg.max_mismatch) & (second_mm >= best_mm + cfg.min_margin)

    d_best = ds[best]                                     # [N]
    o_best = d_best - len2

    # build merged read of length d_best: position t takes r1[t] and/or
    # r2[t - o_best], higher-quality base wins in the overlap
    t = jnp.arange(out_len, dtype=jnp.int32)[None, :]
    from1 = t < len1[:, None]
    k2 = t - o_best[:, None]
    from2 = (k2 >= 0) & (k2 < len2[:, None])
    k2c = jnp.clip(k2, 0, L - 1)
    tc = jnp.clip(t, 0, L - 1)
    b1 = jnp.take_along_axis(codes1, tc, axis=1)
    q1 = jnp.take_along_axis(quals1, tc, axis=1)
    b2 = jnp.take_along_axis(r2, k2c, axis=1)
    q2g = jnp.take_along_axis(q2, k2c, axis=1)

    use2 = from2 & (~from1 | (q2g > q1))
    merged = jnp.where(use2, b2, jnp.where(from1, b1, PAD_CODE)).astype(jnp.uint8)
    # double quality where the strands agree; min where they disagree
    agree = from1 & from2 & (b1 == b2)
    q = jnp.where(agree, jnp.minimum(q1.astype(jnp.int32) + q2g.astype(jnp.int32), 60),
                  jnp.where(use2, q2g, jnp.where(from1, q1, 0)).astype(jnp.int32))
    mlen = jnp.where(ok, jnp.minimum(d_best, out_len), 0)
    in_read = t < mlen[:, None]
    merged = jnp.where(in_read, merged, PAD_CODE).astype(jnp.uint8)
    q = jnp.where(in_read, q, 0).astype(jnp.uint8)
    return merged, q, mlen.astype(jnp.int32), ok
