"""Phase-2 quality-aware K=24 spectrum error correction + read cleaning.

Behavior contract (ref: src/paths/FindErrors.cc, FindErrorsCore.cc,
SURVEY.md §2.5 row 4 and §3.2): a kmer is *strong* if its quality-weighted
support clears a threshold derived from the spectrum valley; for each read
base covered only by weak kmers, search the minimal edit that makes all
covering kmers strong; cap edits by base quality; iterate to fixpoint
(bounded rounds); ploidy-safe because het kmers sit far above the valley and
bases covered by any strong kmer are never touched.

CleanCorrectedReads (ref: src/paths/CleanCorrectedReads.cc behavior,
SURVEY.md §2.5 row 5): after correction, trim reads back to their longest
strong prefix and drop reads with residual weak cores, keeping row indices
stable so pairing survives.

Device shape: membership tests are searchsorted joins against the sorted strong
table; candidate re-tests substitute bases into packed fwd windows with
dynamic bit ops and re-canonicalize — [B, MAXFIX, 3, K] lookups, all batched.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from allpathslg_tpu.kmer import bits, kmerize
from allpathslg_tpu.kmer import count as kcount
from allpathslg_tpu.ops import join


@dataclasses.dataclass(frozen=True)
class SpectrumECConfig:
    K: int = 24
    min_strong_count: int = 2      # raw multiplicity floor for strong
    min_strong_qsum: int = 60      # quality-weighted support floor
    max_fixes_per_round: int = 4   # candidate positions per read per round
    rounds: int = 3
    # adaptive cutoff: stop iterating once a round fixes fewer than this
    # fraction of reads (the reference iterates to bounded fixpoint; late
    # rounds fix a vanishing tail at full-pass cost — ~38 min/round at
    # E. coli scale on this rig)
    min_round_fixes_frac: float = 0.002
    qual_protect: int = 45         # never edit bases at/above this quality
    min_tail_len: int = 24         # CleanCorrectedReads: min kept read length


@functools.partial(jax.jit, static_argnames=("cfg",))
def strong_table(ck: kcount.CountedKmers, cfg: SpectrumECConfig):
    """Strong kmer keys from a quality-weighted counted table (padded table
    is fine: padding rows have count 0)."""
    strong = (ck.counts >= cfg.min_strong_count)
    if ck.qsum is not None:
        strong = strong & (ck.qsum >= cfg.min_strong_qsum)
    sent = jnp.uint32(0xFFFFFFFF)
    # keep table sorted: padding/weak rows become sentinels then re-sort
    keyed = [jnp.where(strong, w, sent) for w in ck.words]
    out = lax.sort(keyed, num_keys=len(keyed), dimension=0, is_stable=False)
    return list(out), jnp.sum(strong.astype(jnp.int32))


def compact_strong_table(table, n_strong: int, bucket: int = 1 << 18):
    """Slice the sorted strong-first table down to a quantized capacity
    (sentinel rows fill the tail). Keeping the table a small, shape-stable
    array bounds recompiles of correct_round/clean_reads across EC rounds
    and kills the full-table re-upload per round (the raw table is the
    whole counted kmer set; the strong set is ~genome-sized)."""
    ns = max(int(n_strong), 1)
    cap = ((ns + bucket - 1) // bucket) * bucket
    out = []
    for w in table:
        if w.shape[0] >= cap:
            out.append(w[:cap])
        else:
            pad = cap - w.shape[0]
            out.append(jnp.concatenate(
                [w, jnp.full(pad, 0xFFFFFFFF, jnp.uint32)]))
    return out


def _member(table, flat):
    """Membership dispatch: HashedTable (r5 fast path — H+W+3 gathers per
    query instead of log2(M) x W) or a legacy sorted word list."""
    if isinstance(table, join.HashedTable):
        return join.member_hashed(table, flat)
    _, found = join.searchsorted_words(table, flat)
    return found


def _window_strong(codes, table, K: int):
    """bool [N, P]: window's canonical kmer is in the strong table."""
    canon, valid = kmerize.kmer_windows(codes, K)
    N, P = valid.shape
    flat = [w.reshape(-1) for w in canon]
    found = _member(table, flat)
    return (found.reshape(N, P) & valid), valid


def _coverage_counts(strongw, K: int, L: int):
    """Per-base counts over covering windows: (n_strong_cov, n_cov)."""
    N, P = strongw[0].shape if isinstance(strongw, tuple) else strongw.shape
    s, v = strongw if isinstance(strongw, tuple) else (strongw, None)
    cs = jnp.cumsum(jnp.pad(s.astype(jnp.int32), ((0, 0), (1, 0))), axis=1)
    cv = jnp.cumsum(jnp.pad(v.astype(jnp.int32), ((0, 0), (1, 0))), axis=1)
    # windows covering base c: p in [max(0, c-K+1), min(c, P-1)]
    c = jnp.arange(L, dtype=jnp.int32)
    lo = jnp.maximum(0, c - K + 1)
    hi = jnp.minimum(c, P - 1)
    n_strong = cs[:, hi + 1] - cs[:, lo]
    n_cov = cv[:, hi + 1] - cv[:, lo]
    return n_strong, n_cov, lo, hi


@functools.partial(jax.jit, static_argnames=("L", "cfg"))
def correct_round_packed(words, nmask, qnib, qpal, L: int, table,
                         cfg: SpectrumECConfig):
    """Packed-in/packed-out correct_round (dtypes/packed): the per-batch
    host<->device transfer is the genome-scale bottleneck, not compute."""
    from allpathslg_tpu.dtypes import packed as pk

    out, n = correct_round(pk.unpack_codes(words, nmask, L),
                           pk.unpack_quals(qnib, qpal, L), table, cfg)
    ow, om = pk.pack_codes_device(out)
    return ow, om, n


@functools.partial(jax.jit, static_argnames=("cfg",))
def correct_round(codes, quals, table, cfg: SpectrumECConfig):
    """One round of spectrum EC. Returns (new_codes, n_fixed)."""
    K = cfg.K
    N, L = codes.shape
    P = L - K + 1
    MAXFIX = cfg.max_fixes_per_round

    strongw, validw = _window_strong(codes, table, K)
    n_strong, n_cov, lo_c, hi_c = _coverage_counts((strongw, validw), K, L)

    # suspect base: has covering valid windows, none strong, editable quality
    suspect = (n_cov > 0) & (n_strong == 0) & (quals.astype(jnp.int32) < cfg.qual_protect)
    suspect = suspect & (codes < 4)

    # pick up to MAXFIX suspects per read, preferring the highest covering-
    # window count: an error position is covered by every weak window around
    # it, so it maximizes n_cov among its suspect run (end-of-read suspect
    # runs would otherwise eat the slots)
    score = jnp.where(suspect, n_cov, -1)
    top_scores, cand = lax.top_k(score, MAXFIX)  # [N, MAXFIX]
    cand = jnp.where(top_scores > 0, cand.astype(jnp.int32), -1)

    fwd, fvalid = kmerize.kmer_windows_fwd(codes, K)

    # for each candidate (n, s), alt base a, covering offset j:
    # window index p = c - j; substituted base at offset c - p = j
    c = cand  # [N, MAXFIX]
    has_c = c >= 0
    csafe = jnp.maximum(c, 0)

    own = jnp.take_along_axis(codes, csafe, axis=1).astype(jnp.int32)  # [N,MAXFIX]
    # 3 alternative bases per candidate: the non-own codes
    alts = jnp.arange(4, dtype=jnp.int32)[None, None, :]  # [1,1,4]
    alt_ok = alts != own[:, :, None]  # [N, MAXFIX, 4]

    # gather original fwd windows for all covering offsets j
    j = jnp.arange(K, dtype=jnp.int32)[None, None, :]          # [1,1,K]
    p = csafe[:, :, None] - j                                   # [N,MF,K]
    p_ok = (p >= 0) & (p < P) & has_c[:, :, None]
    psafe = jnp.clip(p, 0, P - 1)

    gwords = []
    for w in fwd:  # w: [N, P] uint32 → gather [N, MF, K]
        gwords.append(jnp.take_along_axis(w, psafe.reshape(N, -1), axis=1)
                      .reshape(N, MAXFIX, K))
    gvalid = jnp.take_along_axis(fvalid, psafe.reshape(N, -1), axis=1).reshape(N, MAXFIX, K)
    p_ok = p_ok & gvalid

    # substitute each alt base at offset j within each window
    # broadcast: words [N,MF,K] -> [N,MF,4,K]
    jb = jnp.broadcast_to(j[:, :, None, :], (N, MAXFIX, 4, K))
    gw4 = [jnp.broadcast_to(w[:, :, None, :], (N, MAXFIX, 4, K)) for w in gwords]
    ab = jnp.broadcast_to(alts[:, :, :, None], (N, MAXFIX, 4, K))
    sub = bits.put_base_dyn(gw4, jb, ab)
    canon, _ = bits.canonical(sub, K)

    flat = [w.reshape(-1) for w in canon]
    found = _member(table, flat)
    strong_alt = found.reshape(N, MAXFIX, 4, K) | ~p_ok[:, :, None, :]
    all_strong = strong_alt.all(axis=-1) & alt_ok & has_c[:, :, None]  # [N,MF,4]

    n_good = all_strong.sum(axis=-1)                    # [N, MF]
    unique_fix = n_good == 1
    fix_base = jnp.argmax(all_strong, axis=-1).astype(jnp.uint8)

    do = unique_fix & has_c
    # apply: scatter per (read, cand)
    rows = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[:, None], (N, MAXFIX))
    upd = jnp.where(do, fix_base, jnp.take_along_axis(codes, csafe, axis=1))
    new_codes = codes.at[rows.reshape(-1), csafe.reshape(-1)].set(upd.reshape(-1))
    return new_codes, jnp.sum(do)


@functools.partial(jax.jit, static_argnames=("L", "cfg"))
def clean_reads_packed(words, nmask, lengths, L: int, table,
                       cfg: SpectrumECConfig):
    """Packed-in/packed-out clean_reads (see correct_round_packed)."""
    from allpathslg_tpu.dtypes import packed as pk

    out, lens, k = clean_reads(pk.unpack_codes(words, nmask, L),
                               lengths, table, cfg)
    ow, om = pk.pack_codes_device(out)
    return ow, om, lens, k


@functools.partial(jax.jit, static_argnames=("cfg",))
def clean_reads(codes, lengths, table, cfg: SpectrumECConfig):
    """CleanCorrectedReads: trim to the longest window-strong span; drop
    reads whose strong span is shorter than min_tail_len (length set to 0,
    rows kept so pair indices stay valid). Returns (codes, lengths, n_kept)."""
    K = cfg.K
    N, L = codes.shape
    strongw, validw = _window_strong(codes, table, K)
    P = L - K + 1
    # longest prefix of consecutive strong windows starting at window 0 is too
    # strict; instead keep [first_strong, last_strong] span if its weak-window
    # count is 0, else truncate at first weak window after first_strong.
    anys = strongw.any(axis=1)
    first = jnp.argmax(strongw, axis=1)
    idxp = jnp.arange(P, dtype=jnp.int32)[None, :]
    weak_after = (~strongw) & validw & (idxp >= first[:, None])
    has_weak = weak_after.any(axis=1)
    first_weak = jnp.where(has_weak, jnp.argmax(weak_after, axis=1), P)
    # keep bases [first, first_weak + K - 1)
    start = jnp.where(anys, first, 0)
    end = jnp.where(anys, jnp.minimum(first_weak + K - 1, lengths), 0)
    keep_len = jnp.maximum(end - start, 0)
    ok = keep_len >= cfg.min_tail_len
    keep_len = jnp.where(ok, keep_len, 0)

    # shift kept span to column 0 via gather
    cols = jnp.arange(L, dtype=jnp.int32)[None, :] + start[:, None]
    cols = jnp.clip(cols, 0, L - 1)
    shifted = jnp.take_along_axis(codes, cols, axis=1)
    mask = jnp.arange(L, dtype=jnp.int32)[None, :] < keep_len[:, None]
    out = jnp.where(mask, shifted, jnp.uint8(4))
    return out, keep_len.astype(jnp.int32), jnp.sum(ok)


def find_errors(codes, quals, cfg: SpectrumECConfig = SpectrumECConfig()):
    """Full FindErrors phase 2: build quality-weighted table, iterate
    correction rounds. Returns (codes, table, n_fixed_total)."""
    total = 0
    table = None
    for r in range(cfg.rounds):
        ck = kcount.count_reads(codes, cfg.K, quals)
        table, _ = strong_table(ck, cfg)
        codes, n = correct_round(codes, quals, table, cfg)
        total += int(n)
    return codes, table, total
