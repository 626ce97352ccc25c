"""Seed-and-verify read-to-contig alignment producing alignlets.

Behavior contract (ref: src/lookup/ lookup_table + QueryLookupTable +
ImperfectLookup, and src/paths/AlignPairsToHyper* — SURVEY.md §2.2, §3.5):
build a kmer seed index of the contig set, find candidate placements for
each read by seed vote, verify gap-free with a mismatch count, and keep
unique placements as compact alignlets (read, contig, pos, rc, mismatches).
This is the "aligned read-pairs/s" metric path; gapped rescue goes through
the banded-DP kernel later.

Device shape: the index is a hash-bucketed (canonical kmer → packed
gpos|rc) table over the *flat* concatenated contig bases (windows
crossing contig boundaries masked out); seeds probe buckets with direct
gathers; votes resolve DENSELY per read (every read has exactly S*H
candidate rows → [N, C, C] all-pairs count — no sort, no scatter); verification is a gather + compare, with banded-DP gapped
rescue for verify failures.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from allpathslg_tpu.dtypes.reads import PAD_CODE
from allpathslg_tpu.kmer import bits, kmerize
from allpathslg_tpu.ops import sort as ops_sort, segmented


@dataclasses.dataclass
class SeedIndex:
    """Hash-bucketed canonical-kmer seed index of a contig set.

    Rows are sorted by a 32-bit mixed hash of the canonical seed kmer and
    addressed by DIRECT bucket lookup on the hash's top bits — one gather
    per query instead of a ~22-round binary search. Hash collisions
    (~T²/2³³ rows) only add spurious candidates, which the vote/verify
    stages already reject.

    Row payloads are PACKED into one uint32 `(gpos << 1) | is_rc` when the
    flat contig set is < 2^30 bases (r5: halves the random gathers in the
    hit expansion — the measured 57% cost center); contig/pos derive from
    gpos via a log(n_contigs) search of the TINY offsets array. Larger
    indexes fall back to the 3-array layout (packed=None)."""
    K: int
    hash: jnp.ndarray            # uint32 [T] sorted (0xFFFFFFFF reserved)
    bucket_starts: jnp.ndarray   # int32 [NB + 1]; NB = 1 << (32 - shift)
    shift: int                   # bucket = hash >> shift
    contig: jnp.ndarray          # int32 [T] (legacy layout; None if packed)
    pos: jnp.ndarray             # int32 [T] position within contig
    is_rc: jnp.ndarray           # bool [T] canonical form is rc of contig fwd
    offsets: jnp.ndarray         # int32 [n_contigs + 1]
    contig_lens: np.ndarray      # int32 [n_contigs] (host)
    packed: jnp.ndarray = None   # uint32 [T] (gpos << 1) | is_rc


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    K: int = 24
    seed_stride: int = 8        # query seed every `stride` windows
    max_hits_per_seed: int = 8  # repeat guard
    max_mismatch_frac: float = 0.06
    require_unique: bool = True
    rescue_band: int = 8        # banded-DP rescue half-width for reads whose
                                # winning placement fails gap-free verify
                                # (ref: QueryLookupTable seed-extend through
                                # SmithWatBandedA, SURVEY §3.5); 0 = off


def build_index(bases: np.ndarray, offsets: np.ndarray, K: int,
                force_legacy: bool = False) -> SeedIndex:
    """bases: uint8 flat contig bases; offsets: int [n+1].

    force_legacy keeps the 3-array row layout even under 2^30 bases
    (tests the >=1 Gb fallback path on small data)."""
    total = int(offsets[-1])
    flat = jnp.asarray(bases, dtype=jnp.uint8).reshape(1, -1)
    off32 = jnp.asarray(np.asarray(offsets, np.int64).astype(np.int32))
    canon, valid = kmerize.kmer_windows(flat, K)
    fwd, _ = kmerize.kmer_windows_fwd(flat, K)
    P = total - K + 1
    gpos = jnp.arange(P, dtype=jnp.int32)
    contig = jnp.searchsorted(off32, gpos, side="right").astype(jnp.int32) - 1
    # window must not cross its contig's end
    end = off32[contig + 1]
    inside = (gpos + K) <= end
    valid = valid.reshape(-1) & inside
    is_rc = ~bits.lex_eq(canon, fwd)
    pos = gpos - off32[contig]

    sent = jnp.uint32(0xFFFFFFFF)
    flat_words = [w.reshape(-1) for w in canon]
    h = jnp.minimum(bits.hash_words(flat_words), jnp.uint32(0xFFFFFFFE))
    keys = [jnp.where(valid.reshape(-1), h, sent)]
    packed_mode = total < (1 << 30) and not force_legacy
    if packed_mode:
        pk32 = ((gpos.astype(jnp.uint32) << 1)
                | is_rc.reshape(-1).astype(jnp.uint32))
        skeys, spay = ops_sort.sort_by_words(keys, [pk32])
    else:
        skeys, spay = ops_sort.sort_by_words(
            keys, [contig, pos, is_rc.reshape(-1).astype(jnp.int32)])
    n_valid = int(jnp.sum(valid.astype(jnp.int32)))
    hash_sorted = skeys[0][:n_valid]
    # bucket directory: ~4 buckets per row keeps mean occupancy ≈ 0.25 so
    # an H-row scan from the bucket start covers the query's hash run
    nb_bits = max(16, min(26, int(np.ceil(np.log2(max(4 * n_valid, 2))))))
    shift = 32 - nb_bits
    NB = 1 << nb_bits
    bounds = (jnp.arange(NB, dtype=jnp.uint32) << shift)
    bucket_starts = jnp.concatenate([
        jnp.searchsorted(hash_sorted, bounds, side="left").astype(jnp.int32),
        jnp.full((1,), n_valid, jnp.int32)])
    clens = np.diff(np.asarray(offsets)).astype(np.int32)
    if packed_mode:
        return SeedIndex(
            K=K, hash=hash_sorted, bucket_starts=bucket_starts, shift=shift,
            contig=None, pos=None, is_rc=None, offsets=off32,
            contig_lens=clens, packed=spay[0][:n_valid])
    return SeedIndex(
        K=K,
        hash=hash_sorted,
        bucket_starts=bucket_starts,
        shift=shift,
        contig=spay[0][:n_valid],
        pos=spay[1][:n_valid],
        is_rc=spay[2][:n_valid].astype(bool),
        offsets=off32,
        contig_lens=clens,
    )


@functools.partial(jax.jit, static_argnames=("cfg", "shift"))
def _candidates(index_hash, bucket_starts, index_contig, index_pos,
                index_rc, codes, lengths, cfg: AlignConfig, shift: int):
    """Seed lookups → candidate (contig, diag, orient) votes per read.

    Seeds address the index by DIRECT hash-bucket lookup (2 gathers per
    seed) instead of a multi-round binary search."""
    K = cfg.K
    N, L = codes.shape
    P = L - K + 1
    canon, valid = kmerize.kmer_windows(codes, K)
    fwd, _ = kmerize.kmer_windows_fwd(codes, K)
    q_rc = ~bits.lex_eq(canon, fwd)  # read window stored as rc of read-fwd

    # seeds: every stride-th window
    seed_pos = jnp.arange(0, P, cfg.seed_stride, dtype=jnp.int32)
    S = seed_pos.shape[0]
    sw = [w[:, seed_pos] for w in canon]
    sval = valid[:, seed_pos]
    sqrc = q_rc[:, seed_pos]

    flat = [w.reshape(-1) for w in sw]
    qh = jnp.minimum(bits.hash_words(flat), jnp.uint32(0xFFFFFFFE))
    b = (qh >> shift).astype(jnp.int32)
    lo = bucket_starts[b]
    hi = bucket_starts[b + 1]
    H = cfg.max_hits_per_seed
    T = index_contig.shape[0]

    # expand each seed to up to H rows scanned from its bucket start
    hit_idx = lo[:, None] + jnp.arange(H, dtype=jnp.int32)[None, :]
    ok = hit_idx < hi[:, None]
    hit_clip = jnp.minimum(hit_idx, T - 1)
    ok = ok & (index_hash[hit_clip] == qh[:, None])
    c = index_contig[hit_clip]
    p = index_pos[hit_clip]
    t_rc = index_rc[hit_clip]

    # orientation: read-fwd maps to contig-fwd iff (q_rc == t_rc)
    qrc_f = sqrc.reshape(-1)[:, None]
    orient_rc = qrc_f ^ t_rc  # True: read maps reverse-complemented
    qpos = jnp.broadcast_to(seed_pos[None, :, None], (N, S, H)).reshape(-1, H)
    # seed-invariant anchors: fwd placements use A with read j ↔ A + j
    # (A = p - qpos); rc placements use A with read j ↔ A - j
    # (A = p + qpos + K - 1)
    diag = jnp.where(orient_rc, p + qpos + (K - 1), p - qpos)
    read_id = jnp.broadcast_to(
        jnp.arange(N, dtype=jnp.int32)[:, None, None], (N, S, H)).reshape(-1, H)
    ok = ok & sval.reshape(-1)[:, None]
    return (read_id.reshape(-1), c.reshape(-1), diag.reshape(-1),
            orient_rc.reshape(-1), ok.reshape(-1))


@functools.partial(jax.jit, static_argnames=("cfg", "shift"))
def _candidates_packed(index_hash, bucket_starts, index_packed, offsets,
                       codes, lengths, cfg: AlignConfig, shift: int):
    """_candidates over the packed (gpos<<1|rc) index: HALF the random
    gathers in the hit expansion (2 instead of 4 — hash + packed);
    contig/pos derive from gpos through the tiny offsets array."""
    K = cfg.K
    N, L = codes.shape
    P = L - K + 1
    canon, valid = kmerize.kmer_windows(codes, K)
    fwd, _ = kmerize.kmer_windows_fwd(codes, K)
    q_rc = ~bits.lex_eq(canon, fwd)

    seed_pos = jnp.arange(0, P, cfg.seed_stride, dtype=jnp.int32)
    S = seed_pos.shape[0]
    sw = [w[:, seed_pos] for w in canon]
    sval = valid[:, seed_pos]
    sqrc = q_rc[:, seed_pos]

    flat = [w.reshape(-1) for w in sw]
    qh = jnp.minimum(bits.hash_words(flat), jnp.uint32(0xFFFFFFFE))
    b = (qh >> shift).astype(jnp.int32)
    lo = bucket_starts[b]
    hi = bucket_starts[b + 1]
    H = cfg.max_hits_per_seed
    T = index_packed.shape[0]

    hit_idx = lo[:, None] + jnp.arange(H, dtype=jnp.int32)[None, :]
    ok = hit_idx < hi[:, None]
    hit_clip = jnp.minimum(hit_idx, T - 1)
    ok = ok & (index_hash[hit_clip] == qh[:, None])
    pk = index_packed[hit_clip]
    gp = (pk >> 1).astype(jnp.int32)
    t_rc = (pk & 1).astype(bool)
    c = (jnp.searchsorted(offsets, gp, side="right") - 1).astype(jnp.int32)
    p = gp - offsets[c]

    qrc_f = sqrc.reshape(-1)[:, None]
    orient_rc = qrc_f ^ t_rc
    qpos = jnp.broadcast_to(seed_pos[None, :, None], (N, S, H)).reshape(-1, H)
    diag = jnp.where(orient_rc, p + qpos + (K - 1), p - qpos)
    read_id = jnp.broadcast_to(
        jnp.arange(N, dtype=jnp.int32)[:, None, None], (N, S, H)).reshape(-1, H)
    ok = ok & sval.reshape(-1)[:, None]
    return (read_id.reshape(-1), c.reshape(-1), diag.reshape(-1),
            orient_rc.reshape(-1), ok.reshape(-1))


@functools.partial(jax.jit, static_argnames=("cfg",))
def _vote_and_verify_dense(contig, diag, orient, ok,
                           flat_bases, offsets, codes, lengths,
                           cfg: AlignConfig):
    """Dense per-read voting (r5): every read has EXACTLY S*H candidate
    rows ([N, C] read-major from _candidates), so the modal placement is
    an all-pairs vote count on a [N, C, C] block — no global sort, no
    scatter, no scan: elementwise work and reductions only.

    Tie-break: earliest candidate row (deterministic; rows are seed-major
    so this prefers the leftmost seed's placement)."""
    N, L = codes.shape
    C = contig.shape[1]
    c = jnp.where(ok, contig, -1)
    d = jnp.where(ok, diag, jnp.int32(1 << 30))
    o = jnp.where(ok, orient.astype(jnp.int32), 2)
    same = ((c[:, :, None] == c[:, None, :])
            & (d[:, :, None] == d[:, None, :])
            & (o[:, :, None] == o[:, None, :])
            & ok[:, None, :])
    votes = same.sum(axis=2).astype(jnp.int32) * ok.astype(jnp.int32)
    # winner: most votes, ties to the earliest row
    score = votes * (C + 1) + (C - jnp.arange(C, dtype=jnp.int32))[None, :]
    score = score * ok.astype(jnp.int32)
    win_row = jnp.argmax(score, axis=1).astype(jnp.int32)
    take = lambda a: jnp.take_along_axis(a, win_row[:, None], axis=1)[:, 0]
    win_votes = take(votes)
    has = win_votes > 0
    win_contig = jnp.where(has, take(c), -1)
    win_diag = jnp.where(has, take(d), 0)
    win_orient = jnp.where(has, take(o), 0)

    # runner-up among OTHER placements; same-locus near-diagonal rows
    # (the other side of an indel, within the rescue band) don't count
    # as ambiguity (ref: QueryLookupTable groups hits by approx diagonal)
    tol = max(cfg.rescue_band, 1)
    same_as_win = ((c == win_contig[:, None]) & (d == win_diag[:, None])
                   & (o == win_orient[:, None]))
    near = ((c == win_contig[:, None]) & (o == win_orient[:, None])
            & (jnp.abs(d - win_diag[:, None]) <= tol))
    run2 = jnp.max(jnp.where(same_as_win | near, 0, votes), axis=1)

    # verification: compare read to contig segment
    total = flat_bases.shape[0]
    gstart = offsets[jnp.maximum(win_contig, 0)]
    j = jnp.arange(L, dtype=jnp.int32)[None, :]
    lenv = lengths[:, None]
    tpos_f = win_diag[:, None] + j
    tpos_r = win_diag[:, None] - j
    tpos = jnp.where(win_orient[:, None] == 1, tpos_r, tpos_f) \
        + gstart[:, None]
    cend = offsets[jnp.maximum(win_contig, 0) + 1]
    inb = (tpos >= gstart[:, None]) & (tpos < cend[:, None]) & (j < lenv)
    tb = flat_bases[jnp.clip(tpos, 0, total - 1)]
    tb = jnp.where(win_orient[:, None] == 1, 3 - tb.astype(jnp.int32),
                   tb.astype(jnp.int32))
    mm = ((codes.astype(jnp.int32) != tb) & inb & (codes < 4)).sum(1)
    n_in = (inb & (codes < 4)).sum(1)

    max_mm = (cfg.max_mismatch_frac
              * lengths.astype(jnp.float32)).astype(jnp.int32)
    aligned = (win_contig >= 0) & (n_in >= (lengths * 9) // 10) \
        & (mm <= max_mm)
    unique_ok = (run2 * 2 < win_votes) if cfg.require_unique \
        else jnp.ones_like(aligned)
    aligned = aligned & unique_ok
    return win_contig, win_diag, win_orient.astype(bool), mm, aligned, \
        unique_ok


@functools.partial(jax.jit, static_argnames=("cfg",))
def _gapped_rescue(win_c, win_d, win_o, aligned, flat_bases, offsets,
                   codes, lengths, cfg: AlignConfig):
    """Banded-DP rescue of reads whose winning placement failed gap-free
    verification (an indel vs the contig shifts the tail and swamps the
    mismatch count; ref: QueryLookupTable's SmithWatBandedA extension).

    Every unaligned-with-candidate read aligns against its expected contig
    window (± band) through ops/banded; the
    placement is accepted when the EDIT distance clears the same fraction
    threshold the gap-free path applies to mismatches."""
    from allpathslg_tpu.ops import banded

    N, L = codes.shape
    band = cfg.rescue_band
    total = flat_bases.shape[0]
    j = jnp.arange(L, dtype=jnp.int32)[None, :]
    lenv = lengths[:, None]
    # rc reads align forward after reversing within their length
    j2 = jnp.clip(lenv - 1 - j, 0, L - 1)
    rc_codes = jnp.where(j < lenv,
                         jnp.take_along_axis(codes, j2, axis=1), PAD_CODE)
    rc_codes = jnp.where((rc_codes < 4) & (j < lenv), 3 - rc_codes.astype(
        jnp.int32), PAD_CODE).astype(jnp.uint8)
    q = jnp.where(win_o[:, None], rc_codes, codes)

    gstart = offsets[jnp.maximum(win_c, 0)]
    cend = offsets[jnp.maximum(win_c, 0) + 1]
    # expected contig start of the (possibly rc'd) query
    exp = jnp.where(win_o, win_d - (lengths - 1), win_d)
    tstart = gstart + exp - band
    Wt = L + 2 * band
    jt = jnp.arange(Wt, dtype=jnp.int32)[None, :]
    tpos = tstart[:, None] + jt
    inb = (tpos >= gstart[:, None]) & (tpos < cend[:, None])
    t = jnp.where(inb, flat_bases[jnp.clip(tpos, 0, total - 1)],
                  PAD_CODE).astype(jnp.uint8)
    t_len = jnp.full((N,), Wt, jnp.int32)
    # the DP body is traced inline into this program
    q_len = lengths.astype(jnp.int32)
    offv = jnp.full((N,), band, jnp.int32)
    cost, _ = banded.banded_align.__wrapped__(q, q_len, t, t_len, offv,
                                              band=band)
    max_mm = (cfg.max_mismatch_frac
              * lengths.astype(jnp.float32)).astype(jnp.int32)
    ok = (win_c >= 0) & ~aligned & (cost <= max_mm)
    return ok, cost


def align_reads(index: SeedIndex, codes, lengths, cfg: AlignConfig,
                flat_bases: np.ndarray):
    """Full alignment: returns host alignlet arrays
    (contig, pos, rc, mismatches, aligned).

    Host code batches upload 2-bit packed (dtypes/packed) and unpack
    inside the jitted program: raw [N, L] uint8 batches are 4x the
    host->device bytes."""
    from allpathslg_tpu.utils.jitsafe import call_buffer_safe

    if isinstance(codes, np.ndarray):
        from allpathslg_tpu.dtypes import packed as pk

        w, m, L = pk.pack_codes(codes)
        codes = call_buffer_safe(_unpack_jit, jnp.asarray(w),
                                 jnp.asarray(m), L)
    else:
        codes = jnp.asarray(codes)
    lengths = jnp.asarray(lengths)
    if index.packed is not None:
        rid, c, d, o, ok = call_buffer_safe(
            _candidates_packed, index.hash, index.bucket_starts,
            index.packed, index.offsets, codes, lengths, cfg, index.shift)
    else:
        rid, c, d, o, ok = call_buffer_safe(
            _candidates, index.hash, index.bucket_starts,
            index.contig, index.pos, index.is_rc, codes, lengths, cfg,
            index.shift)
    fb = jnp.asarray(flat_bases)
    N = int(codes.shape[0])
    win_c, win_d, win_o, mm, aligned, unique_ok = call_buffer_safe(
        _vote_and_verify_dense, c.reshape(N, -1), d.reshape(N, -1),
        o.reshape(N, -1), ok.reshape(N, -1), fb, index.offsets,
        codes, lengths, cfg)
    if cfg.rescue_band > 0:
        rescued, cost = call_buffer_safe(
            _gapped_rescue, win_c, win_d, win_o, aligned, fb,
            index.offsets, codes, lengths, cfg)
        rescued = rescued & unique_ok   # rescue fixes verify failures,
        aligned = aligned | rescued     # never ambiguity failures
        mm = jnp.where(rescued, cost, mm)
    return (np.asarray(win_c), np.asarray(win_d), np.asarray(win_o),
            np.asarray(mm), np.asarray(aligned))


@functools.partial(jax.jit, static_argnames=("L",))
def _unpack_jit(words, nmask, L: int):
    from allpathslg_tpu.dtypes import packed as pk

    return pk.unpack_codes(words, nmask, L)
