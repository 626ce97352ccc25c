"""Phase-1 pre-correction: 25-mer stack majority voting.

Behavior contract (ref: src/paths/FindErrors.cc phase 1 / PreCorrect,
SURVEY.md §2.5 row 3 and §3.2): pile up all 25-mers sharing the same 24-base
context (12 bases each side of the center), majority-vote the center base
when a dominant alternative exists, and never touch high-quality disagreeing
bases.

Device shape: each interior base of each read is the center of exactly ONE
25-window, so votes come back as a dense [N, P] array — corrections apply
with a plain `where`, no scatter. Stacks are strand-neutral: windows orient
by the lexicographically smaller of (context, rc(context)) with the center
bits masked, and the center base complements along.

Per-stack per-base tallies use cumsum-difference segmented sums (no
scatters): four one-hot sums + four max-qual reductions.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from allpathslg_tpu.kmer import bits, kmerize
from allpathslg_tpu.ops import sort as ops_sort
from allpathslg_tpu.ops import segmented

K_PRE = 25
CENTER = 12  # self-mirroring position: 24 - 12 == 12


@dataclasses.dataclass(frozen=True)
class PrecorrectConfig:
    min_winner: int = 6        # dominant base needs this many observations
    qual_protect: int = 30     # protect recurrent (>=2x) bases at/above this qual
    min_ratio: int = 8         # winner/loser count ratio


@functools.partial(jax.jit, static_argnames=("cfg",))
def precorrect(codes: jnp.ndarray, quals: jnp.ndarray,
               cfg: PrecorrectConfig = PrecorrectConfig()) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (corrected_codes, n_corrections)."""
    N, L = codes.shape
    P = L - K_PRE + 1
    fwd, valid = kmerize.kmer_windows_fwd(codes, K_PRE)

    # strand-neutral context orientation: mask center bits, compare fwd vs rc
    ctx_f = bits.mask_base(fwd, CENTER)
    rc = bits.rc_words(fwd, K_PRE)
    ctx_r = bits.mask_base(rc, CENTER)  # rc center lands back at CENTER
    use_rc = bits.lex_less(ctx_r, ctx_f)
    key = bits.select_words(use_rc, ctx_r, ctx_f)

    center_in_read = codes[:, CENTER : CENTER + P].astype(jnp.int32)
    center = jnp.where(use_rc, 3 - center_in_read, center_in_read)
    cqual = quals[:, CENTER : CENTER + P].astype(jnp.int32)

    # flatten + sentinel invalid
    T = N * P
    sent = jnp.uint32(0xFFFFFFFF)
    vm = valid.reshape(-1)
    fkey = [jnp.where(vm, w.reshape(-1), sent) for w in key]
    fcen = jnp.where(vm, center.reshape(-1), 0)
    fq = jnp.where(vm, cqual.reshape(-1), 0)
    slot = jnp.arange(T, dtype=jnp.int32)  # to route votes back

    skeys, spay = ops_sort.sort_by_words(fkey, [fcen, fq, slot])
    scen, squal, sslot = spay
    starts = ops_sort.run_starts(skeys)
    rl = segmented.run_lengths(starts)
    start_pos = jnp.arange(T, dtype=jnp.int32) - segmented.position_in_run(starts)
    rl_all = rl[start_pos]  # run length broadcast to members

    # per-stack per-base counts and max quals (cumsum-diff, no scatter)
    def sum_per_run_broadcast(vals):
        return _sum_per_run_at_starts(vals, starts, rl)[start_pos]

    n_b = []
    q_b = []
    for b in range(4):
        oneb = (scen == b).astype(jnp.int32)
        n_b.append(sum_per_run_broadcast(oneb))
        q_b.append(sum_per_run_broadcast(oneb * squal))
    n_b = jnp.stack(n_b, axis=-1)   # [T, 4]
    q_b = jnp.stack(q_b, axis=-1)

    own = scen
    own_n = jnp.take_along_axis(n_b, own[:, None], axis=1)[:, 0]
    winner = jnp.argmax(n_b, axis=-1).astype(jnp.int32)
    win_n = jnp.take_along_axis(n_b, winner[:, None], axis=1)[:, 0]

    # a singleton minority is correctable at any quality; a recurrent
    # minority (>=2 observations, e.g. a het allele) is protected once its
    # quality is high (ref: PreCorrect's high-quality-disagreement guard)
    protected = (squal >= cfg.qual_protect) & (own_n >= 2)
    fix = (
        (own != winner)
        & (win_n >= cfg.min_winner)
        & (win_n >= cfg.min_ratio * jnp.maximum(own_n, 1))
        & ~protected
        & ~bits.is_sentinel(skeys)
    )

    # route decisions back to window slots (scatter over T — one int32 array)
    new_center = jnp.full(T, -1, dtype=jnp.int32)
    new_center = new_center.at[sslot].set(jnp.where(fix, winner, -1))
    new_center = new_center.reshape(N, P)

    # un-orient and apply to the dense interior band
    do_fix = new_center >= 0
    fixed_val = jnp.where(use_rc, 3 - new_center, new_center)
    interior = codes[:, CENTER : CENTER + P].astype(jnp.int32)
    updated = jnp.where(do_fix, fixed_val, interior).astype(jnp.uint8)
    out = codes.at[:, CENTER : CENTER + P].set(updated)
    return out, jnp.sum(do_fix)


def _sum_per_run_at_starts(values, starts, rl):
    """Sum of values over each run, at run-start positions (0 elsewhere)."""
    cs = jnp.cumsum(values)
    T = values.shape[0]
    idx = jnp.arange(T, dtype=jnp.int32)
    last = jnp.clip(idx + rl - 1, 0, T - 1)
    before = jnp.where(idx > 0, cs[jnp.maximum(idx - 1, 0)], 0)
    return jnp.where(rl > 0, cs[last] - before, 0)


# ---------------------------------------------------------------------------
# Global (all-reads) stacks — the scale-correct path.
#
# The jitted `precorrect` above piles stacks WITHIN one batch; at genome
# scale a 65k-read batch holds ~1x coverage and stacks never reach
# min_winner (observed: 26 corrections on 4.6 Mb/100x vs ~15k/Mb expected).
# The reference piles 25-mer stacks over the WHOLE read set via hash-block
# passes (ref: src/kmers/naif_kmer/NaifKmerizer.cc driving PreCorrect).
# Here: pass 1 streams batches into a global (context, base) -> count table
# (3-word keys through the generic count machinery); pass 2 re-streams and
# votes each window against the global table via searchsorted joins — no
# sort in the apply pass at all.
# ---------------------------------------------------------------------------


def _orient_windows(codes, quals):
    """Strand-neutral per-window records: oriented masked-context key
    (2 words), oriented center base, center qual, valid mask, rc flag —
    all in [N, P] layout."""
    N, L = codes.shape
    P = L - K_PRE + 1
    fwd, valid = kmerize.kmer_windows_fwd(codes, K_PRE)
    ctx_f = bits.mask_base(fwd, CENTER)
    rc = bits.rc_words(fwd, K_PRE)
    ctx_r = bits.mask_base(rc, CENTER)
    use_rc = bits.lex_less(ctx_r, ctx_f)
    key = bits.select_words(use_rc, ctx_r, ctx_f)
    center_in_read = codes[:, CENTER : CENTER + P].astype(jnp.int32)
    center = jnp.where(use_rc, 3 - center_in_read, center_in_read)
    cqual = quals[:, CENTER : CENTER + P].astype(jnp.int32)
    return key, center, cqual, valid, use_rc


@jax.jit
def precorrect_stats_batch(codes: jnp.ndarray, quals: jnp.ndarray):
    """Compact (context, base) -> count table for one batch (3-word keys:
    ctx_w0, ctx_w1, base)."""
    from allpathslg_tpu.kmer import count as kcount

    key, center, _, valid, _ = _orient_windows(codes, quals)
    sent = jnp.uint32(0xFFFFFFFF)
    vm = valid.reshape(-1)
    words = [jnp.where(vm, w.reshape(-1), sent) for w in key]
    words.append(jnp.where(vm, center.reshape(-1).astype(jnp.uint32), sent))
    skeys, counts, starts = kcount.count_sorted(words)
    return kcount.compact_table(skeys, counts, starts)


@functools.partial(jax.jit, static_argnames=("L",))
def precorrect_stats_batch_packed(words, nmask, qnib, qpal, L: int):
    """precorrect_stats_batch over a 2-bit packed batch (dtypes/packed):
    unpack fuses into the program; the host->device link moves ~4x fewer
    bytes — the binding cost at genome scale (see count_reads_packed)."""
    from allpathslg_tpu.dtypes import packed as pk

    return precorrect_stats_batch(pk.unpack_codes(words, nmask, L),
                                  pk.unpack_quals(qnib, qpal, L))


@functools.partial(jax.jit, static_argnames=("L", "n_blocks"))
def precorrect_stats_batch_packed_blocked(words, nmask, qnib, qpal, L: int,
                                          blk, n_blocks: int):
    """Hash-block slice of the batch stack stats (ref: NaifKmerizer
    hash-block passes): rows whose context-hash block != blk become
    sentinels, so per-block unique volume is ~1/n_blocks and the global
    accumulator never spills off-device. `blk` is traced — one compile serves
    all blocks."""
    from allpathslg_tpu.dtypes import packed as pk

    codes = pk.unpack_codes(words, nmask, L)
    quals = pk.unpack_quals(qnib, qpal, L)
    from allpathslg_tpu.kmer import count as kcount

    key, center, _, valid, _ = _orient_windows(codes, quals)
    h = bits.hash_words([w.reshape(-1) for w in key])
    vm = valid.reshape(-1) & ((h % jnp.uint32(n_blocks))
                              == jnp.uint32(0) + blk)
    sent = jnp.uint32(0xFFFFFFFF)
    ws = [jnp.where(vm, w.reshape(-1), sent) for w in key]
    ws.append(jnp.where(vm, center.reshape(-1).astype(jnp.uint32), sent))
    skeys, counts, starts = kcount.count_sorted(ws)
    return kcount.compact_table(skeys, counts, starts)


@functools.partial(jax.jit, static_argnames=("L", "cfg"))
def precorrect_apply_batch_packed(words, nmask, qnib, qpal, L: int,
                                  table_words, table_counts,
                                  cfg: "PrecorrectConfig"):
    """Packed-in, packed-out apply: corrected codes return as 2-bit words
    (+ N mask), cutting the download ~2.7x as well."""
    from allpathslg_tpu.dtypes import packed as pk

    out, k = precorrect_apply_batch(pk.unpack_codes(words, nmask, L),
                                    pk.unpack_quals(qnib, qpal, L),
                                    table_words, table_counts, cfg)
    ow, om = pk.pack_codes_device(out)
    return ow, om, k


@functools.partial(jax.jit, static_argnames=("cfg",))
def precorrect_apply_batch(codes, quals, table_words, table_counts,
                           cfg: PrecorrectConfig = PrecorrectConfig()):
    """Vote every window of one batch against the global stack table.

    table_words: 3 sorted uint32 arrays [M] (ctx_w0, ctx_w1, base);
    table_counts: int32 [M]. Returns (corrected_codes, n_corrections)."""
    from allpathslg_tpu.ops import join

    N, L = codes.shape
    P = L - K_PRE + 1
    key, center, cqual, valid, use_rc = _orient_windows(codes, quals)
    flat_ctx = [w.reshape(-1) for w in key]
    n_b = []
    for b in range(4):
        q = flat_ctx + [jnp.full_like(flat_ctx[0], b)]
        if isinstance(table_words, join.HashedTable):
            # hash-bucketed exact lookup: one bucket gather per query in
            # place of a binary search
            cnt, _ = join.payload_hashed(table_words, 0, q, 0)
        else:
            cnt, _ = join.lookup_payload(table_words, table_counts, q, 0)
        n_b.append(cnt)
    n_b = jnp.stack(n_b, axis=-1)                     # [N*P, 4]

    own = center.reshape(-1)
    own_n = jnp.take_along_axis(n_b, own[:, None], axis=1)[:, 0]
    winner = jnp.argmax(n_b, axis=-1).astype(jnp.int32)
    win_n = jnp.take_along_axis(n_b, winner[:, None], axis=1)[:, 0]
    squal = cqual.reshape(-1)
    protected = (squal >= cfg.qual_protect) & (own_n >= 2)
    fix = (
        (own != winner)
        & (win_n >= cfg.min_winner)
        & (win_n >= cfg.min_ratio * jnp.maximum(own_n, 1))
        & ~protected
        & valid.reshape(-1)
    )
    new_center = jnp.where(fix, winner, -1).reshape(N, P)
    do_fix = new_center >= 0
    fixed_val = jnp.where(use_rc, 3 - new_center, new_center)
    interior = codes[:, CENTER : CENTER + P].astype(jnp.int32)
    updated = jnp.where(do_fix, fixed_val, interior).astype(jnp.uint8)
    out = codes.at[:, CENTER : CENTER + P].set(updated)
    return out, jnp.sum(do_fix)


def precorrect_global_resident(db, cfg: PrecorrectConfig = PrecorrectConfig(),
                               log=None, n_blocks: int = None):
    """Two-pass global pre-correction over a DEVICE-RESIDENT batch cache
    (dtypes/devcache.DeviceBatches): zero read uploads — pass 1 builds
    the global stack table from resident batches, pass 2 corrects them
    in place (packed outputs replace the resident words; nothing crosses
    the host->device link). Returns n_corrections.

    Pass 1 runs in HASH-BLOCK passes (ref: NaifKmerizer's hash-block
    multi-pass driving PreCorrect): at genome scale the raw
    (context, base) table is dominated by error singletons (~1 novel
    context per error-read position) and a single-pass accumulator
    spills multi-GB to host. Blocks partition the key space, so the per-block
    min_count>=2 filter kills singletons with GLOBALLY correct
    semantics, each block's accumulator stays resident, and only the
    small filtered block tables survive (concat + recount on device)."""
    from allpathslg_tpu.kmer import count as kcount

    say = log or (lambda *a: None)
    rows_per_batch = db.batch * max(db.L - K_PRE + 1, 1)
    total_rows = db.n_batches * rows_per_batch
    # worst-case uniques ~ 0.5x raw rows (error singletons); keep each
    # block's accumulator ~<=0.75 GB of HBM. Tables hold 4 arrays x 4 B
    # per row (3 key words + counts); the 20 B/row figure keeps ~25%
    # deliberate slack for sort scratch.
    if n_blocks is None:
        n_blocks = max(1, -(-int(total_rows * 0.5) * 20 // (768 << 20)))
    say(f"  [precorrect] pass 1: {db.n_batches} batches x "
        f"{n_blocks} hash blocks")
    block_tables = []
    for blk in range(n_blocks):
        sc = kcount.StreamingCounter()
        for i in range(db.n_batches):
            sc.add(precorrect_stats_batch_packed_blocked(
                db.words[i], db.nmask[i], db.qnib[i], db.qpal[i], db.L,
                jnp.uint32(blk), n_blocks))
        t = sc.finish(min_count=min(2, cfg.min_winner))
        block_tables.append(t)
        say(f"  [precorrect] block {blk}: {int(t.n_unique)} strong rows")
    if len(block_tables) > 1:
        # disjoint key spaces: recount = sorted merge, stays on device
        merged = kcount.merge_tables(block_tables)
    else:
        merged = block_tables[0]
    merged = kcount.pad_table_quantized(merged)
    from allpathslg_tpu.ops import join as _join
    ht = _join.hash_table(list(merged.words), payloads=[merged.counts])
    tw, tc = ht, None
    say(f"  [precorrect] stack table hashed (scan depth H={ht.H})")

    say(f"  [precorrect] pass 2: voting {db.n_batches} batches")
    total = 0
    for i in range(db.n_batches):
        ow, om, k = precorrect_apply_batch_packed(
            db.words[i], db.nmask[i], db.qnib[i], db.qpal[i], db.L,
            tw, tc, cfg)
        db.update_codes(i, ow, om)
        total += int(k)
        if (i + 1) % 10 == 0 or i + 1 == db.n_batches:
            say(f"  [precorrect] voted {i + 1}/{db.n_batches} batches "
                f"({total} corrections)")
    return total


def precorrect_global(codes, quals, cfg: PrecorrectConfig = PrecorrectConfig(),
                      batch_size: int = 65536):
    """Two-pass global pre-correction over a host read set (numpy in/out).

    Pass 1 builds the global (context, base) count table (count-1 rows are
    dropped: they cannot win a vote, cannot be a >=2 protected minority, and
    with max(own_n, 1) an absent own row scores identically to count 1).
    Pass 2 corrects each batch against the table.
    """
    import numpy as np

    from allpathslg_tpu.kmer import count as kcount

    from allpathslg_tpu.dtypes import packed as pk

    n, L = codes.shape
    sc = kcount.StreamingCounter()
    for s in range(0, n, batch_size):
        cb, qb = _pad_slice(codes, quals, s, batch_size)
        w, m, Lb = pk.pack_codes(cb)
        qn, qp, _ = pk.pack_quals(qb)
        sc.add(precorrect_stats_batch_packed(
            jnp.asarray(w), jnp.asarray(m),
            None if qn is None else jnp.asarray(qn), jnp.asarray(qp), Lb))
    # table stays DEVICE-resident, padded to a quantized capacity so the
    # apply pass compiles once per size bucket (sentinel rows never match)
    # count-1 rows are droppable only when min_winner >= 2 (a count-1 row
    # can neither win a vote nor be a >=2 protected minority); with
    # min_winner == 1 they must be kept or semantics diverge from the
    # single-batch path (ADVICE r2).
    merged = kcount.pad_table_quantized(
        sc.finish(min_count=min(2, cfg.min_winner)))
    from allpathslg_tpu.ops import join as _join
    ht = _join.hash_table(list(merged.words), payloads=[merged.counts])
    tw, tc = ht, None

    out = np.empty_like(codes)
    total = 0
    for s in range(0, n, batch_size):
        cb, qb = _pad_slice(codes, quals, s, batch_size)
        w, m, Lb = pk.pack_codes(cb)
        qn, qp, _ = pk.pack_quals(qb)
        ow, om, k = precorrect_apply_batch_packed(
            jnp.asarray(w), jnp.asarray(m),
            None if qn is None else jnp.asarray(qn), jnp.asarray(qp), Lb,
            tw, tc, cfg)
        e = min(s + batch_size, n)
        out[s:e] = pk.unpack_codes_host(ow, om, Lb)[: e - s]
        total += int(k)
    return out, total


def _pad_slice(codes, quals, s: int, batch_size: int):
    import numpy as np

    e = min(s + batch_size, codes.shape[0])
    cb = np.asarray(codes[s:e])
    qb = np.asarray(quals[s:e])
    if e - s < batch_size:
        pad = batch_size - (e - s)
        cb = np.concatenate([cb, np.full((pad, cb.shape[1]), 4, cb.dtype)])
        qb = np.concatenate([qb, np.zeros((pad, qb.shape[1]), qb.dtype)])
    return cb, qb
