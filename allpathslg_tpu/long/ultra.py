"""Ultra: high-error (PacBio CLR ~15%) long-read consensus correction.

Behavior contract (ref: src/paths/long/ultra/ — the MultipleAligner /
ConsensusScoreModel machinery, SURVEY.md §2.5 long-read extensions): correct
noisy long reads by stacking each read's *friends* (reads sharing k-mer
content at a locus), aligning friend fragments against the read, and
re-calling every base — substitutions, deletions AND insertions — from the
aligned pileup. The reference does this with per-read multiple alignments;
at 15% error fixed-offset stacking (long/friends.correct_with_friends) is
useless because indels drift the frame by ±7% of the distance from any
anchor.

Device shape: alignment problems are WINDOWED — every (read, friend)
overlap is cut into fixed-size fragment-vs-window problems anchored at a
shared k-mer hit inside the window, so the residual drift within a problem
is bounded by band. All problems across all reads are solved in one batched
banded-DP sweep (vectorized anti-row DP + vectorized traceback, host numpy;
the same formulation ops/banded uses on device for scoring). Votes
scatter into global per-read pileup arrays; the consensus emit is a single
vectorized pass per read.

Cost model: sub=3, gap=2 (indel-dominant error profile; ins:del:sub is
~50:30:20 for CLR). Free fragment ends (glocal on the fragment axis), the
window axis fully consumed — a window base aligned to a fragment gap is a
deletion VOTE, a fragment base between window bases an insertion VOTE.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence, Tuple

import numpy as np

from allpathslg_tpu.kmer import bits, kmerize


@dataclasses.dataclass(frozen=True)
class UltraConfig:
    friend_k: int = 14        # anchor k-mer (0.85^2k of sites are clean pairs)
    window: int = 256         # target window width
    margin: int = 48          # fragment margin each side (also the band)
    max_run: int = 24         # cap per-kmer stack (repeat clip)
    max_frags_per_window: int = 12
    min_cov: int = 2          # friend coverage below which bases stay put
    rounds: int = 2
    sub_cost: int = 3
    gap_cost: int = 2


# ---------------------------------------------------------------------------
# friend hits: (a, b, apos, bpos, rc) — all pairs within equal-kmer runs
# ---------------------------------------------------------------------------


def _pack_reads(reads: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    lens = np.array([len(r) for r in reads], np.int64)
    L = int(lens.max())
    codes = np.full((len(reads), L), 4, np.uint8)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = r
    return codes, lens


def friend_hits(reads: Sequence[np.ndarray], K: int = 14,
                max_run: int = 24):
    """All-pairs k-mer hits between reads: arrays (a, b, apos, bpos, rc).

    a/b read ids, apos/bpos window positions in each read's OWN forward
    frame, rc True when the two windows matched in opposite orientation.
    Pairs within an equal-canonical-kmer run of the device sort, capped at
    max_run tuples per run (repeat clip, as the reference's friend finder
    caps stack growth). At CLR error rates runs are tiny (~coverage x
    0.85^2K), so all-pairs stays linear in practice.
    """
    import jax.numpy as jnp
    from jax import lax
    from allpathslg_tpu.ops import sort as ops_sort

    codes, lens = _pack_reads(reads)
    cj = jnp.asarray(codes)
    canon, valid = kmerize.kmer_windows(cj, K)
    fwd, _ = kmerize.kmer_windows_fwd(cj, K)
    is_rc = jnp.zeros_like(valid)
    for wf, wc in zip(fwd, canon):
        is_rc = is_rc | (wf != wc)
    N, P = valid.shape
    flat, _ = kmerize.flatten_kmers(canon, valid, K)
    read = jnp.repeat(jnp.arange(N, dtype=jnp.int32), P)
    pos = jnp.tile(jnp.arange(P, dtype=jnp.int32), N)
    skeys = lax.sort(flat + [read.view(jnp.uint32), pos.view(jnp.uint32),
                             is_rc.reshape(-1).astype(jnp.uint32)],
                     num_keys=len(flat), dimension=0, is_stable=False)
    starts = ops_sort.run_starts(list(skeys[: len(flat)]))
    sent = jnp.ones_like(skeys[0], bool)
    for w in skeys[: len(flat)]:
        sent = sent & (w == jnp.uint32(0xFFFFFFFF))

    read = np.asarray(skeys[len(flat)].view(jnp.int32))
    pos = np.asarray(skeys[len(flat) + 1].view(jnp.int32))
    rcf = np.asarray(skeys[len(flat) + 2]).astype(bool)
    starts = np.asarray(starts)
    keep = ~np.asarray(sent)
    run_id = np.cumsum(starts) - 1
    run_id, read, pos, rcf = (x[keep] for x in (run_id, read, pos, rcf))
    if len(read) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z, z.astype(bool)

    first = np.searchsorted(run_id, run_id, side="left")
    within = np.arange(len(read)) - first
    clip = within < max_run
    run_id, read, pos, rcf = (x[clip] for x in (run_id, read, pos, rcf))
    # recompute run extents on the clipped arrays (stale pre-clip indices
    # would mix coordinate systems)
    first = np.searchsorted(run_id, run_id, side="left")
    within = np.arange(len(read)) - first
    last = np.searchsorted(run_id, run_id, side="right")  # exclusive
    rl = last - first
    # all ordered pairs (i, j), i != j, within each run: expand via repeat
    tot = int((rl * (rl - 1)).sum()) if len(rl) else 0
    if tot == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z, z.astype(bool)
    # row r of run appears (rl-1) times as "a"
    a_idx = np.repeat(np.arange(len(read)), rl - 1)
    # partner index: enumerate run members excluding self
    k = (np.arange(len(a_idx))
         - np.repeat(np.cumsum(np.concatenate([[0], (rl - 1)[:-1]])),
                     rl - 1))
    b_idx = np.repeat(first, rl - 1) + k + (k >= np.repeat(within, rl - 1))
    a, b = read[a_idx], read[b_idx]
    apos, bpos = pos[a_idx], pos[b_idx]
    rc = rcf[a_idx] != rcf[b_idx]
    ok = a != b
    return (a[ok].astype(np.int64), b[ok].astype(np.int64),
            apos[ok].astype(np.int64), bpos[ok].astype(np.int64), rc[ok])


# ---------------------------------------------------------------------------
# batched banded DP with traceback — DEVICE path (VERDICT r3 Next #6)
# ---------------------------------------------------------------------------


def _banded_votes_kernel(win, frag, flen, wlen, Lt: int, Lq: int,
                         band: int, sub: int, gap: int):
    """Device DP + traceback for one padded problem chunk.

    Same recurrence as the host oracle `_banded_votes_host` (band slot
    scheme shared with ops/affine.py: window row i, slot k ↔ fragment
    j = i + band + k - band; diag = same slot prev row, up = slot k+1
    prev row, left = slot k-1 same row, with the within-row left chain
    collapsed by the min-plus cummin trick). The forward pass records
    2-bit choices; traceback replays them in a lax.scan emitting one
    (window pos, kind, base) event per problem per step.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    B = win.shape[0]
    W2 = 2 * band + 1
    BIG = jnp.int32(1 << 20)
    off0 = band
    ks = jnp.arange(W2, dtype=jnp.int32)
    flen_c = jnp.minimum(flen, Lq).astype(jnp.int32)
    wlen_c = jnp.minimum(wlen, Lt).astype(jnp.int32)

    j0 = ks[None, :] + off0 - band          # fragment j at i=0
    D0 = jnp.where((j0 >= 0) & (j0 <= flen_c[:, None]), 0, BIG)

    winj = win.astype(jnp.int32)
    fragj = frag.astype(jnp.int32)

    def step(carry, i):
        Dp, Dend = carry                     # [B, W2] each
        j = i + off0 + ks - band             # [W2]
        jv = (j >= 1) & (j <= Lq)
        fj = jnp.where(jv[None, :],
                       fragj[:, jnp.clip(j - 1, 0, Lq - 1)], 4)
        wb = winj[:, jnp.clip(i - 1, 0, Lt - 1)][:, None]
        sub_c = jnp.where((fj == wb) & (fj < 4) & (wb < 4), 0, sub)
        diag = Dp + sub_c
        diag = jnp.where(jv[None, :] & (j[None, :] - 1 <= flen_c[:, None]),
                         diag, BIG)
        up = jnp.concatenate([Dp[:, 1:], jnp.full((B, 1), BIG)], 1) + gap
        cur = jnp.minimum(diag, up)
        # left chain: r_k = k*gap + cummin_{k'<=k}(cur_k' - k'*gap)
        ramp = ks * gap
        r = lax.cummin(cur - ramp[None, :], axis=1) + ramp[None, :]
        is_left = r < cur
        cur = jnp.minimum(cur, r)
        jok = (j[None, :] >= 0) & (j[None, :] <= flen_c[:, None])
        cur = jnp.where(jok, cur, BIG)
        # choice: 0 diag, 1 up, 2 left (host tie order: diag > up > left)
        choice = jnp.where(is_left & jok, jnp.int8(2),
                           jnp.where(diag <= up, jnp.int8(0), jnp.int8(1)))
        Dend = jnp.where((i == wlen_c)[:, None], cur, Dend)
        return (cur, Dend), choice

    (Dlast, Dend), choices = lax.scan(
        step, (D0, jnp.where((0 == wlen_c)[:, None], D0, BIG)),
        jnp.arange(1, Lt + 1, dtype=jnp.int32))
    # choices: [Lt, B, W2]

    end_k = jnp.argmin(Dend, axis=1).astype(jnp.int32)
    best = jnp.min(Dend, axis=1)
    alive0 = (best < BIG) & \
        (best < (1.3 * jnp.maximum(wlen_c, 1)).astype(jnp.int32))

    bidx = jnp.arange(B, dtype=jnp.int32)
    ch_flat = choices.reshape(-1)            # [(Lt)*B*W2]

    def tb_step(carry, _):
        i, k, alive = carry
        act = alive & (i > 0)
        ii = jnp.maximum(i, 1)
        ch = ch_flat[((ii - 1) * B + bidx) * W2 + k]
        is_diag = act & (ch == 0)
        is_up = act & (ch == 1)
        is_left = act & (ch == 2)
        j = i + off0 + k - band
        fj = jnp.where((j >= 1) & (j <= Lq),
                       fragj[bidx, jnp.clip(j - 1, 0, Lq - 1)], 4)
        ev_i = jnp.where(is_diag | is_up, i - 1,
                         jnp.where(is_left, i, -1))
        ev_kind = jnp.where(is_diag, 0, jnp.where(is_up, 1, 2)) \
            .astype(jnp.int8)
        ev_base = jnp.where(is_up, 0, fj).astype(jnp.int8)
        i2 = i - (is_diag | is_up).astype(jnp.int32)
        k2 = jnp.where(is_up, jnp.minimum(k + 1, W2 - 1),
                       jnp.where(is_left, jnp.maximum(k - 1, 0), k))
        return (i2, k2, alive), (ev_i, ev_kind, ev_base)

    n_steps = Lt + Lq + 2
    (_, _, _), (tev_i, tev_kind, tev_base) = lax.scan(
        tb_step, (wlen_c, end_k, alive0), None, length=n_steps)
    return tev_i, tev_kind, tev_base          # [n_steps, B] each


def _banded_votes(win: np.ndarray, frag: np.ndarray, flen: np.ndarray,
                  wlen: np.ndarray, band: int, sub: int, gap: int,
                  chunk: int = 8192):
    """Device-batched banded DP + traceback (jit, lax.scan); returns the
    same event tuple as the host oracle. Problems stream in fixed-size
    chunks so the compiled kernel count stays O(1)."""
    import jax
    import jax.numpy as jnp

    B, Lt = win.shape
    Lq = frag.shape[1]
    if B == 0:
        z = np.zeros(0, np.int64)
        return z, z.astype(np.int8), z.astype(np.int8), z
    kern = jax.jit(functools.partial(
        _banded_votes_kernel, Lt=Lt, Lq=Lq, band=band, sub=sub, gap=gap))
    out_i, out_k, out_b, out_p = [], [], [], []
    for s in range(0, B, chunk):
        e = min(s + chunk, B)
        n = e - s
        pad = chunk - n if B > chunk else 0
        wv, fv = win[s:e], frag[s:e]
        fl, wl = flen[s:e], wlen[s:e]
        if pad:
            wv = np.concatenate([wv, np.full((pad, Lt), 4, np.uint8)])
            fv = np.concatenate([fv, np.full((pad, Lq), 4, np.uint8)])
            fl = np.concatenate([fl, np.zeros(pad, fl.dtype)])
            wl = np.concatenate([wl, np.zeros(pad, wl.dtype)])
        ti, tk, tb = kern(jnp.asarray(wv), jnp.asarray(fv),
                          jnp.asarray(fl), jnp.asarray(wl))
        ti = np.asarray(ti)[:, :n]
        tk = np.asarray(tk)[:, :n]
        tb = np.asarray(tb)[:, :n]
        m = ti >= 0
        probs = np.broadcast_to(np.arange(s, e, dtype=np.int64)[None, :],
                                ti.shape)
        out_i.append(ti[m].astype(np.int64))
        out_k.append(tk[m])
        out_b.append(tb[m])
        out_p.append(probs[m])
    return (np.concatenate(out_i), np.concatenate(out_k),
            np.concatenate(out_b), np.concatenate(out_p))


# ---------------------------------------------------------------------------
# batched banded DP with traceback (host numpy oracle — kept for tests)
# ---------------------------------------------------------------------------


def _banded_votes_host(win: np.ndarray, frag: np.ndarray, flen: np.ndarray,
                       wlen: np.ndarray, band: int, sub: int, gap: int):
    """Align each fragment to its window; return per-problem vote events.

    win  [B, Lt] uint8 window bases (the read being corrected); rows padded 4
    frag [B, Lq] uint8 fragment bases; glocal — free fragment ends
    Returns (ev_i, ev_kind, ev_base, ev_prob): alignment events with
    ev_kind 0=match/sub (base at window pos i), 1=del (window pos i against
    gap), 2=ins (base between window pos i-1 and i).
    """
    B, Lt = win.shape
    Lq = frag.shape[1]
    W2 = 2 * band + 1
    BIG = np.int32(1 << 20)
    # D[i, :, k]: cost for window prefix i, fragment position
    # j = i + band + k - band = i + k  (anchor maps window i -> fragment
    # i + band: fragments carry a `band`-wide margin before the anchor)
    off0 = band
    D = np.full((Lt + 1, B, W2), BIG, np.int32)
    j0 = np.arange(W2) + off0 - band  # fragment j at i=0
    D[0][:, :] = np.where((j0 >= 0) & (j0[None, :] <= flen[:, None]), 0, BIG)
    ks = np.arange(W2)
    for i in range(1, Lt + 1):
        j = i + off0 + ks - band              # [W2] fragment position
        jv = (j >= 1) & (j <= Lq)
        # fragment base at j-1 per problem
        fj = np.where(jv[None, :], frag[:, np.clip(j - 1, 0, Lq - 1)], 4)
        wb = win[:, i - 1][:, None]
        diag = D[i - 1] + np.where((fj == wb) & (fj < 4) & (wb < 4), 0, sub)
        diag = np.where(jv[None, :] & (j[None, :] - 1 <= flen[:, None]),
                        diag, BIG)
        up = np.concatenate([D[i - 1][:, 1:], np.full((B, 1), BIG)],
                            axis=1) + gap    # window base vs gap
        cur = np.minimum(diag, up)
        # left (fragment base vs gap, same i): min-plus prefix along k
        run = np.full(B, BIG, np.int64)
        curT = cur.T  # [W2, B] view for the scan
        for k in range(W2):
            run = np.minimum(run + gap, curT[k])
            curT[k] = run
        # forbid j out of range for this i
        D[i] = np.where((j[None, :] >= 0) &
                        (j[None, :] <= np.minimum(Lq, flen)[:, None]),
                        cur, BIG)
    # free fragment suffix: end at (wlen, any j >= anchor)  — per problem,
    # the window may be shorter than Lt (ragged): gather row wlen[b]
    Dend = D[wlen, np.arange(B)]              # [B, W2]
    end_k = Dend.argmin(axis=1)
    # vectorized traceback: all problems walk together
    i = wlen.astype(np.int64).copy()
    k = end_k.astype(np.int64)
    best = Dend[np.arange(B), end_k]
    # misanchor filter: a genuine overlap of two 15%-error reads costs
    # ~0.7-0.9 per window base; a spurious k-mer collision aligns at
    # ~75% difference (~1.8+/base). Excluding those keeps collision noise
    # out of the pileup (the reference's MultipleAligner keeps only
    # friends whose alignment validates).
    alive = (best < BIG) & (best < np.int64(1.3 * np.maximum(wlen, 1)))
    ev_i, ev_kind, ev_base, ev_prob = [], [], [], []
    bidx = np.arange(B)
    Dt = D  # [Lt+1, B, W2]
    for _ in range(Lt + Lq + 2):
        act = alive & (i > 0)
        if not act.any():
            break
        j = i + off0 + k - band
        cd = Dt[np.maximum(i - 1, 0), bidx, k]
        fj = np.where((j >= 1) & (j <= Lq),
                      frag[bidx, np.clip(j - 1, 0, Lq - 1)], 4)
        wb = win[bidx, np.clip(i - 1, 0, Lt - 1)]
        sub_c = np.where((fj == wb) & (fj < 4) & (wb < 4), 0, sub)
        cur = Dt[i, bidx, k]
        is_diag = act & (cd + sub_c == cur)
        ku = np.minimum(k + 1, W2 - 1)
        is_up = act & ~is_diag & (Dt[np.maximum(i - 1, 0), bidx, ku] + gap
                                  == cur) & (k + 1 < W2)
        kl = np.maximum(k - 1, 0)
        is_left = act & ~is_diag & ~is_up & (k - 1 >= 0) & \
            (Dt[i, bidx, kl] + gap == cur)
        # j == 0 with i > 0 can only go up (shouldn't occur in-band)
        stuck = act & ~is_diag & ~is_up & ~is_left
        is_up = is_up | stuck
        # emit events for active problems
        em = is_diag
        if em.any():
            ev_i.append(np.where(em, i - 1, -1))
            ev_kind.append(np.zeros(B, np.int8))
            ev_base.append(fj.astype(np.int8))
        dm = is_up
        if dm.any():
            ev_i.append(np.where(dm, i - 1, -1))
            ev_kind.append(np.ones(B, np.int8))
            ev_base.append(np.zeros(B, np.int8))
        lm = is_left
        if lm.any():
            ev_i.append(np.where(lm, i, -1))
            ev_kind.append(np.full(B, 2, np.int8))
            ev_base.append(fj.astype(np.int8))
        i = i - (is_diag | is_up)
        k = np.where(is_diag, k, np.where(is_up, k + 1,
                                          np.where(is_left, k - 1, k)))
    if not ev_i:
        z = np.zeros(0, np.int64)
        return z, z.astype(np.int8), z.astype(np.int8), z
    nev = len(ev_i)
    probs = np.tile(bidx, nev)
    ii = np.concatenate(ev_i)
    kk = np.concatenate(ev_kind)
    bb = np.concatenate(ev_base)
    m = ii >= 0
    return ii[m], kk[m], bb[m], probs[m]


# ---------------------------------------------------------------------------
# windowed correction driver
# ---------------------------------------------------------------------------


def correct_round(reads: List[np.ndarray], cfg: UltraConfig
                  ) -> Tuple[List[np.ndarray], int]:
    """One ultra correction round over all reads. Returns (new_reads,
    n_events_changed)."""
    a, b, apos, bpos, rc = friend_hits(reads, K=cfg.friend_k,
                                       max_run=cfg.max_run)
    lens = np.array([len(r) for r in reads], np.int64)
    if len(a) == 0:
        return [r.copy() for r in reads], 0
    Wn, M = cfg.window, cfg.margin
    # assign each hit to the window of its a-position; keep the hit closest
    # to its window's center per (a, b, rc, window)
    wid = apos // Wn
    center_d = np.abs((apos % Wn) - Wn // 2)
    gkey = (a << 40) | (b << 16) | (rc.astype(np.int64) << 15) | wid
    order = np.lexsort((center_d, gkey))
    gk_s = gkey[order]
    first = np.searchsorted(gk_s, gk_s, side="left")
    keep = order[np.unique(first)]
    a, b, apos, bpos, rc, wid = (x[keep] for x in (a, b, apos, bpos, rc, wid))

    # cap fragments per (a, window)
    awkey = a * (1 << 20) + wid
    order = np.argsort(awkey, kind="stable")
    awk_s = awkey[order]
    within = np.arange(len(order)) - np.searchsorted(awk_s, awk_s, "left")
    keep = order[within < cfg.max_frags_per_window]
    a, b, apos, bpos, rc, wid = (x[keep] for x in (a, b, apos, bpos, rc, wid))

    B = len(a)
    Lt, Lq = Wn, Wn + 2 * M
    win = np.full((B, Lt), 4, np.uint8)
    frag = np.full((B, Lq), 4, np.uint8)
    wlen = np.zeros(B, np.int64)
    flen = np.zeros(B, np.int64)
    wbase = wid * Wn
    # build problems (host gather loop — O(B) rows of memcpy)
    for p in range(B):
        r = reads[a[p]]
        ws = int(wbase[p])
        we = min(ws + Wn, len(r))
        win[p, : we - ws] = r[ws:we]
        wlen[p] = we - ws
        q = reads[b[p]]
        if rc[p]:
            qo = (3 - q[::-1]).astype(np.uint8)
            qo[q[::-1] > 3] = 4
            banchor = len(q) - cfg.friend_k - int(bpos[p])
        else:
            qo = q
            banchor = int(bpos[p])
        # fragment spans b-positions matching [ws - M, ws - M + Lq) of a
        fs = banchor - (int(apos[p]) - ws) - M
        fe = fs + Lq
        cs, ce = max(0, fs), min(len(qo), fe)
        if ce <= cs:
            continue
        frag[p, cs - fs : ce - fs] = qo[cs:ce]
        flen[p] = ce - fs
    # window j=0 corresponds to fragment j offset: the anchor alignment has
    # window pos i matching fragment pos i + M → band centered at +M
    # shift fragment left by M is implicit in construction; band covers ±M
    ev_i, ev_kind, ev_base, ev_prob = _banded_votes(
        win, frag, flen, wlen, band=M, sub=cfg.sub_cost, gap=cfg.gap_cost)

    # global vote arrays over concatenated read coordinates
    off = np.zeros(len(reads) + 1, np.int64)
    off[1:] = np.cumsum(lens)
    G = int(off[-1])
    sub_votes = np.zeros((G, 4), np.int32)
    del_votes = np.zeros(G, np.int32)
    ins_votes = np.zeros((G + len(reads), 4), np.int32)  # +1 slot per read
    cover = np.zeros(G, np.int32)

    gpos = off[a[ev_prob]] + wbase[ev_prob] + ev_i
    rd = a[ev_prob]
    mm = ev_kind == 0
    okb = mm & (ev_base < 4)
    np.add.at(sub_votes, (gpos[okb], ev_base[okb].astype(np.int64)), 1)
    np.add.at(cover, gpos[mm], 1)
    dd = ev_kind == 1
    np.add.at(del_votes, gpos[dd], 1)
    np.add.at(cover, gpos[dd], 1)
    ii = ev_kind == 2
    ipos = off[rd[ii]] + rd[ii] + wbase[ev_prob[ii]] + ev_i[ii]
    oki = ev_base[ii] < 4
    np.add.at(ins_votes, (ipos[oki] , ev_base[ii][oki].astype(np.int64)), 1)

    # consensus emit per read (vectorized per read)
    out: List[np.ndarray] = []
    n_changed = 0
    for r in range(len(reads)):
        s, e = off[r], off[r + 1]
        L = int(e - s)
        sv = sub_votes[s:e].copy()
        base = reads[r][:L]
        okb_ = base < 4
        sv[np.arange(L)[okb_], base[okb_]] += 1          # self vote
        dv = del_votes[s:e]
        cv = cover[s:e] + 1
        iv = ins_votes[s + r : e + r + 1]
        deep = cv - 1 >= cfg.min_cov
        drop = deep & (2 * dv > cv)
        call = np.where(deep, sv.argmax(axis=1).astype(np.uint8), base)
        ins_best = iv.argmax(axis=1).astype(np.uint8)
        ins_n = iv.max(axis=1)
        # insert before position i when a majority of covering friends saw
        # an extra base there (coverage at the junction ~ cover of i)
        covj = np.concatenate([cv, cv[-1:]])[: L + 1]
        do_ins = (ins_n * 2 > covj) & \
            (np.concatenate([deep, deep[-1:]])[: L + 1])
        # build output
        pieces = []
        n_changed += int((call != base).sum()) + int(drop.sum()) \
            + int(do_ins.sum())
        keepm = ~drop
        if not do_ins.any():
            pieces = call[keepm]
        else:
            outbuf = []
            ins_at = np.flatnonzero(do_ins)
            prev = 0
            for t in ins_at:
                outbuf.append(call[prev:t][keepm[prev:t]])
                outbuf.append(ins_best[t : t + 1])
                prev = t
            outbuf.append(call[prev:][keepm[prev:]])
            pieces = np.concatenate(outbuf)
        out.append(np.asarray(pieces, np.uint8))
    return out, n_changed


def correct_long_reads(reads: Sequence[np.ndarray],
                       cfg: UltraConfig = UltraConfig()
                       ) -> Tuple[List[np.ndarray], dict]:
    """Ultra consensus correction: iterated windowed friend-pileup rounds.

    Returns (corrected reads, metrics). 15% CLR-class input typically drops
    to ~1-2% after two rounds (test_longproto_ultra oracle)."""
    cur = [np.asarray(r, np.uint8) for r in reads]
    metrics = {}
    for rnd in range(cfg.rounds):
        cur, n = correct_round(cur, cfg)
        metrics[f"round{rnd}_events"] = int(n)
        if n == 0:
            break
    return cur, metrics
