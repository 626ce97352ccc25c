"""Batched banded affine-gap alignment DP (cost only, device path).

Behavior contract (ref: src/pairwise_aligners/SmithWatAffine.{h,cc} —
SURVEY.md §2.2): align query q against target t around diagonal `offset`
with band half-width W under affine gap costs (mismatch `sub_cost`, gap
open `gap_open` charged once per gap run plus `gap_ext` per base). Glocal
semantics match ops/banded.py: the whole query aligns into a free target
window (D[0][j] = 0, answer = min_j D[|q|][j]).

Band slot scheme is shared with ops/banded.py: in-band slot k of query row
r maps to target column j = r + offset - W + k, so the diagonal predecessor
stays in the same slot, the vertical one in slot k+1, and the horizontal
one in slot k-1 (same row). Affine state split:

  A[k]  = best cost at (r, j) arriving diagonally or vertically
  Ix[k] = best cost at (r, j) inside a vertical (target-gap) run
  Iy[k] = best cost at (r, j) inside a horizontal (query-gap) run

Iy's within-row recurrence collapses with the min-plus prefix trick: a
horizontal run starting after state A[k'] costs gap_open + (k-k')*gap_ext,
and re-opening inside a run is never cheaper than extending, so
  Iy[k] = gap_open + k*gap_ext + cummin_{k'<k}(A[k'] - k'*gap_ext).

The full-path (traceback) variant lives in align/packalign.py (host numpy):
device kernels return score summaries, paths are host-side per the
alignment-representation plan (SURVEY.md §2.2 "Packed alignment repr").
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

BIG = np.int32(1 << 20)


@functools.partial(jax.jit, static_argnames=("band", "sub_cost", "gap_open",
                                              "gap_ext"))
def affine_banded_align(q: jnp.ndarray, q_len: jnp.ndarray,
                        t: jnp.ndarray, t_len: jnp.ndarray,
                        offset: jnp.ndarray, band: int = 16,
                        sub_cost: int = 3, gap_open: int = 4,
                        gap_ext: int = 1):
    """Batched banded glocal affine alignment.

    Args:
      q: uint8 [B, Lq] query codes (4 = pad beyond q_len).
      t: uint8 [B, Lt] target codes.
      offset: int32 [B] expected diagonal (query i ~ target i + offset).

    Returns (cost [B] int32, t_end [B] int32): minimal affine alignment
    cost and the (exclusive) target end column attaining it; (BIG, -1)
    when no in-band path exists.
    """
    B, Lq = q.shape
    Lt = t.shape[1]
    K = 2 * band + 1
    ks = jnp.arange(K, dtype=jnp.int32)[None, :]
    gk = ks * gap_ext
    offs = offset[:, None]
    tl = t_len[:, None]
    tt = t.astype(jnp.int32)

    # row 0: free target prefix. A = 0 on valid columns; no vertical run yet.
    j0 = offs - band + ks
    a0 = jnp.where((j0 >= 0) & (j0 <= tl), 0, BIG)
    ix0 = jnp.full((B, K), BIG)
    res0 = a0

    def step(carry, i):
        a_prev, ix_prev, result = carry
        r = i + 1
        j = r + offs - band + ks
        in_t = (j >= 1) & (j <= tl)
        jc = jnp.clip(j - 1, 0, Lt - 1)
        tb = jnp.take_along_axis(tt, jc, axis=1)
        qb = q[:, i][:, None].astype(jnp.int32)
        sub = jnp.where(tb == qb, 0, sub_cost)

        m_prev = jnp.minimum(a_prev, ix_prev)          # any-state prev row
        diag = m_prev + sub                            # slot k
        up_m = jnp.concatenate([m_prev[:, 1:], jnp.full((B, 1), BIG)], 1)
        up_ix = jnp.concatenate([ix_prev[:, 1:], jnp.full((B, 1), BIG)], 1)
        ix = jnp.minimum(up_m + gap_open + gap_ext, up_ix + gap_ext)
        a = jnp.minimum(diag, ix)
        a = jnp.where(in_t, a, BIG)
        # column 0 (empty target prefix consumed): pure vertical run
        col0 = gap_open + r * gap_ext
        a = jnp.where(j == 0, col0, a)
        ix = jnp.where(j == 0, col0, jnp.where(in_t, ix, BIG))
        # horizontal closure (min-plus prefix over the row)
        run = lax.cummin(a - gk, axis=1)
        run = jnp.concatenate([jnp.full((B, 1), BIG), run[:, :-1]], 1)
        iy = jnp.minimum(run + gk + gap_open, BIG)
        row = jnp.minimum(a, iy)
        row = jnp.where(in_t | (j == 0), row, BIG)
        result = jnp.where(q_len[:, None] == r, row, result)
        # carry A as the any-state row (Iy can be followed by diag/vertical)
        return (jnp.minimum(row, BIG), jnp.where(in_t | (j == 0), ix, BIG),
                result), None

    (a_fin, ix_fin, result), _ = lax.scan(
        step, (a0, ix0, res0), jnp.arange(Lq, dtype=jnp.int32))

    jf = q_len[:, None] + offs - band + ks
    ok = (jf >= 0) & (jf <= tl)
    vals = jnp.where(ok, result, BIG)
    cost = vals.min(axis=1)
    kbest = jnp.argmin(vals, axis=1).astype(jnp.int32)
    t_end = q_len + offset - band + kbest
    t_end = jnp.where(cost < BIG, t_end, -1)
    return cost, t_end


def np_affine_oracle(q, t, offset, band, sub_cost=3, gap_open=4, gap_ext=1):
    """Unbanded-with-mask numpy oracle (full 3-state affine DP), glocal."""
    Lq, Lt = len(q), len(t)
    INF = 1 << 20
    A = np.full((Lq + 1, Lt + 1), INF, np.int64)    # diag/vertical arrival
    IX = np.full((Lq + 1, Lt + 1), INF, np.int64)   # in vertical run
    IY = np.full((Lq + 1, Lt + 1), INF, np.int64)   # in horizontal run
    for j in range(Lt + 1):
        if abs(j - offset) <= band:
            A[0, j] = 0
    for i in range(1, Lq + 1):
        for j in range(0, Lt + 1):
            if abs(j - i - offset) > band:
                continue
            if j == 0:
                A[i, 0] = IX[i, 0] = gap_open + i * gap_ext
                continue
            prev_any = min(A[i - 1, j], IX[i - 1, j], IY[i - 1, j])
            if prev_any < INF:
                IX[i, j] = min(prev_any + gap_open + gap_ext,
                               IX[i - 1, j] + gap_ext)
            d = min(A[i - 1, j - 1], IX[i - 1, j - 1], IY[i - 1, j - 1])
            if d < INF:
                A[i, j] = d + (0 if q[i - 1] == t[j - 1] else sub_cost)
            A[i, j] = min(A[i, j], IX[i, j])
            left_any = min(A[i, j - 1], IY[i, j - 1])
            if A[i, j - 1] < INF or IY[i, j - 1] < INF:
                IY[i, j] = min(A[i, j - 1] + gap_open + gap_ext,
                               IY[i, j - 1] + gap_ext)
    last = np.minimum(np.minimum(A[Lq], IX[Lq]), IY[Lq])
    cost = int(last.min())
    if cost >= INF:
        return cost, -1
    return cost, int(last.argmin())
