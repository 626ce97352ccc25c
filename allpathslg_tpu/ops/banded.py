"""Batched banded alignment DP — north-star kernel #2 (jnp reference).

Behavior contract (ref: src/pairwise_aligners/SmithWatBandedA.{h,cc} —
SURVEY.md §2.2): align query q against target t around a given diagonal
offset with band half-width W; returns the minimal edit-style cost and the
target end position. Glocal semantics (the whole query aligns into a free
target window): D[0][j] = 0, answer = min_j D[|q|][j]. This is the inner
loop of consensus, patching, gap closure and eval.

DP shape: iterate query rows with the band as a vector.
In-band slot k ∈ [0, 2W] of row r maps to target column j = r + off - W + k
(the window slides right one column per row, so the diagonal predecessor
stays in the SAME slot and the vertical one in slot k+1). The within-row
horizontal dependency is resolved in one step with the min-plus prefix
trick:
  D_r[k] = min(M_r[k], k·gap + cummin_{k'<=k}(M_r[k'] - k'·gap))
so each row costs a handful of vector ops + one cummin over the band axis;
the row loop is a lax.scan of length |q|. A query code >= 4 (N or
padding) matches nothing. This one program serves every caller on every
backend: a bit-parallel Pallas kernel was 6-12x faster per call on an H100
but slower end to end (PERF.md, Findings).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

# a numpy scalar, not a jnp one: a jnp constant made while this module is
# first imported inside a trace would be that trace's tracer, leaked into
# every later trace as an extra executable argument
BIG = np.int32(1 << 20)


@functools.partial(jax.jit, static_argnames=("band", "sub_cost", "gap_cost"))
def banded_align(q: jnp.ndarray, q_len: jnp.ndarray,
                 t: jnp.ndarray, t_len: jnp.ndarray,
                 offset: jnp.ndarray, band: int = 16,
                 sub_cost: int = 1, gap_cost: int = 1):
    """Batched banded glocal alignment.

    Args:
      q: uint8 [B, Lq] query codes (4 = pad beyond q_len).
      t: uint8 [B, Lt] target codes.
      offset: int32 [B] expected diagonal (query i ≈ target i + offset).

    Returns (cost [B] int32, t_end [B] int32): minimal alignment cost and
    the (exclusive) target end column attaining it; (BIG, -1) if no in-band
    path exists.
    """
    B, Lq = q.shape
    Lt = t.shape[1]
    K = 2 * band + 1
    ks = jnp.arange(K, dtype=jnp.int32)[None, :]
    gk = ks * gap_cost
    offs = offset[:, None]
    tl = t_len[:, None]
    tt = t.astype(jnp.int32)

    # D row 0 (empty query prefix): free target prefix → 0 on valid columns
    j0 = offs - band + ks
    row0 = jnp.where((j0 >= 0) & (j0 <= tl), 0, BIG)
    res0 = row0  # answer row for q_len == 0

    def step(carry, i):
        prev, result = carry
        r = i + 1  # computing D row r
        j = r + offs - band + ks
        in_t = (j >= 1) & (j <= tl)
        jc = jnp.clip(j - 1, 0, Lt - 1)
        tb = jnp.take_along_axis(tt, jc, axis=1)
        qb = q[:, i][:, None].astype(jnp.int32)
        sub = jnp.where((tb == qb) & (qb < 4), 0, sub_cost)

        diag = prev + sub                                       # slot k
        up = jnp.concatenate([prev[:, 1:], jnp.full((B, 1), BIG)], 1) + gap_cost
        m = jnp.minimum(diag, up)
        m = jnp.where(in_t, m, BIG)
        m = jnp.where(j == 0, r * gap_cost, m)                  # column 0
        # horizontal closure
        run = lax.cummin(m - gk, axis=1)
        row = jnp.minimum(m, run + gk)
        row = jnp.where(in_t | (j == 0), row, BIG)
        row = jnp.minimum(row, BIG)
        result = jnp.where((q_len[:, None] == r), row, result)
        return (row, result), None

    (final, result), _ = lax.scan(step, (row0, res0), jnp.arange(Lq, dtype=jnp.int32))

    jf = q_len[:, None] + offs - band + ks
    ok = (jf >= 0) & (jf <= tl)
    vals = jnp.where(ok, result, BIG)
    cost = vals.min(axis=1)
    kbest = jnp.argmin(vals, axis=1).astype(jnp.int32)
    t_end = q_len + offset - band + kbest
    t_end = jnp.where(cost < BIG, t_end, -1)
    return cost, t_end


def np_banded_oracle(q, t, offset, band, sub_cost=1, gap_cost=1):
    """Unbanded-with-mask python oracle for tests (same semantics)."""
    Lq, Lt = len(q), len(t)
    INF = 1 << 20
    D = np.full((Lq + 1, Lt + 1), INF, dtype=np.int64)
    for j in range(Lt + 1):
        if abs(j - 0 - offset) <= band:
            D[0, j] = 0
    for i in range(1, Lq + 1):
        for j in range(0, Lt + 1):
            if abs(j - i - offset) > band:
                continue
            best = INF
            if j == 0:
                best = i * gap_cost
            if j >= 1 and D[i - 1, j - 1] < INF:
                hit = q[i - 1] == t[j - 1] and q[i - 1] < 4
                best = min(best, D[i - 1, j - 1] + (0 if hit else sub_cost))
            if D[i - 1, j] < INF:
                best = min(best, D[i - 1, j] + gap_cost)
            if j >= 1 and D[i, j - 1] < INF:
                best = min(best, D[i, j - 1] + gap_cost)
            D[i, j] = best
    cost = int(D[Lq].min())
    t_end = int(D[Lq].argmin())
    if cost >= INF:
        return cost, -1
    return cost, t_end
