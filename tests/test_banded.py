"""Banded DP vs python oracle and known mutations."""

import numpy as np
import jax.numpy as jnp
import pytest

from allpathslg_tpu.ops import banded
from allpathslg_tpu.eval import sim


def _run(qs, ts, offs, band, Lq=None, Lt=None):
    B = len(qs)
    Lq = Lq or max(len(x) for x in qs)
    Lt = Lt or max(len(x) for x in ts)
    q = np.full((B, Lq), 4, np.uint8)
    t = np.full((B, Lt), 4, np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for i, (a, b) in enumerate(zip(qs, ts)):
        q[i, : len(a)] = a
        t[i, : len(b)] = b
        ql[i], tl[i] = len(a), len(b)
    cost, tend = banded.banded_align(jnp.asarray(q), jnp.asarray(ql),
                                     jnp.asarray(t), jnp.asarray(tl),
                                     jnp.asarray(np.asarray(offs, np.int32)),
                                     band=band)
    return np.asarray(cost), np.asarray(tend)


def test_matches_oracle_random():
    rng = np.random.default_rng(0)
    qs, ts, offs = [], [], []
    for i in range(40):
        lq = rng.integers(5, 60)
        lt = rng.integers(5, 80)
        qs.append(rng.integers(0, 4, lq).astype(np.uint8))
        ts.append(rng.integers(0, 4, lt).astype(np.uint8))
        offs.append(int(rng.integers(-5, 6)))
    cost, tend = _run(qs, ts, offs, band=8)
    for i in range(len(qs)):
        oc, oe = banded.np_banded_oracle(qs[i], ts[i], offs[i], band=8)
        assert cost[i] == oc, (i, cost[i], oc)
        if oc < (1 << 20):
            assert tend[i] == oe or cost[i] == oc  # ties may differ


def test_perfect_and_mutated_substrings():
    rng = np.random.default_rng(1)
    g = sim.random_genome(2000, seed=2)
    qs, ts, offs, want = [], [], [], []
    for i in range(30):
        s = int(rng.integers(0, 1500))
        q = g[s : s + 80].copy()
        t = g[max(0, s - 20) : s + 120]
        # plant mutations
        n_mut = int(rng.integers(0, 4))
        for _ in range(n_mut):
            p = int(rng.integers(0, 80))
            q[p] = (q[p] + 1) % 4
        qs.append(q)
        ts.append(t)
        offs.append(s - max(0, s - 20))
        want.append(n_mut)
    cost, tend = _run(qs, ts, offs, band=10)
    # cost <= planted mutations (mutations may create cheaper indel paths)
    for i in range(30):
        assert cost[i] <= want[i], (i, cost[i], want[i])
        assert cost[i] >= 0


def test_indel_alignment():
    g = sim.random_genome(500, seed=5)
    q = np.concatenate([g[100:140], g[143:180]])  # 3bp deletion in query
    t = g[80:200]
    cost, tend = _run([q], [t], [20], band=8)
    assert cost[0] == 3  # 3 gaps
    q2 = np.concatenate([g[100:140], np.array([0, 1, 2], np.uint8), g[140:180]])
    cost2, _ = _run([q2], [t], [20], band=8)
    assert cost2[0] <= 3


def test_out_of_band_returns_big():
    q = np.zeros(50, np.uint8)
    t = np.full(50, 1, np.uint8)
    # offset far beyond target length
    cost, tend = _run([q], [t], [500], band=4)
    assert cost[0] >= (1 << 20)
    assert tend[0] == -1


B = 128


def _random_batch(rng, band, Lq=40, Lt=56, ragged=True):
    q = rng.integers(0, 4, (B, Lq)).astype(np.uint8)
    t = rng.integers(0, 4, (B, Lt)).astype(np.uint8)
    # half the batch: targets are mutated copies => realistic diagonals
    for i in range(0, B, 2):
        L = min(Lq, Lt)
        t[i, :L] = q[i, :L]
        for _ in range(int(rng.integers(0, 5))):
            p = int(rng.integers(0, Lt))
            t[i, p] = rng.integers(0, 4)
    ql = (rng.integers(1, Lq + 1, B) if ragged
          else np.full(B, Lq)).astype(np.int32)
    ql[0] = 0  # empty query
    tl = rng.integers(1, Lt + 1, B).astype(np.int32)
    off = rng.integers(-(Lq + band) - 3, Lt + band + 4, B).astype(np.int32)
    return q, ql, t, tl, off


def _align(q, ql, t, tl, off, band):
    cost, tend = banded.banded_align(jnp.asarray(q), jnp.asarray(ql),
                                     jnp.asarray(t), jnp.asarray(tl),
                                     jnp.asarray(off), band=band)
    return np.asarray(cost), np.asarray(tend)


@pytest.mark.parametrize("band", [1, 4, 8, 15])
def test_batch_matches_oracle_exactly(band):
    """Ragged lengths, empty queries and offsets on both sides of the
    feasible range: cost AND t_end equal the oracle (ties resolve to the
    lowest column in both)."""
    rng = np.random.default_rng(band)
    q, ql, t, tl, off = _random_batch(rng, band)
    cost, tend = _align(q, ql, t, tl, off, band)
    for i in range(B):
        want_c, want_e = banded.np_banded_oracle(
            q[i, : ql[i]], t[i, : tl[i]], int(off[i]), band)
        assert cost[i] == want_c, (i, cost[i], want_c, off[i])
        if want_c < int(banded.BIG):
            assert tend[i] == want_e, (i, tend[i], want_e)


def test_infeasible_offsets_killed():
    band = 6
    q = np.ones((B, 16), np.uint8)
    t = np.ones((B, 20), np.uint8)
    ql = np.full(B, 16, np.int32)
    tl = np.full(B, 20, np.int32)
    off = np.full(B, 10_000, np.int32)  # far outside any feasible window
    cost, tend = _align(q, ql, t, tl, off, band)
    assert int(cost.min()) >= int(banded.BIG)
    assert (tend == -1).all()


def test_long_query_wide_band():
    band = 15
    rng = np.random.default_rng(7)
    q, ql, t, tl, off = _random_batch(rng, band, Lq=97, Lt=120)
    cost, _ = _align(q, ql, t, tl, off, band)
    for i in range(0, B, 7):
        want_c, _ = banded.np_banded_oracle(
            q[i, : ql[i]], t[i, : tl[i]], int(off[i]), band)
        assert cost[i] == want_c, f"problem {i}"


@pytest.mark.parametrize("n,Lq,Lt", [(1, 31, 40), (127, 33, 47),
                                     (130, 64, 70)])
def test_n_bases_match_nothing(n, Lq, Lt):
    """N (code 4) in queries and targets, including N facing N, never
    matches: the device DP agrees with the oracle, and an all-N query
    costs its length."""
    band = 5
    rng = np.random.default_rng(n + Lq)
    t = rng.integers(0, 4, (n, Lt)).astype(np.uint8)
    q = t[:, :Lq].copy()
    q[rng.random((n, Lq)) < 0.05] = 4
    t[rng.random((n, Lt)) < 0.05] = 4
    q[:, -1] = 4
    t[:, Lq - 1] = 4   # N facing N on the main diagonal
    ql = rng.integers(0, Lq + 1, n).astype(np.int32)
    ql[-1] = Lq
    tl = rng.integers(Lq, Lt + 1, n).astype(np.int32)
    off = rng.integers(-band, band + 1, n).astype(np.int32)
    cost, tend = _align(q, ql, t, tl, off, band)
    for i in range(n):
        want = banded.np_banded_oracle(q[i, : ql[i]], t[i, : tl[i]],
                                       int(off[i]), band)
        assert (int(cost[i]), int(tend[i])) == want, (i, want)
    allN = np.full((1, Lq), 4, np.uint8)
    c, _ = _align(allN, np.array([Lq], np.int32), allN,
                  np.array([Lq], np.int32), np.zeros(1, np.int32), band)
    assert int(c[0]) == Lq
