"""Perfect/Imperfect lookup (one-hot convolution scan) vs numpy oracle."""

import numpy as np
import jax.numpy as jnp

from allpathslg_tpu.align import mxu_scan
from allpathslg_tpu.eval import sim


def _rc(s):
    return (3 - s[::-1]).astype(np.uint8)


def _oracle_best(target, read, l):
    """Best (pos, is_rc, mism) by exhaustive scan, fwd preferred on ties."""
    r = read[:l]
    best = (10**9, 0, False)
    for rc in (False, True):
        q = _rc(r) if rc else r
        for p in range(len(target) - l + 1):
            mism = int((target[p:p + l] != q).sum())
            if mism < best[0]:
                best = (mism, p, rc)
    return best


def test_match_counts_oracle():
    rng = np.random.default_rng(0)
    target = sim.random_genome(300, seed=1)
    reads = np.stack([target[i:i + 40] for i in (3, 50, 120)])
    mc = np.asarray(mxu_scan.match_counts(jnp.asarray(target),
                                          jnp.asarray(reads)))
    for n, s in enumerate((3, 50, 120)):
        assert mc[n, s] == 40
        # oracle full row
        for p in range(mc.shape[1]):
            assert mc[n, p] == (target[p:p + 40] == reads[n]).sum()
        break  # full row once is enough


def test_imperfect_lookup_finds_planted_reads():
    target = sim.random_genome(2000, seed=2)
    rng = np.random.default_rng(3)
    L = 60
    n = 40
    starts = rng.integers(0, len(target) - L, n)
    is_rc = rng.random(n) < 0.5
    reads = np.zeros((n, L), np.uint8)
    for i, (s, rc) in enumerate(zip(starts, is_rc)):
        seg = target[s:s + L].copy()
        # plant 2 substitutions
        pp = rng.choice(L, 2, replace=False)
        seg[pp] = (seg[pp] + rng.integers(1, 4, 2)) % 4
        reads[i] = _rc(seg) if rc else seg
    lengths = np.full(n, L, np.int32)
    pos, urc, mism = mxu_scan.imperfect_lookup(
        jnp.asarray(target), jnp.asarray(reads), jnp.asarray(lengths))
    pos, urc, mism = map(np.asarray, (pos, urc, mism))
    assert (pos == starts).all()
    assert (urc == is_rc).all()
    assert (mism <= 2).all()


def test_imperfect_lookup_ragged_rc_offsets():
    target = sim.random_genome(800, seed=5)
    L, l = 50, 37
    s = 333
    seg = target[s:s + l]
    fwd = np.full((1, L), 4, np.uint8); fwd[0, :l] = seg
    rcr = np.full((1, L), 4, np.uint8); rcr[0, :l] = _rc(seg)
    for reads, want_rc in ((fwd, False), (rcr, True)):
        pos, urc, mism = mxu_scan.imperfect_lookup(
            jnp.asarray(target), jnp.asarray(reads),
            jnp.asarray(np.asarray([l], np.int32)))
        assert int(np.asarray(mism)[0]) == 0
        assert bool(np.asarray(urc)[0]) == want_rc
        assert int(np.asarray(pos)[0]) == s


def test_imperfect_matches_oracle_random():
    target = sim.random_genome(400, seed=7)
    rng = np.random.default_rng(8)
    reads = rng.integers(0, 4, size=(12, 30)).astype(np.uint8)
    lengths = np.full(12, 30, np.int32)
    pos, urc, mism = map(np.asarray, mxu_scan.imperfect_lookup(
        jnp.asarray(target), jnp.asarray(reads), jnp.asarray(lengths)))
    for i in range(12):
        om, op, orc = _oracle_best(target, reads[i], 30)
        assert mism[i] == om  # same best score (position may tie)


def test_perfect_lookup_repeat_hits():
    rep = sim.random_genome(45, seed=11)
    target = np.concatenate([sim.random_genome(200, seed=12), rep,
                             sim.random_genome(200, seed=13), rep,
                             sim.random_genome(200, seed=14)])
    reads = np.stack([rep, _rc(rep)])
    lengths = np.full(2, 45, np.int32)
    pos, is_rc, n_hits = map(np.asarray, mxu_scan.perfect_lookup(
        jnp.asarray(target), jnp.asarray(reads), jnp.asarray(lengths)))
    # the repeat occurs fwd at 200 and 445: 2 exact hits per strandedness
    assert (n_hits == 2).all()
    assert set(pos[0][pos[0] >= 0]) == {200, 445}
    assert not np.asarray(is_rc[0][:2]).any()
    assert set(pos[1][pos[1] >= 0]) == {200, 445}
    assert np.asarray(is_rc[1][:2]).all()
