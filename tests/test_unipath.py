"""Unipath construction vs the python bidirected de Bruijn oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from allpathslg_tpu.dtypes.reads import batch_from_codes
from allpathslg_tpu.kmer import count
from allpathslg_tpu.graph import unipath
from allpathslg_tpu.eval import oracle, sim


def _unipaths_from_reads(reads_codes, lengths, K, min_count=1):
    batch = batch_from_codes(reads_codes, lengths)
    ck = count.trim_to_host(count.count_reads(batch.codes, K))
    return unipath.build_unipaths(ck.words, K, min_count=min_count,
                                  counts=ck.counts)


def _canon_seq(seq):
    t = tuple(int(b) for b in seq)
    rt = tuple(3 - b for b in reversed(t))
    return min(t, rt)


def _got_set(ups):
    return {_canon_seq(ups.sequence(i)) for i in range(ups.n)}


def _oracle_set(reads, K):
    kset = set(oracle.count_kmers(reads, K).keys())
    return oracle.unipaths(kset, K)


@pytest.mark.parametrize("K", [5, 11, 24])
def test_unipaths_match_oracle_random_reads(K):
    rng = np.random.default_rng(0)
    n, L = 12, 60
    codes = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    lengths = np.full(n, L, dtype=np.int32)
    ups = _unipaths_from_reads(codes, lengths, K)
    reads = [codes[i] for i in range(n)]
    want = _oracle_set(reads, K)
    got = _got_set(ups)
    assert got == want


@pytest.mark.parametrize("K", [24, 96])
def test_single_genome_gives_one_unipath(K):
    """A read set tiling a random (repeat-free) genome produces one unipath
    equal to the genome."""
    G = 600
    genome = sim.random_genome(G, seed=4)
    step = 20
    L = 150
    reads = [genome[s : s + L] for s in range(0, G - L + 1, step)]
    reads.append(genome[G - L :])
    codes = np.stack([r for r in reads])
    lengths = np.full(len(reads), L, dtype=np.int32)
    ups = _unipaths_from_reads(codes, lengths, K)
    # random 600bp genome at K=24/96: overwhelmingly likely repeat-free
    assert ups.n == 1
    assert _canon_seq(ups.sequence(0)) == _canon_seq(genome)


def test_branch_splits_unipaths():
    K = 7
    rng = np.random.default_rng(7)
    # two sequences sharing a middle segment → branch points split paths
    a = sim.random_genome(80, seed=1)
    b = sim.random_genome(80, seed=2)
    mid = sim.random_genome(30, seed=3)
    s1 = np.concatenate([a, mid, sim.random_genome(60, seed=8)])
    s2 = np.concatenate([b, mid, sim.random_genome(60, seed=9)])
    codes = np.stack([s1, s2])
    lengths = np.array([len(s1), len(s2)], np.int32)
    ups = _unipaths_from_reads(codes, lengths, K)
    reads = [s1, s2]
    want = _oracle_set(reads, K)
    assert _got_set(ups) == want
    assert ups.n > 2  # the shared segment forces splits


def test_circular_genome_unipath():
    """Circular chromosome → cycle in the graph; must terminate and cover."""
    K = 15
    G = 300
    genome = sim.random_genome(G, seed=12)
    circ = np.concatenate([genome, genome[: K - 1 + 50]])
    L = 80
    reads = [circ[s : s + L] for s in range(0, len(circ) - L + 1, 10)]
    codes = np.stack(reads)
    lengths = np.full(len(reads), L, np.int32)
    ups = _unipaths_from_reads(codes, lengths, K)
    reads_list = [r for r in reads]
    want = _oracle_set(reads_list, K)
    got = _got_set(ups)
    # cycle breakpoints are arbitrary: compare rotation-invariantly via
    # lengths and canonical kmer content
    def kset(seqs):
        out = set()
        for s in seqs:
            out |= set(oracle.count_kmers([np.array(s, np.uint8)], K).keys())
        return out
    assert sorted(len(s) for s in got) == sorted(len(s) for s in want)
    assert kset(got) == kset(want)


def test_min_count_filters_error_kmers():
    K = 24
    genome = sim.random_genome(5000, seed=20)
    batch, _, _ = sim.simulate_paired_reads(genome, coverage=40,
                                            error_rate=0.005, seed=21)
    ck = count.trim_to_host(count.count_reads(batch.codes, K))
    ups = unipath.build_unipaths(ck.words, K, min_count=3, counts=ck.counts)
    # contigs should reconstruct most of the genome in few pieces
    from allpathslg_tpu.eval import stats
    st = stats.assembly_stats(ups.lengths(), min_len=100)
    assert st["total_bases"] > 0.9 * 5000
    assert st["n50"] > 1000


def test_chain_phase_chunked_matches_fused():
    """The bounded-dispatch condensation (used above _FUSED_MAX_NODES to
    keep single programs short) must reproduce the
    fused _chain_phase exactly."""
    import jax.numpy as jnp
    import numpy as np
    from allpathslg_tpu.graph import unipath as gup
    from allpathslg_tpu.kmer import count as kcount
    from allpathslg_tpu.eval import sim

    g = sim.random_genome(3000, seed=41)
    rb, _, _ = sim.simulate_paired_reads(g, coverage=12, error_rate=0.0,
                                         seed=42)
    ck = kcount.trim_to_host(kcount.count_reads_streaming(
        np.asarray(rb.codes), 32))
    tw = tuple(jnp.asarray(w) for w in ck.words)
    h1, d1, v1, o1, n1 = gup._chain_phase(tw, 32)
    h2, d2, v2, o2, n2 = gup._chain_phase_chunked(tw, 32)
    assert np.array_equal(np.asarray(h1), np.asarray(h2))
    assert np.array_equal(np.asarray(d1), np.asarray(d2))
    assert np.array_equal(np.asarray(o1), np.asarray(o2))
    assert np.array_equal(np.asarray(n1), np.asarray(n2))
