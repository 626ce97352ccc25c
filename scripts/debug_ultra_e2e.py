"""Debug harness for test_ultra_e2e_reconstructs_60kb_genome.

Caches the (slow) ultra correction to /tmp, then re-runs only the
LongProto assembly with diagnostics: contig duplication via kmer
multiset, graph stats per simplification step.
"""
import os
import sys
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import jax  # noqa: E402
jax.config.update("jax_platforms", "cpu")

from allpathslg_tpu.eval import sim
from allpathslg_tpu.long import longproto, supported, ultra

CACHE = "/tmp/ultra_e2e_cache.npz"
G = 60_000


def get_corrected():
    g = sim.random_genome(G, seed=13)
    if os.path.exists(CACHE):
        d = np.load(CACHE, allow_pickle=True)
        return g, list(d["cor"])
    reads, _, _ = sim.simulate_long_reads(g, coverage=15, mean_len=5000,
                                          error_rate=0.15, seed=17)
    cor, _ = ultra.correct_long_reads(reads, ultra.UltraConfig(rounds=3))
    np.savez(CACHE, cor=np.array(cor, dtype=object))
    return g, cor


def main():
    g, cor = get_corrected()
    tiles = []
    for r in cor:
        for s in range(0, max(len(r) - 250 + 1, 1), 200):
            t = r[s : s + 250]
            if len(t) >= 100:
                tiles.append(t)
    codes = np.full((len(tiles), 250), 4, np.uint8)
    for i, t in enumerate(tiles):
        codes[i, : len(t)] = t
    print(f"tiles: {len(tiles)}")

    res = longproto.long_proto(
        codes, longproto.LongProtoConfig(min_kmer_count=3,
                                         correction_rounds=0))
    lens = sorted((len(s) for s in res.contigs.seqs), reverse=True)
    total = sum(lens)
    print("metrics:", res.metrics)
    print(f"contigs: n={len(lens)} total={total} (G={G}) top={lens[:12]}")

    # duplication: distinct canonical 100-mers vs total 100-mer instances
    K2 = 100
    from collections import Counter
    cnt = Counter()
    for s in res.contigs.seqs:
        s = np.asarray(s, np.uint8)
        for i in range(len(s) - K2 + 1):
            a = s[i : i + K2].tobytes()
            b = (3 - s[i : i + K2][::-1]).astype(np.uint8).tobytes()
            cnt[min(a, b)] += 1
    inst = sum(cnt.values())
    print(f"100-mer instances={inst} distinct={len(cnt)} "
          f"dup_ratio={inst / max(len(cnt), 1):.2f}")
    mult = Counter(cnt.values())
    print("multiplicity histogram:", dict(sorted(mult.items())[:8]))

    # genome coverage
    cset = set(cnt)
    probes = list(range(0, G - K2 + 1, 200))
    def canon(w):
        a = w.tobytes()
        b = (3 - w[::-1]).astype(np.uint8).tobytes()
        return min(a, b)
    cov = sum(canon(g[i : i + K2]) in cset for i in probes) / len(probes)
    print(f"genome 100-mer coverage: {cov:.3f}")


if __name__ == "__main__":
    main()
