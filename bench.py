"""Benchmark: canonical k-mer counting throughput per chip (north-star #1).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"extra"}.

vs_baseline divides by a MEASURED host-CPU k-mer counting rate: at bench
time we build and run scripts/cpu_kmer_baseline.cpp (KMC2-class canonical
K=24 radix counter) on this host and use its best rate; if the toolchain
is unavailable we fall back to the last committed host measurement
(CPU_HOST_KMERS_PER_S_FALLBACK, docs/counting_baseline.md). The ALLPATHS-LG
reference publishes no kernel-level numbers (BASELINE.md).

Timing method: REP iterations of the full count+spectrum program chained
inside ONE jitted fori_loop with iteration-varying input (prevents loop
hoisting), so the number is sustained device throughput without
per-dispatch overhead.

Requires a GPU: with none it exits non-zero and prints no number. stderr
names the device (platform, kind, count, nvidia-smi name and power limit)
and also reports the banded-DP rate (`banded_align`) and the lookup
aligner's read-pairs/s.
"""

import json
import sys
import time

import numpy as np

CPU_HOST_KMERS_PER_S_FALLBACK = 67e6  # measured 2026-08, docs/counting_baseline.md
REP = 8


def measure_cpu_baseline(timeout_s=120):
    """Build + run the host-CPU canonical-kmer counter; return kmers/s.

    Falls back to the last committed measurement if g++ or the run fails
    (docs/counting_baseline.md records the methodology)."""
    import os
    import subprocess

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "scripts", "cpu_kmer_baseline.cpp")
    exe = os.path.join(os.path.dirname(src), "cpu_kmer_baseline")
    try:
        if not os.path.exists(exe):
            subprocess.run(["g++", "-O3", "-march=native", "-pthread",
                            src, "-o", exe],
                           check=True, capture_output=True, timeout=timeout_s)
        # matched shape with the device bench batch: 131072 reads x 150 bp
        r = subprocess.run([exe, "131072", "150", "3"], capture_output=True,
                           timeout=timeout_s, text=True)
        best = max(json.loads(line)["mkmers_per_s"]
                   for line in r.stdout.splitlines() if line.startswith("{"))
        log(f"cpu baseline measured on this host: {best:.1f} M kmers/s")
        return best * 1e6, "measured"
    except Exception as e:
        log(f"cpu baseline build/run failed ({e}); using committed "
            f"measurement {CPU_HOST_KMERS_PER_S_FALLBACK/1e6:.1f} M/s")
        return CPU_HOST_KMERS_PER_S_FALLBACK, "committed-measurement"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: no GPU (JAX platform is {dev.platform!r});"
                         " refusing to report a CPU number")
    from allpathslg_tpu.utils import compile_cache
    from allpathslg_tpu.utils.device_info import nvidia_smi

    compile_cache.enable()
    log(f"bench device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())}; nvidia-smi: {'; '.join(nvidia_smi())}")

    import jax.numpy as jnp
    from jax import lax
    from allpathslg_tpu import tuning
    from allpathslg_tpu.kmer import count as kcount, kmerize

    K = 24
    n_reads, read_len = 131072, 150
    kmers_per_batch = n_reads * (read_len - K + 1)
    rng = np.random.default_rng(0)
    codes = jnp.asarray(rng.integers(0, 4, (n_reads, read_len)).astype(np.uint8))

    engine = tuning.get("count_engine")
    log(f"count_engine={engine}")

    if engine == "bucketed":
        from allpathslg_tpu.ops import bucket_count

        N, R, Bk, S = bucket_count.grouping_plan(kmers_per_batch)

        @jax.jit
        def many(codes):
            def body(i, carry):
                tot, allok = carry
                c = codes.at[0, 0].set((i % 4).astype(jnp.uint8))
                canon, valid = kmerize.kmer_windows(c, K)
                flat, _ = kmerize.flatten_kmers(canon, valid, K)
                words = bucket_count._pad_to(list(flat), N)
                spec, nu, ok = bucket_count.spectrum_grouped(
                    words, R, Bk, S, 255)
                return tot + nu, allok & ok
            tot, allok = lax.fori_loop(0, REP, body,
                                       (jnp.int32(0), jnp.bool_(True)))
            return tot + jnp.where(allok, 0, 1 << 30)
    else:
        @jax.jit
        def many(codes):
            def body(i, tot):
                c = codes.at[0, 0].set((i % 4).astype(jnp.uint8))
                spec, nu = kcount.spectrum_reads(c, K, 255)
                return tot + nu
            return lax.fori_loop(0, REP, body, jnp.int32(0))

    int(many(codes))  # compile + warm
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        int(many(codes))
        ts.append(time.perf_counter() - t0)
    dt = min(ts) / REP
    kps = kmers_per_batch / dt
    log(f"k-mer counting: {dt*1e3:.1f} ms/batch, {kps/1e6:.1f} M kmers/s")

    # context: banded-DP rate (north-star #2)
    try:
        from allpathslg_tpu.ops import banded
        B, Lq, Lt, W = 16384, 100, 140, 15
        q = jnp.asarray(rng.integers(0, 4, (B, Lq)).astype(np.uint8))
        t = jnp.asarray(rng.integers(0, 4, (B, Lt)).astype(np.uint8))
        ql = jnp.full((B,), Lq, jnp.int32)
        tl = jnp.full((B,), Lt, jnp.int32)
        off = jnp.asarray(rng.integers(-4, 5, B).astype(np.int32))

        def sustain_dp(name, align_fn):
            @jax.jit
            def many_dp(q, ql, t, tl, off):
                def body(i, tot):
                    # (i % 3) - 1 keeps the body loop-VARYING so XLA cannot
                    # hoist the kernel out of the fori_loop (a prior `tot&0`
                    # formulation constant-folded, over-reporting ~27%).
                    c, e = align_fn(q, ql, t, tl, off + (i % 3) - 1, band=W)
                    return tot + c.sum() + e.sum()
                return lax.fori_loop(0, REP, body, jnp.int32(0))

            int(many_dp(q, ql, t, tl, off))
            t0 = time.perf_counter()
            int(many_dp(q, ql, t, tl, off))
            ddt = (time.perf_counter() - t0) / REP
            cells = B * Lq * (2 * W + 1)
            log(f"banded-DP {name}: {ddt*1e3:.1f} ms/batch, "
                f"{cells/ddt/1e9:.2f} Gcells/s, "
                f"{B/ddt/1e6:.2f} M alignments/s")

        sustain_dp("banded_align", banded.banded_align)
    except Exception as e:
        log(f"banded-DP bench skipped: {e}")

    # aligned read-pairs/s (the other half of the binding metric, ref:
    # src/lookup/QueryLookupTable.cc + AlignPairsToHyper, BASELINE.md):
    # index a simulated 2 Mb contig set, stream read batches through the
    # seed-vote-verify aligner inside one jitted fori_loop
    pairs_per_s = 0.0
    try:
        from allpathslg_tpu.align import lookup as alook
        from allpathslg_tpu.eval import sim

        genome = sim.random_genome(2_000_000, seed=5)
        n_contigs = 16
        cl = len(genome) // n_contigs
        offs = np.arange(n_contigs + 1, dtype=np.int64) * cl
        index = alook.build_index(genome[: offs[-1]], offs, K=24)
        rb, _, _ = sim.simulate_paired_reads(genome, coverage=3.3,
                                             error_rate=0.01, seed=6)
        n_r = (min(rb.n_reads, 65536) // 2) * 2
        rcodes = jnp.asarray(np.asarray(rb.codes)[:n_r])
        rlens = jnp.asarray(np.asarray(rb.lengths)[:n_r])
        acfg = alook.AlignConfig(K=24)
        fb = jnp.asarray(genome[: offs[-1]])

        @jax.jit
        def many_align(codes, lens):
            def body(i, tot):
                c = codes.at[0, 0].set((i % 4).astype(jnp.uint8))
                if index.packed is not None:
                    rid, cc, d, o, okc = alook._candidates_packed(
                        index.hash, index.bucket_starts, index.packed,
                        index.offsets, c, lens, acfg, index.shift)
                else:
                    rid, cc, d, o, okc = alook._candidates(
                        index.hash, index.bucket_starts, index.contig,
                        index.pos, index.is_rc, c, lens, acfg, index.shift)
                NB = c.shape[0]
                _, _, _, _, aligned, _ = alook._vote_and_verify_dense(
                    cc.reshape(NB, -1), d.reshape(NB, -1),
                    o.reshape(NB, -1), okc.reshape(NB, -1),
                    fb, index.offsets, c, lens, acfg)
                return tot + aligned.sum()
            return lax.fori_loop(0, REP, body, jnp.int32(0))

        n_al = int(many_align(rcodes, rlens))
        t0 = time.perf_counter()
        n_al = int(many_align(rcodes, rlens))
        adt = (time.perf_counter() - t0) / REP
        pairs_per_s = (n_r / 2) / adt
        log(f"lookup align: {adt*1e3:.1f} ms/batch of {n_r} reads, "
            f"{n_al/REP/n_r:.2f} aligned frac, "
            f"{pairs_per_s/1e6:.3f} M read-pairs/s")
    except Exception as e:
        log(f"read-pairs bench skipped: {e}")

    cpu_rate, cpu_rate_kind = measure_cpu_baseline()
    print(json.dumps({
        "metric": "canonical_kmer_count_throughput",
        "value": round(kps / 1e6, 2),
        "unit": "Mkmers/s/chip",
        "vs_baseline": round(kps / cpu_rate, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extra": {"aligned_read_pairs_per_s": round(pairs_per_s, 0),
                  "cpu_host_mkmers_s": round(cpu_rate / 1e6, 1),
                  "cpu_baseline_kind": cpu_rate_kind},
    }))


if __name__ == "__main__":
    main()
