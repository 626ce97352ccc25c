"""Profile the aligned read-pairs/s path (VERDICT r3 Next #4).

Decomposes the bench loop (bench.py lookup align) into its
stages, each timed as its own jitted sustained loop on the device:

  A. kmerize+seed-expand   (_candidates)
  B. candidate vote sort   (the 4-word sort in _vote_and_verify)
  C. winner scatter + verify (rest of _vote_and_verify)
  D. full pipeline         (candidates + vote + verify)

Prints one JSON line with ms per stage so the bottleneck is attributable.
Run on the real chip: `python scripts/profile_lookup_align.py`.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
from jax import lax

from allpathslg_tpu.align import lookup as alook
from allpathslg_tpu.eval import sim
from allpathslg_tpu.ops import sort as ops_sort

REP = 8


def sustain(fn, *args):
    @jax.jit
    def many(*a):
        def body(i, tot):
            r = fn(i, *a)
            return tot + r
        return lax.fori_loop(0, REP, body, jnp.int32(0))

    int(many(*args))
    ts = []
    for _ in range(2):
        t0 = time.perf_counter()
        int(many(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts) / REP


def main():
    genome = sim.random_genome(2_000_000, seed=5)
    n_contigs = 16
    cl = len(genome) // n_contigs
    offs = np.arange(n_contigs + 1, dtype=np.int64) * cl
    index = alook.build_index(genome[: offs[-1]], offs, K=24)
    rb, _, _ = sim.simulate_paired_reads(genome, coverage=3.3,
                                         error_rate=0.01, seed=6)
    n_r = (min(rb.n_reads, 65536) // 2) * 2
    codes = jnp.asarray(np.asarray(rb.codes)[:n_r])
    lens = jnp.asarray(np.asarray(rb.lengths)[:n_r])
    acfg = alook.AlignConfig(K=24)
    fb = jnp.asarray(genome[: offs[-1]])
    out = {}

    def _cands(c, lens):
        if index.packed is not None:
            return alook._candidates_packed(
                index.hash, index.bucket_starts, index.packed,
                index.offsets, c, lens, acfg, index.shift)
        return alook._candidates(
            index.hash, index.bucket_starts, index.contig, index.pos,
            index.is_rc, c, lens, acfg, index.shift)

    # A: candidates only
    def stage_a(i, codes, lens):
        c = codes.at[0, 0].set((i % 4).astype(jnp.uint8))
        rid, cc, d, o, ok = _cands(c, lens)
        return ok.sum()

    out["candidates_ms"] = sustain(stage_a, codes, lens) * 1e3

    # materialize candidates once for the isolated downstream stages
    rid, cc, d, o, ok = _cands(codes, lens)
    rid, cc, d, o, ok = jax.tree.map(jnp.asarray, (rid, cc, d, o, ok))
    print(f"candidate rows: {rid.shape[0]}", file=sys.stderr)

    # B: the vote sort alone (4-word sort as in _vote_and_verify)
    L = codes.shape[1]

    def stage_b(i, rid, cc, d, o, ok):
        BIG = jnp.int32(0x7FFFFFFF)
        okx = ok ^ (i % 2 == 3)  # loop-varying
        key_r = jnp.where(okx, rid, BIG).astype(jnp.uint32)
        key_c = jnp.where(okx, cc, 0).astype(jnp.uint32)
        key_o = jnp.where(okx, o.astype(jnp.int32), 0).astype(jnp.uint32)
        key_d = jnp.where(okx, d + 2 * L, 0).astype(jnp.uint32)
        skeys, _ = ops_sort.sort_by_words([key_r, key_c, key_o, key_d], [])
        return skeys[0][0].astype(jnp.int32)

    out["vote_sort_ms"] = sustain(stage_b, rid, cc, d, o, ok) * 1e3

    # C: full vote+verify from materialized candidates
    def stage_c(i, rid, cc, d, o, ok, codes, lens):
        okx = ok ^ (i % 2 == 3)
        NB = codes.shape[0]
        _, _, _, _, aligned, _ = alook._vote_and_verify_dense(
            cc.reshape(NB, -1), d.reshape(NB, -1), o.reshape(NB, -1),
            okx.reshape(NB, -1), fb, index.offsets, codes, lens, acfg)
        return aligned.sum()

    out["vote_verify_ms"] = sustain(stage_c, rid, cc, d, o, ok, codes, lens) * 1e3

    # D: full pipeline
    def stage_d(i, codes, lens):
        c = codes.at[0, 0].set((i % 4).astype(jnp.uint8))
        rid, cc, d, o, ok = _cands(c, lens)
        NB = c.shape[0]
        cc, d, o, ok = (x.reshape(NB, -1) for x in (cc, d, o, ok))
        _, _, _, _, aligned, _ = alook._vote_and_verify_dense(
            cc, d, o, ok, fb, index.offsets, c, lens, acfg)
        return aligned.sum()

    out["full_ms"] = sustain(stage_d, codes, lens) * 1e3
    out["n_reads"] = n_r
    out["pairs_per_s"] = (n_r / 2) / (out["full_ms"] / 1e3)
    print(json.dumps({k: (round(v, 2) if isinstance(v, float) else v)
                      for k, v in out.items()}))


if __name__ == "__main__":
    main()
