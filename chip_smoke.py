#!/usr/bin/env python3
"""Smoke run of the assembler on one NVIDIA GPU, in one process.

Phases (each a function, so the CPU tests can call them at toy size):
  1. device     a GPU is required (no CPU fallback); prints its kind and
                count, the JAX versions, the compile-cache directory and
                nvidia-smi's name and power limit.
  2. dp         the banded DP (`ops.banded.banded_align`, as XLA compiles
                it for the card) at the four shapes the product path
                sends, against the plain numpy oracle on a sample of
                problems: costs and target ends must be equal exactly
                (integer DP, ties resolve to the lowest column in both);
                median time per call, with the card named. The repository
                has no hand-written kernel (PERF.md, Findings).
  3. main path  `Pipeline.run_full()` on simulated input (default: a 1 Mb
                genome with the libraries of the E. coli-class deployment
                of scripts/run_scale.py, so that a run with a cold compile
                cache fits its time limit; `--genome 4600000` runs the full
                deployment), checked against the truth genome; per-stage
                walls, peak device memory and peak host RSS.

With `--chips 4` it runs only the multi-device path: the pipeline with
n_devices=4 against n_devices=1 (artifacts must be byte-identical) and the
mesh legs of `__graft_entry__` (hash-routed all_to_all counting, ring scan,
sample sort).

Usage:
  python chip_smoke.py [--genome BASES] [--chips 4]

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Any failed phase raises, so the process exits non-zero and prints no
result line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# (name, batch, Lq, Lt, band, offset rule) — the shapes the product path
# sends to the banded DP
DP_SHAPES = (
    ("patch", 16384, 100, 140, 15, "window"),      # bench.py / asm/patch
    ("rescue", 65536, 100, 116, 8, "rescue"),      # align/lookup rescue
    ("rescue_filled", 65536, 288, 304, 8, "rescue"),  # filled reads
    ("polish", 16384, 100, 140, 6, "window"),      # asm/polish, consensus
)


def log(*a):
    print(*a, flush=True)


def device_phase(n_chips: int = 1) -> dict:
    """Require `n_chips` GPUs; print what runs here. Returns the device
    record of the result line and the card label for timing lines."""
    import jax
    import jaxlib

    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX platform is "
                         f"{d0.platform!r}); refusing to run on the CPU")
    if len(devs) < n_chips:
        raise SystemExit(f"chip_smoke: need {n_chips} GPUs, JAX sees "
                         f"{len(devs)}")
    from allpathslg_tpu.utils import compile_cache
    from allpathslg_tpu.utils.device_info import nvidia_smi

    cache = compile_cache.enable()
    smi = nvidia_smi()
    log(f"[device] platform={d0.platform} kind={d0.device_kind} "
        f"count={len(devs)} jax={jax.__version__} "
        f"jaxlib={jaxlib.__version__} compile_cache={cache}")
    for line in smi:
        log(line)
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devs), "card": smi[0]}


def make_problems(B, Lq, Lt, band, rule, seed=0):
    """Realistic banded-DP problems: reads sampled from a random genome
    with 1% substitutions, one indel of 1-3 bases in a third of them, a
    few N bases on both sides, ragged query lengths; targets are the
    genome windows the product path would cut around the read."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, 1 << 20).astype(np.uint8)
    margin = (Lt - Lq) // 2 if rule == "window" else band
    start = rng.integers(8, len(g) - Lt - 16, B)
    t = g[start[:, None] + np.arange(Lt)[None, :]]
    pos = np.arange(Lq)[None, :]
    cut = rng.integers(0, Lq, B)[:, None]
    step = np.where(rng.random(B) < 1 / 3, rng.integers(-3, 4, B), 0)
    src = start[:, None] + margin + pos + np.where(pos >= cut,
                                                   step[:, None], 0)
    q = g[src]
    sub = rng.random((B, Lq)) < 0.01
    q = np.where(sub, (q + rng.integers(1, 4, (B, Lq))) % 4, q)
    q = np.where(rng.random((B, Lq)) < 0.002, 4, q).astype(np.uint8)
    t = np.where(rng.random((B, Lt)) < 0.002, 4, t).astype(np.uint8)
    ql = np.where(rng.random(B) < 0.1, rng.integers(Lq // 2, Lq + 1, B),
                  Lq).astype(np.int32)
    q = np.where(np.arange(Lq)[None, :] < ql[:, None], q, 4).astype(np.uint8)
    if rule == "window":
        tl = np.where(rng.random(B) < 0.1, rng.integers(Lq, Lt + 1, B),
                      Lt).astype(np.int32)
        off = (margin + rng.integers(-4, 5, B)).astype(np.int32)
    else:
        tl = np.full(B, Lt, np.int32)
        off = np.full(B, band, np.int32)
    return q, ql, t, tl, off


def _median_time(fn, args, reps):
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm-up
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def dp_phase(shapes=DP_SHAPES, card: str = "", reps: int = 10,
             n_check: int = 32) -> list:
    """`banded_align` at each shape: exact equality of cost and t_end with
    `np_banded_oracle` on `n_check` problems spread over the batch, then
    the median wall time of one call (host clock around
    block_until_ready)."""
    import functools

    import jax
    import jax.numpy as jnp

    from allpathslg_tpu.ops import banded

    rows = []
    for name, B, Lq, Lt, band, rule in shapes:
        host = make_problems(B, Lq, Lt, band, rule)
        q, ql, t, tl, off = host
        fn = functools.partial(banded.banded_align, band=band)
        cost, tend = (np.asarray(x) for x in fn(*map(jnp.asarray, host)))
        bad = []
        idx = np.linspace(0, B - 1, min(n_check, B)).astype(np.int64)
        for i in idx:
            want = banded.np_banded_oracle(q[i, : ql[i]], t[i, : tl[i]],
                                           int(off[i]), band)
            if (int(cost[i]), int(tend[i])) != want:
                bad.append((int(i), int(cost[i]), int(tend[i]), want))
        med = _median_time(fn, tuple(map(jnp.asarray, host)), reps)
        feas = int((cost < int(banded.BIG)).sum())
        log(f"[dp] {name} B={B} Lq={Lq} Lt={Lt} band={band}: banded_align "
            f"vs oracle equal on {len(idx) - len(bad)}/{len(idx)} sampled "
            f"problems (tolerance: exact), feasible {feas}/{B}; median "
            f"{med * 1e3:.3f} ms per call "
            f"[{card or jax.devices()[0].device_kind}]")
        if bad:
            raise AssertionError(f"banded_align != oracle at {name}: "
                                 f"(problem, cost, t_end, oracle) {bad[:5]}")
        rows.append(dict(name=name, B=B, Lq=Lq, Lt=Lt, band=band,
                         checked=len(idx), feasible=feas, ms=med * 1e3))
    return rows


def run_pipeline(run_dir, genome, coverage=100.0, jump_coverage=50.0,
                 error_rate=0.01, seed=7, n_devices=1, quiet=False,
                 **overrides):
    """Simulate the deployment into `run_dir` and run the full pipeline
    through the user entry points. Returns (RunDir, report)."""
    from allpathslg_tpu.pipeline import run as prun
    from allpathslg_tpu.pipeline.config import AssemblyConfig
    from allpathslg_tpu.pipeline.rundir import RunDir
    from allpathslg_tpu.pipeline.stages import Pipeline

    rd = RunDir(run_dir)
    say = (lambda *a: None) if quiet else prun._log_factory(rd)
    prun.prepare_sim_inputs(rd, genome, coverage, error_rate, 100, seed, say,
                            jump_coverage=jump_coverage, jump_insert=3000,
                            jump_sd=300)
    cfg = AssemblyConfig.from_overrides(n_devices=n_devices, **overrides)
    return rd, Pipeline(rd, cfg, say).run_full()


def check_assembly(rd, report, genome) -> dict:
    """Truth checks of the finished run (raises on failure)."""
    ev = rd.metrics("evaluate")
    sc = rd.metrics("make_scaffolds")
    got = {"total_bases": report["total_bases"],
           "misassembly_breaks": ev.get("misassembly_breaks"),
           "genome_covered_frac": ev.get("genome_covered_frac"),
           "scaffold_n50": sc.get("scaffold_n50")}
    fails = []
    if not 0.95 * genome <= got["total_bases"] <= 1.10 * genome:
        fails.append("total assembly outside 0.95-1.10x genome")
    if got["misassembly_breaks"] != 0:
        fails.append("misassembly_breaks != 0")
    if not (got["genome_covered_frac"] or 0) >= 0.99:
        fails.append("genome_covered_frac < 0.99")
    if not (got["scaffold_n50"] or 0) >= 0.5 * genome:
        fails.append("scaffold N50 < 0.5x genome")
    if genome >= 1_000_000 and not report.get("n50", 0) > 100_000:
        fails.append("contig N50 <= 100 kb at >= 1 Mb")
    log(f"[main] truth checks: {got} -> "
        f"{'ok' if not fails else 'FAILED: ' + '; '.join(fails)}")
    if fails:
        raise AssertionError(f"assembly failed truth checks: {fails}")
    return got


def main_path_phase(run_dir, genome, card: str = "", **kw) -> dict:
    """Full pipeline at `genome` bases, truth checks, per-stage walls,
    peak device memory and peak host RSS."""
    import jax

    t0 = time.perf_counter()
    rd, report = run_pipeline(run_dir, genome, **kw)
    wall = time.perf_counter() - t0
    got = check_assembly(rd, report, genome)
    stage_s = {n: rec.get("elapsed_s", 0.0)
               for n, rec in rd.manifest["stages"].items()}
    for n, s in stage_s.items():
        log(f"[main] stage {n}: {s:.2f} s")
    mem = jax.devices()[0].memory_stats() or {}
    peak_dev = mem.get("peak_bytes_in_use")
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    log(f"[main] genome={genome} wall={wall:.1f} s (prepare + pipeline), "
        f"peak device memory="
        f"{'not available' if peak_dev is None else f'{peak_dev / 1e9:.2f} GB'}"
        f", peak host RSS={rss_gb:.2f} GB [{card}]")
    return {"wall_s": wall, "stage_s": stage_s, "peak_device_bytes": peak_dev,
            "peak_rss_gb": rss_gb, **got}


def artifact_digests(rd) -> dict:
    """sha256 of every array artifact (npz members and .arrd arrays) and
    of the FASTA/superb outputs; logs, manifest and report (which carry
    timings) are left out."""
    out = {}
    for root, _, files in os.walk(rd.path):
        for fn in sorted(files):
            p = os.path.join(root, fn)
            rel = os.path.relpath(p, rd.path)
            if fn.endswith(".npz"):
                with np.load(p) as z:
                    for k in z.files:
                        out[f"{rel}:{k}"] = hashlib.sha256(
                            np.ascontiguousarray(z[k]).tobytes()).hexdigest()
            elif fn.endswith((".npy", ".fasta", ".efasta", ".fsa", ".agp",
                              ".superb")):
                with open(p, "rb") as f:
                    out[rel] = hashlib.sha256(f.read()).hexdigest()
    return out


def multichip_phase(work, genome, n_chips=4, card: str = "") -> None:
    """The pipeline on `n_chips` devices vs one device (byte-identical
    artifacts), then the mesh legs of the driver entry."""
    import __graft_entry__ as entry

    digests = {}
    for n in (1, n_chips):
        t0 = time.perf_counter()
        rd, report = run_pipeline(os.path.join(work, f"dev{n}"), genome,
                                  n_devices=n, quiet=True)
        check_assembly(rd, report, genome)
        digests[n] = artifact_digests(rd)
        log(f"[multichip] n_devices={n}: {time.perf_counter() - t0:.1f} s, "
            f"{len(digests[n])} artifact arrays [{card}]")
    a, b = digests[1], digests[n_chips]
    diff = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
    log(f"[multichip] artifacts byte-identical: {not diff} "
        f"({len(a)} compared)" + (f"; differ: {diff[:20]}" if diff else ""))
    if diff:
        raise AssertionError(f"{n_chips}-device artifacts differ from the "
                             f"1-device run: {diff[:20]}")
    entry.mesh_legs(n_chips)
    log(f"[multichip] mesh legs (all_to_all counting, ring scan, sample "
        f"sort) ok on {n_chips} devices")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome", type=int, default=None,
                    help="genome bases (default 1000000; 20000 with "
                         "--chips 4, a correctness check that costs 4x)")
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    import jax

    dev = device_phase(args.chips)
    work_root = os.path.join(REPO, ".smoke_runs")
    os.makedirs(work_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work_root) as work:
        if args.chips > 1:
            multichip_phase(work, args.genome or 20_000, args.chips,
                            dev["card"])
        else:
            dp_phase(card=dev["card"])
            main_path_phase(os.path.join(work, "run"),
                            args.genome or 1_000_000, dev["card"])
    d0 = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
