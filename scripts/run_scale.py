"""Reproducible scale run: simulate a genome, run the FULL pipeline, and
land the receipts (wall-clock, peak RSS, N50s, base-error report) as JSON.

This is the artifact runner for the binding E. coli-class config
(BASELINE.md: "E. coli K-12 100x fragment+jump libraries, full pipeline,
1 chip"; ref envelope: hours on a multicore server, SURVEY.md §6).

Usage:
  python scripts/run_scale.py --genome 4600000 --coverage 100 \
      --jump-coverage 50 --run-dir /tmp/ecoli [--seed 7] [KEY=VALUE ...]

Prints one JSON line at the end with the metrics; also writes
<run-dir>/scale_metrics.json.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome", type=int, default=4_600_000)
    ap.add_argument("--coverage", type=float, default=100.0)
    ap.add_argument("--error-rate", type=float, default=0.01)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--jump-coverage", type=float, default=50.0)
    ap.add_argument("--jump-insert", type=int, default=3000)
    ap.add_argument("--jump-sd", type=int, default=300)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--k", type=int, default=96)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    from allpathslg_tpu.pipeline import run as prun
    from allpathslg_tpu.pipeline.config import AssemblyConfig
    from allpathslg_tpu.pipeline.rundir import RunDir
    from allpathslg_tpu.pipeline.stages import Pipeline
    from allpathslg_tpu.utils import compile_cache

    over = {}
    for kv in args.overrides:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except Exception:
            pass
        over[k] = v
    cfg = AssemblyConfig.from_overrides(K=args.k, **over)
    rd = RunDir(args.run_dir)
    log = prun._log_factory(rd)
    log(f"[scale] config: {cfg.to_json()}")
    log(f"[scale] compile cache: {compile_cache.enable()}")

    t0 = time.perf_counter()
    if not rd.has("frag_reads_orig"):
        prun.prepare_sim_inputs(
            rd, args.genome, args.coverage, args.error_rate, args.read_len,
            args.seed, log, jump_coverage=args.jump_coverage,
            jump_insert=args.jump_insert, jump_sd=args.jump_sd)
    t_prep = time.perf_counter() - t0

    pipe = Pipeline(rd, cfg, log)
    t1 = time.perf_counter()
    report = pipe.run_full()
    wall = time.perf_counter() - t1

    peak_rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    stage_s = {name: rec.get("elapsed_s", 0.0)
               for name, rec in rd.manifest["stages"].items()}
    top3 = sorted(stage_s.items(), key=lambda kv: -kv[1])[:3]
    stage_metrics = {name: rd.manifest["stages"][name].get("metrics", {})
                     for name in ("make_scaffolds", "evaluate",
                                  "clean_final", "unipaths")
                     if name in rd.manifest["stages"]}
    metrics = {
        "genome_size": args.genome,
        "coverage": args.coverage,
        "jump_coverage": args.jump_coverage,
        "error_rate": args.error_rate,
        "prepare_s": round(t_prep, 1),
        "pipeline_wall_s": round(wall, 1),
        "peak_rss_gb": round(peak_rss_gb, 2),
        "stage_wall_s": stage_s,
        "top3_stages": [[n, round(s, 1)] for n, s in top3],
        "stage_metrics": stage_metrics,
        "report": report,
    }
    with open(os.path.join(args.run_dir, "scale_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=1)
    print(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    sys.exit(main())
