"""Scaling curve for distributed k-mer counting (BASELINE.md measurement
points: 1 chip / 1 host / >=2 hosts).

The points run on a VIRTUAL CPU mesh
(--xla_force_host_platform_device_count) and a real 2-process
jax.distributed CPU arrangement — labeled `virtual-cpu`. The machinery
measured (hash-routed all_to_all + sharded sort/count in
parallel/dist_count.py) is what runs over NVLink on a multi-GPU host; the
absolute CPU numbers are meaningless, the SCALING RATIOS and the fact the
collective path executes end-to-end are the point. The device rate is
measured by bench.py on a GPU.

Usage: python scripts/bench_scaling.py   (prints one JSON line)
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_READS, READ_LEN, K, REP = 4096, 100, 24, 4

_SINGLE = r"""
import os, sys, time, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%(nd)d"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from jax import lax

N, L, K, REP = %(n)d, %(l)d, %(k)d, %(rep)d
rng = np.random.default_rng(0)
codes = jnp.asarray(rng.integers(0, 4, (N, L)).astype(np.uint8))
if %(nd)d == 1:
    from allpathslg_tpu.kmer import count as kcount
    @jax.jit
    def many(c):
        def body(i, tot):
            cc = c.at[0, 0].set((i %% 4).astype(jnp.uint8))
            spec, nu = kcount.spectrum_reads(cc, K, 63)
            return tot + nu
        return lax.fori_loop(0, REP, body, jnp.int32(0))
else:
    from allpathslg_tpu.parallel import mesh as pmesh
    from allpathslg_tpu.parallel.dist_count import distributed_spectrum
    m = pmesh.make_mesh()
    @jax.jit
    def many(c):
        def body(i, tot):
            cc = c.at[0, 0].set((i %% 4).astype(jnp.uint8))
            spec, dropped, w, cnt, nu = distributed_spectrum(
                m, cc, K=K, capacity_factor=4.0, max_freq=63)
            return tot + nu.sum() + 0 * dropped.sum()
        return lax.fori_loop(0, REP, body, jnp.int32(0))
int(many(codes))
t0 = time.perf_counter(); int(many(codes)); dt = (time.perf_counter()-t0)/REP
print(json.dumps({"devices": %(nd)d, "kmers_per_s": N*(L-K+1)/dt}))
"""

_MULTI = r"""
import os, sys, time, json
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
from allpathslg_tpu.parallel import multihost as mh
mh.initialize(coordinator=f"127.0.0.1:{port}", num_processes=nproc,
              process_id=pid)
import numpy as np
import jax.numpy as jnp
from jax import lax
from allpathslg_tpu.parallel.dist_count import distributed_spectrum

N, L, K, REP = %(n)d, %(l)d, %(k)d, %(rep)d
rng = np.random.default_rng(0)
codes = rng.integers(0, 4, (N, L)).astype(np.uint8)
m = mh.global_mesh()
rows = N // nproc
garr = mh.host_batch_to_global(codes[pid*rows:(pid+1)*rows], m)

@jax.jit
def many(c):
    def body(i, tot):
        cc = c.at[0, 0].set((i %% 4).astype(jnp.uint8))
        spec, dropped, w, cnt, nu = distributed_spectrum(
            m, cc, K=K, capacity_factor=4.0, max_freq=63)
        return tot + nu.sum() + 0 * dropped.sum()
    return lax.fori_loop(0, REP, body, jnp.int32(0))
int(many(garr))
t0 = time.perf_counter(); int(many(garr)); dt = (time.perf_counter()-t0)/REP
if pid == 0:
    print(json.dumps({"devices": 4*nproc, "processes": nproc,
                      "kmers_per_s": N*(L-K+1)/dt}), flush=True)
"""


def _run_single(nd: int):
    code = _SINGLE % {"nd": nd, "n": N_READS, "l": READ_LEN, "k": K,
                      "rep": REP}
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(r.stdout + r.stderr)
    return json.loads(r.stdout.strip().splitlines()[-1])


def _run_multi(nproc: int):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    code = _MULTI % {"n": N_READS, "l": READ_LEN, "k": K, "rep": REP}
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(p), str(nproc), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for p in range(nproc)]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(o)
    for o in outs:
        for line in o.splitlines():
            if line.startswith("{"):
                return json.loads(line)
    raise RuntimeError("no result line\n" + "\n".join(outs))


def main():
    points = []
    for nd in (1, 8):
        r = _run_single(nd)
        r["arrangement"] = f"{nd}-device virtual-cpu mesh" if nd > 1 \
            else "1 device (cpu reference for ratios)"
        points.append(r)
        print(json.dumps(r), file=sys.stderr, flush=True)
    r = _run_multi(2)
    r["arrangement"] = "2-process jax.distributed x 4 virtual-cpu devices"
    points.append(r)
    print(json.dumps(r), file=sys.stderr, flush=True)
    base = points[0]["kmers_per_s"]
    for p in points:
        p["speedup_vs_1dev"] = round(p["kmers_per_s"] / base, 2)
    print(json.dumps({
        "metric": "dist_count_scaling_virtual_cpu",
        "note": "this host has 2 physical cores; 8 virtual devices share "
                "them, so ratios <1 reflect collective+shard overhead on "
                "oversubscribed cores, NOT the multi-GPU behavior. The "
                "points demonstrate the multi-device/multi-process path "
                "executes end-to-end; the device rate is in bench.py.",
        "points": points}))


if __name__ == "__main__":
    main()
