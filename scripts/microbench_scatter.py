"""Measure device scatter/gather primitives at N=2^24 to judge radix-sort feasibility."""
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

REP = 4
N = 1 << 24


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timeit(name, fn, *args):
    r = jax.jit(fn)
    try:
        int(np.asarray(r(*args)).ravel()[0])
    except Exception as e:
        log(f"{name:44s} FAILED {type(e).__name__}: {e}")
        return None
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        int(np.asarray(r(*args)).ravel()[0])
        ts.append(time.perf_counter() - t0)
    dt = min(ts) / REP
    log(f"{name:44s} {dt*1e3:8.2f} ms  {N/dt/1e6:8.1f} Melem/s")
    return dt


def loopify(body):
    def fn(*args):
        def it(i, tot):
            a0 = args[0].at[0].set(i.astype(args[0].dtype))
            out = body(a0, *args[1:])
            return tot + out[0].astype(jnp.int32) + out[-1].astype(jnp.int32)
        return lax.fori_loop(0, REP, it, jnp.int32(0))
    return fn


def main():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, 1 << 31, N, dtype=np.int64).astype(np.int32))
    perm = jnp.asarray(rng.permutation(N).astype(np.int32))
    log(f"device: {jax.devices()[0]}")

    timeit("random gather x[perm]", loopify(lambda x, p: x[p]), x, perm)
    timeit("scatter-set unique x.at[perm].set",
           loopify(lambda x, p: jnp.zeros(N, jnp.int32).at[p].set(
               x, mode="drop", unique_indices=True)), x, perm)
    timeit("scatter-set sorted-ish ids",
           loopify(lambda x, p: jnp.zeros(N, jnp.int32).at[
               jnp.arange(N, dtype=jnp.int32)].set(x, unique_indices=True)), x, perm)
    # 2D gather: rows of a [N/128,128] matrix
    x2 = x.reshape(-1, 128)
    rp = jnp.asarray(rng.permutation(N // 128).astype(np.int32))
    timeit("row gather [131072,128]",
           loopify(lambda x2, rp: x2[rp].reshape(-1)), x2, rp)
    timeit("row scatter [131072,128]",
           loopify(lambda x2, rp: jnp.zeros_like(x2).at[rp].set(
               x2, unique_indices=True).reshape(-1)), x2, rp)
    # one-hot matmul histogram (256 bins) for radix pass-1 cost estimate
    d = (x & 255).astype(jnp.int32)
    def hist_mm(d):
        oh = (d.reshape(-1, 128)[:, :, None] == jnp.arange(256)[None, None, :])
        return [oh.sum(axis=(0, 1)).astype(jnp.int32)]
    timeit("one-hot 256-bin histogram (compare-reduce)", loopify(hist_mm), d)
    # masked cumsum rank for 16 buckets (one 4-bit radix pass rank cost)
    def rank16(d):
        d4 = d & 15
        r = jnp.zeros(N, jnp.int32)
        for b in range(16):
            m = (d4 == b).astype(jnp.int32)
            r = r + jnp.where(d4 == b, jnp.cumsum(m) - 1, 0)
        return [r]
    timeit("16-bucket stable rank (16 masked cumsums)", loopify(rank16), d)


if __name__ == "__main__":
    main()
