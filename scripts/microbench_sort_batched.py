"""Microbench: is a BATCHED row sort (lax.sort along axis 1) materially
faster per element than one flat sort? If rows fit on-chip memory and XLA fuses the
whole per-row network on-chip, counting can be restructured as
bucket-partition + row sorts (columnsort-style), beating the HBM-pass-bound
flat sort.

Run on the real chip: timeout 600 python scripts/microbench_sort_batched.py
"""
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
    int(np.asarray(r(*args)).ravel()[0])
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        int(np.asarray(r(*args)).ravel()[0])
        ts.append(time.perf_counter() - t0)
    dt = min(ts) / REP
    log(f"{name:46s} {dt*1e3:8.2f} ms  {N/dt/1e6:8.1f} Melem/s")
    return dt


def loopify(body):
    def fn(w0, w1):
        def it(i, tot):
            a = w0.ravel().at[0].set(i.astype(jnp.uint32)).reshape(w0.shape)
            out = body(a, w1)
            s = jnp.uint64(0)
            for o in out:
                f = o.ravel()
                s += f[0].astype(jnp.uint64) + f[-1].astype(jnp.uint64)
            return tot + s
        return lax.fori_loop(0, REP, it, jnp.uint64(0))
    return fn


def main():
    rng = np.random.default_rng(0)
    w0f = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    w1f = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    dev = jax.devices()[0]
    log(f"device: {dev} ({dev.device_kind}), N=2^24")

    flat0 = jnp.asarray(w0f)
    flat1 = jnp.asarray(w1f)
    timeit("flat sort 2 keys (current count path)",
           loopify(lambda a, b: lax.sort([a, b], num_keys=2,
                                         is_stable=False)), flat0, flat1)
    timeit("flat sort 1 key",
           loopify(lambda a, b: lax.sort([a], num_keys=1,
                                         is_stable=False)), flat0, flat1)

    for rows_log2 in (20, 17, 14, 12, 10):
        R = 1 << rows_log2
        T = N // R
        a0 = jnp.asarray(w0f.reshape(T, R))
        a1 = jnp.asarray(w1f.reshape(T, R))
        timeit(f"row sort 2 keys [{T}, 2^{rows_log2}] axis=1",
               loopify(lambda a, b: lax.sort([a, b], num_keys=2,
                                             dimension=1, is_stable=False)),
               a0, a1)
        timeit(f"row sort 1 key  [{T}, 2^{rows_log2}] axis=1",
               loopify(lambda a, b: lax.sort([a], num_keys=1,
                                             dimension=1, is_stable=False)),
               a0, a1)

    # transpose cost (columnsort step)
    R = 1 << 17
    T = N // R
    a0 = jnp.asarray(w0f.reshape(T, R))
    timeit("transpose [128, 2^17] -> [2^17, 128]",
           loopify(lambda a, b: (a.T.reshape(b.shape[0] if False else -1)[:1],)),
           a0, flat1)

    # gather cost: take_along_axis rows (bucket slab gather analog)
    idx = jnp.asarray(rng.permutation(N).astype(np.int32))
    timeit("flat gather x[idx] (1 word)",
           loopify(lambda a, b: (a.ravel()[idx],)), flat0, flat1)


if __name__ == "__main__":
    main()
