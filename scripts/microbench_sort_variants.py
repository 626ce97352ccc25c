"""Microbench lax.sort key/payload variants on the device at N=2^24.

Question: does dropping from 2 compare-keys to 1 key (+payload) buy enough
to justify a hash-sort + odd-even fixup counting path?
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
    int(np.asarray(r(*args)).ravel()[0])  # compile+warm
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        int(np.asarray(r(*args)).ravel()[0])
        ts.append(time.perf_counter() - t0)
    dt = min(ts) / REP
    log(f"{name:42s} {dt*1e3:8.2f} ms  {N/dt/1e6:8.1f} Melem/s")
    return dt


def main():
    rng = np.random.default_rng(0)
    w0 = jnp.asarray(rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32))
    w1 = jnp.asarray(rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32))
    dev = jax.devices()[0]
    log(f"device: {dev} ({dev.device_kind}), N=2^24")

    def loopify(body):
        # iteration-varying input; returns scalar dependent on all output
        def fn(w0, w1):
            def it(i, tot):
                a = w0.at[0].set(i.astype(jnp.uint32))
                out = body(a, w1)
                return tot + sum(o[0].astype(jnp.int64) + o[-1].astype(jnp.int64) for o in out)
            return lax.fori_loop(0, REP, it, jnp.int64(0))
        return fn

    timeit("sort 2 keys (current)",
           loopify(lambda a, b: lax.sort([a, b], num_keys=2, is_stable=False)), w0, w1)
    timeit("sort 1 key + 2 payload",
           loopify(lambda a, b: lax.sort([a, b, b], num_keys=1, is_stable=False)), w0, w1)
    timeit("sort 1 key + 1 payload",
           loopify(lambda a, b: lax.sort([a, b], num_keys=1, is_stable=False)), w0, w1)
    timeit("sort 1 key alone",
           loopify(lambda a, b: lax.sort([a], num_keys=1, is_stable=False)), w0, w1)
    timeit("sort 3 keys",
           loopify(lambda a, b: lax.sort([a, b, b], num_keys=3, is_stable=False)), w0, w1)

    # odd-even fixup pass cost (6 passes over 3 words)
    def oddeven(a, b):
        h, x, y = a, b, b

        def one_pass(h, x, y, phase):
            idx = jnp.arange(N, dtype=jnp.int32)
            up = (idx % 2) == phase
            nh = jnp.roll(h, -1)
            nx = jnp.roll(x, -1)
            ny = jnp.roll(y, -1)
            swap = up & (h == nh) & ((x > nx) | ((x == nx) & (y > ny)))
            swap_lo = jnp.roll(swap, 1)
            h2 = jnp.where(swap, nh, jnp.where(swap_lo, jnp.roll(h, 1), h))
            x2 = jnp.where(swap, nx, jnp.where(swap_lo, jnp.roll(x, 1), x))
            y2 = jnp.where(swap, ny, jnp.where(swap_lo, jnp.roll(y, 1), y))
            return h2, x2, y2

        def body(i, c):
            h, x, y = c
            return one_pass(h, x, y, i % 2)
        h, x, y = lax.fori_loop(0, 6, body, (h, x, y))
        return [h, x, y]
    timeit("6 odd-even fixup passes (3 words)", loopify(oddeven), w0, w1)


if __name__ == "__main__":
    main()
