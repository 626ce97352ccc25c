"""Microbench: lax.sort variants on the device — where does kmer counting time go.

Run: timeout 600 python scripts/microbench_sort.py
"""
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

REP = 8


def timeit(name, fn, *args):
    int(fn(*args))  # compile + sync
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        int(fn(*args))
        ts.append(time.perf_counter() - t0)
    dt = min(ts) / REP
    print(f"{name}: {dt*1e3:.2f} ms/iter", flush=True)
    return dt


def chain(body_fn, x):
    """REP iterations chained in one jit; input varied per iter."""
    @jax.jit
    def run(x):
        def body(i, carry):
            tot, x = carry
            x0 = [w.at[0].set(i.astype(w.dtype)) for w in x]
            out = body_fn(x0)
            return tot + out, x
        tot, _ = lax.fori_loop(0, REP, body, (jnp.uint32(0), x))
        return tot
    return run


def main():
    dev = jax.devices()[0]
    print(f"device: {dev} ({dev.device_kind})", file=sys.stderr, flush=True)
    N = 1 << 24
    rng = np.random.default_rng(0)
    w0 = jnp.asarray(rng.integers(0, 2**32, N, dtype=np.uint32))
    w1 = jnp.asarray(rng.integers(0, 2**16, N, dtype=np.uint32))

    # 1-key sort
    f1 = chain(lambda x: lax.sort([x[0]], num_keys=1)[0][-1], [w0])
    timeit("sort 1key 2^24 flat", f1, [w0])

    # 2-key sort
    f2 = chain(lambda x: lax.sort([x[0], x[1]], num_keys=2,
                                  dimension=0)[0][-1], [w0, w1])
    timeit("sort 2key 2^24 flat", f2, [w0, w1])

    # 1key + 1 payload
    f3 = chain(lambda x: lax.sort([x[0], x[1]], num_keys=1,
                                  dimension=0)[0][-1], [w0, w1])
    timeit("sort 1key+1pay 2^24", f3, [w0, w1])

    # batched rows: [256, 65536] along axis 1
    w0r = w0.reshape(256, 65536)
    w1r = w1.reshape(256, 65536)
    f4 = chain(lambda x: lax.sort([x[0], x[1]], num_keys=2,
                                  dimension=1)[0][-1, -1], [w0r, w1r])
    timeit("sort 2key [256,65536] rows", f4, [w0r, w1r])

    # batched rows: [16, 2^20]
    w0s = w0.reshape(16, 1 << 20)
    w1s = w1.reshape(16, 1 << 20)
    f5 = chain(lambda x: lax.sort([x[0], x[1]], num_keys=2,
                                  dimension=1)[0][-1, -1], [w0s, w1s])
    timeit("sort 2key [16,2^20] rows", f5, [w0s, w1s])

    # smaller flat sorts: 2^21
    w0t = w0[: 1 << 21]
    w1t = w1[: 1 << 21]
    f6 = chain(lambda x: lax.sort([x[0], x[1]], num_keys=2,
                                  dimension=0)[0][-1], [w0t, w1t])
    dt = timeit("sort 2key 2^21 flat", f6, [w0t, w1t])
    print(f"  -> x8 = {dt*8*1e3:.2f} ms for same total elems", flush=True)


if __name__ == "__main__":
    main()
