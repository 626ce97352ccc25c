"""Distributed sample sort over a device mesh.

Behavior contract (ref: the OpenMP `ParallelSort`/`SortSync` workhorse,
src/ParallelVecUtilities.h — SURVEY.md §2.7 P6): sort giant key/payload
record arrays across all chips. The reference never leaves one host; here
the multi-chip recipe is the classic sample sort mapped onto JAX
collectives (SURVEY.md §5.8):

  1. local sort per shard (`lax.sort`),
  2. every shard contributes s sample keys → `all_gather` → global
     splitters (replicated, deterministic),
  3. bucket local elements by splitter (searchsorted — elements are
     already sorted so buckets are contiguous runs),
  4. `all_to_all` redistribution into owner shards with fixed per-bucket
     capacity (static shapes: capacity_factor × fair share; overflowing
     elements are counted, never silently dropped),
  5. local merge = one more local sort of the received records.

Keys are multi-word uint32 (lexicographic), payloads ride along. The output
stays sharded: shard i holds the i-th contiguous range of the global order,
sentinel-padded at the tail (count returned per shard).
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

SENTINEL = np.uint32(0xFFFFFFFF)
AXIS = "x"


def _local_sort(words: List[jnp.ndarray], pays: List[jnp.ndarray]):
    out = lax.sort(list(words) + list(pays), num_keys=len(words),
                   dimension=0, is_stable=True)
    return list(out[: len(words)]), list(out[len(words):])


def _searchsorted_words(sorted_words, query_words):
    """Rank of each query in the local sorted multi-word key array
    (side='left'), via bit-packed comparison per word pair."""
    # binary search over lo/hi using lexicographic compare
    n = sorted_words[0].shape[0]
    q = query_words
    # derive carries from the operands so their varying-axes type matches
    # the loop body under shard_map's vma tracking
    lo = (q[0] & jnp.uint32(0)).astype(jnp.int32) \
        + (sorted_words[0][0] & jnp.uint32(0)).astype(jnp.int32)
    hi = lo + n

    def less(words_at, qws):
        # words_at < qws lexicographically
        lt = jnp.zeros(qws[0].shape, bool)
        eq = jnp.ones(qws[0].shape, bool)
        for w, qq in zip(words_at, qws):
            lt = lt | (eq & (w < qq))
            eq = eq & (w == qq)
        return lt

    n_iter = max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)

    def body(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) // 2
        midw = [w[jnp.clip(mid, 0, n - 1)] for w in sorted_words]
        go_right = less(midw, q) & (mid < n)
        return jnp.where(go_right, mid + 1, lo), jnp.where(go_right, hi, mid)

    lo, hi = lax.fori_loop(0, n_iter, body, (lo, hi))
    return lo


def sample_sort(mesh: Mesh, words: Sequence[jnp.ndarray],
                payloads: Sequence[jnp.ndarray] = (),
                oversample: int = 32,
                capacity_factor: float = 2.0):
    """Globally sort sharded multi-word keys (+payloads) across the mesh.

    words/payloads: arrays sharded on axis 0 over mesh axis "x"; sentinel
    (all-ones) keys sort last and pad shard tails.

    Returns (sorted_words, sorted_payloads, n_real_per_shard, n_dropped):
    shard i holds global-order range i, sentinel-padded; n_dropped is the
    total count that exceeded per-shard capacity (0 in healthy runs —
    raise capacity_factor if nonzero).
    """
    n_shards = mesh.devices.size
    W = len(words)
    NP = len(payloads)
    total = words[0].shape[0]
    per_shard = total // n_shards
    cap = int(np.ceil(per_shard * capacity_factor / 128.0)) * 128

    def step(*arrs):
        ws = [a.reshape(-1) for a in arrs[:W]]
        ps = [a.reshape(-1) for a in arrs[W:]]
        ws, ps = _local_sort(ws, ps)
        n_local = ws[0].shape[0]

        # 2) splitters: s evenly spaced local samples, all-gathered
        s_idx = (jnp.arange(oversample, dtype=jnp.int32) * n_local
                 // oversample)
        samples = [w[s_idx] for w in ws]
        gathered = [lax.all_gather(s, AXIS).reshape(-1) for s in samples]
        gsorted = lax.sort(gathered, num_keys=W, dimension=0)
        if not isinstance(gsorted, (list, tuple)):
            gsorted = [gsorted]
        gsorted = list(gsorted)
        m = gsorted[0].shape[0]
        sp_idx = (jnp.arange(1, n_shards, dtype=jnp.int32) * m) // n_shards
        splitters = [g[sp_idx] for g in gsorted]  # [n_shards-1]

        # 3) bucket = rank among splitters (elements sorted → runs):
        # bucket of element i = #{splitter ranks <= i}
        ranks = _searchsorted_words(ws, splitters)  # rank of splitter in ws
        bounds = jnp.concatenate([jnp.zeros(1, jnp.int32), ranks,
                                  jnp.full((1,), n_local, jnp.int32)])
        idx = jnp.arange(n_local, dtype=jnp.int32)
        bucket = (jnp.searchsorted(ranks, idx, side="right").astype(jnp.int32)
                  if n_shards > 1 else jnp.zeros(n_local, jnp.int32))
        pos_in_bucket = idx - bounds[bucket]
        slot = bucket * cap + pos_in_bucket
        dropped = jnp.sum((pos_in_bucket >= cap).astype(jnp.int32))

        buf_w = [jnp.full((n_shards * cap,), SENTINEL, jnp.uint32)
                 for _ in range(W)]
        buf_p = [jnp.zeros((n_shards * cap,), p.dtype) for p in ps]
        ok = pos_in_bucket < cap
        slot_safe = jnp.where(ok, slot, 0)
        buf_w = [b.at[slot_safe].set(jnp.where(ok, w, SENTINEL), mode="drop")
                 for b, w in zip(buf_w, ws)]
        buf_p = [b.at[slot_safe].set(jnp.where(ok, p, jnp.zeros_like(p)),
                                     mode="drop")
                 for b, p in zip(buf_p, ps)]

        # 4) all_to_all: bucket b of every shard → shard b
        def a2a(x):
            return lax.all_to_all(x.reshape(n_shards, cap), AXIS, 0, 0,
                                  tiled=False).reshape(-1)

        recv_w = [a2a(b) for b in buf_w]
        recv_p = [a2a(b) for b in buf_p]

        # 5) local merge
        recv_w, recv_p = _local_sort(recv_w, recv_p)
        n_real = jnp.sum((~_is_sentinel(recv_w)).astype(jnp.int32))
        n_drop_tot = lax.psum(dropped, AXIS)
        return tuple(recv_w) + tuple(recv_p) + (
            n_real.reshape(1), n_drop_tot.reshape(1))

    in_specs = tuple([P(AXIS)] * (W + NP))
    out_specs = tuple([P(AXIS)] * (W + NP)) + (P(AXIS), P(AXIS))
    f = shard_map(step, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    out = f(*(list(words) + list(payloads)))
    sw = list(out[:W])
    sp = list(out[W: W + NP])
    n_real = out[W + NP]
    n_drop = out[W + NP + 1][0]
    return sw, sp, n_real, n_drop


def _is_sentinel(words):
    m = jnp.ones(words[0].shape, bool)
    for w in words:
        m = m & (w == SENTINEL)
    return m
