"""Unipath construction: condense the de Bruijn graph of canonical k-mers
into maximal unbranched paths, entirely with sorts, joins and pointer
doubling on device.

Behavior contract (ref: src/paths/Unipath.cc `Unipath()`, Unipather.cc,
KmerBaseBroker — SURVEY.md §2.4/§3.3): given the kmer set of (corrected)
reads, emit unipaths (maximal runs of kmers with unique extension) and their
base sequences (unibases), with reverse-complement involution handled so each
unipath appears exactly once.

Device algorithm (replaces hash maps + sequential walking):
  * 2M oriented nodes over M canonical kmers (node id = 2*i + orient).
  * successor lookup: shift-append each base, canonicalize, searchsorted
    into the sorted kmer table → out-degrees and unique successors.
  * indeg(x) = outdeg(flip x); chain edge x→y iff outdeg(x)==1 ∧ indeg(y)==1
    (plus a hairpin guard y != flip(x)), giving an rc-symmetric `next`.
  * prev[x] = flip(next[flip x]) — no scatter needed.
  * chains found by pointer doubling on prev (distance-to-head), with
    cycles (circular contigs/plasmids, homopolymer self-loops) broken at
    their minimum-id node found by min-label doubling.
  * unibase emission: ragged flat+offsets built by a searchsorted inverse
    map — every output base is one dynamic-bit-extract gather.

Known simplification: fully rc-palindromic K-mers (even K only) get two
coincident oriented nodes; their chains dedupe by sequence later stages.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from allpathslg_tpu.kmer import bits
from allpathslg_tpu.ops import join, sort as ops_sort, segmented


@dataclasses.dataclass
class Unipaths:
    """Host-side unipath set (ragged)."""
    bases: np.ndarray      # uint8 [total] concatenated unibase sequences
    offsets: np.ndarray    # int64 [n+1] start offsets into bases
    kmer_counts: np.ndarray  # int32 [n] kmers per unipath (len - K + 1)
    mean_cov: Optional[np.ndarray] = None  # float [n] mean kmer multiplicity

    @property
    def n(self) -> int:
        return len(self.offsets) - 1

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def sequence(self, i: int) -> np.ndarray:
        return self.bases[self.offsets[i] : self.offsets[i + 1]]


def _node_values(table, K: int):
    """Oriented node values: [2M] word arrays, node 2i fwd / 2i+1 rc."""
    M = table[0].shape[0]
    rc = bits.rc_words(table, K)
    vals = []
    for wf, wr in zip(table, rc):
        v = jnp.stack([wf, wr], axis=1).reshape(-1)  # interleave: 2i, 2i+1
        vals.append(v)
    return vals


@functools.partial(jax.jit, static_argnames=("K",))
def _chain_phase(table: Tuple[jnp.ndarray, ...], K: int):
    """Phase 1: next/prev pointers, chain heads, distances, per-node info.

    table: W sorted unique canonical kmer words [M] (no padding).
    Returns (head, dist, vals, outdeg) over 2M oriented nodes.
    """
    table = list(table)
    M = table[0].shape[0]
    n_nodes = 2 * M
    vals = _node_values(table, K)

    # successors: 4 shift-appends + canonical + join
    found_any = jnp.zeros(n_nodes, dtype=jnp.int32)
    succ_node = jnp.full(n_nodes, -1, dtype=jnp.int32)
    for b in range(4):
        s = bits.shift_append(vals, jnp.uint32(b), K)
        canon, is_rc = bits.canonical(s, K)
        idx, found = join.searchsorted_words(table, canon)
        node = idx * 2 + is_rc.astype(jnp.int32)
        found_any = found_any + found.astype(jnp.int32)
        succ_node = jnp.where(found, node, succ_node)
    outdeg = found_any
    uniq_succ = jnp.where(outdeg == 1, succ_node, -1)

    # indeg(y) = outdeg(flip y); flip(node) = node ^ 1
    node_ids = jnp.arange(n_nodes, dtype=jnp.int32)
    indeg_of = lambda nodes: outdeg[nodes ^ 1]
    y = uniq_succ
    ok = (y >= 0) & (indeg_of(jnp.maximum(y, 0)) == 1)
    nxt = jnp.where(ok, y, -1)
    # rc symmetry gives prev without scatter: prev[x] = flip(next[flip x])
    nf = nxt[node_ids ^ 1]
    prv = jnp.where(nf >= 0, nf ^ 1, -1)

    n_iter = max(1, int(np.ceil(np.log2(max(n_nodes, 2)))) + 1)

    # min-label doubling to find cycle representatives
    ptr = jnp.where(prv >= 0, prv, node_ids)
    lab = node_ids

    def mbody(_, state):
        ptr, lab = state
        lab = jnp.minimum(lab, lab[ptr])
        return ptr[ptr], lab

    ptr_f, minlab = lax.fori_loop(0, n_iter, mbody, (ptr, lab))
    # path nodes end at a head (prev==-1); cycle nodes never do
    in_cycle = prv[ptr_f] >= 0
    # break each cycle at its min-label node
    is_head = (prv < 0) | (in_cycle & (minlab == node_ids))
    prv = jnp.where(is_head, -1, prv)

    # distance-to-head pointer jumping: dist[x] += dist[ptr[x]] with
    # dist[head] = 0 and self-pointing heads converges to steps-to-head
    ptr = jnp.where(prv >= 0, prv, node_ids)
    dist = jnp.where(is_head, 0, 1)

    def dbody(_, state):
        ptr, dist = state
        return ptr[ptr], dist + dist[ptr]

    ptr_f2, dist = lax.fori_loop(0, n_iter, dbody, (ptr, dist))
    head = ptr_f2  # converged pointer = head (heads self-point)
    return head, dist, vals, outdeg, nxt


@functools.partial(jax.jit, static_argnames=("K", "b"))
def _succ_probe(table: Tuple[jnp.ndarray, ...], vals: Tuple[jnp.ndarray, ...],
                K: int, b: int):
    """One base's successor probe (shift-append + canonical + join)."""
    s = bits.shift_append(list(vals), jnp.uint32(b), K)
    canon, is_rc = bits.canonical(s, K)
    idx, found = join.searchsorted_words(list(table), canon)
    node = idx * 2 + is_rc.astype(jnp.int32)
    return node, found


@jax.jit
def _chain_links(succ0, found0, succ1, found1, succ2, found2, succ3, found3):
    """Combine per-base probes into (outdeg, nxt, prv, is_head_seed)."""
    outdeg = (found0.astype(jnp.int32) + found1.astype(jnp.int32)
              + found2.astype(jnp.int32) + found3.astype(jnp.int32))
    succ = jnp.full_like(succ0, -1)
    for s, f in ((succ0, found0), (succ1, found1),
                 (succ2, found2), (succ3, found3)):
        succ = jnp.where(f, s, succ)
    n_nodes = succ.shape[0]
    node_ids = jnp.arange(n_nodes, dtype=jnp.int32)
    uniq_succ = jnp.where(outdeg == 1, succ, -1)
    y = uniq_succ
    ok = (y >= 0) & (outdeg[jnp.maximum(y, 0) ^ 1] == 1)
    nxt = jnp.where(ok, y, -1)
    nf = nxt[node_ids ^ 1]
    prv = jnp.where(nf >= 0, nf ^ 1, -1)
    return outdeg, nxt, prv


@jax.jit
def _double_min(ptr, lab):
    return ptr[ptr], jnp.minimum(lab, lab[ptr])


@jax.jit
def _double_dist(ptr, dist):
    return ptr[ptr], dist + dist[ptr]


def _chain_phase_chunked(table: Tuple[jnp.ndarray, ...], K: int):
    """_chain_phase semantics in BOUNDED device dispatches: at multi-M
    node counts the single fused program runs for minutes; slicing the
    probes and each pointer-doubling round into separate dispatches keeps
    every program short. Outputs
    are identical to _chain_phase."""
    table = list(table)
    M = int(table[0].shape[0])
    n_nodes = 2 * M
    vals = _node_values(table, K)
    probes = [_succ_probe(tuple(table), tuple(vals), K, b)
              for b in range(4)]
    args = []
    for node, found in probes:
        args += [node, found]
    outdeg, nxt, prv = _chain_links(*args)

    n_iter = max(1, int(np.ceil(np.log2(max(n_nodes, 2)))) + 1)
    node_ids = jnp.arange(n_nodes, dtype=jnp.int32)
    ptr = jnp.where(prv >= 0, prv, node_ids)
    lab = node_ids
    for _ in range(n_iter):
        ptr, lab = _double_min(ptr, lab)
    in_cycle = prv[ptr] >= 0
    is_head = (prv < 0) | (in_cycle & (lab == node_ids))
    prv2 = jnp.where(is_head, -1, prv)
    ptr = jnp.where(prv2 >= 0, prv2, node_ids)
    dist = jnp.where(is_head, 0, 1).astype(jnp.int32)
    for _ in range(n_iter):
        ptr, dist = _double_dist(ptr, dist)
    return ptr, dist, vals, outdeg, nxt


# fused-program node-count ceiling: above this build_unipaths uses the
# chunked dispatches (the fused one is marginally faster for small tables)
_FUSED_MAX_NODES = 2 << 20


@functools.partial(jax.jit, static_argnames=("K",))
def _order_phase(head, dist, K: int):
    """Phase 2: sort nodes by (head, dist); chain bookkeeping + rc dedupe.

    Returns (order, chain_start_flag, chain_len_at_start, keep_chain_flag)
    in sorted order."""
    n_nodes = head.shape[0]
    skeys, spay = ops_sort.sort_by_words(
        [head.astype(jnp.uint32), dist.astype(jnp.uint32)],
        [jnp.arange(n_nodes, dtype=jnp.int32)],
    )
    order = spay[0]  # node ids in (head, dist) order
    starts = ops_sort.run_starts([skeys[0]])  # runs of equal head
    rl = segmented.run_lengths(starts)
    idx = jnp.arange(n_nodes, dtype=jnp.int32)
    start_pos = idx - segmented.position_in_run(starts)
    chain_len = rl[start_pos]              # broadcast chain length
    tail_node = order[start_pos + chain_len - 1]
    head_node = order[start_pos]
    keep = head_node <= (tail_node ^ 1)    # keep one of each rc pair
    return order, starts, rl, chain_len, keep, start_pos


@dataclasses.dataclass
class UniGraph:
    """Oriented unipath adjacency (K-1 overlap semantics at junctions —
    the HyperBasevector structure, ref: src/paths/HyperBasevector.h).
    Edge: oriented chain (a, fa) is followed by oriented chain (b, fb)."""
    a: np.ndarray    # int32 [E]
    fa: np.ndarray   # bool [E]
    b: np.ndarray    # int32 [E]
    fb: np.ndarray   # bool [E]


def _chain_sums_ring(mesh, node_counts: np.ndarray,
                     starts_np: np.ndarray) -> np.ndarray:
    """Per-position inclusive within-chain count sums, computed
    position-sharded over the mesh via parallel.ring (P9): pad to a
    shard-divisible length (padding rows are their own 1-element
    segments so no carry leaks), run the cross-shard segmented cumsum,
    return the host array."""
    from allpathslg_tpu.parallel.ring import ring_segmented_cumsum
    n_sh = int(mesh.devices.size)
    T = len(node_counts)
    Tp = -(-T // n_sh) * n_sh
    # int32 on BOTH paths (x64 is disabled repo-wide, so jnp would silently
    # downcast an int64 alloc anyway): guard the worst-case per-chain sum so
    # device accumulation can't wrap where the host fallback (which promotes
    # to int64 under np.cumsum) wouldn't — byte-identity depends on it.
    total = int(np.asarray(node_counts, np.int64).sum())
    if total >= 2**31:
        raise OverflowError(
            f"chain count sum {total} >= 2^31: int32 ring scan would wrap; "
            "chunk the count stream or raise the EC max_freq cap")
    vals = np.zeros(Tp, np.int32)
    vals[:T] = node_counts
    sts = np.ones(Tp, bool)
    sts[:T] = starts_np
    seg = np.asarray(ring_segmented_cumsum(
        mesh, jnp.asarray(vals), jnp.asarray(sts)))
    return seg[:T]


def build_unipaths(table_words: List[jnp.ndarray], K: int,
                   min_count: int = 2,
                   counts: jnp.ndarray = None,
                   with_graph: bool = False,
                   with_placement: bool = False,
                   mesh=None):
    """Host driver: kmer table (sorted canonical, possibly padded with
    sentinels + counts) → unipaths with base sequences (and optionally the
    oriented unipath adjacency graph).

    with_placement additionally returns a KmerPlacement (graph/pathsdb.py):
    the kmer→(unipath, offset, orientation) map that underlies read pathing
    (ref: the pathsdb of src/paths/ReadPaths.cc / KmerPathDatabase — reads
    re-expressed in unipath coordinates, SURVEY.md §2.4).
    """
    counts_f = None
    if counts is not None:
        mask = np.asarray(counts) >= min_count
        tw = [jnp.asarray(np.asarray(w)[mask]) for w in table_words]
        counts_f = np.asarray(counts)[mask]
    else:
        tw = [jnp.asarray(np.asarray(w)) for w in table_words]
    M = int(tw[0].shape[0])
    if M == 0:
        empty = Unipaths(np.zeros(0, np.uint8), np.zeros(1, np.int64),
                         np.zeros(0, np.int32))
        out = [empty]
        if with_graph:
            z = np.zeros(0)
            out.append(UniGraph(z.astype(np.int32), z.astype(bool),
                                z.astype(np.int32), z.astype(bool)))
        if with_placement:
            from allpathslg_tpu.graph.pathsdb import KmerPlacement
            out.append(KmerPlacement(
                K=K, table=[np.zeros(0, np.uint32) for _ in table_words],
                uid=np.zeros(0, np.int32), upos=np.zeros(0, np.int32),
                urc=np.zeros(0, bool)))
        return out[0] if len(out) == 1 else tuple(out)

    if 2 * M > _FUSED_MAX_NODES:
        head, dist, vals, outdeg, nxt = _chain_phase_chunked(tuple(tw), K)
    else:
        head, dist, vals, outdeg, nxt = _chain_phase(tuple(tw), K)
    order, starts, rl, chain_len, keep, start_pos = _order_phase(head, dist, K)

    # host: gather kept-chain structure (stage boundary; sizes become static)
    order_np = np.asarray(order)
    starts_np = np.asarray(starts)
    rl_np = np.asarray(rl)
    keep_np = np.asarray(keep)

    chain_starts = np.nonzero(starts_np)[0]
    lens = rl_np[chain_starts]
    kept = keep_np[chain_starts]
    chain_starts = chain_starts[kept]
    lens = lens[kept]
    n_chains = len(chain_starts)
    seq_lens = lens + K - 1
    seq_off = np.zeros(n_chains + 1, dtype=np.int64)
    np.cumsum(seq_lens, out=seq_off[1:])
    total = int(seq_off[-1])

    bases = _emit_bases(
        tuple(v for v in vals), K,
        jnp.asarray(order_np), jnp.asarray(chain_starts.astype(np.int32)),
        jnp.asarray(seq_off.astype(np.int32)), total)

    # per-unipath mean kmer multiplicity (ref: UnipathCoverage input)
    mean_cov = None
    if counts_f is not None:
        node_counts = counts_f[order_np >> 1]  # node -> its canonical kmer
        if mesh is not None and len(node_counts):
            # P9 (SURVEY §2.7): chain totals via the cross-shard segmented
            # scan over the position-sharded chain-sorted count stream —
            # only the O(n_shards) boundary carry crosses devices
            # (parallel/ring.py). Integer-exact, so artifacts stay
            # byte-identical to the 1-device path. Tradeoff (ADVICE r4):
            # counts_f is host numpy either way, so on a thin host<->device
            # link this upload+scan+download can lose to np.cumsum; it is
            # kept as the product consumer of the ring scan because on real
            # multi-chip meshes the stream arrives already device-sharded.
            seg = _chain_sums_ring(mesh, node_counts, starts_np)
            chain_sums = seg[chain_starts + lens - 1]
        else:
            csum = np.concatenate([[0], np.cumsum(node_counts)])
            chain_sums = csum[chain_starts + lens] - csum[chain_starts]
        mean_cov = (chain_sums
                    / np.maximum(lens, 1)).astype(np.float32)

    ups = Unipaths(bases=np.asarray(bases), offsets=seq_off,
                   kmer_counts=lens.astype(np.int32), mean_cov=mean_cov)

    placement = None
    if with_placement:
        # kmer table row → (kept chain, offset, orientation). Each canonical
        # kmer sits in exactly one kept chain (rc twins were dropped by
        # `keep`; rc-palindromic kmers resolve to whichever write lands).
        from allpathslg_tpu.graph.pathsdb import KmerPlacement
        flat_idx = np.repeat(chain_starts, lens) + _ragged_arange(lens)
        nodes = order_np[flat_idx]
        kidx = nodes >> 1
        uid = np.zeros(M, np.int32)
        upos = np.zeros(M, np.int32)
        urc = np.zeros(M, bool)
        uid[kidx] = np.repeat(np.arange(n_chains, dtype=np.int32), lens)
        upos[kidx] = _ragged_arange(lens)
        urc[kidx] = (nodes & 1).astype(bool)
        placement = KmerPlacement(K=K, table=[np.asarray(w) for w in tw],
                                  uid=uid, upos=upos, urc=urc)

    if not with_graph:
        return (ups, placement) if with_placement else ups

    # --- oriented chain adjacency (edges via successor joins) ---
    n_nodes = 2 * M
    heads = order_np[chain_starts]                      # kept chain heads
    tails = order_np[chain_starts + lens - 1]
    # leading-node map: node → (kept chain, orientation entering via it)
    lead_chain = np.full(n_nodes, -1, np.int32)
    lead_orient = np.zeros(n_nodes, bool)
    lead_chain[heads] = np.arange(n_chains, dtype=np.int32)
    lead_orient[heads] = False
    lead_chain[tails ^ 1] = np.arange(n_chains, dtype=np.int32)
    lead_orient[tails ^ 1] = True

    # trailing kmer values of oriented chains: (c,0) trails with tail node,
    # (c,1) trails with head^1
    trail_nodes = np.concatenate([tails, heads ^ 1])
    tvals = [jnp.asarray(np.asarray(v)[trail_nodes]) for v in vals]
    ea_parts, efa_parts, eb_parts, efb_parts = [], [], [], []
    src_ids = np.arange(2 * n_chains, dtype=np.int32) % n_chains
    src_flips = np.arange(2 * n_chains) >= n_chains
    for bb in range(4):
        s = bits.shift_append(tvals, jnp.uint32(bb), K)
        canon, is_rc = bits.canonical(s, K)
        idx, found = join.searchsorted_words([jnp.asarray(np.asarray(w)) for w in tw], canon)
        node = (np.asarray(idx) * 2 + np.asarray(is_rc).astype(np.int32))
        fnd = np.asarray(found)
        tc = np.where(fnd, lead_chain[np.where(fnd, node, 0)], -1)
        m = tc >= 0
        ea_parts.append(src_ids[m])
        efa_parts.append(src_flips[m])
        eb_parts.append(tc[m].astype(np.int32))
        efb_parts.append(lead_orient[node[m]])
    graph = UniGraph(np.concatenate(ea_parts), np.concatenate(efa_parts),
                     np.concatenate(eb_parts), np.concatenate(efb_parts))
    return (ups, graph, placement) if with_placement else (ups, graph)


def _ragged_arange(lens: np.ndarray) -> np.ndarray:
    """[0..l0), [0..l1), ... concatenated."""
    if len(lens) == 0:
        return np.zeros(0, np.int32)
    total = int(lens.sum())
    starts = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    return (np.arange(total, dtype=np.int64)
            - np.repeat(starts, lens)).astype(np.int32)


@functools.partial(jax.jit, static_argnames=("K", "total"))
def _emit_bases(vals, K: int, order, chain_starts, seq_off, total: int):
    """Every output base via inverse map: position t → (chain, offset) →
    (node, base-in-kmer) → 2-bit extract."""
    t = jnp.arange(total, dtype=jnp.int32)
    c = jnp.searchsorted(seq_off, t, side="right").astype(jnp.int32) - 1
    r = (t - seq_off[c]).astype(jnp.int32)
    node_rank = jnp.maximum(0, r - (K - 1))
    node = order[chain_starts[c] + node_rank]
    j = jnp.minimum(r, K - 1)
    gw = [v[node] for v in vals]
    return bits.get_base_dyn(gw, j)
