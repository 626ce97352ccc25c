"""Gap-free exhaustive alignment as one one-hot convolution.

Behavior contract (ref: src/lookup/PerfectLookup.cc, ImperfectLookup.cc —
SURVEY.md §2.2): place short reads on a target allowing substitutions only,
exhaustively over every offset and both strands; PerfectLookup keeps exact
matches, ImperfectLookup the best placement with bounded mismatches.

Device design: match-counting at every offset is a correlation of
one-hot encodings — Σ_j 1[target[p+j] == read[j]] — i.e. a conv with the
read as filter. One `lax.conv` does the whole scan: reads are output
channels, base identity is the contracted channel dim, offsets are the
spatial dim. A [G]-base target vs [N, L] reads costs G·N·L·4 MACs — bf16
one-hot operands with float32 accumulation (`preferred_element_type`), so
the counts are exact integers on any backend; no hashing, no seeds, no
branches. (The module name is historical.)
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from allpathslg_tpu.dtypes.reads import PAD_CODE


def _one_hot(codes: jnp.ndarray) -> jnp.ndarray:
    """uint8 codes → bf16 one-hot on the trailing axis; pad rows all-zero."""
    return (codes[..., None] == jnp.arange(4, dtype=codes.dtype)).astype(
        jnp.bfloat16)


@functools.partial(jax.jit, static_argnames=())
def match_counts(target: jnp.ndarray, reads: jnp.ndarray) -> jnp.ndarray:
    """Match counts of every read at every target offset.

    target: uint8 [G] (PAD_CODE allowed: never matches).
    reads:  uint8 [N, L] (PAD_CODE positions never match → effectively
            free matches are NOT granted to padding; callers add the pad
            count back if they want length-normalized scores).
    Returns int32 [N, G - L + 1].
    """
    G = target.shape[0]
    N, L = reads.shape
    t = _one_hot(target).T[None]          # [1, 4, G]  (NCW)
    r = _one_hot(reads).transpose(0, 2, 1)  # [N, 4, L]  (OIW)
    out = lax.conv_general_dilated(
        t, r, window_strides=(1,), padding="VALID",
        dimension_numbers=("NCW", "OIW", "NCW"),
        preferred_element_type=jnp.float32)
    return jnp.round(out[0]).astype(jnp.int32)  # [N, P]


@functools.partial(jax.jit, static_argnames=())
def imperfect_lookup(target: jnp.ndarray, reads: jnp.ndarray,
                     lengths: jnp.ndarray) -> Tuple[jnp.ndarray, ...]:
    """Best substitution-only placement of each read on either strand.

    Returns (pos, is_rc, mismatches): pos is the offset of the read's
    first base on the target fwd strand; mismatches counts real-base
    mismatches of the best placement. (ref: ImperfectLookup semantics —
    best unique gap-free placement; ties resolve to the lowest offset,
    fwd strand preferred.)
    """
    N, L = reads.shape
    mc_f = match_counts(target, reads)
    rc = jnp.where(reads[:, ::-1] >= PAD_CODE, PAD_CODE,
                   3 - reads[:, ::-1].astype(jnp.int32)).astype(reads.dtype)
    mc_r = match_counts(target, rc)
    best_f = jnp.argmax(mc_f, axis=1)
    best_r = jnp.argmax(mc_r, axis=1)
    nf = jnp.take_along_axis(mc_f, best_f[:, None], axis=1)[:, 0]
    nr = jnp.take_along_axis(mc_r, best_r[:, None], axis=1)[:, 0]
    use_r = nr > nf
    n_match = jnp.where(use_r, nr, nf)
    # rc placement offset: window position of the reversed read equals the
    # fwd-strand offset of the read's last base's complement — the window
    # start IS the first-base offset on the fwd strand either way.
    raw_pos = jnp.where(use_r, best_r, best_f).astype(jnp.int32)
    # pad-aware: padded tail of an rc'd read sits BEFORE the window start
    pad = (L - lengths).astype(jnp.int32)
    pos = jnp.where(use_r, raw_pos + pad, raw_pos)
    mism = (lengths.astype(jnp.int32) - n_match)
    return pos, use_r, mism


@functools.partial(jax.jit, static_argnames=("max_hits",))
def perfect_lookup(target: jnp.ndarray, reads: jnp.ndarray,
                   lengths: jnp.ndarray, max_hits: int = 4):
    """All exact placements (both strands) of each read, up to max_hits.

    Returns (pos [N, max_hits], is_rc [N, max_hits], n_hits [N]); unused
    slots hold -1. (ref: PerfectLookup — exhaustive exact placements.)
    """
    N, L = reads.shape
    mc_f = match_counts(target, reads)
    rc = jnp.where(reads[:, ::-1] >= PAD_CODE, PAD_CODE,
                   3 - reads[:, ::-1].astype(jnp.int32)).astype(reads.dtype)
    mc_r = match_counts(target, rc)
    P = mc_f.shape[1]
    exact_f = mc_f == lengths[:, None]
    exact_r = mc_r == lengths[:, None]
    # rc windows begin at raw_pos; first-base fwd offset shifts by padding
    pad = (L - lengths).astype(jnp.int32)
    both = jnp.concatenate([exact_f, exact_r], axis=1)  # [N, 2P]
    n_hits = jnp.sum(both, axis=1).astype(jnp.int32)
    # top-k by position: use iota keys where hit, big otherwise
    iota = jnp.arange(2 * P, dtype=jnp.int32)[None, :]
    keyed = jnp.where(both, iota, 2 * P)
    hits = -lax.top_k(-keyed, max_hits)[0]  # smallest positions first
    found = hits < 2 * P
    is_rc = found & (hits >= P)
    raw = jnp.where(is_rc, hits - P, hits)
    pos = jnp.where(found, jnp.where(is_rc, raw + pad[:, None], raw), -1)
    return pos.astype(jnp.int32), is_rc, n_hits
