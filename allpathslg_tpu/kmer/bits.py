"""Multi-word packed k-mer bit arithmetic.

The reference stores k-mers as 2-bit-packed fixed-K types in 1..4 64-bit words
(ref: src/kmers/KmerRecord.h, src/kmers/naif_kmer/Kmers.h — Kmer29/Kmer60/
Kmer124/Kmer248) with canonical form = min(fwd, reverse-complement).

Device representation chosen here: a k-mer is ``W = ceil(K/16)`` uint32
words, **big-endian base order, left-aligned**: the first base of the k-mer
occupies the top 2 bits of word 0; the last (32*W - 2*K) bits are zero.
This makes lexicographic uint32 word comparison == lexicographic base
comparison, so multi-operand `lax.sort` orders k-mers correctly and the
all-ones sentinel sorts after every *canonical* key (a canonical key can
never be all-ones: its RC would be all-zeros, which is smaller).

All functions operate on ``words``: a length-W list/tuple of equal-shape
uint32 arrays (kept as separate arrays, not stacked, so XLA can keep them in
registers and `lax.sort` gets them as separate operands).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

U32 = jnp.uint32
BASES_PER_WORD = 16

# Base codes: A=0 C=1 G=2 T=3; anything >=4 is invalid (N / pad).
INVALID_CODE = 4


def n_words(K: int) -> int:
    """Number of uint32 words holding a K-mer."""
    return (K + BASES_PER_WORD - 1) // BASES_PER_WORD


def pad_bits(K: int) -> int:
    """Unused low bits in the last word (kmer is left-aligned)."""
    return 32 * n_words(K) - 2 * K


def last_word_mask(K: int) -> int:
    """uint32 mask keeping only the used (top) bits of the last word."""
    r = K - (n_words(K) - 1) * BASES_PER_WORD  # bases in last word, 1..16
    if r == 16:
        return 0xFFFFFFFF
    return (0xFFFFFFFF << (32 - 2 * r)) & 0xFFFFFFFF


def sentinel_words(K: int, shape=()):
    """All-ones sentinel key (sorts after every canonical key)."""
    return [jnp.full(shape, 0xFFFFFFFF, dtype=U32) for _ in range(n_words(K))]


def is_sentinel(words) -> jnp.ndarray:
    m = words[0] == jnp.uint32(0xFFFFFFFF)
    for w in words[1:]:
        m = m & (w == jnp.uint32(0xFFFFFFFF))
    return m


# ---------------------------------------------------------------------------
# bit-level helpers
# ---------------------------------------------------------------------------

def _rev2_word(x):
    """Reverse the sixteen 2-bit groups inside each uint32."""
    x = x.astype(U32)
    m2 = jnp.uint32(0x33333333)
    m4 = jnp.uint32(0x0F0F0F0F)
    m8 = jnp.uint32(0x00FF00FF)
    x = ((x >> 2) & m2) | ((x & m2) << 2)
    x = ((x >> 4) & m4) | ((x & m4) << 4)
    x = ((x >> 8) & m8) | ((x & m8) << 8)
    x = (x >> 16) | (x << 16)
    return x


def _shift_left_words(words, s: int):
    """Left-shift a multi-word bit string by s (0 <= s < 32) bits."""
    if s == 0:
        return list(words)
    W = len(words)
    out = []
    for w in range(W):
        hi = words[w] << jnp.uint32(s)
        lo = (words[w + 1] >> jnp.uint32(32 - s)) if w + 1 < W else jnp.uint32(0)
        out.append(hi | lo)
    return out


def rc_words(words, K: int):
    """Reverse complement of packed K-mers (vectorized over any shape).

    rc(X): reverse the 2-bit groups of the whole 32W-bit string (kmer lands in
    the LOW 2K bits, reversed), complement, shift back up to the top, and mask
    the pad bits.
    """
    W = n_words(K)
    assert len(words) == W
    rev = [_rev2_word(words[W - 1 - w]) for w in range(W)]
    comp = [~r for r in rev]
    out = _shift_left_words(comp, pad_bits(K))
    out[-1] = out[-1] & jnp.uint32(last_word_mask(K))
    return out


def lex_less(a, b):
    """Elementwise lexicographic a < b over word lists."""
    lt = a[0] < b[0]
    eq = a[0] == b[0]
    for wa, wb in zip(a[1:], b[1:]):
        lt = lt | (eq & (wa < wb))
        eq = eq & (wa == wb)
    return lt


def lex_eq(a, b):
    eq = a[0] == b[0]
    for wa, wb in zip(a[1:], b[1:]):
        eq = eq & (wa == wb)
    return eq


def select_words(pred, a, b):
    """where(pred, a, b) per word."""
    return [jnp.where(pred, wa, wb) for wa, wb in zip(a, b)]


def canonical(words, K: int):
    """(canon_words, is_rc): canonical = min(fwd, rc) lexicographically."""
    rc = rc_words(words, K)
    use_rc = lex_less(rc, words)
    return select_words(use_rc, rc, words), use_rc


def get_base(words, j: int):
    """Base code (0..3) at position j (static) of each packed kmer."""
    w = j // BASES_PER_WORD
    shift = 30 - 2 * (j % BASES_PER_WORD)
    return ((words[w] >> jnp.uint32(shift)) & jnp.uint32(3)).astype(jnp.uint8)


def get_base_dyn(words, j):
    """Base code at traced position j (clamped to [0, K))."""
    w_idx = j // BASES_PER_WORD
    shift = (30 - 2 * (j % BASES_PER_WORD)).astype(jnp.uint32)
    stacked = jnp.stack(words)  # [W, ...]
    word = jnp.take_along_axis(stacked, w_idx[None].astype(jnp.int32), axis=0)[0]
    return ((word >> shift) & jnp.uint32(3)).astype(jnp.uint8)


def put_base_dyn(words, j, base):
    """Replace the base at traced position j with `base` (arrays broadcast
    with the word shapes). Returns new word list."""
    w_idx = (j // BASES_PER_WORD).astype(jnp.int32)
    shift = (30 - 2 * (j % BASES_PER_WORD)).astype(jnp.uint32)
    b = jnp.asarray(base).astype(U32) & jnp.uint32(3)
    out = []
    for w, word in enumerate(words):
        here = w_idx == w
        cleared = word & ~(jnp.uint32(3) << shift)
        out.append(jnp.where(here, cleared | (b << shift), word))
    return out


def mask_base_dyn(words, j):
    """Zero the 2 bits of the base at traced position j (for context keys)."""
    w_idx = (j // BASES_PER_WORD).astype(jnp.int32)
    shift = (30 - 2 * (j % BASES_PER_WORD)).astype(jnp.uint32)
    out = []
    for w, word in enumerate(words):
        here = w_idx == w
        out.append(jnp.where(here, word & ~(jnp.uint32(3) << shift), word))
    return out


def mask_base(words, j: int):
    """Zero the 2 bits of the base at static position j."""
    w = j // BASES_PER_WORD
    shift = 30 - 2 * (j % BASES_PER_WORD)
    out = list(words)
    out[w] = out[w] & ~(jnp.uint32(3) << jnp.uint32(shift))
    return out


def shift_append(words, base, K: int):
    """Drop the first base, append `base` (0..3) at the end: the de Bruijn
    successor operation. `base` may be a scalar or an array broadcastable to
    the word shapes."""
    W = n_words(K)
    out = _shift_left_words(words, 2)
    j = K - 1
    w = j // BASES_PER_WORD
    shift = 30 - 2 * (j % BASES_PER_WORD)
    b = jnp.asarray(base).astype(U32) & jnp.uint32(3)
    out[w] = out[w] | (b << jnp.uint32(shift))
    out[-1] = out[-1] & jnp.uint32(last_word_mask(K))
    return out


def shift_prepend(words, base, K: int):
    """Drop the last base, prepend `base` at the front: de Bruijn predecessor."""
    W = n_words(K)
    # right shift by 2 over the 32W-bit string
    out = []
    for w in range(W):
        lo = words[w] >> jnp.uint32(2)
        hi = (words[w - 1] << jnp.uint32(30)) if w > 0 else jnp.uint32(0)
        out.append(hi | lo)
    b = jnp.asarray(base).astype(U32) & jnp.uint32(3)
    out[0] = out[0] | (b << jnp.uint32(30))
    out[-1] = out[-1] & jnp.uint32(last_word_mask(K))
    return out


def hash_words(words, seed: int = 0):
    """Cheap mixing hash of packed kmers → uint32 (for shard assignment)."""
    h = jnp.uint32(0x9E3779B9 + seed)
    for w in words:
        h = (h ^ w.astype(U32)) * jnp.uint32(0x85EBCA6B)
        h = h ^ (h >> jnp.uint32(13))
    h = h * jnp.uint32(0xC2B2AE35)
    return h ^ (h >> jnp.uint32(16))


# ---------------------------------------------------------------------------
# numpy oracles (host-side reference implementations for tests)
# ---------------------------------------------------------------------------

def np_pack(seq_codes, K: int) -> tuple:
    """Pack a 1-D numpy array of base codes (len K) into W python ints."""
    W = n_words(K)
    words = [0] * W
    for j, b in enumerate(seq_codes[:K]):
        w = j // BASES_PER_WORD
        shift = 30 - 2 * (j % BASES_PER_WORD)
        words[w] |= (int(b) & 3) << shift
    return tuple(words)


def np_unpack(words, K: int) -> np.ndarray:
    out = np.empty(K, dtype=np.uint8)
    for j in range(K):
        w = j // BASES_PER_WORD
        shift = 30 - 2 * (j % BASES_PER_WORD)
        out[j] = (int(words[w]) >> shift) & 3
    return out


def np_rc(words, K: int) -> tuple:
    codes = np_unpack(words, K)
    return np_pack((3 - codes)[::-1], K)


def np_canonical(words, K: int) -> tuple:
    rc = np_rc(words, K)
    return min(tuple(words), tuple(rc))
