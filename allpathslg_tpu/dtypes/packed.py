"""2-bit packed read transfer (ref: src/feudal/BaseVec.{h,cc} — the
reference keeps ALL bases 2-bit packed in memory; here the packing's job
is the host->device link: the PCIe transfer of a read batch
shrinks 4x (codes go as 2-bit words plus an N-position bitmask) and the
device unpacks inside the consuming jitted program, so transfer bytes —
not dispatch count — scale with genome size.

Codes are 0..3 = ACGT, 4 = N/pad (dtypes/reads.py convention). words[i,w]
carries bases 16w..16w+15 of read i, base j in bits 2*(j%16)..+1;
nmask[i,w] carries bases 32w..32w+31, bit j%32 set when code==4. Lossless
for any [N, L] uint8 code matrix."""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp


def pack_codes(codes: np.ndarray):
    """Host pack: [N, L] uint8 (0..4) -> (words [N, ceil(L/16)] uint32,
    nmask [N, ceil(L/32)] uint32, L).

    The nmask is always emitted at full width (L/32 uint32 per read) even
    when the batch has no N/pad bases: a zero-width fast path would make
    consecutive batches alternate pytree shapes and force extra XLA
    recompiles of the large jitted consumers."""
    codes = np.asarray(codes, np.uint8)
    n, L = codes.shape
    Wb = (L + 15) // 16
    Wn = (L + 31) // 32
    cp = np.zeros((n, Wb * 16), np.uint32)
    cp[:, :L] = codes & 3
    sh = (np.arange(Wb * 16, dtype=np.uint32) % 16) * 2
    words = np.bitwise_or.reduce(
        (cp << sh).reshape(n, Wb, 16), axis=2).astype(np.uint32)
    npad = np.zeros((n, Wn * 32), bool)
    npad[:, :L] = codes == 4
    shn = np.arange(Wn * 32, dtype=np.uint32) % 32
    nmask = np.bitwise_or.reduce(
        (npad.astype(np.uint32) << shn).reshape(n, Wn, 32), axis=2)
    return words, nmask, L


def unpack_codes(words: jnp.ndarray, nmask: jnp.ndarray, L: int):
    """Device unpack (jit-safe): -> [N, L] uint8 codes 0..4."""
    j = jnp.arange(L, dtype=jnp.uint32)
    base = (words[:, j // 16] >> ((j % 16) * 2)) & 3
    if nmask.shape[1] == 0:
        return base.astype(jnp.uint8)
    isn = (nmask[:, j // 32] >> (j % 32)) & 1
    return jnp.where(isn != 0, jnp.uint8(4), base.astype(jnp.uint8))


def pack_codes_device(codes: jnp.ndarray):
    """Device-side pack (jit-safe) for the RETURN path of batch programs
    (e.g. corrected reads): -> (words [N, ceil(L/16)] uint32,
    nmask [N, ceil(L/32)] uint32). The download shrinks ~2.7x."""
    from jax import lax

    n, L = codes.shape
    Wb = (L + 15) // 16
    Wn = (L + 31) // 32
    # sum in int32 (Mosaic has no unsigned reductions); addends occupy
    # disjoint bit slots so two's-complement addition == OR
    cp = jnp.zeros((n, Wb * 16), jnp.int32).at[:, :L].set(
        codes.astype(jnp.int32) & 3)
    sh = (jnp.arange(Wb * 16, dtype=jnp.int32) % 16) * 2
    words = lax.bitcast_convert_type(
        jnp.sum((cp << sh).reshape(n, Wb, 16), axis=2, dtype=jnp.int32),
        jnp.uint32)
    npad = jnp.zeros((n, Wn * 32), jnp.int32).at[:, :L].set(
        (codes == 4).astype(jnp.int32))
    shn = jnp.arange(Wn * 32, dtype=jnp.int32) % 32
    nmask = lax.bitcast_convert_type(
        jnp.sum((npad << shn).reshape(n, Wn, 32), axis=2, dtype=jnp.int32),
        jnp.uint32)
    return words, nmask


def unpack_codes_host(words: np.ndarray, nmask: np.ndarray, L: int):
    """Host-side numpy mirror of unpack_codes."""
    words = np.asarray(words)
    nmask = np.asarray(nmask)
    j = np.arange(L, dtype=np.uint32)
    base = ((words[:, j // 16] >> ((j % 16) * 2)) & 3).astype(np.uint8)
    if nmask.shape[1] == 0:
        return base
    isn = (nmask[:, j // 32] >> (j % 32)) & 1
    return np.where(isn != 0, np.uint8(4), base)


def pack_quals(quals: np.ndarray):
    """Host pack quals via a 4-bit palette (ref: feudal QualNibbleVec — the
    reference stores quals 4-bit; modern Illumina emits 4-8 distinct
    values, so a per-batch palette of <=16 keeps this LOSSLESS). Returns
    (nibbles [N, ceil(L/8)] uint32, palette [16] uint8, L), or
    (None, quals, L) raw fallback when >16 distinct values exist."""
    quals = np.asarray(quals, np.uint8)
    n, L = quals.shape
    palette = np.unique(quals)
    if len(palette) > 16:
        return None, quals, L
    pal16 = np.zeros(16, np.uint8)
    pal16[: len(palette)] = palette
    idx = np.searchsorted(palette, quals).astype(np.uint32)
    Wq = (L + 7) // 8
    ip = np.zeros((n, Wq * 8), np.uint32)
    ip[:, :L] = idx
    sh = (np.arange(Wq * 8, dtype=np.uint32) % 8) * 4
    nib = np.bitwise_or.reduce(
        (ip << sh).reshape(n, Wq, 8), axis=2).astype(np.uint32)
    return nib, pal16, L


def device_codes(codes: np.ndarray):
    """Host uint8 [N, L] code batch -> device uint8 [N, L], transferred
    2-bit packed (~2.7x fewer link bytes) and unpacked in a tiny jitted
    program on device."""
    import functools
    import jax

    w, m, L = pack_codes(codes)
    return _unpack_codes_jit(jnp.asarray(w), jnp.asarray(m), L)


def device_quals(quals: np.ndarray):
    """Host uint8 qual batch -> device, transferred 4-bit palette-packed
    when <=16 distinct values (the NovaSeq case), raw otherwise."""
    nib, pal, L = pack_quals(quals)
    if nib is None:
        return jnp.asarray(pal)
    return _unpack_quals_jit(jnp.asarray(nib), jnp.asarray(pal), L)


def _unpack_codes_jit(words, nmask, L: int):
    import jax

    global _UPC
    try:
        f = _UPC
    except NameError:
        f = _UPC = jax.jit(unpack_codes, static_argnums=2)
    return f(words, nmask, L)


def _unpack_quals_jit(nib, pal, L: int):
    import jax

    global _UPQ
    try:
        f = _UPQ
    except NameError:
        f = _UPQ = jax.jit(unpack_quals, static_argnums=2)
    return f(nib, pal, L)


def unpack_quals(nibbles, palette, L: int):
    """Device unpack (jit-safe): -> [N, L] uint8. `palette` may be the raw
    qual matrix (fallback path) — detected by ndim."""
    if nibbles is None:
        return jnp.asarray(palette)
    j = jnp.arange(L, dtype=jnp.uint32)
    idx = (nibbles[:, j // 8] >> ((j % 8) * 4)) & 15
    return jnp.asarray(palette)[idx].astype(jnp.uint8)
