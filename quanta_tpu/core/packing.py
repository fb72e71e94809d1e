"""4-bit code packing: two nibbles per byte.

Two layouts:

  - ``"nibbles"`` (serialization layout): flat, low-nibble-first —
    ``packed[i] = codes[2i] | codes[2i+1] << 4`` — the same byte layout the
    reference uses (/root/reference/Quanta/utils/utils.py:23-48), but
    vectorized (the reference's model wrapper packs with a per-element
    Python loop, /root/reference/Quanta/functional/model.py:76-81).

  - ``"split_k"`` (matmul layout): for a 2-D weight ``(K, N)``, rows ``k``
    and ``k + K/2`` share a byte: ``packed[k, n] = codes[k, n] |
    codes[k + K/2, n] << 4``. The fused
    dequant-matmul kernel computes ``x[:, :K/2] @ deq(lo) + x[:, K/2:] @
    deq(hi)`` with *contiguous* activation slices — no lane shuffles, no
    interleave on the critical path.
"""

from __future__ import annotations

import jax.numpy as jnp


def pack_nibbles(codes: jnp.ndarray) -> jnp.ndarray:
    """Flat low-nibble-first packing. ``codes`` values must fit in 4 bits.

    Returns uint8 array of length ``ceil(n/2)``; odd length is zero-padded.
    """
    flat = codes.reshape(-1).astype(jnp.uint8)
    if flat.shape[0] % 2:
        flat = jnp.concatenate([flat, jnp.zeros((1,), jnp.uint8)])
    pairs = flat.reshape(-1, 2)
    return (pairs[:, 0] | (pairs[:, 1] << 4)).astype(jnp.uint8)


def unpack_nibbles(packed: jnp.ndarray, numel: int) -> jnp.ndarray:
    """Inverse of :func:`pack_nibbles`; returns flat uint8 of ``numel``."""
    lo = packed & 0x0F
    hi = (packed >> 4) & 0x0F
    flat = jnp.stack([lo, hi], axis=-1).reshape(-1)
    return flat[:numel].astype(jnp.uint8)


def pack_split_k(codes: jnp.ndarray) -> jnp.ndarray:
    """Matmul layout: (K, N) uint8 codes -> (K/2, N) uint8. K must be even."""
    k = codes.shape[0]
    if k % 2:
        raise ValueError(f"split_k packing needs even K, got {k}")
    lo = codes[: k // 2].astype(jnp.uint8)
    hi = codes[k // 2 :].astype(jnp.uint8)
    return (lo | (hi << 4)).astype(jnp.uint8)


def unpack_split_k(packed: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`pack_split_k`: (K/2, N) -> (K, N)."""
    lo = packed & 0x0F
    hi = (packed >> 4) & 0x0F
    return jnp.concatenate([lo, hi], axis=0).astype(jnp.uint8)
