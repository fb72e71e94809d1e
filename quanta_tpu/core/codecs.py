"""Blockwise quantize / dequantize — the pure-``jax.numpy`` reference core.

This module is the ground-truth oracle: every Pallas kernel in
``quanta_tpu.ops`` is tested for bit-exact (codes) / allclose (values)
parity against these functions. One scale convention throughout (see
quanta_tpu.core.qtensor docstring); the reference's three incompatible
conventions (SURVEY.md §1) are deliberately collapsed to one.

Behavioral contracts kept from the reference:
  - constant / zero blocks quantize with scale=1 and round-trip exactly
    (/root/reference/Quanta/functional/base.py:26-27);
  - NF4 uses the exact QLoRA level constants
    (/root/reference/Quanta/functional/quantization.py:105-110);
  - affine 8-bit matches the min/max range convention of
    /root/reference/Quanta/backends/cpu/quantization.py:52-57.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp

from quanta_tpu.core import codebooks, packing
from quanta_tpu.core.qtensor import QuantizedTensor

_EPS = 1e-12


def _blockify(x: jax.Array, block_size: int):
    """Flatten + pad to (n_blocks, block) blocks. block_size=0 -> 1 block."""
    flat = x.reshape(-1).astype(jnp.float32)
    n = flat.shape[0]
    bs = n if block_size == 0 else block_size
    n_blocks = -(-n // bs)
    pad = n_blocks * bs - n
    if pad:
        flat = jnp.pad(flat, (0, pad))
    return flat.reshape(n_blocks, bs), n


def _safe_scale(s: jax.Array) -> jax.Array:
    """Replace zero scales (constant-zero blocks) with 1.0."""
    return jnp.where(s <= _EPS, 1.0, s)


# ---------------------------------------------------------------- quantize


def quantize(
    x: jax.Array,
    *,
    bits: int = 8,
    scheme: str = "symmetric",
    codebook: Optional[str] = None,
    block_size: int = 0,
    pack: bool = False,
) -> QuantizedTensor:
    """Quantize ``x`` blockwise.

    scheme: "symmetric" (signed absmax grid), "affine" (asymmetric
    zero-point), or "codebook" (NF4/NF8/FP4/FP8; ``codebook`` names it).
    """
    if scheme == "codebook":
        if codebook is None:
            codebook = {4: "nf4", 8: "nf8"}[bits]
        if codebooks.bits_of(codebook) != bits:
            raise ValueError(f"codebook {codebook} is not {bits}-bit")

    blocks, _n = _blockify(x, block_size)

    if scheme == "symmetric":
        qmax = 2 ** (bits - 1) - 1
        scale = _safe_scale(jnp.max(jnp.abs(blocks), axis=1) / qmax)
        q = jnp.clip(jnp.round(blocks / scale[:, None]), -qmax, qmax)
        codes = q.astype(jnp.int8)
        if bits == 4:
            codes = (codes + 8).astype(jnp.uint8)  # store offset for packing
        zp = None
    elif scheme == "affine":
        qmax = 2**bits - 1
        # extend the range to include zero (standard affine convention;
        # also makes constant blocks round-trip exactly)
        mn = jnp.minimum(jnp.min(blocks, axis=1), 0.0)
        mx = jnp.maximum(jnp.max(blocks, axis=1), 0.0)
        scale = _safe_scale((mx - mn) / qmax)
        zp = jnp.clip(jnp.round(-mn / scale), 0, qmax)
        q = jnp.clip(jnp.round(blocks / scale[:, None]) + zp[:, None], 0, qmax)
        codes = q.astype(jnp.uint8)
    elif scheme == "codebook":
        scale = _safe_scale(jnp.max(jnp.abs(blocks), axis=1))
        normalized = blocks / scale[:, None]
        mids = codebooks.get_midpoints(codebook)
        codes = jnp.searchsorted(mids, normalized).astype(jnp.uint8)
        zp = None
    else:
        raise ValueError(f"unknown scheme {scheme!r}")

    packed = "none"
    if pack:
        if bits != 4:
            raise ValueError("packing is only for 4-bit codes")
        codes = packing.pack_nibbles(codes)
        packed = "nibbles"

    return QuantizedTensor(
        codes=codes,
        scale=scale.astype(jnp.float32),
        zero_point=None if zp is None else zp.astype(jnp.float32),
        bits=bits,
        scheme=scheme,
        codebook=codebook,
        shape=tuple(x.shape),
        dtype=x.dtype,
        block_size=block_size,
        packed=packed,
    )


def dequantize(qt: QuantizedTensor) -> jax.Array:
    """Reconstruct the (approximate) original tensor from a QuantizedTensor."""
    n = math.prod(qt.shape) if qt.shape else 1

    codes = qt.codes
    if qt.packed == "nibbles":
        codes = packing.unpack_nibbles(codes, qt.scale.shape[0] * _block(qt, n))
    elif qt.packed == "split_k":
        codes = packing.unpack_split_k(codes)

    if qt.packed == "split_k":
        # matmul layout: blocks run along axis 0 (K) per column
        return _dequant_matmul_layout(qt, codes)

    bs = _block(qt, n)
    blocks = codes.reshape(-1, bs)

    if qt.scheme == "symmetric":
        vals = blocks.astype(jnp.int32)
        if qt.bits == 4:
            vals = vals - 8
        out = vals.astype(jnp.float32) * qt.scale[:, None]
    elif qt.scheme == "affine":
        out = (blocks.astype(jnp.float32) - qt.zero_point[:, None]) * qt.scale[
            :, None
        ]
    elif qt.scheme == "codebook":
        lv = codebooks.get_codebook(qt.codebook)
        out = lv[blocks.astype(jnp.int32)] * qt.scale[:, None]
    else:
        raise ValueError(qt.scheme)

    return out.reshape(-1)[:n].reshape(qt.shape).astype(qt.dtype)


def _block(qt: QuantizedTensor, n: int) -> int:
    return n if qt.block_size == 0 else qt.block_size


# --------------------------------------------- matmul-layout weight quant


def quantize_matmul_weight(
    w: jax.Array,
    *,
    fmt: str = "nf4",
    block_size: int = 64,
) -> QuantizedTensor:
    """Quantize a 2-D weight ``(K, N)`` in the fused-matmul layout.

    Blocks run along K per column: ``scale`` has shape ``(K_pad/block, N_pad)``.
    4-bit formats are packed ``split_k`` (see quanta_tpu.core.packing) so
    the Pallas kernel consumes contiguous activation slices. 8-bit formats
    keep ``(K_pad, N_pad)`` int8 codes.

    The stored arrays are zero-padded to K a multiple of ``16*block_size``
    and N a multiple of 128, so every Pallas tile (including the per-step
    scale tile, whose sublane count must be a multiple of 8) aligns for
    any K/N the model throws at us; ``shape`` records the logical (K, N)
    and padded rows/columns are sliced away on dequant (padded x rows are
    zero, so they contribute nothing to the matmul).

    fmt: "nf4" | "nf4a" | "fp4" | "int4" | "int8" | "nf8" | "fp8"
    """
    if w.ndim != 2:
        raise ValueError(f"expected 2-D weight, got shape {w.shape}")
    k, n_cols = w.shape
    logical_shape = (k, n_cols)
    k_pad = -(-k // (16 * block_size)) * (16 * block_size)
    n_pad = -(-n_cols // 128) * 128
    if (k_pad, n_pad) != (k, n_cols):
        w = jnp.pad(w, ((0, k_pad - k), (0, n_pad - n_cols)))
        k = k_pad

    wf = w.astype(jnp.float32)
    blocks = wf.reshape(k // block_size, block_size, -1)

    if fmt == "int8":
        scale = _safe_scale(jnp.max(jnp.abs(blocks), axis=1) / 127.0)
        q = jnp.round(blocks / scale[:, None, :])
        codes = jnp.clip(q, -127, 127).astype(jnp.int8).reshape(k, -1)
        bits, scheme, cb, packed = 8, "symmetric", None, "none"
    elif fmt in ("nf8", "fp8"):
        scale = _safe_scale(jnp.max(jnp.abs(blocks), axis=1))
        mids = codebooks.get_midpoints(fmt)
        idx = jnp.searchsorted(mids, blocks / scale[:, None, :])
        codes = idx.astype(jnp.uint8).reshape(k, -1)
        bits, scheme, cb, packed = 8, "codebook", fmt, "none"
    elif fmt in ("nf4", "nf4a", "fp4", "int4"):
        cb = fmt
        scale = _safe_scale(jnp.max(jnp.abs(blocks), axis=1))
        mids = codebooks.get_midpoints(cb)
        idx = jnp.searchsorted(mids, blocks / scale[:, None, :])
        codes4 = idx.astype(jnp.uint8).reshape(k, -1)
        codes = packing.pack_split_k(codes4)
        bits, scheme, packed = 4, "codebook", "split_k"
    elif fmt in ("int8a", "int4a"):
        # affine (zero-point) blockwise — the reference's default 8-bit
        # scheme (backends/cpu/quantization.py:52-57). Convention here:
        # w = codes * scale + zp, zp = block min, codes unsigned. The
        # fused kernels need NO affine variant: codes*scale runs through
        # the symmetric path and the zp term factors out of the matmul
        # as blocksum(x) @ zp (ops/matmul handles it; one tiny
        # (M, K/B) x (K/B, N) GEMM).
        qmax = 255 if fmt == "int8a" else 15
        lo = jnp.min(blocks, axis=1)
        hi = jnp.max(blocks, axis=1)
        scale = _safe_scale((hi - lo) / qmax)
        zp = lo
        q = jnp.clip(jnp.round((blocks - zp[:, None, :]) / scale[:, None, :]),
                     0, qmax)
        codes4 = q.astype(jnp.uint8).reshape(k, -1)
        if fmt == "int4a":
            codes = packing.pack_split_k(codes4)
            bits, packed = 4, "split_k"
        else:
            codes = codes4
            bits, packed = 8, "none"
        scheme, cb = "affine", None
        return QuantizedTensor(
            codes=codes,
            scale=scale.astype(jnp.float32),
            zero_point=zp.astype(jnp.float32),
            bits=bits,
            scheme=scheme,
            codebook=cb,
            shape=logical_shape,
            dtype=w.dtype,
            block_size=block_size,
            packed=packed,
        )
    else:
        raise ValueError(f"unknown matmul weight format {fmt!r}")

    return QuantizedTensor(
        codes=codes,
        scale=scale.astype(jnp.float32),
        zero_point=None,
        bits=bits,
        scheme=scheme,
        codebook=cb,
        shape=logical_shape,
        dtype=w.dtype,
        block_size=block_size,
        packed=packed,
    )


def _dequant_matmul_layout(qt: QuantizedTensor, codes: jax.Array) -> jax.Array:
    k, n = qt.shape
    # (K_pad, N_pad) normalized; the same rule the fused kernel applies
    vals = codebooks.dequant_codes(codes.astype(jnp.int32), qt.codebook)
    scale = jnp.repeat(qt.scale, qt.block_size, axis=0)
    return (vals * scale)[:k, :n].astype(qt.dtype)


def dequantize_matmul_weight(qt: QuantizedTensor) -> jax.Array:
    """Dequantize a matmul-layout weight back to the logical (K, N)."""
    k, n = qt.shape
    if qt.scheme == "affine":  # int8a / int4a: w = codes*scale + zp
        codes = (packing.unpack_split_k(qt.codes)
                 if qt.packed == "split_k" else qt.codes)
        scale = jnp.repeat(qt.scale, qt.block_size, axis=0)
        zp = jnp.repeat(qt.zero_point, qt.block_size, axis=0)
        vals = codes.astype(jnp.float32) * scale + zp
        return vals[:k, :n].astype(qt.dtype)
    if qt.packed == "split_k":
        codes = packing.unpack_split_k(qt.codes)
        return _dequant_matmul_layout(qt, codes)
    return _dequant_matmul_layout(qt, qt.codes)
