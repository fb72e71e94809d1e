"""Precision conversion and hardware-target presets.

Parity with the reference's ``convert_precision`` family
(`/root/reference/Quanta/utils/utils.py:216-307`): conversion is a
dequantize -> requantize round trip through float, producing a new
QuantizedTensor under the target settings, and the hardware-target
table (:309-335).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from quanta_tpu.core import QuantizedTensor, dequantize, quantize
from quanta_tpu.core import codebooks as _cb
from quanta_tpu.state.config import QuantConfig


def convert_precision(
    qt: QuantizedTensor,
    *,
    bits: Optional[int] = None,
    scheme: Optional[str] = None,
    codebook: Optional[str] = None,
    block_size: Optional[int] = None,
    pack: Optional[bool] = None,
) -> QuantizedTensor:
    """Requantize ``qt`` under new settings (fp round trip).

    Unspecified fields keep the source tensor's values, except ``codebook``
    which resets when the scheme or bit-width changes (an nf4 codebook is
    meaningless for an 8-bit target — the reference's converter had the
    same reset behavior via its params rebuild, utils.py:243-268).
    """
    new_bits = bits if bits is not None else qt.bits
    new_scheme = scheme if scheme is not None else qt.scheme
    if codebook is None and (new_bits != qt.bits or new_scheme != qt.scheme):
        new_codebook = None
    else:
        new_codebook = codebook if codebook is not None else qt.codebook
    new_block = block_size if block_size is not None else qt.block_size
    new_pack = pack if pack is not None else (new_bits == 4 and qt.packed != "none")
    return quantize(
        dequantize(qt),
        bits=new_bits,
        scheme=new_scheme,
        codebook=new_codebook,
        block_size=new_block,
        pack=new_pack,
    )


def transcode_codebook(
    qt: QuantizedTensor, target: str = "nf4a"
) -> QuantizedTensor:
    """Deterministic same-bit-width codebook remap, e.g. exact-NF4 ->
    arithmetic nf4a, WITHOUT an fp round trip.

    Both codebooks are absmax-normalized, so the per-block scales carry
    over unchanged and the transcode is a pure 16-entry code lookup: each
    source code maps to the nearest target level of its source level —
    exactly what dequantize->requantize at the same block size would
    produce, but O(bytes) and valid on packed matmul-layout tensors.

    Why: checkpoints quantized by bitsandbytes/QLoRA arrive as exact NF4
    (/root/reference/Quanta/functional/quantization.py:105-110), whose
    16-entry table dequant is a select tree per element; nf4a dequantizes
    in 3 fused multiply-adds. This converter lets imported NF4
    checkpoints opt into nf4a serving; the added quantization error is
    one extra nearest-level rounding, measured in the accuracy bench
    (docs/ACCURACY.md).
    """
    if qt.codebook is None:
        raise ValueError("transcode_codebook needs a codebook-format tensor")
    for name in (qt.codebook, target):
        if name not in _cb.codebook_names():
            raise ValueError(f"unknown codebook {name!r}")
    src = np.asarray(_cb._REGISTRY[qt.codebook], np.float32)
    dst = np.asarray(_cb._REGISTRY[target], np.float32)
    if len(src) != len(dst):
        raise ValueError(
            f"codebook sizes differ: {qt.codebook}={len(src)} vs "
            f"{target}={len(dst)}"
        )
    remap = np.argmin(np.abs(dst[None, :] - src[:, None]), axis=1)
    remap = jnp.asarray(remap.astype(np.uint8))
    if qt.packed != "none":  # packed nibbles (split_k or flat: remap each
        # half). An UNPACKED 4-bit tensor holds one code per byte with the
        # high nibble always 0 — remapping that nibble would corrupt codes
        # whenever remap[0] != 0, so it takes the plain-lookup branch below.
        lo = jnp.take(remap, (qt.codes & 0x0F).astype(jnp.int32))
        hi = jnp.take(remap, (qt.codes >> 4).astype(jnp.int32))
        codes = (lo | (hi << 4)).astype(jnp.uint8)
    else:
        codes = jnp.take(remap, qt.codes.astype(jnp.int32)).astype(jnp.uint8)
    return dataclasses.replace(qt, codes=codes, codebook=target)


def transcode_params(params, target: str = "nf4a", source: str = "nf4"):
    """Pytree version: remap every ``source``-codebook QuantizedTensor
    leaf to ``target`` (the load-time path for imported QLoRA/NF4
    checkpoints; see ``transcode_codebook``)."""

    def conv(leaf):
        if isinstance(leaf, QuantizedTensor) and leaf.codebook == source:
            return transcode_codebook(leaf, target)
        return leaf

    return jax.tree_util.tree_map(
        conv, params, is_leaf=lambda x: isinstance(x, QuantizedTensor)
    )


def convert_8bit_to_4bit(qt: QuantizedTensor, **kw) -> QuantizedTensor:
    """utils.py:281-293 parity."""
    return convert_precision(qt, bits=4, **kw)


def convert_4bit_to_8bit(qt: QuantizedTensor, **kw) -> QuantizedTensor:
    """utils.py:295-307 parity."""
    return convert_precision(qt, bits=8, **kw)


# Static hardware table (reference utils.py:321-326).
HARDWARE_TARGETS = {
    "cpu": QuantConfig(bits=8, scheme="affine", block_size=0),
    "gpu": QuantConfig(bits=8, scheme="symmetric", block_size=64),
    "mobile": QuantConfig(bits=4, scheme="codebook", codebook="nf4",
                          block_size=64, pack=True),
    "edge": QuantConfig(bits=4, scheme="symmetric", block_size=64, pack=True),
}


def optimize_for_target_hardware(
    qt: QuantizedTensor, target: str = "gpu"
) -> QuantizedTensor:
    """Requantize for a named hardware target (utils.py:309-335 parity)."""
    if target not in HARDWARE_TARGETS:
        raise ValueError(
            f"unknown target {target!r}; options: {sorted(HARDWARE_TARGETS)}"
        )
    c = HARDWARE_TARGETS[target]
    return convert_precision(
        qt, bits=c.bits, scheme=c.scheme, codebook=c.codebook,
        block_size=c.block_size, pack=c.pack,
    )
