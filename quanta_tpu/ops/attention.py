"""Causal attention through ``jax.nn.dot_product_attention``.

The route for multi-token causal attention whose queries start at
position 0 (training, scoring, prefill into an empty cache): on the GPU
``implementation="cudnn"`` runs cuDNN's fused attention, which keeps the
(S, T) scores out of device memory, supports grouped KV heads and has
its own backward. ops.attention_impl decides when it is taken; every
other case (decode, prefill at an offset, f32) runs the plain
quanta_tpu.models.llama._attention, which is also this route's oracle.
"""

from __future__ import annotations

from typing import Optional

import jax


def causal_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    kv_len: Optional[jax.Array] = None,
    *,
    implementation: Optional[str] = None,
) -> jax.Array:
    """Causal GQA attention, queries at positions 0..S-1.

    q: (B, S, n_heads, hd); k/v: (B, T, n_kv_heads, hd) with T >= S and
    n_heads a multiple of n_kv_heads; kv_len: optional (B,) int32 count of
    valid keys (the rest are masked). Scale 1/sqrt(hd). ``implementation``
    is jax.nn.dot_product_attention's: "cudnn", "xla" or None.
    """
    return jax.nn.dot_product_attention(
        q, k, v, is_causal=True, key_value_seq_lengths=kv_len,
        implementation=implementation,
    )
