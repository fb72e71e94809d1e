"""Flax linen wrappers over :func:`quanta_tpu.nn.linear.linear`.

Kept apart from the functional layer so that flax is needed only by
users of the module API: ``quanta_tpu.nn`` imports this file on first
access to ``Linear8bitLt`` or ``Linear4bit``.
"""

from __future__ import annotations

from typing import Any

import flax.linen as fnn
import jax.numpy as jnp

from quanta_tpu.nn.linear import linear


class Linear8bitLt(fnn.Module):
    """LLM.int8() linear (reference: Quanta/nn/linear.py:10-45).

    At init the kernel is a dense bf16/f32 array (``has_fp16_weights``
    semantics); call :func:`quanta_tpu.nn.quantize_params` on the param
    tree to swap kernels for Int8Weight leaves. ``__call__`` handles both.
    """

    features: int
    use_bias: bool = True
    has_fp16_weights: bool = False
    threshold: float = 6.0
    param_dtype: Any = jnp.float32

    @fnn.compact
    def __call__(self, x):
        in_features = x.shape[-1]
        kernel = self.param(
            "kernel",
            fnn.initializers.kaiming_uniform(),
            (in_features, self.features),
            self.param_dtype,
        )
        bias = (
            self.param(
                "bias", fnn.initializers.zeros_init(), (self.features,), self.param_dtype
            )
            if self.use_bias
            else None
        )
        return linear(x, kernel, bias)


class Linear4bit(fnn.Module):
    """QLoRA-style 4-bit linear (reference: Quanta/nn/linear.py:48-83)."""

    features: int
    use_bias: bool = True
    compute_dtype: Any = jnp.bfloat16
    quant_type: str = "nf4"
    block_size: int = 64
    param_dtype: Any = jnp.float32

    @fnn.compact
    def __call__(self, x):
        in_features = x.shape[-1]
        kernel = self.param(
            "kernel",
            fnn.initializers.kaiming_uniform(),
            (in_features, self.features),
            self.param_dtype,
        )
        bias = (
            self.param(
                "bias", fnn.initializers.zeros_init(), (self.features,), self.param_dtype
            )
            if self.use_bias
            else None
        )
        return linear(x.astype(self.compute_dtype), kernel, bias)
