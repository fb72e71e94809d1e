"""Quantized module layer (reference parity: Quanta/nn/__init__.py:5)."""

from quanta_tpu.nn.linear import (
    dequantize_params,
    init_quantized_params,
    linear,
    quantize_linear_weight,
    quantize_params,
)
from quanta_tpu.nn.lora import (
    LoRAWeight,
    init_lora,
    lora_linear,
    lora_params_filter,
    merge_lora,
)

__all__ = [
    "Linear8bitLt",
    "Linear4bit",
    "linear",
    "quantize_linear_weight",
    "quantize_params",
    "dequantize_params",
    "init_quantized_params",
    "LoRAWeight",
    "init_lora",
    "lora_linear",
    "lora_params_filter",
    "merge_lora",
]


def __getattr__(name):
    # the flax modules load on first use: flax is optional for the
    # functional API that models, serving and training run on
    if name in ("Linear8bitLt", "Linear4bit"):
        from quanta_tpu.nn import linen

        return getattr(linen, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
