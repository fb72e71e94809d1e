"""quanta_tpu — a quantized-inference and QLoRA framework in JAX.

Brand-new JAX/XLA/Pallas implementation of the capability set of the
reference project ved1beta/Quanta (a PyTorch bitsandbytes-style library):
INT8 absmax / zero-point quantization, blockwise NF4/INT4/FP4/FP8 weight
quantization, LLM.int8()-style outlier-decomposition matmul, QLoRA
fine-tuning with 8-bit blockwise Adam, fused dequant-matmul Pallas kernels,
and GSPMD-sharded multi-host serving with a paged KV cache.

Layers (bottom-up):
  core      pure-jnp quant math (oracle)        <- reference functional/
  ops       Pallas kernel + dispatch policy     <- reference backends/
  state     config + quant-state registry       <- reference functional/state.py
  utils     packing, serialization, conversion  <- reference utils/
  nn        quantized module layer              <- reference nn/
  optim     8-bit blockwise optimizers          <- reference optim/
  models    Llama / GPT-2 decoders (new)
  parallel  mesh + GSPMD shardings (new)
  serve     paged KV cache + continuous batching (new)
"""

import logging

from quanta_tpu.core import QuantizedTensor, dequantize, quantize

__version__ = "0.1.0"

# Match the reference's library-logging etiquette
# (/root/reference/Quanta/__init__.py:16-17).
logging.getLogger(__name__).addHandler(logging.NullHandler())

__all__ = ["QuantizedTensor", "quantize", "dequantize", "__version__"]
