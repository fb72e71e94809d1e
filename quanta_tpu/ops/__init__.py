"""Kernels and the one dispatch policy (reference parity: Quanta/backends/).

The reference dispatches per-tensor to cpu/cuda packages
(/root/reference/Quanta/backends/__init__.py:28-40; the cuda package is
absent). Here every op has a plain jnp/lax path that XLA compiles for
any backend, and the policy below decides, from the platform and the
shape, where a faster route exists on the GPU:

  - quantized linear at small M: the fused dequant-matmul kernel
    (ops.matmul, Pallas through Triton); larger M and the formats the
    kernel cannot dequantize take the plain dequant + GEMM;
  - long causal attention from position 0 in bf16: cuDNN's fused
    attention through jax.nn.dot_product_attention (ops.attention).

On the CPU the policy picks the plain path; tests reach a kernel only by
asking for ``interpret=True``. On a platform it does not know it raises.
It never picks interpret mode by itself.
"""

import jax
import jax.numpy as jnp

from quanta_tpu.ops.int4c import Int4cWeight, matmul_int4c, quantize_int4c_weight
from quanta_tpu.ops.int8mm import Int8Weight, matmul_int8, quantize_int8_weight
from quanta_tpu.ops.matmul import fused_matmul, kernel_supports, matmul_quantized

# Largest M (rows of x) that the fused matmul kernel takes on the GPU.
# Measured on an H100 at the TinyLlama projections (PERF.md "Kernel
# decisions"): summed over a model's linears the kernel beats the plain
# dequant + cuBLAS GEMM at M = 32, 64 and 128 in nf4, nf4a and int8
# alike (1.35-2.0x), and loses at M = 512 on every shape. One threshold
# serves both bit widths.
FUSED_MAX_M = 128
# Shortest sequence that takes the cuDNN attention route.
CUDNN_ATTENTION_MIN_S = 1024


def _platform() -> str:
    platform = jax.default_backend()
    if platform not in ("cpu", "gpu"):
        raise NotImplementedError(
            f"no dispatch policy for platform {platform!r} (known: cpu, gpu)")
    return platform


def use_fused_matmul(m: int, qt) -> bool:
    """Fused kernel (True) or plain path (False) for ``x (m, K) @ qt``."""
    return (_platform() == "gpu" and m <= FUSED_MAX_M
            and kernel_supports(qt))


def attention_impl(s: int, dtype, from_zero: bool):
    """"cudnn" for multi-token causal attention over a sequence that
    starts at position 0, in bf16, at ``s >= CUDNN_ATTENTION_MIN_S`` on the
    GPU; None (the plain attention) otherwise."""
    if (_platform() == "gpu" and from_zero and s >= CUDNN_ATTENTION_MIN_S
            and jnp.dtype(dtype) == jnp.bfloat16):
        return "cudnn"
    return None


__all__ = [
    "matmul_quantized",
    "fused_matmul",
    "kernel_supports",
    "use_fused_matmul",
    "attention_impl",
    "FUSED_MAX_M",
    "CUDNN_ATTENTION_MIN_S",
    "matmul_int8",
    "quantize_int8_weight",
    "Int8Weight",
    "Int4cWeight",
    "matmul_int4c",
    "quantize_int4c_weight",
]
