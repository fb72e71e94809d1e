"""Quantized linear layers.

API contract from the reference shells (which declare the interface but
forward in fp, /root/reference/Quanta/nn/linear.py:10-83):

  - ``Linear8bitLt(in, out, bias, has_fp16_weights, threshold=6.0)`` —
    LLM.int8() semantics: int8 GEMM + outlier decomposition at `threshold`.
  - ``Linear4bit(in, out, bias, compute_dtype, quant_type="nf4")`` —
    QLoRA semantics: packed 4-bit weight, bf16 compute.

Here the *functional* entry point is :func:`linear`, which dispatches on
the weight leaf type (plain array / QuantizedTensor / Int8Weight), so
whole-model quantization is a pytree transformation, not module surgery.
The Flax linen modules in quanta_tpu.nn.linen wrap it for users who want
the module API (imported on first use, so flax stays optional).
"""

from __future__ import annotations

import math
from typing import Any, Optional

import jax
import jax.numpy as jnp

from quanta_tpu import calib
from quanta_tpu.core import codecs
from quanta_tpu.core.qtensor import QuantizedTensor
from quanta_tpu import ops
from quanta_tpu.ops.int4c import Int4cWeight, matmul_int4c, quantize_int4c_weight
from quanta_tpu.ops.int8mm import Int8Weight, matmul_int8, quantize_int8_weight
from quanta_tpu.ops.matmul import matmul_quantized

WeightLike = Any  # jax.Array | QuantizedTensor | Int8Weight


def linear(
    x: jax.Array,
    w: WeightLike,
    b: Optional[jax.Array] = None,
    *,
    use_kernel: Optional[bool] = None,
    interpret: bool = False,
) -> jax.Array:
    """``x @ W (+ b)`` for any supported weight representation.

    ``W`` is (in_features, out_features). For a QuantizedTensor,
    ``use_kernel`` picks the fused dequant-matmul kernel (True) or the
    plain dequant + matmul (False); None asks ops.use_fused_matmul, the
    dispatch policy (the role of the reference's backends/__init__.py:
    28-40). ``interpret=True`` runs the kernel in Pallas interpret mode
    (tests on the CPU). Int8Weight and Int4cWeight have one (XLA) path.
    """
    if isinstance(w, calib.TapWeight):  # calibration stats hook
        calib.tap_record(w.name, x)
        w = w.w
    if isinstance(w, calib.ActQuantWeight):  # calibrated activation quant
        x = calib.fake_quant(x, w.lo, w.hi, w.bits)
        w = w.w
    if isinstance(w, QuantizedTensor):
        if use_kernel is None:
            m = math.prod(x.shape[:-1])
            use_kernel = ops.kernel_supports(w) and (
                interpret or ops.use_fused_matmul(m, w))
        y = matmul_quantized(x, w, kernel=use_kernel, interpret=interpret)
    elif isinstance(w, Int8Weight):
        y = matmul_int8(x, w)
    elif isinstance(w, Int4cWeight):
        y = matmul_int4c(x, w)
    elif type(w).__name__ == "LoRAWeight":  # avoid circular import
        from quanta_tpu.nn.lora import lora_linear

        return lora_linear(x, w, b, use_kernel=use_kernel, interpret=interpret)
    else:
        y = x @ w.astype(x.dtype)
    if b is not None:
        y = y + b.astype(y.dtype)
    return y


def quantize_linear_weight(
    w: jax.Array,
    *,
    mode: str = "nf4",
    block_size: int = 64,
    threshold: float = 6.0,
    calib_colmax: Optional[jax.Array] = None,
) -> WeightLike:
    """Convert a dense (in, out) weight into a quantized representation.

    mode: "nf4"/"nf4a"/"int4"/"fp4"/"int8"/"nf8"/"fp8" (fused-kernel
    formats), "int8a"/"int4a" (affine zero-point blockwise — the
    reference's default 8-bit scheme; served via the symmetric kernel
    plus a blocksum(x) @ zp correction GEMM), "llm_int8"
    (outlier-decomposition Int8Weight), or "int4c" (4-bit weights with
    per-column scales and int8 activations; ops/int4c.py).
    """
    if mode == "llm_int8":
        return quantize_int8_weight(
            w, threshold=threshold, calib_colmax=calib_colmax
        )
    if mode == "int4c":
        return quantize_int4c_weight(w)
    return codecs.quantize_matmul_weight(w, fmt=mode, block_size=block_size)


def quantize_params(
    params,
    *,
    mode: str = "nf4",
    block_size: int = 64,
    threshold: float = 6.0,
    predicate=None,
    min_size: int = 4096,
    stats=None,
):
    """Pytree transformation: replace 2-D weight leaves with quantized ones.

    This is the functional equivalent of the reference's ``ModelQuantize``
    in-place module rewrite (/root/reference/Quanta/functional/model.py:
    254-289) — transform the param pytree, not the module tree.

    predicate(path, leaf) -> bool selects which leaves to quantize;
    default: 2-D float arrays with >= min_size elements whose first dim is
    divisible by block_size (embeddings/norms stay in full precision).

    stats: optional {tree_path: calib.ActivationStats} from
    calib.collect_stats; with mode="llm_int8" the per-feature activation
    colmax selects the outlier set (the LLM.int8() systematic-outlier
    criterion) instead of the weight-norm proxy.
    """

    def default_pred(path, leaf):
        names = "/".join(
            str(getattr(p, "name", getattr(p, "key", getattr(p, "idx", ""))))
            for p in path
        )
        return (
            isinstance(leaf, jax.Array)
            and leaf.ndim == 2
            and jnp.issubdtype(leaf.dtype, jnp.floating)
            and leaf.size >= min_size
            # embeddings are gathered (and possibly tied to the head), not
            # matmul'd: keep them dense
            and "emb" not in names
            and "wte" not in names
            and "wpe" not in names
        )

    pred = predicate or default_pred

    def maybe_quant(path, leaf):
        if pred(path, leaf):
            colmax = None
            if stats is not None:
                st = stats.get(calib._path_name(path))
                if st is not None:
                    colmax = jnp.asarray(st.colmax)
            return quantize_linear_weight(
                leaf, mode=mode, block_size=block_size, threshold=threshold,
                calib_colmax=colmax,
            )
        return leaf

    return jax.tree_util.tree_map_with_path(
        maybe_quant, params,
        is_leaf=lambda x: isinstance(
            x, (QuantizedTensor, Int8Weight, Int4cWeight)
        ),
    )


def init_quantized_params(rng, cfg, *, mode: str = "nf4a",
                          block_size: int = 64):
    """Random-init a Llama param tree DIRECTLY in quantized form — codes
    and scales are drawn without ever materializing the dense bf16 tree.

    Why: benchmarking and compiling north-star model sizes without the
    dense tree (a dense Llama-2-7B init is ~13.5 GB bf16); random codes +
    calibrated-looking scales measure identical throughput (decode cost
    depends on shapes and formats, not weight values).
    """
    import dataclasses as _dc
    import math as _math

    from quanta_tpu.core import codecs

    def quantize_shape(key, shape):
        k, n = shape
        # template carries the format's static metadata; codes/scales are
        # drawn at the real (padded) layout the quantizer would produce
        # (K_pad % 16*block == 0, N_pad % 128 == 0; see core/codecs.py)
        template = codecs.quantize_matmul_weight(
            jnp.zeros((16 * block_size, 128), jnp.float32),
            fmt=mode, block_size=block_size,
        )
        k_pad = -(-k // (16 * block_size)) * (16 * block_size)
        n_pad = -(-n // 128) * 128
        kc, ks = jax.random.split(key)
        if template.packed == "split_k":
            codes = jax.random.randint(
                kc, (k_pad // 2, n_pad), 0, 256, jnp.int32
            ).astype(jnp.uint8)
        elif template.codes.dtype == jnp.int8:
            codes = jax.random.randint(
                kc, (k_pad, n_pad), -127, 128, jnp.int32
            ).astype(jnp.int8)
        else:
            codes = jax.random.randint(
                kc, (k_pad, n_pad), 0, 256, jnp.int32
            ).astype(jnp.uint8)
        scale = (
            jax.random.uniform(ks, (k_pad // block_size, n_pad), jnp.float32)
            * (1.0 / _math.sqrt(k))
            + 1e-4
        )
        return _dc.replace(
            template, codes=codes, scale=scale, shape=(k, n),
            dtype=jnp.dtype(jnp.bfloat16),
        )

    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    keys = iter(jax.random.split(rng, 4 + 7 * cfg.n_layers))
    emb_scale = 0.02
    params = {
        "tok_emb": (jax.random.normal(
            next(keys), (cfg.vocab_size, cfg.dim), jnp.float32
        ) * emb_scale).astype(cfg.dtype),
        "norm_f": jnp.ones((cfg.dim,), cfg.dtype),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "attn_norm": jnp.ones((cfg.dim,), cfg.dtype),
            "wq": quantize_shape(next(keys), (cfg.dim, nh * hd)),
            "wk": quantize_shape(next(keys), (cfg.dim, nkv * hd)),
            "wv": quantize_shape(next(keys), (cfg.dim, nkv * hd)),
            "wo": quantize_shape(next(keys), (nh * hd, cfg.dim)),
            "ffn_norm": jnp.ones((cfg.dim,), cfg.dtype),
            "w_gate": quantize_shape(next(keys), (cfg.dim, cfg.hidden_dim)),
            "w_up": quantize_shape(next(keys), (cfg.dim, cfg.hidden_dim)),
            "w_down": quantize_shape(next(keys), (cfg.hidden_dim, cfg.dim)),
        })
    if not cfg.tie_embeddings:
        params["lm_head"] = quantize_shape(
            next(keys), (cfg.dim, cfg.vocab_size)
        )
    return params


def dequantize_params(params):
    """Inverse transformation: materialize dense weights from quantized."""

    def deq(leaf):
        if isinstance(leaf, (calib.TapWeight, calib.ActQuantWeight)):
            leaf = leaf.w
        if isinstance(leaf, QuantizedTensor):
            return codecs.dequantize_matmul_weight(leaf)
        if isinstance(leaf, Int8Weight):
            k, n = leaf.shape
            dense = leaf.codes.astype(jnp.float32) * leaf.scale[None, :]
            dense = dense.at[leaf.outlier_idx].set(
                leaf.w_outlier.astype(jnp.float32))
            return dense[:k, :n]  # drop kernel-tile padding
        if isinstance(leaf, Int4cWeight):
            from quanta_tpu.ops.int4c import dequantize_int4c

            return dequantize_int4c(leaf)
        return leaf

    return jax.tree_util.tree_map(
        deq,
        params,
        is_leaf=lambda x: isinstance(
            x, (QuantizedTensor, Int8Weight, Int4cWeight, calib.TapWeight,
                calib.ActQuantWeight)
        ),
    )
