"""LLM.int8()-style mixed-precision matmul with outlier decomposition.

Behavior contract from the reference's `Linear8bitLt` shell
(/root/reference/Quanta/nn/linear.py:10-45: `threshold=6.0`,
`has_fp16_weights`) and the LLM.int8() paper: activation features whose
magnitude exceeds `threshold` are computed in 16-bit; everything else goes
through an int8 x int8 -> int32 matmul with per-row activation scales
and per-column weight scales.

Static formulation (XLA requires static shapes, so the dynamic outlier
set becomes a *static-capacity* set, SURVEY.md §7 hard part 2):

  - At quantize time we reserve `outlier_capacity` columns. A bf16 copy of
    those weight rows is kept (`w_outlier`), chosen by calibration or weight
    magnitude; their int8 codes are zeroed so the two GEMMs never double
    count.
  - At run time the activation columns at the stored indices are gathered
    for the 16-bit GEMM; remaining activations are per-row absmax-quantized
    to int8. Columns above `threshold` outside the stored set are clamped
    (capacity misses are measurable via `outlier_coverage`).

The int8 GEMM uses jnp.dot with preferred_element_type=int32, which XLA
lowers onto an int8 tensor-core GEMM.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

_EPS = 1e-12


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Int8Weight:
    """Weight state for LLM.int8() inference. Layout: (K, N) like x @ W."""

    codes: jax.Array  # int8 (K, N), outlier rows zeroed
    scale: jax.Array  # f32 (N,) per-output-column scales
    outlier_idx: jax.Array  # int32 (capacity,) K-indices of outlier features
    w_outlier: jax.Array  # bf16 (capacity, N) original rows at outlier_idx

    threshold: float = dataclasses.field(metadata=dict(static=True), default=6.0)
    shape: tuple = dataclasses.field(metadata=dict(static=True), default=())


def quantize_int8_weight(
    w: jax.Array,
    *,
    threshold: float = 6.0,
    outlier_capacity: Optional[int] = None,
    calib_colmax: Optional[jax.Array] = None,
) -> Int8Weight:
    """Prepare a weight (K, N) for LLM.int8() inference.

    calib_colmax: optional (K,) per-feature max |activation| statistics from
    calibration; outlier features are the top-`capacity` by this statistic
    (features the paper identifies as systematic outliers). Without
    calibration, weight-row norms are the proxy.
    """
    k, n = w.shape
    if outlier_capacity is None:
        outlier_capacity = max(32, k // 64)  # ~1.5% of features, static
    wf = w.astype(jnp.float32)

    stat = (
        calib_colmax.astype(jnp.float32)
        if calib_colmax is not None
        else jnp.max(jnp.abs(wf), axis=1)
    )
    _, idx = jax.lax.top_k(stat, outlier_capacity)
    idx = jnp.sort(idx)

    w_outlier = wf[idx, :].astype(jnp.bfloat16)
    # zero outlier rows in the int8 operand (no double counting)
    mask = jnp.zeros((k,), jnp.float32).at[idx].set(1.0)
    w_inlier = wf * (1.0 - mask)[:, None]

    scale = jnp.maximum(jnp.max(jnp.abs(w_inlier), axis=0) / 127.0, _EPS)
    codes = jnp.clip(jnp.round(w_inlier / scale[None, :]), -127, 127).astype(jnp.int8)

    # pad to 128 ONCE at quantize time (padding per matmul call would
    # copy the weight every step). Zero code rows/cols contribute nothing
    # to the GEMM; logical dims live in ``shape``.
    k_pad, n_pad = _round_up(k, 128), _round_up(n, 128)
    codes = jnp.pad(codes, ((0, k_pad - k), (0, n_pad - n)))
    scale = jnp.pad(scale.astype(jnp.float32), (0, n_pad - n))
    w_outlier = jnp.pad(w_outlier, ((0, 0), (0, n_pad - n)))

    return Int8Weight(
        codes=codes,
        scale=scale,
        outlier_idx=idx.astype(jnp.int32),
        w_outlier=w_outlier,
        threshold=float(threshold),
        shape=(k, n),
    )


def matmul_int8(
    x: jax.Array,
    qw: Int8Weight,
    *,
    out_dtype=None,
) -> jax.Array:
    """``x (.., K) @ W (K, N)`` via int8 GEMM + 16-bit outlier GEMM.

    The int8 x int8 -> int32 ``jnp.dot`` is left to XLA, which hands it
    to an int8 tensor-core GEMM on the GPU and fuses the activation
    quantize and the scales around it.
    """
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    k, n = qw.shape
    x2 = x.reshape(-1, k).astype(jnp.float32)

    # 16-bit path: gathered outlier features in f32 (TF32 on the GPU
    # unless a matmul precision is set); the outlier GEMM is ~1.5% of K,
    # so the cast costs nothing material.
    x_out = jnp.take(x2, qw.outlier_idx, axis=1)
    y_out = jnp.dot(
        x_out.astype(jnp.float32),
        qw.w_outlier.astype(jnp.float32),
        preferred_element_type=jnp.float32,
    )

    # int8 path: per-row absmax over INLIER features only (outlier
    # activations are exactly the large ones and would blow the scale).
    # The outlier columns themselves need no zeroing before the GEMM —
    # their weight codes are zero, so whatever they quantize to (they
    # clip) contributes nothing.
    mask = jnp.zeros((k,), jnp.float32).at[qw.outlier_idx].set(1.0)
    x_in = x2 * (1.0 - mask)[None, :]
    row_scale = jnp.maximum(jnp.max(jnp.abs(x_in), axis=1) / 127.0, _EPS)

    k_pad = qw.codes.shape[0]
    xq = jnp.clip(jnp.round(x_in / row_scale[:, None]), -127, 127).astype(
        jnp.int8
    )
    if k_pad != k:
        xq = jnp.pad(xq, ((0, 0), (0, k_pad - k)))
    acc = jnp.dot(xq, qw.codes, preferred_element_type=jnp.int32)
    y_in = acc.astype(jnp.float32) * row_scale[:, None] * qw.scale[None, :]

    y = (y_in[:, :n] + y_out[:, :n]).astype(out_dtype)
    return y.reshape(*lead, n)


def outlier_coverage(x: jax.Array, qw: Int8Weight) -> jax.Array:
    """Fraction of above-threshold activation features covered by the static
    outlier set (diagnostics for capacity tuning)."""
    k = x.shape[-1]
    colmax = jnp.max(jnp.abs(x.reshape(-1, k)), axis=0)
    hot = colmax > qw.threshold
    mask = jnp.zeros((k,), bool).at[qw.outlier_idx].set(True)
    covered = jnp.sum(hot & mask)
    return covered / jnp.maximum(jnp.sum(hot), 1)
