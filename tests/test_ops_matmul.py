"""Fused dequant-matmul kernel (Pallas, Triton route) vs the jnp oracle,
and the plain LLM.int8 / int4c paths vs float64 NumPy references.

The kernel runs in Pallas interpret mode on the CPU (the replacement for
the reference's CUDA-twin skipif pattern, SURVEY.md §4); chip_smoke.py
and the `gpu`-marked tests compare it compiled on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quanta_tpu import core
from quanta_tpu.ops import matmul as mm

FORMATS = ["nf4", "nf4a", "int4", "fp4", "int8", "nf8", "fp8",
           "int8a", "int4a"]


def _setup(fmt, m=48, k=256, n=192, block=64, seed=0):
    x = jax.random.normal(jax.random.PRNGKey(seed), (m, k), jnp.float32)
    w = jax.random.normal(jax.random.PRNGKey(seed + 1), (k, n), jnp.float32)
    qt = core.quantize_matmul_weight(w, fmt=fmt, block_size=block)
    ref = x @ core.dequantize_matmul_weight(qt)
    return x, qt, ref


@pytest.mark.parametrize("fmt", FORMATS)
def test_kernel_matches_oracle(fmt):
    from quanta_tpu.nn.linear import linear

    x, qt, ref = _setup(fmt)
    if fmt == "fp8":
        # the 256-level table needs a gather Triton does not lower: the
        # kernel refuses it and linear() keeps it on the plain path
        assert not mm.kernel_supports(qt)
        with pytest.raises(ValueError):
            mm.matmul_quantized(x, qt, interpret=True)
        out = linear(x, qt, interpret=True)
    else:
        assert mm.kernel_supports(qt)
        out = mm.matmul_quantized(x, qt, interpret=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("splits", [1, 4])
def test_multiple_k_steps(splits, monkeypatch):
    # K = 1024: 16 quant blocks, 8 packed rows of blocks walked by the
    # in-block loop, whole (one split: the N tiles alone fill the grid,
    # here a grid target of 4 programs) or as the 4 K splits pick_tiles
    # makes for 2 N tiles
    n = 128
    if splits == 1:
        n = 256  # another shape, so the jit cache holds no 4-split trace
        monkeypatch.setattr(mm, "_TARGET_PROGRAMS", 4)
    x, qt, ref = _setup("nf4", m=16, k=1024, n=n)
    n_blocks = qt.codes.shape[0] // qt.block_size
    assert mm.pick_tiles(16, qt.codes.shape[1], n_blocks)[2] == splits
    out = mm.matmul_quantized(x, qt, interpret=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5, atol=1e-3)


def test_unaligned_m_n():
    # M, N not multiples of the tile: wrapper pads and slices back
    x, qt, ref = _setup("nf4", m=7, k=256, n=100)
    out = mm.matmul_quantized(x, qt, interpret=True)
    assert out.shape == ref.shape
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5, atol=1e-4)


def test_batched_input():
    x = jax.random.normal(jax.random.PRNGKey(3), (2, 5, 256), jnp.float32)
    w = jax.random.normal(jax.random.PRNGKey(4), (256, 128), jnp.float32)
    qt = core.quantize_matmul_weight(w, fmt="nf4", block_size=64)
    ref = x @ core.dequantize_matmul_weight(qt)
    out = mm.matmul_quantized(x, qt, interpret=True)
    assert out.shape == (2, 5, 128)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5, atol=1e-4)


def test_bf16_activations():
    x, qt, _ = _setup("nf4")
    xb = x.astype(jnp.bfloat16)
    ref = xb.astype(jnp.float32) @ core.dequantize_matmul_weight(qt)
    out = mm.matmul_quantized(xb, qt, interpret=True, out_dtype=jnp.float32)
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(ref), rtol=2e-2, atol=2e-1
    )


def test_jit_grad_through_dequant():
    """The kernel path is differentiable wrt x (weights are frozen codes)."""
    x, qt, _ = _setup("nf4", m=16)

    def loss(xx):
        return jnp.sum(mm.matmul_quantized(xx, qt, interpret=True) ** 2)

    g = jax.grad(loss)(x)
    wd = core.dequantize_matmul_weight(qt)
    g_ref = 2.0 * (x @ wd) @ wd.T
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-4, atol=1e-2)


# ------------------------------------------------------- LLM.int8 kernel


def _setup_int8(m=8, k=300, n=200, seed=0, outliers=True):
    from quanta_tpu.ops import int8mm

    rng = jax.random.PRNGKey(seed)
    kx, kw, ko = jax.random.split(rng, 3)
    x = jax.random.normal(kx, (m, k), jnp.float32)
    w = jax.random.normal(kw, (k, n), jnp.float32) * 0.05
    if outliers:
        # systematic outlier features: large activations in a few columns
        hot = jax.random.choice(ko, k, (5,), replace=False)
        x = x.at[:, hot].multiply(40.0)
    qw = int8mm.quantize_int8_weight(w, outlier_capacity=16)
    return x, w, qw


def _int8_reference(x, qw):
    """float64 NumPy LLM.int8: outlier rows in full precision, the rest
    per-row absmax int8 activations x int8 codes x column scales."""
    x = np.asarray(x, np.float64)
    k, n = qw.shape
    idx = np.asarray(qw.outlier_idx)
    y_out = x[:, idx] @ np.asarray(qw.w_outlier, np.float64)[:, :n]
    x_in = x.copy()
    x_in[:, idx] = 0.0
    rs = np.maximum(np.abs(x_in).max(axis=1) / 127.0, 1e-12)
    xq = np.clip(np.round(x_in / rs[:, None]), -127, 127)
    codes = np.asarray(qw.codes, np.float64)[:k, :n]
    return (xq @ codes) * rs[:, None] * np.asarray(qw.scale)[None, :n] + y_out


@pytest.mark.parametrize("shape", [(8, 300, 200), (48, 512, 384),
                                   (1, 128, 128)])
def test_int8_kernel_matches_xla_path(shape):
    """The plain LLM.int8 path (int8 x int8 -> int32 dot left to XLA)
    matches a float64 NumPy reference of the same decomposition,
    including unpadded K/N and M = 1."""
    from quanta_tpu.ops import int8mm

    m, k, n = shape
    x, _, qw = _setup_int8(m=m, k=k, n=n)
    out = int8mm.matmul_int8(x, qw)
    assert out.shape == (m, n)
    np.testing.assert_allclose(np.asarray(out), _int8_reference(x, qw),
                               rtol=1e-5, atol=1e-4)


def test_int8_kernel_through_linear_dispatch():
    """linear() routes Int8Weight through matmul_int8; outputs track the
    dense matmul (quantization error only)."""
    from quanta_tpu.nn.linear import linear

    x, w, qw = _setup_int8(m=16, k=256, n=192)
    dense = np.asarray(x @ w)
    out = np.asarray(linear(x, qw))
    np.testing.assert_allclose(out, _int8_reference(x, qw),
                               rtol=1e-5, atol=1e-4)
    err = np.abs(out - dense).max() / (np.abs(dense).max() + 1e-9)
    assert err < 0.05, err


def test_int8_weight_padding_round_trip():
    """Padded codes/scales (kernel tiles) must not leak into the dense
    reconstruction or the logical output shape."""
    from quanta_tpu.nn.linear import dequantize_params
    from quanta_tpu.ops import int8mm

    x, w, qw = _setup_int8(m=4, k=130, n=70)
    assert qw.codes.shape == (256, 128) and qw.shape == (130, 70)
    dense = dequantize_params({"w": qw})["w"]
    assert dense.shape == (130, 70)
    # outlier rows restored exactly; inliers to int8 precision
    np.testing.assert_allclose(
        np.asarray(dense), np.asarray(w), atol=np.abs(np.asarray(w)).max() / 100
    )
    out = int8mm.matmul_int8(x, qw)
    assert out.shape == (4, 70)


# ------------------------------------------------------------ int4c kernel


def _setup_int4c(m=8, k=300, n=200, seed=0):
    from quanta_tpu.ops import int4c

    kx, kw = jax.random.split(jax.random.PRNGKey(seed))
    x = jax.random.normal(kx, (m, k), jnp.float32)
    w = jax.random.normal(kw, (k, n), jnp.float32) * 0.05
    return x, w, int4c.quantize_int4c_weight(w)


def test_int4c_round_trip():
    from quanta_tpu.ops import int4c

    _, w, qw = _setup_int4c(k=260, n=130)
    assert qw.codes.shape == (256, 256) and qw.codes.dtype == jnp.uint8
    assert qw.scale.shape == (256,) and qw.shape == (260, 130)
    back = int4c.dequantize_int4c(qw)
    assert back.shape == (260, 130)
    # per-column absmax/7 grid: error bounded by scale/2 per element
    err = np.abs(np.asarray(back - w))
    bound = np.asarray(qw.scale)[None, :130] / 2 + 1e-6
    assert (err <= bound).all()


def _int4c_reference(x, qw):
    """float64 NumPy int4c: per-row absmax int8 activations x unpacked
    int4 codes x row and column scales."""
    x = np.asarray(x, np.float64)
    k, n = qw.shape
    packed = np.asarray(qw.codes, np.int64)
    w4 = np.concatenate([(packed & 0x0F) - 8, (packed >> 4) - 8], axis=0)
    rs = np.maximum(np.abs(x).max(axis=1) / 127.0, 1e-12)
    xq = np.clip(np.round(x / rs[:, None]), -127, 127)
    acc = xq @ w4[:k, :n].astype(np.float64)
    return acc * rs[:, None] * np.asarray(qw.scale, np.float64)[None, :n]


@pytest.mark.parametrize("shape", [(8, 300, 200), (48, 512, 384),
                                   (1, 128, 128)])
def test_int4c_kernel_matches_xla_path(shape):
    from quanta_tpu.ops import int4c

    m, k, n = shape
    x, _, qw = _setup_int4c(m=m, k=k, n=n)
    out = int4c.matmul_int4c(x, qw)
    assert out.shape == (m, n)
    np.testing.assert_allclose(np.asarray(out), _int4c_reference(x, qw),
                               rtol=1e-5, atol=1e-4)


def test_int4c_through_linear_and_model():
    """linear() dispatch + tiny-Llama forward + serialization round trip
    for the int4c format."""
    from quanta_tpu import nn as qnn
    from quanta_tpu.models import llama
    from quanta_tpu.nn.linear import linear
    from quanta_tpu.ops.int4c import Int4cWeight
    from quanta_tpu.utils import serialization

    x, w, qw = _setup_int4c(m=16, k=256, n=192)
    dense = np.asarray(x @ w)
    out = np.asarray(linear(x, qw))
    # 4-bit per-column weights + int8 activations on gaussian data: ~15%
    # worst-element error is expected coarseness, not a plumbing bug (the
    # exact-parity check is kernel-vs-oracle above; QUALITY is gated at
    # model level by the ppl tests / docs/ACCURACY.md)
    rel = np.abs(out - dense).max() / (np.abs(dense).max() + 1e-9)
    assert rel < 0.3, rel

    cfg = llama.LlamaConfig.tiny(dtype=jnp.float32)
    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    qp = qnn.quantize_params(params, mode="int4c", min_size=0)
    assert isinstance(qp["layers"][0]["wq"], Int4cWeight)
    toks = jnp.asarray(np.random.default_rng(0).integers(0, 256, (2, 12)),
                       jnp.int32)
    lg_ref, _ = llama.forward(params, toks, cfg)
    lg_q, _ = llama.forward(qp, toks, cfg)
    corr = np.corrcoef(np.asarray(lg_ref).ravel(), np.asarray(lg_q).ravel())
    # random-init tiny dims exaggerate per-column 4-bit error; trained
    # models are the quality gate (accuracy bench: +0.17 ppl, well under
    # the 0.5 4-bit gate)
    assert corr[0, 1] > 0.9, corr

    import tempfile

    with tempfile.TemporaryDirectory() as d:
        serialization.save_checkpoint(qp, f"{d}/ck.npz")
        back = serialization.load_checkpoint(f"{d}/ck.npz")
    bw = back["layers"][0]["wq"]
    assert isinstance(bw, Int4cWeight) and bw.shape == qp["layers"][0]["wq"].shape
    np.testing.assert_array_equal(np.asarray(bw.codes),
                                  np.asarray(qp["layers"][0]["wq"].codes))


@pytest.mark.parametrize("shape", [(8, 300, 200), (48, 512, 384),
                                   (1, 128, 128)])
def test_int8_fused_prologue_epilogue_matches(shape):
    """Without planted outliers (inlier-only rows, the common decode
    case) and under jit with bf16 activations, the plain LLM.int8 path
    still matches the float64 decomposition."""
    from quanta_tpu.ops import int8mm

    m, k, n = shape
    x, _, qw = _setup_int8(m=m, k=k, n=n, seed=1, outliers=False)
    out = jax.jit(int8mm.matmul_int8)(x, qw)
    np.testing.assert_allclose(np.asarray(out), _int8_reference(x, qw),
                               rtol=1e-5, atol=1e-4)
    xb = x.astype(jnp.bfloat16)
    outb = jax.jit(int8mm.matmul_int8)(xb, qw)
    assert outb.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(outb, np.float32),
                               _int8_reference(xb.astype(jnp.float32), qw),
                               rtol=2e-2, atol=2e-2)


def test_affine_handles_shifted_weights():
    """Affine (zero-point) blockwise exists for asymmetric distributions:
    on an all-positive weight it must reconstruct far better than
    symmetric at the same bit width (VERDICT r4 missing #6)."""
    w = jax.random.uniform(jax.random.PRNGKey(7), (256, 128),
                           jnp.float32, 3.0, 5.0)  # mean 4, range 2
    qa = core.quantize_matmul_weight(w, fmt="int8a", block_size=64)
    qs = core.quantize_matmul_weight(w, fmt="int8", block_size=64)
    ea = float(jnp.abs(core.dequantize_matmul_weight(qa) - w).max())
    es = float(jnp.abs(core.dequantize_matmul_weight(qs) - w).max())
    assert qa.zero_point is not None and qa.scheme == "affine"
    # affine step = range/255 ~ 0.004; symmetric step = absmax/127 ~ 0.04
    assert ea < es / 3, (ea, es)


def test_affine_ptq_reachable():
    """scheme='affine' resolves through the config system to the fused
    path (config_to_mode -> int8a/int4a) and the model still runs."""
    from quanta_tpu import ptq
    from quanta_tpu.state.config import QuantConfig

    for bits, mode in ((8, "int8a"), (4, "int4a")):
        c = QuantConfig(bits=bits, scheme="affine")
        assert ptq.config_to_mode(c) == mode
        assert QuantConfig.from_mode(mode).scheme == "affine"


@pytest.mark.parametrize("fmt", FORMATS)
def test_backward_kernel_matches_oracle(fmt):
    """The gradient rule: jax.grad through linear() on a quantized weight
    (the kernel's custom VJP, dx = g @ dequant(W)^T, wherever the kernel
    takes the format) matches the dequant oracle's gradient."""
    from quanta_tpu.nn.linear import linear

    x, qt, _ = _setup(fmt, m=12, k=256, n=192)
    wd = core.dequantize_matmul_weight(qt).astype(jnp.float32)

    def loss_kernel(x):
        return jnp.sum(linear(x, qt, interpret=True) ** 2)

    def loss_oracle(x):
        return jnp.sum((x @ wd) ** 2)

    gk = jax.grad(loss_kernel)(x)
    go = jax.grad(loss_oracle)(x)
    # affine adds the zp term as a separately-summed GEMM: slightly
    # different accumulation order than the fused oracle product
    np.testing.assert_allclose(np.asarray(gk), np.asarray(go),
                               rtol=5e-4, atol=2e-3)


def test_backward_kernel_unaligned_and_batched():
    x = jax.random.normal(jax.random.PRNGKey(9), (2, 5, 250), jnp.float32)
    w = jax.random.normal(jax.random.PRNGKey(10), (250, 100), jnp.float32)
    qt = core.quantize_matmul_weight(w, fmt="nf4a", block_size=64)
    wd = core.dequantize_matmul_weight(qt).astype(jnp.float32)
    gk = jax.grad(
        lambda x: jnp.sum(mm.matmul_quantized(x, qt, interpret=True) ** 2)
    )(x)
    go = jax.grad(lambda x: jnp.sum((x @ wd) ** 2))(x)
    assert gk.shape == x.shape
    np.testing.assert_allclose(np.asarray(gk), np.asarray(go),
                               rtol=1e-4, atol=1e-3)
