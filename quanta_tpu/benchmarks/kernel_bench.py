"""Kernel checks and timings on the card.

Each hand-written kernel and library route is compared, compiled for the
GPU, with the repo's plain reference at TinyLlama-1.1B widths, and timed
against what XLA compiles of the plain version of the same math:

  - the fused dequant-matmul kernel (ops.matmul) for every format it
    takes, vs ``x @ dequant(W)`` (reference: dequantize to f32, then a
    matmul at ``highest`` precision — an f32 product otherwise runs in
    TF32 on this card);
  - cuDNN attention (ops.attention) vs llama._attention;
  - which GEMM XLA picks for the LLM.int8 s8 x s8 -> s32 dot;
  - the compiled memory plan of a Llama-2-7B NF4 QLoRA step.

chip_smoke.py prints these as its kernel phase; tests/test_gpu.py calls
the same functions at smaller sizes. Every function needs a GPU.

  python -m quanta_tpu.benchmarks.kernel_bench [--m 8 512] [--formats ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from quanta_tpu.core import codecs
from quanta_tpu.models import llama
from quanta_tpu.ops import matmul as mm
from quanta_tpu.ops.attention import causal_attention
from quanta_tpu.profiling import time_fn

# TinyLlama-1.1B projections (K, N): wq/wo, wk/wv, gate/up, down, lm_head
TINYLLAMA_SHAPES = ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
                    (2048, 32000))
# every QuantizedTensor format the fused kernel takes (fp8 is plain)
KERNEL_FORMATS = ("nf4", "nf4a", "int4", "fp4", "int8", "nf8", "int8a",
                  "int4a")
# Normalized max error (max|out - ref| / max|ref|) allowed between the
# kernel and the f32 `highest` reference. Source of the error: the kernel
# rounds each dequantized weight to bf16 before the tensor-core dot
# (2^-9 relative per element) and sums in f32 in another order than the
# reference; x is bf16 in both.
MATMUL_TOL = 8e-3
# cuDNN attention vs the f32 `highest` reference: bf16 inputs, and the
# softmax probabilities are rounded to bf16 before the P @ V product.
ATTENTION_TOL = 2e-2
ATTENTION_GRAD_TOL = 3e-2
# weight bytes each timed stack streams: twice the H100's 50 MB L2, so
# the weights come from device memory as they do in a real decode
_STREAM_BYTES = 100 << 20


def require_gpu() -> None:
    if jax.default_backend() != "gpu":
        raise RuntimeError(
            f"kernel_bench needs a GPU; default backend is "
            f"{jax.default_backend()!r}")


def _quantized(fmt, k, n, seed=0):
    w = jax.random.normal(jax.random.PRNGKey(seed), (k, n), jnp.float32)
    return codecs.quantize_matmul_weight(w * k ** -0.5, fmt=fmt,
                                         block_size=64)


def _activations(m, k, seed=1):
    return jax.random.normal(jax.random.PRNGKey(seed), (m, k),
                             jnp.bfloat16)


def _normalized_err(out, ref) -> float:
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def check_matmul(fmt: str, m: int, k: int, n: int, seed: int = 0) -> dict:
    """Kernel and plain path vs the f32 ``highest`` reference."""
    require_gpu()
    qt = _quantized(fmt, k, n, seed)
    x = _activations(m, k, seed + 1)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda x, qt: x.astype(jnp.float32)
                      @ codecs.dequantize_matmul_weight(qt).astype(
                          jnp.float32))(x, qt)
    kern = jax.jit(partial(mm.matmul_quantized, out_dtype=jnp.float32))
    plain = jax.jit(partial(mm.matmul_quantized, kernel=False))
    err = _normalized_err(kern(x, qt), ref)
    plain_err = _normalized_err(plain(x, qt).astype(jnp.float32), ref)
    return {"fmt": fmt, "m": m, "k": k, "n": n, "err": err,
            "plain_err": plain_err, "tol": MATMUL_TOL,
            "ok": bool(err <= MATMUL_TOL)}


def _copies(fmt, k, n):
    """Copies of one weight in distinct buffers, enough to stream
    _STREAM_BYTES per pass (values do not change the time)."""
    one = _quantized(fmt, k, n)
    nbytes = sum(a.nbytes for a in jax.tree_util.tree_leaves(one))
    r = max(2, min(128, math.ceil(_STREAM_BYTES / nbytes)))
    return [jax.tree_util.tree_map(jnp.copy, one) for _ in range(r)]


def time_matmul(fmt: str, m: int, k: int, n: int, reps: int = 5) -> dict:
    """Microseconds per product: fused kernel vs XLA's plain dequant +
    GEMM, each applied back to back to distinct copies of the weight in
    one program (weights stream from device memory as in a layer stack;
    launch overhead stays in, as it does in a decode step)."""
    require_gpu()
    copies = _copies(fmt, k, n)
    x = _activations(m, k)

    def over_copies(kernel):
        def run(x, copies):
            return [mm.matmul_quantized(x, qt, kernel=kernel)
                    for qt in copies]
        return jax.jit(run)

    r = len(copies)
    out = {"fmt": fmt, "m": m, "k": k, "n": n,
           "t_kernel_us": 1e6 * time_fn(over_copies(True), x, copies,
                                        reps=reps) / r,
           "t_plain_us": 1e6 * time_fn(over_copies(False), x, copies,
                                       reps=reps) / r}
    out["speedup"] = out["t_plain_us"] / out["t_kernel_us"]
    return out


def check_attention(b: int = 2, s: int = 2048, nh: int = 32, nkv: int = 4,
                    hd: int = 64, time_it: bool = True) -> dict:
    """cuDNN route vs the plain attention: error against the f32
    ``highest`` reference (forward and gradient) and times of both in
    bf16 (forward, and forward + backward)."""
    require_gpu()
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    q = jax.random.normal(ks[0], (b, s, nh, hd), jnp.bfloat16)
    k = jax.random.normal(ks[1], (b, s, nkv, hd), jnp.bfloat16)
    v = jax.random.normal(ks[2], (b, s, nkv, hd), jnp.bfloat16)
    w = jax.random.normal(ks[3], (b, s, nh, hd), jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    valid = jnp.ones((b, s), bool)

    def plain(q, k, v):
        return llama._attention(q, k, v, pos, valid, None)

    def cudnn(q, k, v):
        return causal_attention(q, k, v, implementation="cudnn")

    def loss(f):
        return lambda q, k, v: jnp.sum(f(q, k, v).astype(jnp.float32) * w)

    f32 = [a.astype(jnp.float32) for a in (q, k, v)]
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(plain)(*f32)
        ref_g = jax.jit(jax.grad(loss(plain), argnums=(0, 1, 2)))(*f32)
    got = jax.jit(cudnn)(q, k, v)
    got_g = jax.jit(jax.grad(loss(cudnn), argnums=(0, 1, 2)))(q, k, v)
    err = _normalized_err(got.astype(jnp.float32), ref)
    grad_err = max(_normalized_err(g.astype(jnp.float32), r)
                   for g, r in zip(got_g, ref_g))
    out = {"b": b, "s": s, "err": err, "tol": ATTENTION_TOL,
           "grad_err": grad_err, "grad_tol": ATTENTION_GRAD_TOL,
           "ok": bool(err <= ATTENTION_TOL
                      and grad_err <= ATTENTION_GRAD_TOL)}
    if time_it:
        for name, f in (("cudnn", cudnn), ("plain", plain)):
            out[f"t_{name}_fwd_ms"] = 1e3 * time_fn(jax.jit(f), q, k, v)
            out[f"t_{name}_fwd_bwd_ms"] = 1e3 * time_fn(
                jax.jit(jax.grad(loss(f), argnums=(0, 1, 2))), q, k, v)
    return out


def int8_gemm_kind(m: int, k: int = 2048, n: int = 5632) -> dict:
    """Which kernel XLA compiles the LLM.int8 s8 x s8 -> s32 dot into,
    read from the optimized HLO, and whether it is exact."""
    require_gpu()
    ka, kb = jax.random.split(jax.random.PRNGKey(0))
    a = jax.random.randint(ka, (m, k), -127, 128, jnp.int32).astype(jnp.int8)
    b = jax.random.randint(kb, (k, n), -127, 128, jnp.int32).astype(jnp.int8)
    f = jax.jit(lambda a, b: jnp.dot(a, b, preferred_element_type=jnp.int32))
    hlo = f.lower(a, b).compile().as_text()
    targets = sorted(set(re.findall(r'custom_call_target="([^"]+)"', hlo)))
    kinds = sorted(set(re.findall(r'"kind":"(__[a-z_]+)"', hlo)))
    exact = bool(np.array_equal(
        np.asarray(f(a, b)),
        np.asarray(a, np.int64) @ np.asarray(b, np.int64)))
    return {"m": m, "k": k, "n": n, "custom_calls": targets,
            "fusion_kinds": kinds, "exact": exact,
            "t_us": 1e6 * time_fn(f, a, b)}


def memory_qlora_7b(batch: int = 1, seq: int = 1024, n_layers=None) -> dict:
    """Compile (never run) a Llama-2-7B NF4 QLoRA step from shapes alone
    and return its memory plan beside the packed and dense weight sizes.
    Answers whether XLA hoists every layer's dense dequant at once."""
    from quanta_tpu import optim, train
    from quanta_tpu.nn.linear import init_quantized_params

    cfg = llama.LlamaConfig.llama2_7b()
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)

    def build(key):
        p = init_quantized_params(key, cfg, mode="nf4")
        return train.add_lora(p, jax.random.PRNGKey(1), rank=16)

    params = jax.eval_shape(build, jax.random.PRNGKey(0))
    tx = optim.adam8bit(1e-4)
    adapters = jax.eval_shape(train.extract_adapters, params)
    opt_state = jax.eval_shape(tx.init, adapters)
    tok = jax.ShapeDtypeStruct((batch, seq), jnp.int32)
    step = jax.jit(train.make_qlora_train_step(cfg, tx))
    compiled = step.lower(adapters, opt_state, params,
                          {"inputs": tok, "targets": tok}).compile()
    ma = compiled.memory_analysis()
    packed = sum(math.prod(a.shape) * a.dtype.itemsize
                 for a in jax.tree_util.tree_leaves(params))
    dense_layer = 2 * (4 * cfg.dim * cfg.dim + 3 * cfg.dim * cfg.hidden_dim)
    return {"layers": cfg.n_layers, "batch": batch, "seq": seq,
            "temp_gib": ma.temp_size_in_bytes / 2**30,
            "argument_gib": ma.argument_size_in_bytes / 2**30,
            "params_gib": packed / 2**30,
            "dense_bf16_layers_gib": cfg.n_layers * dense_layer / 2**30}


def decode_ab(fmt: str, n_layers=None, batch: int = 8) -> dict:
    """End-to-end decode of TinyLlama-1.1B (all 22 layers unless cut),
    weights drawn directly in ``fmt``: the dispatch policy (kernel at
    decode) against every quantized linear on the plain path, measured
    policy, plain, policy, plain."""
    from quanta_tpu.nn.linear import init_quantized_params

    cfg = llama.LlamaConfig.tinyllama_1b()
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = init_quantized_params(jax.random.PRNGKey(0), cfg, mode=fmt)
    prompt = jnp.zeros((batch, 128), jnp.int32)
    # use_kernel=None is the dispatch policy (kernel at decode, plain at
    # the 128-token prefill); False keeps every quantized linear plain
    runs = {name: jax.jit(partial(llama.greedy_decode, cfg=cfg,
                                  max_new_tokens=64, use_kernel=uk))
            for name, uk in (("policy", None), ("plain", False))}
    times = {"policy": [], "plain": []}
    for _ in range(2):
        for name, fn in runs.items():
            times[name].append(time_fn(fn, params, prompt, reps=3))
    tok = batch * 64
    return {"fmt": fmt, "layers": cfg.n_layers, "batch": batch,
            "prompt": 128, "new_tokens": 64,
            "policy_tok_s": [tok / t for t in times["policy"]],
            "plain_tok_s": [tok / t for t in times["plain"]],
            "speedup": min(times["plain"]) / min(times["policy"])}


# ------------------------------------------------------ card-only checks
#
# Small, fast checks that need the card. tests/test_gpu.py runs each as a
# `gpu`-marked test; chip_smoke.py runs them all as its last phase.


def _check_fused_matmul_unaligned():
    for fmt in KERNEL_FORMATS:
        for m in (3, 100):  # one padded M tile; two M tiles
            r = check_matmul(fmt, m, 320, 200)
            assert r["ok"], r


def _check_fused_matmul_grad():
    from quanta_tpu.nn.linear import linear

    qt = _quantized("nf4", 2048, 512)
    x = _activations(8, 2048)
    w = jax.random.normal(jax.random.PRNGKey(2), (8, 512), jnp.float32)

    def loss(x, use_kernel):
        y = linear(x, qt, use_kernel=use_kernel).astype(jnp.float32)
        return jnp.sum(y * w)

    got = jax.jit(jax.grad(partial(loss, use_kernel=True)))(x)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(jax.grad(lambda x: jnp.sum(
            (x @ codecs.dequantize_matmul_weight(qt).astype(jnp.float32))
            * w)))(x.astype(jnp.float32))
    err = _normalized_err(got.astype(jnp.float32), ref)
    assert err <= MATMUL_TOL, err


def _check_cudnn_attention():
    r = check_attention(b=1, s=1024, nh=8, nkv=2, hd=64, time_it=False)
    assert r["ok"], r


def _check_cudnn_prefill():
    """greedy_decode's prefill into an empty, longer cache takes cuDNN
    (read from the compiled program) and matches the plain attention."""
    from quanta_tpu import ops

    cfg = dataclasses.replace(llama.LlamaConfig.tinyllama_1b(), n_layers=1)
    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    s = ops.CUDNN_ATTENTION_MIN_S
    toks = jax.random.randint(jax.random.PRNGKey(1), (1, s), 0,
                              cfg.vocab_size)

    def prefill(p, t, empty):
        cache = llama.init_cache(cfg, 1, max_len=s + 8)
        return llama.forward(p, t, cfg, cache=cache, cache_empty=empty)[0]

    route, plain = (jax.jit(partial(prefill, empty=e)) for e in (True, False))
    hlo = route.lower(params, toks).compile().as_text()
    assert "__cudnn$fmha" in hlo, sorted(
        set(re.findall(r'custom_call_target="([^"]+)"', hlo)))
    err = _normalized_err(route(params, toks), plain(params, toks))
    assert err <= ATTENTION_TOL, err


def _check_int8_gemm_exact():
    for m in (8, 512):
        r = int8_gemm_kind(m, k=512, n=256)
        assert r["exact"], r


def _check_dispatch_policy():
    from quanta_tpu import ops

    nf4 = _quantized("nf4", 256, 128)
    assert ops.use_fused_matmul(8, nf4)
    assert not ops.use_fused_matmul(ops.FUSED_MAX_M + 1, nf4)
    assert not ops.use_fused_matmul(8, _quantized("fp8", 256, 128))
    assert ops.attention_impl(2048, jnp.bfloat16, True) == "cudnn"
    assert ops.attention_impl(2048, jnp.bfloat16, False) is None
    assert ops.attention_impl(2048, jnp.float32, True) is None


CARD_CHECKS = (
    ("fused_matmul_unaligned", _check_fused_matmul_unaligned),
    ("fused_matmul_grad", _check_fused_matmul_grad),
    ("cudnn_attention", _check_cudnn_attention),
    ("cudnn_prefill", _check_cudnn_prefill),
    ("int8_gemm_exact", _check_int8_gemm_exact),
    ("dispatch_policy", _check_dispatch_policy),
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, nargs="+", default=[8, 512])
    ap.add_argument("--formats", nargs="+", default=list(KERNEL_FORMATS))
    args = ap.parse_args(argv)
    require_gpu()
    for m in args.m:
        for fmt in args.formats:
            for k, n in TINYLLAMA_SHAPES:
                print(json.dumps(check_matmul(fmt, m, k, n)), flush=True)
                print(json.dumps(time_matmul(fmt, m, k, n)), flush=True)
    print(json.dumps(check_attention()), flush=True)
    for m in (8, 512):
        print(json.dumps(int8_gemm_kind(m)), flush=True)
    print(json.dumps(memory_qlora_7b()), flush=True)


if __name__ == "__main__":
    main()
