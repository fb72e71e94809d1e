"""Headline benchmark: TinyLlama-1.1B decode, prefill and serving.

Measures north-star config 2 (BASELINE.md): TinyLlama-1.1B-geometry decoder
with 4-bit blockwise weights decoding through the dispatch policy's path
(the fused dequant-matmul kernel at decode on the GPU) — against bf16
dense decode of the *same* model on the *same* device. The reference
publishes no numbers (BASELINE.md: "published": {}), so vs_baseline is the
quantized/bf16 decode-throughput ratio.

Headline format is **nf4a** — this framework's arithmetic NormalFloat-4
codebook (cubic-polynomial levels, ~12% lower quantization MSE than QLoRA
NF4 on per-block-normalized gaussian weights, and dequantizable in 3 fused
multiply-adds per element instead of a 15-select table walk; see
quanta_tpu/core/codebooks.py). Exact-NF4 and bf16 numbers are printed
alongside on stderr.

Timing: each measurement runs its step loop inside one jit (lax.scan,
serialized through the KV cache carry), waits for the result, and takes
the slope between two loop lengths, which cancels the fixed prefill and
dispatch cost.

Prints ONE JSON line:
  {"metric": "tinyllama_nf4a_decode_tokens_per_sec_per_chip",
   "value": <tok/s>, "unit": "tokens/s/chip", "vs_baseline": <nf4a/bf16>,
   "nf4a_vs_bf16": ..., "nf4_vs_bf16": ...,
   "extra": {decode/prefill/ttft for bf16, nf4, nf4a, int4c;
             long-prefill tok/s at S=2048;
             "serve": engine tok/s + TTFT p50/p99 for nf4a, llm_int8 and
             int4c (continuous batching under a Poisson trace): 16-req and
             64-req rows at 8 slots/k=8, plus a 16-slot/k=16 row}}
"""

import json
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _timed(fn, params, reps=3):
    """Best wall time of jitted fn(params, seed) including host readback.

    params is an explicit argument (NOT a closure capture): closing over
    the tree would bake ~GBs of weights into the lowered HLO as
    constants."""
    np.asarray(fn(params, jnp.int32(0)))  # compile + warm
    best = 1e9
    for r in range(reps):
        t0 = time.perf_counter()
        np.asarray(fn(params, jnp.int32(r + 1)))
        best = min(best, time.perf_counter() - t0)
    return best


def bench_decode(params, cfg, batch=8, prefill_len=128, cache_len=512,
                 L0=8, L1=72):
    """Per-token decode step time via scan-length slope. Returns seconds."""
    from quanta_tpu.models import llama

    def make_loop(L):
        @jax.jit
        def loop(params, seed):
            cache = llama.init_cache(cfg, batch, max_len=cache_len)
            toks = jnp.zeros((batch, prefill_len), jnp.int32) + (seed & 1)
            logits, cache = llama.forward(params, toks, cfg, cache=cache)
            tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)

            def body(carry, _):
                cache, tok = carry
                lg, cache = llama.forward(params, tok, cfg, cache=cache)
                nxt = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
                return (cache, nxt), None

            (cache, tok), _ = jax.lax.scan(body, (cache, tok), None, length=L)
            return tok.sum()

        return loop

    t0 = _timed(make_loop(L0), params)
    t1 = _timed(make_loop(L1), params)
    return max((t1 - t0) / (L1 - L0), 1e-9)


def bench_prefill(params, cfg, batch=8, prefill_len=128, L0=2, L1=14):
    """Per-prefill time (batch x prefill_len tokens -> first-token logits)."""
    from quanta_tpu.models import llama

    def make_loop(L):
        @jax.jit
        def loop(params, seed):
            base = jnp.zeros((batch, prefill_len), jnp.int32)

            def body(acc, _):
                toks = base + (acc & 1)
                cache = llama.init_cache(cfg, batch, max_len=prefill_len + 8)
                logits, _ = llama.forward(params, toks, cfg, cache=cache)
                tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
                return tok.sum() & 1, None

            acc, _ = jax.lax.scan(body, seed & 1, None, length=L)
            return acc

        return loop

    t0 = _timed(make_loop(L0), params)
    t1 = _timed(make_loop(L1), params)
    return max((t1 - t0) / (L1 - L0), 1e-9)


def main():
    from quanta_tpu import nn as qnn
    from quanta_tpu.models import llama

    log("devices:", jax.devices())
    cfg = llama.LlamaConfig.tinyllama_1b()
    batch, prefill_len = 8, 128

    dense = llama.init_params(jax.random.PRNGKey(0), cfg)
    jax.block_until_ready(dense)

    results = {}
    for name, params in [
        ("bf16", dense),
        ("nf4a", qnn.quantize_params(dense, mode="nf4a", block_size=64)),
        ("nf4", qnn.quantize_params(dense, mode="nf4", block_size=64)),
        ("int4c", qnn.quantize_params(dense, mode="int4c", block_size=64)),
    ]:
        jax.block_until_ready(params)
        t_step = bench_decode(params, cfg, batch=batch,
                              prefill_len=prefill_len)
        t_prefill = bench_prefill(params, cfg, batch=batch,
                                  prefill_len=prefill_len)
        r = {
            "decode_tok_s_chip": round(batch / t_step, 1),
            "prefill_tok_s_chip": round(batch * prefill_len / t_prefill, 1),
            "ttft_ms": round((t_prefill + t_step) * 1e3, 2),
        }
        results[name] = r
        log(f"{name:5s} decode {r['decode_tok_s_chip']:8.1f} tok/s/chip | "
            f"prefill {r['prefill_tok_s_chip']:9.1f} tok/s/chip | "
            f"ttft {r['ttft_ms']:6.2f} ms (batch={batch}, len={prefill_len})")

    # long-context prefill at S=2048: attention takes the policy's route
    # (cuDNN's fused attention on the GPU)
    def long_prefill(S=2048, B=2, L=3, reps=3):
        @jax.jit
        def loop(params, seed):
            toks = jnp.zeros((B, S), jnp.int32)

            def body(acc, _):
                lg, _ = llama.forward(
                    params, toks + (acc.astype(jnp.int32) % 2), cfg)
                return (lg[:, -1, :].sum() * 1e-30).astype(jnp.float32), None

            acc, _ = jax.lax.scan(body, seed, None, length=L)
            return acc

        np.asarray(loop(dense, jnp.float32(0)))
        best = 1e9
        for r in range(reps):
            t0 = time.perf_counter()
            np.asarray(loop(dense, jnp.float32(r + 1)))
            best = min(best, time.perf_counter() - t0)
        return best / L

    t_long = long_prefill()
    results["long_prefill_s2048"] = {"tok_s_chip": round(2 * 2048 / t_long, 1)}
    log(f"long prefill S=2048: {2 * 2048 / t_long:8.1f} tok/s")

    # serving-engine measurement (north-star config 3 protocol): the
    # continuous-batching Engine under a Poisson trace, end to end —
    # not just the raw scan loop. Engine TTFT/throughput land in extra.
    from quanta_tpu.benchmarks.serve_bench import run_one

    serve = {}
    for idx, fmt in enumerate(("nf4a", "llm_int8", "int4c")):
        sparams = qnn.quantize_params(dense, mode=fmt, block_size=64)
        jax.block_until_ready(sparams)
        if idx == 0:
            # compile the engine's programs on a short throwaway trace
            run_one(sparams, cfg, fmt_name=f"{fmt}(warm)",
                    n_requests=4, rate=24.0, max_new=16, n_slots=8,
                    multi_step=8)
        for key, kw in (
            (fmt, dict(n_requests=16, rate=24.0, max_new=48, n_slots=8,
                       multi_step=8)),
            # sustained: 64 requests saturate the engine so ramp-up /
            # drain at 8 slots stops dominating
            (f"{fmt}_sustained", dict(n_requests=64, rate=40.0, max_new=48,
                                      n_slots=8, multi_step=8)),
            # 16 slots, k=16 windows, saturated arrival stream
            (f"{fmt}_tuned", dict(n_requests=192, rate=100.0, max_new=64,
                                  n_slots=16, multi_step=16)),
        ):
            m = run_one(sparams, cfg, fmt_name=key, **kw)
            serve[key] = {
                "tok_s_chip": m["throughput_tok_s"],
                "ttft_p50_ms": m.get("ttft_p50_ms"),
                "ttft_p99_ms": m.get("ttft_p99_ms"),
            }
    results["serve"] = serve

    # metric name pinned since r2; both quantized/bf16 ratios at top level
    vs = results["nf4a"]["decode_tok_s_chip"] / results["bf16"]["decode_tok_s_chip"]
    vs_nf4 = results["nf4"]["decode_tok_s_chip"] / results["bf16"]["decode_tok_s_chip"]
    vs_int4c = results["int4c"]["decode_tok_s_chip"] / results["bf16"]["decode_tok_s_chip"]
    print(
        json.dumps(
            {
                "metric": "tinyllama_nf4a_decode_tokens_per_sec_per_chip",
                "value": results["nf4a"]["decode_tok_s_chip"],
                "unit": "tokens/s/chip",
                "vs_baseline": round(vs, 3),
                "nf4a_vs_bf16": round(vs, 3),
                "nf4_vs_bf16": round(vs_nf4, 3),
                "int4c_vs_bf16": round(vs_int4c, 3),
                "extra": results,
            }
        )
    )


if __name__ == "__main__":
    main()
