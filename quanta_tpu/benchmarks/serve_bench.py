"""Serving-engine benchmark: continuous batching under a Poisson trace.

Measures the *Engine* (quanta_tpu.serve) end to end on the device —
not the raw lax.scan decode loop of decode_bench — so admission, paged-KV
gathers, per-step sampling readback and scheduler overhead are all in the
measurement. This is north-star config 3's protocol (BASELINE.md:
"tokens/sec/chip, p50 TTFT" of *serving*, LLM.int8 + continuous
batching), applied to every serving format.

Trace: seeded Poisson arrivals at ``--rate`` req/s, prompt lengths
uniform in [16, bucket_max], ``--max-new`` output tokens each. The
engine is stepped in a tight loop; requests are submitted when their
arrival time passes (open-loop load, like a real frontend).

Usage:
  python -m quanta_tpu.benchmarks.serve_bench [--fmt nf4a llm_int8 bf16]
      [--requests 24] [--rate 16] [--out table.md]

``run_one`` is importable — decode_bench calls it to fold serving
metrics into the headline BENCH json.
"""

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_trace(n_requests: int, rate: float, max_prompt: int, max_new: int,
               vocab: int, seed: int = 0):
    """Poisson arrival times + random prompts (deterministic by seed)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    arrivals = np.cumsum(gaps)
    trace = []
    for i in range(n_requests):
        plen = int(rng.integers(16, max_prompt + 1))
        prompt = rng.integers(0, vocab, size=plen).astype(np.int32)
        trace.append((float(arrivals[i]), prompt))
    return trace


def run_one(params, cfg, *, fmt_name: str, n_requests: int = 24,
            rate: float = 16.0, max_new: int = 64, n_slots: int = 8,
            kv_quant: bool = False, multi_step: int = 1,
            pipeline_depth: int = 2, seed: int = 0):
    """Serve one Poisson trace; returns the engine metrics dict."""
    from quanta_tpu.serve import Engine, Request

    eng = Engine(
        params, cfg,
        n_slots=n_slots,
        page_size=16,
        prefill_buckets=(64, 256),
        kv_quant=kv_quant,
        multi_step=multi_step,
        pipeline_depth=pipeline_depth,
    )
    pool_bytes = sum(
        int(np.prod(a.shape)) * a.dtype.itemsize
        for a in jax.tree_util.tree_leaves(eng.pool)
    )
    trace = make_trace(n_requests, rate, max_prompt=250, max_new=max_new,
                       vocab=cfg.vocab_size, seed=seed)

    # warm the compiled programs (prefill buckets + every decode width the
    # trace can reach) so the measured trace is steady-state serving, not
    # compilation
    max_need = (250 + max_new + eng.multi_step) // eng.page_size + 1
    eng.warm_widths(max_need, max_prompt_len=250)

    t0 = time.perf_counter()
    next_uid = 0
    while next_uid < len(trace) or eng._draining:
        now = time.perf_counter() - t0
        while next_uid < len(trace) and trace[next_uid][0] <= now:
            arr, prompt = trace[next_uid]
            eng.submit(Request(uid=next_uid, prompt=prompt,
                               max_new_tokens=max_new))
            next_uid += 1
        eng.step()
        if eng.idle and next_uid < len(trace):
            # truly idle (nothing seated or in flight) before the next
            # arrival: sleep to its arrival time
            time.sleep(max(0.0, trace[next_uid][0] - (time.perf_counter() - t0)))
    eng._t_serve = time.perf_counter() - t0

    m = eng.metrics()
    m["fmt"] = fmt_name
    m["multi_step"] = multi_step
    m["kv_pool_mib"] = round(pool_bytes / 2**20, 1)
    m["n_requests"] = n_requests
    m["offered_rate_req_s"] = rate
    log(f"{fmt_name:9s} serve: {m['throughput_tok_s']:8.1f} tok/s/chip | "
        f"ttft p50 {m.get('ttft_p50_ms', 0):7.1f} ms | "
        f"p99 {m.get('ttft_p99_ms', 0):7.1f} ms | "
        f"steps {m['decode_steps']} | preempt {m['preemptions']}")
    return m


def main():
    from quanta_tpu import nn as qnn
    from quanta_tpu.models import llama

    ap = argparse.ArgumentParser()
    ap.add_argument("--fmt", nargs="+",
                    default=["nf4a", "llm_int8", "bf16"])
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--rate", type=float, default=16.0)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--kv-quant", action="store_true",
                    help="add an int8-KV-cache row for the first format")
    ap.add_argument("--multi-step", type=int, default=1,
                    help="decode steps per device program (amortizes "
                         "host-link latency)")
    ap.add_argument("--light-rate", type=float, default=0.0,
                    help="add a sub-saturation row for the first format "
                         "at this offered rate (TTFT measures the engine, "
                         "not the queue)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model (CPU smoke run)")
    ap.add_argument("--out", help="also write a markdown table here")
    args = ap.parse_args()

    log("devices:", jax.devices())
    cfg = (llama.LlamaConfig.tiny(max_seq_len=512)
           if args.tiny else llama.LlamaConfig.tinyllama_1b())
    dense = llama.init_params(jax.random.PRNGKey(0), cfg)
    jax.block_until_ready(dense)

    rows = []
    warmed = False
    for fmt in args.fmt:
        if fmt == "bf16":
            params = dense
        else:
            params = qnn.quantize_params(dense, mode=fmt, block_size=64)
        jax.block_until_ready(params)
        if not warmed:
            # compile the engine's programs on a short throwaway trace
            run_one(params, cfg, fmt_name=f"{fmt}(warm)", n_requests=4,
                    rate=args.rate, max_new=16, n_slots=args.slots,
                    multi_step=args.multi_step)
            warmed = True
        rows.append(run_one(
            params, cfg, fmt_name=fmt, n_requests=args.requests,
            rate=args.rate, max_new=args.max_new, n_slots=args.slots,
            multi_step=args.multi_step,
        ))
        if args.kv_quant and fmt == args.fmt[0]:
            rows.append(run_one(
                params, cfg, fmt_name=f"{fmt}+kv8", n_requests=args.requests,
                rate=args.rate, max_new=args.max_new, n_slots=args.slots,
                kv_quant=True, multi_step=args.multi_step,
            ))
        if args.light_rate > 0 and fmt == args.fmt[0]:
            # sub-saturation: TTFT here is the ENGINE's latency (prefill +
            # first window + readback), not queueing delay
            rows.append(run_one(
                params, cfg, fmt_name=f"{fmt}@light",
                n_requests=max(8, args.requests // 4),
                rate=args.light_rate, max_new=args.max_new,
                n_slots=args.slots,
                multi_step=args.multi_step,
            ))

    lines = [
        "# Serving benchmark — continuous-batching Engine under Poisson load",
        "",
        f"Device: `{jax.devices()[0]}` · TinyLlama-1.1B geometry · "
        f"{args.requests} requests @ {args.rate} req/s · "
        f"{args.max_new} new tokens each · {args.slots} slots · "
        "prompts 16-250 tokens",
        "",
        "Measured through `serve.Engine` end to end (admission, paged-KV"
        " bucketed gathers, per-step sampling readback included).",
        "",
        "| format | tok/s/chip | TTFT p50 (ms) | TTFT p99 (ms) | decode "
        "steps | preemptions | KV pool (MiB) |",
        "|---|---|---|---|---|---|---|",
    ]
    for m in rows:
        lines.append(
            f"| {m['fmt']} | {m['throughput_tok_s']} | "
            f"{m.get('ttft_p50_ms', '-')} | {m.get('ttft_p99_ms', '-')} | "
            f"{m['decode_steps']} | {m['preemptions']} | "
            f"{m['kv_pool_mib']} |"
        )
    lines.append("")
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines))
        log("wrote " + args.out)
    print(json.dumps({"serve": rows}))


if __name__ == "__main__":
    main()
