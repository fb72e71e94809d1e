"""North-star model-scale benchmark: Llama-2-7B/13B on one device.

BASELINE.json configs 3-5 name Llama-2-7B/13B; this bench measures them
at full geometry on a single device. The weights are initialized
DIRECTLY in quantized form (nn.init_quantized_params: random codes +
plausible scales, never materializing the 13.5/25 GiB dense tree).
Throughput depends on shapes and formats, not weight values, so random
codes measure the real serving rate.

Measures raw decode (scan-slope, batch 8), prefill, and a 32-request
continuous-batching Engine trace. Prints one JSON line; ``--out`` also
writes a markdown table.

Usage: python -m quanta_tpu.benchmarks.model_scale_bench
           [--model 7b 13b] [--fmt nf4a] [--out FILE]
"""

import argparse
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_model(name, cfg, fmt, *, serve: bool = True):
    from quanta_tpu.benchmarks.decode_bench import bench_decode, bench_prefill
    from quanta_tpu.nn.linear import init_quantized_params
    from quanta_tpu.serve import Engine, Request

    t0 = time.time()
    params = init_quantized_params(jax.random.PRNGKey(0), cfg, mode=fmt,
                                   block_size=64)
    jax.block_until_ready(params)
    gib = sum(a.nbytes for a in jax.tree_util.tree_leaves(params)) / 2**30
    log(f"{name} {fmt}: {gib:.2f} GiB on chip (init {time.time()-t0:.0f}s)")

    row = {"model": name, "fmt": fmt, "weights_gib": round(gib, 2)}
    t = bench_decode(params, cfg, batch=8, prefill_len=128, cache_len=512,
                     L0=4, L1=20)
    row["decode_tok_s_chip"] = round(8 / t, 1)
    tp = bench_prefill(params, cfg, batch=8, prefill_len=128, L0=2, L1=6)
    row["prefill_tok_s_chip"] = round(8 * 128 / tp, 1)
    log(f"{name} {fmt}: decode {row['decode_tok_s_chip']} tok/s/chip | "
        f"prefill {row['prefill_tok_s_chip']} tok/s/chip")

    if serve:
        eng = Engine(params, cfg, n_slots=8, page_size=16,
                     prefill_buckets=(64, 256), multi_step=8)
        eng.warm_widths((250 + 48 + 8) // 16 + 1, max_prompt_len=250)
        rng = np.random.default_rng(0)
        for uid in range(4):  # compile the serving programs first
            eng.submit(Request(uid=-1 - uid,
                               prompt=rng.integers(0, cfg.vocab_size,
                                                   100).astype(np.int32),
                               max_new_tokens=8))
        while eng._draining:
            eng.step()
        eng.finished.clear()
        eng._steps = eng._decode_tokens = 0
        eng._t_serve = eng._t_first_dispatch = eng._t_last_process = 0.0
        reqs = [
            Request(uid=i,
                    prompt=rng.integers(
                        0, cfg.vocab_size, int(rng.integers(16, 251))
                    ).astype(np.int32),
                    max_new_tokens=48)
            for i in range(32)
        ]
        t0 = time.perf_counter()
        done = eng.run(reqs)
        dt = time.perf_counter() - t0
        tok = sum(len(r.output) for r in done)
        row["serve_tok_s_chip"] = round(tok / dt, 1)
        log(f"{name} {fmt}: serve {row['serve_tok_s_chip']} tok/s/chip "
            f"({tok} tok, {dt:.1f}s, {eng._steps} windows)")
    del params
    return row


def main():
    from quanta_tpu.models import llama

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", nargs="+", default=["7b", "13b"])
    ap.add_argument("--fmt", default="nf4a")
    ap.add_argument("--no-serve", action="store_true")
    ap.add_argument("--out", help="also write a markdown table here")
    args = ap.parse_args()
    log("devices:", jax.devices())

    geoms = {
        "llama2-7b": llama.LlamaConfig.llama2_7b(),
        "llama2-13b": llama.LlamaConfig.llama2_13b(),
    }
    rows = []
    for m in args.model:
        key = f"llama2-{m}"
        base = geoms[key]
        cfg = llama.LlamaConfig(
            vocab_size=base.vocab_size, dim=base.dim,
            n_layers=base.n_layers, n_heads=base.n_heads,
            n_kv_heads=base.n_kv_heads, hidden_dim=base.hidden_dim,
            max_seq_len=512,  # KV budget: 8 slots x 512 ctx
        )
        rows.append(run_model(key, cfg, args.fmt, serve=not args.no_serve))

    if args.out:
        lines = [
            "# Model-scale benchmark — Llama-2 on one device",
            "",
            f"Device: `{jax.devices()[0].device_kind}` · {args.fmt} weights "
            "(random codes via nn.init_quantized_params) · batch 8 · "
            "ctx 512 · serve: 32 requests, prompts 16-250, 48 new tokens, "
            "multi_step=8.",
            "",
            "| model | weights | decode tok/s/chip | prefill tok/s/chip"
            " | engine serve tok/s/chip |",
            "|---|---|---|---|---|",
        ]
        for r in rows:
            lines.append(
                f"| {r['model']} ({r['fmt']}) | {r['weights_gib']} GiB | "
                f"{r['decode_tok_s_chip']} | {r['prefill_tok_s_chip']} | "
                f"{r.get('serve_tok_s_chip', '-')} |"
            )
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
        log("wrote " + args.out)
    import json

    print(json.dumps({"model_scale": rows}))


if __name__ == "__main__":
    main()
