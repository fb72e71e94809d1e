"""Accuracy benchmark: perplexity delta of every weight format vs bf16.

North-star gates (BASELINE.md): ppl delta vs bf16 <= 0.1 at 8-bit and
<= 0.5 at 4-bit on WikiText-2. No network egress here, so the protocol is:
pretrain a small byte-level Llama on a deterministic local text corpus
(benchmarks/corpus.py), quantize its weights into every serving format,
and measure held-out perplexity with quanta_tpu.eval — the same harness a
user would point at WikiText-2 + real TinyLlama weights (see
quanta_tpu.models.hf for the checkpoint importer).

Writes docs/ACCURACY.md and prints the table. Run on the GPU (or CPU
with --steps small). The pretrained subject model is cached on disk keyed by
its hyperparameters + corpus hash, so re-runs skip straight to the
quantize+eval phase.

Usage: python -m quanta_tpu.benchmarks.accuracy_bench [--steps 1500]
"""

import argparse
import hashlib
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from quanta_tpu import eval as qeval
from quanta_tpu import nn as qnn
from quanta_tpu import optim as qoptim
from quanta_tpu import train as qtrain
from quanta_tpu.benchmarks import corpus as corpus_mod
from quanta_tpu.models import llama
from quanta_tpu.utils import serialization


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_batches(ids: np.ndarray, batch: int, seq_len: int, steps: int, seed=0):
    rng = np.random.default_rng(seed)
    n = len(ids) - seq_len - 1
    for _ in range(steps):
        starts = rng.integers(0, n, size=batch)
        windows = np.stack([ids[s : s + seq_len + 1] for s in starts])
        yield {
            "inputs": jnp.asarray(windows[:, :-1]),
            "targets": jnp.asarray(windows[:, 1:]),
        }


def main():
    ap = argparse.ArgumentParser()
    # r5 default scale (VERDICT r4 #5): dim 512 / 8 layers / GQA 4:1 /
    # 3000 steps — one notch up from the r3/r4 proxy (dim 256, 4 layers)
    # so outlier structure has somewhere to develop
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--eval-bytes", type=int, default=200_000)
    ap.add_argument("--out", default=os.path.join(os.getcwd(), "docs",
                                                  "ACCURACY.md"))
    ap.add_argument("--cache-dir", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".bench_cache"))
    ap.add_argument("--no-cache", action="store_true")
    args = ap.parse_args()

    log("devices:", jax.devices())
    tok = qeval.ByteTokenizer()
    corpus = corpus_mod.build_corpus()
    train_text, eval_text = corpus_mod.train_eval_split(corpus)
    train_ids = tok.encode(train_text)
    eval_ids = tok.encode(eval_text)[: args.eval_bytes]
    log(f"corpus: {len(train_ids)} train / {len(eval_ids)} eval bytes")

    cfg = llama.LlamaConfig(
        vocab_size=256,
        dim=args.dim,
        n_layers=args.layers,
        n_heads=8,
        n_kv_heads=2,  # 4:1 GQA, the TinyLlama/Llama-3 geometry class
        hidden_dim=args.dim * 3,
        max_seq_len=args.seq,
        dtype=jnp.float32,
    )
    params = llama.init_params(jax.random.PRNGKey(0), cfg)

    corpus_tag = hashlib.sha256(train_ids.tobytes()).hexdigest()[:12]
    cache_key = (
        f"accbench_d{args.dim}_l{args.layers}_s{args.seq}_b{args.batch}"
        f"_t{args.steps}_{corpus_tag}.npz"
    )
    cache_path = os.path.join(args.cache_dir, cache_key)
    if not args.no_cache and os.path.exists(cache_path):
        log(f"loading cached pretrained checkpoint {cache_path}")
        params = serialization.load_checkpoint(cache_path)
        params = jax.tree_util.tree_map(jnp.asarray, params)
    else:
        # pretrain with the framework's own 8-bit blockwise Adam
        tx = qoptim.adam8bit(3e-4)
        opt_state = tx.init(params)
        step = jax.jit(qtrain.make_train_step(cfg, tx, use_kernel=False))

        t0 = time.time()
        loss = None
        for i, batch in enumerate(
            make_batches(train_ids, args.batch, args.seq, args.steps)
        ):
            params, opt_state, loss = step(params, opt_state, batch)
            if i % 200 == 0:
                log(f"step {i:5d} loss {float(loss):.3f} "
                    f"({time.time()-t0:.0f}s)")
        log(f"trained {args.steps} steps, final loss {float(loss):.3f}")
        if not args.no_cache:
            os.makedirs(args.cache_dir, exist_ok=True)
            serialization.save_checkpoint(params, cache_path)
            log(f"cached pretrained checkpoint -> {cache_path}")

    variants = {"bf16": params}
    for fmt in ("int8", "nf8", "llm_int8", "nf4a", "nf4", "int4", "fp4",
                "int4c"):
        variants[fmt] = qnn.quantize_params(
            params, mode=fmt, block_size=64, min_size=4096
        )
    # imported-QLoRA path: exact NF4 codes remapped to nf4a at load time
    # (utils.transcode_params) — double rounding, so its own gated row
    from quanta_tpu.utils import transcode_params
    variants["nf4->nf4a"] = transcode_params(variants["nf4"])

    # W8A8: int8 weights AND int8 fake-quant activations, per calibration
    # method — the reference's declared weights+activations capability
    # (functional/model.py:196-246) finally gets quality evidence
    # (VERDICT r4 missing #4). Stats come from held-in training text.
    from quanta_tpu import calib, ptq
    from quanta_tpu.state.config import ConfigTree, QuantConfig

    calib_batches = list(
        make_batches(train_ids, 8, args.seq, steps=8, seed=123)
    )
    fwd = lambda p, b: llama.forward(p, b["inputs"], cfg,
                                     use_kernel=False)[0]
    stats = calib.collect_stats(fwd, params, calib_batches)
    for method in ("minmax", "percentile", "entropy"):
        variants[f"w8a8-{method}"] = ptq.quantize_model(
            params,
            ConfigTree(QuantConfig(bits=8, scheme="symmetric",
                                   weights_only=False,
                                   calibration=method)),
            stats=stats,
        )

    # the dispatch policy's path: on the GPU, the fused kernel wherever
    # it takes the eval shape; on the CPU, the plain path
    table = qeval.ppl_table(
        variants, eval_ids, cfg, seq_len=args.seq, batch=args.batch,
    )

    gate = {"int8": 0.1, "nf8": 0.1, "llm_int8": 0.1,
            "nf4a": 0.5, "nf4": 0.5, "int4": 0.5, "fp4": 0.5,
            "int4c": 0.5, "nf4->nf4a": 0.5,
            "w8a8-minmax": 0.1, "w8a8-percentile": 0.1,
            "w8a8-entropy": 0.1}
    lines = [
        "# Accuracy: held-out perplexity per weight format",
        "",
        f"Byte-level Llama (dim={args.dim}, layers={args.layers}) pretrained "
        f"{args.steps} steps on a local doc corpus (benchmarks/corpus.py; no "
        "network egress for WikiText-2 — the harness in quanta_tpu.eval is "
        "corpus-agnostic and takes real checkpoints via quanta_tpu.models.hf).",
        "",
        "Gates from BASELINE.md: delta <= 0.1 (8-bit), <= 0.5 (4-bit).",
        "",
        f"Compute path: the dispatch policy's on "
        f"`{jax.devices()[0].device_kind}`.",
        "",
        "| format | ppl | delta vs bf16 | gate | pass |",
        "|---|---|---|---|---|",
    ]
    n_fail = 0
    for name, r in table.items():
        g = gate.get(name)
        ok = "" if g is None else ("yes" if r["delta"] <= g else "**NO**")
        n_fail += ok == "**NO**"
        lines.append(
            f"| {name} | {r['ppl']:.4f} | {r['delta']:+.4f} | "
            f"{g if g is not None else '-'} | {ok} |"
        )
        log(f"{name:9s} ppl {r['ppl']:8.4f}  delta {r['delta']:+.4f}")

    nf4a_d, nf4_d = table["nf4a"]["delta"], table["nf4"]["delta"]
    if nf4a_d <= nf4_d:
        verdict = ("**nf4a <= nf4: the arithmetic codebook's quality claim "
                   "(codebooks.py nf4a coefficients) holds at model level.**")
    elif nf4a_d <= nf4_d + 0.05:
        verdict = ("nf4a within noise of exact NF4 at model level (the "
                   "deterministic weight-space version of the claim is "
                   "asserted in tests/test_accuracy_gates.py: ~12% lower "
                   "reconstruction MSE on gaussian and real-checkpoint "
                   "weights).")
    else:
        verdict = "**REGRESSION: nf4a is clearly worse than exact NF4.**"
    lines += [
        "",
        "## Headline-codebook validation: nf4a vs exact NF4",
        "",
        f"nf4a ppl delta {nf4a_d:+.4f} vs nf4 {nf4_d:+.4f} -> " + verdict,
        "",
        f"Gate result: {len(gate) - n_fail}/{len(gate)} formats pass.",
        "",
        "CI-sized version of these gates: tests/test_accuracy_gates.py "
        "(same protocol, smaller model, runs on the CPU suite).",
        "",
    ]

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines))
    log("wrote " + args.out)
    if n_fail or nf4a_d > nf4_d + 0.05:
        log("GATE FAILURES present")
        sys.exit(1)


if __name__ == "__main__":
    main()
