"""Command-line interface: quantize / eval / generate / serve / finetune /
bench / convert.

Fulfils the reference's planned-but-absent CLI (/root/reference/TODO.md:40
"Command-line interface") plus the runnable-example role of
/root/reference/example/. Every subcommand is a thin orchestration over
the library layers — no logic lives here that isn't reachable from Python.

Usage:  python -m quanta_tpu <command> --help
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# --------------------------------------------------------------- model io


TOY_PRESETS = {
    # vocab, dim, layers, heads, kv_heads, hidden, max_seq
    "tiny": (512, 256, 2, 8, 4, 512, 256),
    "small": (2048, 512, 4, 8, 8, 1024, 512),
    "tinyllama": (32000, 2048, 22, 32, 4, 5632, 2048),
}


def _cfg_to_json(cfg, arch: str) -> dict:
    import jax.numpy as jnp

    d = dataclasses.asdict(cfg)
    d["dtype"] = str(jnp.dtype(d["dtype"]))
    d["__arch__"] = arch
    return d


def _cfg_from_json(d: dict):
    import jax.numpy as jnp

    d = dict(d)
    arch = d.pop("__arch__", "llama")
    d["dtype"] = jnp.dtype(d["dtype"]).type
    if arch == "llama":
        from quanta_tpu.models.llama import LlamaConfig

        return LlamaConfig(**d), arch
    from quanta_tpu.models.gpt2 import GPT2Config

    return GPT2Config(**d), arch


def load_model(args):
    """Resolve --model/--toy/--ckpt into (params, cfg, arch, model_dir)."""
    import jax
    import jax.numpy as jnp

    dtype = jnp.dtype(args.dtype).type if getattr(args, "dtype", None) else None
    if getattr(args, "ckpt", None):
        from quanta_tpu.utils import serialization

        with open(args.ckpt + ".config.json") as f:
            cfg, arch = _cfg_from_json(json.load(f))
        params = serialization.load_checkpoint(args.ckpt)
        return params, cfg, arch, getattr(args, "model", None)
    if getattr(args, "model", None):
        from quanta_tpu.models import hf

        with open(os.path.join(args.model, "config.json")) as f:
            mt = json.load(f).get("model_type", "llama")
        if mt == "gpt2":
            params, cfg = hf.load_gpt2(args.model, dtype=dtype or jnp.float32)
            return params, cfg, "gpt2", args.model
        params, cfg = hf.load_llama(args.model, dtype=dtype or jnp.bfloat16)
        return params, cfg, "llama", args.model
    # toy preset (random init) — for demos and CPU smoke runs
    from quanta_tpu.models import llama

    v, d, l, h, kv, hid, s = TOY_PRESETS[args.toy]
    l = getattr(args, "layers", None) or l
    cfg = llama.LlamaConfig(
        vocab_size=v, dim=d, n_layers=l, n_heads=h, n_kv_heads=kv,
        hidden_dim=hid, max_seq_len=s, dtype=dtype or jnp.bfloat16,
    )
    params = llama.init_params(jax.random.PRNGKey(args.seed), cfg)
    return params, cfg, "llama", None


def _forward_for(arch: str):
    if arch == "gpt2":
        from quanta_tpu.models import gpt2

        return gpt2.forward
    from quanta_tpu.models import llama

    return llama.forward


def _add_model_args(p, ckpt=True):
    p.add_argument("--model", help="HF checkpoint dir (safetensors)")
    if ckpt:
        p.add_argument("--ckpt", help="quanta_tpu .npz checkpoint (from `quantize`)")
    p.add_argument("--toy", choices=sorted(TOY_PRESETS), default="tiny",
                   help="random-init preset when no --model/--ckpt")
    p.add_argument("--layers", type=int, default=None,
                   help="layer count of the --toy preset (cut depth; "
                        "widths stay the preset's)")
    p.add_argument("--dtype", default=None, help="compute dtype (bfloat16/float32)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")


def _maybe_cpu(args):
    if getattr(args, "cpu", False):
        import jax

        jax.config.update("jax_platforms", "cpu")


def _tokens_from_text(path: str, model_dir):
    import numpy as np

    from quanta_tpu import eval as qeval

    tok = qeval.load_tokenizer(model_dir)
    with open(path, "rb") as f:
        text = f.read().decode("utf-8", errors="replace")
    return np.asarray(tok.encode(text), np.int32), tok


# -------------------------------------------------------------- commands


def _norm_npz(path: str) -> str:
    """np.savez appends '.npz' to extensionless paths; normalize up front so
    the name we report (and later open) is the name actually written."""
    return path if path.endswith(".npz") else path + ".npz"


def cmd_quantize(args):
    _maybe_cpu(args)
    import jax

    from quanta_tpu import ptq
    from quanta_tpu.state.config import ConfigTree, QuantConfig
    from quanta_tpu.utils import serialization

    args.out = _norm_npz(args.out)

    params, cfg, arch, model_dir = load_model(args)
    n_bytes_in = sum(x.nbytes for x in jax.tree_util.tree_leaves(params))

    if args.config:
        with open(args.config) as f:
            tree = ConfigTree.from_json(f.read())
    elif args.fmt != "bf16":
        tree = ConfigTree(default=QuantConfig.from_mode(args.fmt,
                                                        block_size=args.block_size))
    calib_kw = {}
    if args.calib_text:
        import numpy as np

        toks, _ = _tokens_from_text(args.calib_text, model_dir)
        seq = min(256, cfg.max_seq_len)
        n = min(args.calib_batches, max(1, len(toks) // seq))
        batches = [toks[i * seq:(i + 1) * seq][None, :] for i in range(n)]
        fwd = _forward_for(arch)
        calib_kw = dict(
            forward=lambda p, b: fwd(p, jax.numpy.asarray(b), cfg)[0],
            calib_batches=batches,
        )
        log(f"calibrating on {n} x {seq}-token batches from {args.calib_text}")

    if args.fmt == "bf16":  # dense checkpoint: the baseline format
        qparams = jax.tree_util.tree_map(
            lambda a: a.astype(jax.numpy.bfloat16), params)
    else:
        qparams = ptq.quantize_model(params, tree, **calib_kw)
    serialization.save_checkpoint(qparams, args.out)
    with open(args.out + ".config.json", "w") as f:
        json.dump(_cfg_to_json(cfg, arch), f, indent=1)
    n_bytes_out = os.path.getsize(args.out)
    log(f"saved {args.out}: {n_bytes_in/1e6:.1f} MB dense -> "
        f"{n_bytes_out/1e6:.1f} MB ({n_bytes_in/max(n_bytes_out,1):.2f}x)")


def cmd_eval(args):
    _maybe_cpu(args)
    from quanta_tpu import eval as qeval

    params, cfg, arch, model_dir = load_model(args)
    tokens, _ = _tokens_from_text(args.text, model_dir)
    ppl = qeval.perplexity(
        params, tokens, cfg, forward=_forward_for(arch),
        seq_len=min(args.seq_len, cfg.max_seq_len - 1), batch=args.batch,
    )
    print(json.dumps({"perplexity": round(ppl, 4), "tokens": int(len(tokens))}))


def cmd_generate(args):
    _maybe_cpu(args)
    import jax.numpy as jnp
    import numpy as np

    from quanta_tpu import eval as qeval
    from quanta_tpu.models import llama

    params, cfg, arch, model_dir = load_model(args)
    if arch != "llama":
        raise SystemExit("generate currently drives the Llama decode loop")
    tok = qeval.load_tokenizer(model_dir)
    ids = np.asarray(tok.encode(args.prompt), np.int32)[None, :]
    t0 = time.perf_counter()
    out = llama.greedy_decode(params, jnp.asarray(ids), cfg,
                              max_new_tokens=args.max_new_tokens)
    dt = time.perf_counter() - t0
    new = np.asarray(out)[0, ids.shape[1]:]
    print(tok.decode(new.tolist()))
    log(f"{len(new)} tokens in {dt:.2f}s ({len(new)/dt:.1f} tok/s incl. compile)")


def cmd_serve(args):
    _maybe_cpu(args)
    import numpy as np

    from quanta_tpu import eval as qeval
    from quanta_tpu.serve.engine import Engine, Request

    params, cfg, arch, model_dir = load_model(args)
    if arch != "llama":
        raise SystemExit("serve currently drives the Llama decode loop")
    tok = qeval.load_tokenizer(model_dir)
    if args.prompts:
        with open(args.prompts) as f:
            prompts = [ln.strip() for ln in f if ln.strip()]
    else:
        prompts = [f"request {i}: the quick brown fox" for i in range(args.n)]
    eng = Engine(params, cfg, n_slots=args.slots, page_size=args.page_size,
                 multi_step=args.multi_step,
                 pipeline_depth=args.pipeline_depth,
                 kv_quant=args.kv_quant)
    reqs = [
        Request(uid=i, prompt=np.asarray(tok.encode(p), np.int32),
                max_new_tokens=args.max_new_tokens)
        for i, p in enumerate(prompts)
    ]
    done = eng.run(reqs)
    ttfts = sorted(1e3 * (r.t_first_token - r.t_arrival) for r in done)
    n_tok = sum(len(r.output) for r in done)
    stats = {
        "requests": len(done),
        "decode_tokens": n_tok,
        "p50_ttft_ms": round(ttfts[len(ttfts) // 2], 2),
        "p99_ttft_ms": round(ttfts[min(len(ttfts) - 1, int(len(ttfts) * .99))], 2),
        "throughput_tok_s": round(n_tok / max(eng._t_serve, 1e-9), 1),
    }
    print(json.dumps(stats))
    if args.out:
        with open(args.out, "w") as f:
            for r in done:
                f.write(json.dumps({"uid": r.uid, "prompt": r.prompt.tolist(),
                                    "output": [int(t) for t in r.output]})
                        + "\n")
    if args.show:
        for r in done[: args.show]:
            log(f"[{r.uid}] {tok.decode(r.output)!r}")


def cmd_finetune(args):
    _maybe_cpu(args)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from quanta_tpu import nn as qnn, optim as qoptim, train

    args.out = _norm_npz(args.out)
    from quanta_tpu.utils import serialization

    params, cfg, arch, model_dir = load_model(args)
    if arch != "llama":
        raise SystemExit("finetune currently drives the Llama train step")
    if not getattr(args, "ckpt", None):
        params = qnn.quantize_params(params, mode=args.fmt,
                                     block_size=args.block_size)
    params = train.add_lora(params, jax.random.PRNGKey(args.seed + 1),
                            rank=args.rank)
    tokens, _ = _tokens_from_text(args.text, model_dir)
    seq = min(args.seq_len, cfg.max_seq_len - 1)
    n_win = max(1, (len(tokens) - 1) // seq)
    wins = np.stack([tokens[i * seq:i * seq + seq + 1] for i in range(n_win)])

    tx = qoptim.adam8bit(args.lr)
    adapters = train.extract_adapters(params)
    opt_state = tx.init(adapters)
    step = jax.jit(train.make_qlora_train_step(cfg, tx))
    rng = np.random.default_rng(args.seed)
    losses = []
    for i in range(args.steps):
        b = jnp.asarray(wins[rng.integers(0, n_win, size=args.batch)])
        batch = {"inputs": b[:, :-1], "targets": b[:, 1:]}
        adapters, opt_state, loss = step(adapters, opt_state, params, batch)
        losses.append(float(loss))
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            log(f"step {i:4d}  loss {losses[-1]:.4f}")
    serialization.save_checkpoint(adapters, args.out)
    log(f"saved LoRA adapters -> {args.out}")
    print(json.dumps({"steps": args.steps, "losses": losses}))


def cmd_bench(args):
    _maybe_cpu(args)
    import runpy

    # benchmark drivers ship inside the package (quanta_tpu/benchmarks/),
    # so the installed console script works outside a repo checkout
    mod = {
        "kernels": "quanta_tpu.benchmarks.kernel_bench",
        "accuracy": "quanta_tpu.benchmarks.accuracy_bench",
        "serve": "quanta_tpu.benchmarks.serve_bench",
        "decode": "quanta_tpu.benchmarks.decode_bench",
    }.get(args.kind, "quanta_tpu.benchmarks.decode_bench")
    sys.argv = [mod.rsplit(".", 1)[-1]]
    runpy.run_module(mod, run_name="__main__")


def cmd_convert(args):
    _maybe_cpu(args)
    from quanta_tpu.state.config import QuantConfig
    from quanta_tpu.utils import convert, serialization

    qt = serialization.load_quantized_tensor(args.src)
    if args.transcode:
        # same-bit-width codebook remap (no fp round trip): the
        # imported-QLoRA path, exact NF4 -> nf4a-speed serving
        out = convert.transcode_codebook(qt, target=args.fmt)
    else:
        c = QuantConfig.from_mode(args.fmt, block_size=args.block_size)
        out = convert.convert_precision(qt, bits=c.bits, scheme=c.scheme,
                                        codebook=c.codebook,
                                        block_size=args.block_size)
    serialization.save_quantized_tensor(out, args.out)
    log(f"{args.src} ({qt.bits}-bit) -> {args.out} ({out.bits}-bit {args.fmt})")


# ----------------------------------------------------------------- parser


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="quanta_tpu",
        description="quantized inference / QLoRA framework",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    q = sub.add_parser("quantize", help="PTQ a model and save a checkpoint")
    _add_model_args(q, ckpt=False)
    q.add_argument("--fmt", default="nf4a",
                   choices=["int8", "int4", "nf4", "nf4a", "nf8", "fp4",
                            "fp8", "llm_int8", "int4c", "int8a", "int4a",
                            "bf16"],
                   help="weight format (bf16: dense checkpoint)")
    q.add_argument("--block-size", type=int, default=64)
    q.add_argument("--config", help="ConfigTree JSON (three-tier rules)")
    q.add_argument("--calib-text", help="text file for activation calibration")
    q.add_argument("--calib-batches", type=int, default=8)
    q.add_argument("--out", required=True)
    q.set_defaults(fn=cmd_quantize)

    e = sub.add_parser("eval", help="perplexity over a text file")
    _add_model_args(e)
    e.add_argument("--text", required=True)
    e.add_argument("--seq-len", type=int, default=256)
    e.add_argument("--batch", type=int, default=8)
    e.set_defaults(fn=cmd_eval)

    g = sub.add_parser("generate", help="greedy decode from a prompt")
    _add_model_args(g)
    g.add_argument("--prompt", required=True)
    g.add_argument("--max-new-tokens", type=int, default=64)
    g.set_defaults(fn=cmd_generate)

    s = sub.add_parser("serve", help="continuous-batching demo over a trace")
    _add_model_args(s)
    s.add_argument("--prompts", help="file with one prompt per line")
    s.add_argument("-n", type=int, default=16, help="synthetic request count")
    s.add_argument("--slots", type=int, default=8)
    s.add_argument("--page-size", type=int, default=16)
    s.add_argument("--multi-step", type=int, default=8,
                   help="decode-window length (tokens per dispatch)")
    s.add_argument("--pipeline-depth", type=int, default=2,
                   help="async readbacks in flight behind the window")
    s.add_argument("--kv-quant", action="store_true",
                   help="int8 per-(token,head) quantized KV pool")
    s.add_argument("--max-new-tokens", type=int, default=32)
    s.add_argument("--show", type=int, default=0, help="print first N outputs")
    s.add_argument("--out", help="write each request's prompt and output "
                                 "tokens here as JSON lines")
    s.set_defaults(fn=cmd_serve)

    f = sub.add_parser("finetune", help="QLoRA fine-tune on a text file")
    _add_model_args(f)
    f.add_argument("--text", required=True)
    f.add_argument("--fmt", default="nf4a")
    f.add_argument("--block-size", type=int, default=64)
    f.add_argument("--rank", type=int, default=8)
    f.add_argument("--lr", type=float, default=1e-4)
    f.add_argument("--steps", type=int, default=50)
    f.add_argument("--batch", type=int, default=4)
    f.add_argument("--seq-len", type=int, default=128)
    f.add_argument("--out", default="lora_adapters.npz")
    f.set_defaults(fn=cmd_finetune)

    b = sub.add_parser("bench", help="run benchmarks")
    b.add_argument("kind",
                   choices=["headline", "decode", "kernels", "accuracy",
                            "serve"],
                   nargs="?", default="kernels")
    b.add_argument("--cpu", action="store_true")
    b.set_defaults(fn=cmd_bench)

    c = sub.add_parser("convert", help="precision-convert a .qtn tensor")
    c.add_argument("src")
    c.add_argument("--bits", type=int, required=True)
    c.add_argument("--fmt", default="nf4")
    c.add_argument("--block-size", type=int, default=64)
    c.add_argument("--transcode", action="store_true",
                   help="same-bit-width codebook remap (no fp round trip), "
                        "e.g. imported exact-NF4 -> nf4a for serving speed")
    c.add_argument("--out", required=True)
    c.add_argument("--cpu", action="store_true")
    c.set_defaults(fn=cmd_convert)

    return ap


def main(argv=None):
    from quanta_tpu import compile_cache

    args = build_parser().parse_args(argv)
    compile_cache.enable()
    args.fn(args)


if __name__ == "__main__":
    main()
