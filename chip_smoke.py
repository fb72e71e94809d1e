#!/usr/bin/env python3
"""Smoke test on NVIDIA GPUs: the main path at TinyLlama-1.1B width.

    python chip_smoke.py          # one card: device, kernels, serve, train,
                                  # card-only checks
    python chip_smoke.py --four   # four cards: the parallel/ path on a
                                  # ('data'=1, 'model'=4) mesh vs one card

Phases (each prints its own lines; any failure raises and exits non-zero):

  device   JAX's device and the card's name and power limit (nvidia-smi);
           no GPU is an error, never a fallback to the CPU.
  kernels  the fused dequant-matmul kernel for every format it takes, at
           the TinyLlama projections and M = 8 and 512, against the f32
           `highest` reference, and its time beside XLA's plain
           dequant + GEMM; 22-layer decode with the kernel vs without;
           cuDNN attention vs the plain attention; the GEMM XLA picks for
           LLM.int8's s8 dot.
  serve    `quanta-tpu quantize` then `quanta-tpu serve` (8 requests) for
           bf16, nf4 and llm_int8; every request gets its token count and
           its first token equals llama.greedy_decode's on that prompt.
  train    `quanta-tpu finetune` (NF4 base, LoRA, 8-bit Adam) for a few
           steps on one repeated batch: the loss is finite and falls. Then
           the compiled memory plan of a Llama-2-7B NF4 QLoRA step.
  card     the checks tests/test_gpu.py runs (kernel_bench.CARD_CHECKS).

Depth is cut to --layers (widths stay TinyLlama's); weights are random
from --seed. One process drives every card; the only child is nvidia-smi.
The last stdout line is the JSON result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".smoke"  # checkpoints and prompt files (git-ignored)


def log(*a):
    print(*a, flush=True)


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def phase_device(n_cards: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU (JAX's devices are {devs[0].platform}); "
            "nothing is run on the CPU")
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: need {n_cards} GPUs, have {len(devs)}")
    from quanta_tpu import compile_cache

    log(f"[device] {devs[0].platform} {devs[0].device_kind} x{len(devs)}; "
        f"jax {jax.__version__}; compile cache {compile_cache.enable()}")
    for line in card_lines():
        log(f"[device] card: {line}")
    return devs


def phase_kernels():
    from quanta_tpu.benchmarks import kernel_bench as kb

    failed = []
    for m in (8, 512):
        for fmt in kb.KERNEL_FORMATS:
            for k, n in kb.TINYLLAMA_SHAPES:
                r = kb.check_matmul(fmt, m, k, n)
                log(f"[kernels] check {json.dumps(r)}")
                if not r["ok"]:
                    failed.append(r)
    for m in (8, 512):
        for fmt in ("nf4", "int8"):
            for k, n in kb.TINYLLAMA_SHAPES:
                r = kb.time_matmul(fmt, m, k, n)
                log(f"[kernels] time {json.dumps(r)}")
    for fmt in ("nf4", "int8"):
        log(f"[kernels] decode {json.dumps(kb.decode_ab(fmt))}")
    att = kb.check_attention()
    log(f"[kernels] attention {json.dumps(att)}")
    if not att["ok"]:
        failed.append(att)
    for m in (8, 512):
        log(f"[kernels] int8-gemm {json.dumps(kb.int8_gemm_kind(m))}")
    if failed:
        raise AssertionError(f"kernel checks over tolerance: {failed}")


def _cli(argv) -> list[str]:
    """Run the CLI in this process; return its stdout lines."""
    from quanta_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main([str(a) for a in argv])
    return buf.getvalue().splitlines()


def _prompts(seed: int, n: int, length: int) -> list[str]:
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz "))
    return ["".join(rng.choice(letters, length)) for _ in range(n)]


def phase_serve(layers: int, seed: int, n_requests: int = 8,
                max_new: int = 16):
    from functools import partial

    import jax
    import jax.numpy as jnp
    import numpy as np

    from quanta_tpu import cli
    from quanta_tpu.models import llama
    from quanta_tpu.utils import serialization

    # 32-byte prompts: the byte tokenizer makes them one 32-token
    # prefill bucket each, the shape the reference decode sees too
    prompts = _prompts(seed, n_requests, 32)
    pfile = WORK / "prompts.txt"
    pfile.write_text("\n".join(prompts) + "\n")
    for fmt in ("bf16", "nf4", "llm_int8"):
        ckpt = WORK / f"tinyllama_{fmt}.npz"
        outs = WORK / f"serve_{fmt}.jsonl"
        t0 = time.perf_counter()
        _cli(["quantize", "--toy", "tinyllama", "--layers", layers,
              "--seed", seed, "--fmt", fmt, "--out", ckpt])
        t1 = time.perf_counter()
        stats = json.loads(_cli(
            ["serve", "--ckpt", ckpt, "--prompts", pfile, "--slots", 8,
             "--max-new-tokens", max_new, "--out", outs])[-1])
        t2 = time.perf_counter()
        done = [json.loads(ln) for ln in outs.read_text().splitlines()]
        assert len(done) == n_requests, (fmt, len(done))
        for r in done:
            assert len(r["output"]) == max_new, (fmt, r["uid"], r["output"])

        params = serialization.load_checkpoint(str(ckpt))
        with open(str(ckpt) + ".config.json") as f:
            cfg, _ = cli._cfg_from_json(json.load(f))
        # the reference prefills one request at a time, as the engine
        # does: same GEMM shapes, and LLM.int8 picks its outlier columns
        # from the same rows
        ref = jax.jit(partial(llama.greedy_decode, cfg=cfg, max_new_tokens=1))
        last = jax.jit(lambda p, t: llama.forward(p, t, cfg)[0][0, -1])
        gaps = []
        for r in sorted(done, key=lambda r: r["uid"]):
            toks = jnp.asarray([r["prompt"]], jnp.int32)
            want = int(np.asarray(ref(params, toks))[0, -1])
            assert r["output"][0] == want, (fmt, r["uid"], r["output"][0],
                                            want)
            lg = np.sort(np.asarray(last(params, toks)))
            gaps.append(float((lg[-1] - lg[-2]) / np.abs(lg).max()))
        log(f"[serve] {fmt}: {json.dumps(stats)}; {len(done)} requests x "
            f"{max_new} tokens; first tokens equal greedy_decode's "
            f"{n_requests}/{n_requests} (smallest top-2 logit gap "
            f"{min(gaps):.2e} of max|logit|); quantize {t1 - t0:.1f} s, "
            f"serve incl. compile {t2 - t1:.1f} s")


def phase_train(layers: int, seed: int, steps: int = 5):
    import math

    import numpy as np

    from quanta_tpu.benchmarks import kernel_bench as kb

    # one 128-byte string repeated: every 128-token window (and so every
    # batch) is the same, so the loss must fall step over step
    unit = _prompts(seed, 1, 128)[0]
    text = WORK / "train.txt"
    text.write_text(unit * 40)
    t0 = time.perf_counter()
    res = json.loads(_cli(
        ["finetune", "--toy", "tinyllama", "--layers", layers, "--seed", seed,
         "--fmt", "nf4", "--text", text, "--steps", steps, "--batch", 4,
         "--seq-len", 128, "--lr", "1e-2", "--rank", 8,
         "--out", WORK / "adapters.npz"])[-1])
    losses = res["losses"]
    log(f"[train] nf4 QLoRA {steps} steps, batch 4 x 128: losses "
        f"{json.dumps(losses)} ({time.perf_counter() - t0:.1f} s incl. "
        "compile)")
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    mem = kb.memory_qlora_7b()
    log(f"[train] llama2-7b nf4 QLoRA step, compile only: "
        f"{json.dumps(mem)}")
    assert np.isfinite(mem["temp_gib"])


def phase_card():
    from quanta_tpu.benchmarks import kernel_bench as kb

    for name, check in kb.CARD_CHECKS:
        check()
        log(f"[card] {name}: ok")


def phase_four(seed: int, layers: int):
    import dataclasses
    from functools import partial

    import jax
    import jax.numpy as jnp
    import numpy as np

    from quanta_tpu import nn as qnn, optim, train
    from quanta_tpu.models import llama
    from quanta_tpu.parallel import (fsdp_param_specs, make_mesh,
                                     shard_params)
    from quanta_tpu.parallel import tp as tpmod
    from quanta_tpu.serve import Engine, Request

    # f32 at `highest` on both sides: the sharded and the one-card
    # programs then agree to summation order
    cfg = dataclasses.replace(llama.LlamaConfig.tinyllama_1b(),
                              n_layers=layers, dtype=jnp.float32)
    mesh = make_mesh(data=1, model=4)
    one = jax.devices()[0]
    t0 = time.perf_counter()
    log(f"[four] mesh {dict(mesh.shape)} over "
        f"{[d.id for d in mesh.devices.ravel()]}")
    dense = llama.init_params(jax.random.PRNGKey(seed), cfg)
    toks = jax.random.randint(jax.random.PRNGKey(seed + 1), (4, 64), 0,
                              cfg.vocab_size)
    log(f"[four] params made at {time.perf_counter() - t0:.0f} s")

    def close(got, want, tol, what):
        err = float(np.abs(np.asarray(got) - np.asarray(want)).max()
                    / max(np.abs(np.asarray(want)).max(), 1e-30))
        log(f"[four] {what}: normalized max err {err:.3e} (tol {tol}) "
            f"at {time.perf_counter() - t0:.0f} s")
        assert err <= tol, (what, err)

    def leaves(tree):
        return [np.asarray(x, np.float64)
                for x in jax.tree_util.tree_leaves(tree)]

    with jax.default_matmul_precision("highest"):
        # manual shard_map TP: NF4 prefill + cached decode
        tp_params = tpmod.tp_llama_params(dense, cfg, 4, fmt="nf4")
        oracle = jax.device_put(_tp_oracle(tpmod, tp_params, dense), one)
        log(f"[four] tp params made at {time.perf_counter() - t0:.0f} s")
        fwd = jax.jit(lambda p, t, c: llama.forward(p, t, cfg, cache=c))
        tp_fwd = jax.jit(lambda p, t, c: tpmod.tp_llama_forward_cached(
            p, t, cfg, mesh, c))
        cache_o = llama.init_cache(cfg, 4, max_len=96)
        cache_t = tpmod.tp_init_cache(cfg, 4, max_len=96)
        lo, cache_o = fwd(oracle, toks, cache_o)
        lt, cache_t = tp_fwd(tp_params, toks, cache_t)
        close(lt, lo, 1e-3, "tp nf4 prefill")
        for step in range(2):
            nxt = jnp.asarray(np.argmax(np.asarray(lo[:, -1]), axis=-1)
                              .astype(np.int32)[:, None])
            lo, cache_o = fwd(oracle, nxt, cache_o)
            lt, cache_t = tp_fwd(tp_params, nxt, cache_t)
            close(lt, lo, 1e-3, f"tp nf4 cached decode step {step}")

        # FSDP QLoRA (NF4 base + LoRA + 8-bit Adam) vs one card
        qparams = train.add_lora(
            qnn.quantize_params(dense, mode="nf4"),
            jax.random.PRNGKey(seed + 2), rank=8, dtype=jnp.float32)
        lr, eps = 1e-3, 1e-8
        tx = optim.adam8bit(lr, eps=eps)
        step = jax.jit(train.make_qlora_train_step(cfg, tx))
        update = jax.jit(tx.update)
        batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}

        def loss_fn(ad, p, batch):
            logits, _ = llama.forward(train.merge_adapters(p, ad),
                                      batch["inputs"], cfg)
            return train.causal_lm_loss(logits, batch["targets"])

        grad_fn = jax.jit(jax.value_and_grad(loss_fn))
        res = {}
        for name, p in (("one", jax.device_put(qparams, one)),
                        ("fsdp", shard_params(
                            qparams, mesh,
                            specs=fsdp_param_specs(cfg, qparams)))):
            ad = train.extract_adapters(p)
            st0 = tx.init(ad)
            loss, grads = grad_fn(ad, p, batch)
            upd, st = update(grads, st0)
            new_ad, _, step_loss = step(ad, st0, p, batch)
            assert all(np.isfinite(x).all() for x in leaves(new_ad))
            res[name] = dict(loss=float(loss), step_loss=float(step_loss),
                             grads=grads, upd=upd, st=st, ad=ad)
        one_r, sh = res["one"], res["fsdp"]
        log(f"[four] fsdp qlora loss {sh['loss']:.6f} vs one card "
            f"{one_r['loss']:.6f}; train step loss {sh['step_loss']:.6f} "
            f"vs {one_r['step_loss']:.6f}")
        close(sh["loss"], one_r["loss"], 1e-4, "fsdp qlora loss")
        close(sh["step_loss"], one_r["step_loss"], 1e-4,
              "fsdp qlora step loss")
        for a, b in zip(leaves(sh["grads"]), leaves(one_r["grads"])):
            close(a, b, 1e-3, "fsdp qlora adapter gradient")

        # the sharded 8-bit Adam update against the same update of the
        # same (gathered) gradients on one card: only the two programs'
        # rounding differs, so the updates agree to a few ulps of lr and
        # a state code moves at most one step
        upd_r, st_r = update(jax.device_put(sh["grads"], one),
                             tx.init(jax.device_put(sh["ad"], one)))
        for a, b in zip(leaves(sh["upd"]), leaves(upd_r)):
            err = float(np.abs(a - b).max()) / lr
            log(f"[four] sharded adam8bit update vs one card, same "
                f"gradients: max err {err:.3e} x lr (tol 1e-5)")
            assert err <= 1e-5, err
        code_diff = max(
            int(np.abs(a - b).max()) for a, b in zip(
                leaves([(q.m_codes, q.v_codes) for q in
                        jax.tree_util.tree_leaves(
                            sh["st"].qstate, is_leaf=_is_qstate)]),
                leaves([(q.m_codes, q.v_codes) for q in
                        jax.tree_util.tree_leaves(
                            st_r.qstate, is_leaf=_is_qstate)])))
        log(f"[four] sharded adam8bit state codes vs one card: max "
            f"difference {code_diff} (tol 1)")
        assert code_diff <= 1, code_diff

        # one card vs FSDP end to end: Adam's first step is
        # -lr * g / (|g| + eps), whose slope in g is at most lr / eps
        # (at g = 0), so each update may differ by lr * |dg| / eps, plus
        # a few ulps of lr
        for a_u, b_u, a_g, b_g in zip(leaves(sh["upd"]),
                                      leaves(one_r["upd"]),
                                      leaves(sh["grads"]),
                                      leaves(one_r["grads"])):
            du, dg = np.abs(a_u - b_u), np.abs(a_g - b_g)
            bound = lr * dg / eps + 1e-6 * lr
            worst = int(np.argmax(du))
            log(f"[four] fsdp vs one card adam8bit update: max "
                f"{du.max() / lr:.3e} x lr, where |g| = "
                f"{abs(b_g.ravel()[worst]):.2e} and lr*|dg|/eps = "
                f"{bound.ravel()[worst] / lr:.3e} x lr; elements over "
                f"the bound: {int((du > bound).sum())}")
            assert (du <= bound).all()

        # Engine on GSPMD-sharded NF4 params vs greedy_decode on one
        # card, one request at a time as the engine prefills
        nf4 = qnn.quantize_params(dense, mode="nf4")
        sharded = shard_params(nf4, mesh, cfg=cfg)
        eng = Engine(sharded, cfg, n_slots=4, page_size=16,
                     prefill_buckets=(64,))
        reqs = [Request(uid=i, prompt=np.asarray(toks[i]), max_new_tokens=8)
                for i in range(4)]
        done = sorted(eng.run(reqs), key=lambda r: r.uid)
        got = np.asarray([r.output for r in done])
        log(f"[four] engine on sharded params: {got.tolist()} at "
            f"{time.perf_counter() - t0:.0f} s")
        ref = jax.jit(partial(llama.greedy_decode, cfg=cfg,
                              max_new_tokens=8))
        nf4_one = jax.device_put(nf4, one)
        want = np.concatenate([np.asarray(ref(nf4_one, toks[i:i + 1]))
                               for i in range(4)])[:, 64:]
        np.testing.assert_array_equal(got, want)
        log("[four] engine tokens equal greedy_decode on one card")


def _is_qstate(x) -> bool:
    return hasattr(x, "m_codes")


def _tp_oracle(tpmod, tp_params, dense):
    """Dense f32 tree holding the TP shards' dequantized values."""
    import jax.numpy as jnp

    layers = []
    for lp in tp_params["layers"]:
        ol = {"attn_norm": lp["attn_norm"], "ffn_norm": lp["ffn_norm"]}
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            ol[name] = tpmod.dequantize_tp(lp[name]).astype(jnp.float32)
        layers.append(ol)
    return {"tok_emb": dense["tok_emb"], "norm_f": dense["norm_f"],
            "lm_head": tpmod.dequantize_tp(tp_params["lm_head"]).astype(
                jnp.float32),
            "layers": layers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="GPU smoke test")
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card parallel path")
    ap.add_argument("--layers", type=int, default=4,
                    help="decoder layers (depth cut; widths are TinyLlama's)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    devs = phase_device(4 if args.four else 1)
    t0 = time.perf_counter()
    if args.four:
        phase_four(args.seed, args.layers)
    else:
        WORK.mkdir(exist_ok=True)
        try:
            phase_kernels()
            log(f"[time] kernels done at {time.perf_counter() - t0:.0f} s")
            phase_serve(args.layers, args.seed)
            log(f"[time] serve done at {time.perf_counter() - t0:.0f} s")
            phase_train(args.layers, args.seed)
            log(f"[time] train done at {time.perf_counter() - t0:.0f} s")
            phase_card()
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
    log(f"[time] total {time.perf_counter() - t0:.0f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
