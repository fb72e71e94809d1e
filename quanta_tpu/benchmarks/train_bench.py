"""QLoRA training benchmark — north-star config 4.

BASELINE.md config 4 (the capability the reference only roadmaps,
/root/reference/TODO.md:47-50): fine-tune with a frozen 4-bit NF4 base,
bf16 LoRA adapters, and blockwise 8-bit Adam. This bench measures:

  - QLoRA step time and tokens/s/chip (L train steps inside one jit, loss
    scalar read back, slope between two loop lengths — cancels compile
    and dispatch constants);
  - memory from XLA's compiled allocation plan
    (``compiled.memory_analysis()``: temp buffers of one train step)
    beside the resident state counted from the arrays;
  - 8-bit Adam state bytes vs an fp32 optax.adam control, measured from
    the actual state trees (adapter-scale allocated for real;
    full-model-scale via ``jax.eval_shape``);
  - Llama-2-7B and 13B NF4-base QLoRA via ``nn.init_quantized_params``
    (no dense tree is ever built), executed with the loss read back;
  - bf16-base controls: compiled only, recording XLA's allocation plan.

Prints one JSON line; ``--out`` also writes a markdown table.

Usage: python -m quanta_tpu.benchmarks.train_bench [--quick] [--out FILE]
"""

import argparse
import dataclasses
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _timed(fn, *args, reps=2):
    """Best wall time of jitted fn(*args) including scalar readback."""
    np.asarray(fn(*args))  # compile + warm
    best = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        np.asarray(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def _tree_bytes(tree) -> int:
    """Bytes over leaves; works on arrays AND ShapeDtypeStructs."""
    tot = 0
    for x in jax.tree_util.tree_leaves(tree):
        if hasattr(x, "nbytes"):
            tot += x.nbytes
        elif hasattr(x, "shape") and hasattr(x, "dtype"):
            tot += int(np.prod(x.shape)) * jnp.dtype(x.dtype).itemsize
    return tot


def _count_params(tree) -> int:
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(tree)
               if hasattr(x, "shape"))


def _make_base(cfg, fmt, *, quantized_init: bool):
    from quanta_tpu import nn as qnn
    from quanta_tpu.models import llama

    if fmt == "bf16":
        return llama.init_params(jax.random.PRNGKey(0), cfg)
    if quantized_init:
        return qnn.init_quantized_params(jax.random.PRNGKey(0), cfg,
                                         mode=fmt, block_size=64)
    dense = llama.init_params(jax.random.PRNGKey(0), cfg)
    return qnn.quantize_params(dense, mode=fmt, block_size=64)


def _make_batch(cfg, batch, seq, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(batch, seq + 1))
    return {
        "inputs": jnp.asarray(toks[:, :-1], jnp.int32),
        "targets": jnp.asarray(toks[:, 1:], jnp.int32),
    }


def bench_qlora(name, cfg, *, fmt, batch, seq, rank=8,
                quantized_init=False, L0=2, L1=6, lr=1e-4,
                compile_only=False):
    """One QLoRA row: step time, tokens/s/chip, XLA memory plan."""
    from quanta_tpu import optim as qoptim
    from quanta_tpu import train

    t_init = time.time()

    def build():
        base = _make_base(cfg, fmt, quantized_init=quantized_init)
        return train.add_lora(base, jax.random.PRNGKey(1), rank=rank,
                              dtype=jnp.bfloat16)

    tx = qoptim.adam8bit(lr)
    if compile_only:
        # never materialize the dense tree — the whole row is XLA's
        # abstract allocation plan
        params = jax.eval_shape(build)
        adapters = train.extract_adapters(params)
        opt_state = jax.eval_shape(tx.init, adapters)
    else:
        params = build()
        jax.block_until_ready(params)
        adapters = train.extract_adapters(params)
        opt_state = tx.init(adapters)
    weights_gib = _tree_bytes(params) / 2**30
    n_adapter = _count_params(adapters)
    step = train.make_qlora_train_step(cfg, tx)
    data = _make_batch(cfg, batch, seq)
    # true resident state (weights + adapters + optimizer + batch),
    # counted from the arrays — XLA's argument_size_in_bytes is
    # post-optimization (dedup/elimination) and not a residency number
    resident_gib = _tree_bytes((adapters, opt_state, params, data)) / 2**30

    def make_loop(L):
        @jax.jit
        def loop(adapters, opt_state, params, data):
            def body(carry, _):
                a, o = carry
                a, o, loss = step(a, o, params, data)
                return (a, o), loss

            (_, _), losses = jax.lax.scan(
                body, (adapters, opt_state), None, length=L
            )
            return losses[-1]

        return loop

    row = {
        "name": name, "fmt": fmt, "batch": batch, "seq": seq, "rank": rank,
        "weights_gib": round(weights_gib, 2),
        "resident_gib": round(resident_gib, 2),
        "adapter_params_m": round(n_adapter / 1e6, 2),
    }

    # XLA's allocation plan for ONE train step (one step is the honest
    # "what must fit" number). NOTE: no is_leaf here — a QuantizedTensor
    # has .shape/.dtype FIELDS, so an is_leaf testing hasattr(shape)
    # collapses the whole quantized leaf into ONE dense-bf16
    # ShapeDtypeStruct and the AOT program compiles with dense weights
    one = make_loop(1)
    shapes = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
        (adapters, opt_state, params, data),
    )
    t0 = time.time()
    compiled = one.lower(*shapes).compile()
    ma = compiled.memory_analysis()
    arg_gib = ma.argument_size_in_bytes / 2**30
    tmp_gib = ma.temp_size_in_bytes / 2**30
    row["xla_args_gib"] = round(arg_gib, 2)
    row["xla_temp_gib"] = round(tmp_gib, 2)
    row["xla_total_gib"] = round(arg_gib + tmp_gib, 2)
    log(f"{name}: weights {weights_gib:.2f} GiB | XLA plan: args "
        f"{arg_gib:.2f} + temps {tmp_gib:.2f} = {arg_gib+tmp_gib:.2f} GiB "
        f"(init {t_init and time.time()-t_init:.0f}s, "
        f"compile {time.time()-t0:.0f}s)")
    if compile_only:
        return row

    loss0 = float(np.asarray(one(adapters, opt_state, params, data)))
    row["loss_step1"] = round(loss0, 3)
    assert np.isfinite(loss0), f"{name}: non-finite loss"

    t0 = _timed(make_loop(L0), adapters, opt_state, params, data)
    t1 = _timed(make_loop(L1), adapters, opt_state, params, data)
    step_t = max((t1 - t0) / (L1 - L0), 1e-9)
    row["step_ms"] = round(step_t * 1e3, 1)
    row["tok_s_chip"] = round(batch * seq / step_t, 1)
    log(f"{name}: step {row['step_ms']} ms | {row['tok_s_chip']} "
        f"tok/s/chip | loss@1 {loss0:.3f}")
    return row


def bench_adam_bytes(cfg):
    """8-bit Adam state bytes vs fp32 optax.adam — measured, not asserted.

    Adapter-scale states are allocated for real; the full-model-scale
    fp32 control (~8.8 GB for 1.1B params) is counted via jax.eval_shape.
    """
    import optax

    from quanta_tpu import nn as qnn
    from quanta_tpu import optim as qoptim
    from quanta_tpu import train
    from quanta_tpu.models import llama
    from quanta_tpu.optim.adam8bit import state_nbytes

    out = {}

    def to_f32(tree):
        # the standard control is FP32 Adam (m+v in f32 = 8 B/param);
        # optax keeps moments in param dtype, so cast the tree first
        return jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, jnp.float32), tree
        )

    # adapter-scale: real allocation for adam8bit
    base = qnn.init_quantized_params(jax.random.PRNGKey(0), cfg, mode="nf4")
    params = train.add_lora(base, jax.random.PRNGKey(1), rank=8,
                            dtype=jnp.bfloat16)
    adapters = train.extract_adapters(params)
    n = _count_params(adapters)
    st8 = qoptim.adam8bit(1e-4).init(adapters)
    st32_s = jax.eval_shape(optax.adam(1e-4).init, to_f32(adapters))
    out["adapters"] = {
        "params_m": round(n / 1e6, 3),
        "adam8bit_bytes_per_param": round(state_nbytes(st8) / n, 3),
        "fp32_adam_bytes_per_param": round(
            (_tree_bytes(st32_s) - 4) / n, 3  # - count scalar
        ),
    }
    del st8, st32_s

    # full-model scale (full-parameter training): eval_shape only
    dense_shapes = jax.eval_shape(
        lambda k: llama.init_params(k, cfg), jax.random.PRNGKey(0)
    )
    n_full = _count_params(dense_shapes)

    def nbytes_tree(shapes):
        return sum(
            int(np.prod(s.shape)) * s.dtype.itemsize
            for s in jax.tree_util.tree_leaves(shapes)
            if hasattr(s, "shape")
        )

    st8_s = jax.eval_shape(qoptim.adam8bit(1e-4).init, dense_shapes)
    st32_s = jax.eval_shape(optax.adam(1e-4).init, to_f32(dense_shapes))
    out["full_model"] = {
        "params_m": round(n_full / 1e6, 1),
        "adam8bit_gib": round(nbytes_tree(st8_s.qstate) / 2**30, 2),
        "adam8bit_bytes_per_param": round(
            nbytes_tree(st8_s.qstate) / n_full, 3
        ),
        "fp32_adam_gib": round(nbytes_tree(st32_s) / 2**30, 2),
        "fp32_adam_bytes_per_param": round(nbytes_tree(st32_s) / n_full, 3),
    }
    log(f"adam state: adapters {out['adapters']} | full {out['full_model']}")
    return out


def main():
    from quanta_tpu.models import llama

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="TinyLlama rows only (skip 7B/13B)")
    ap.add_argument("--out", help="also write a markdown table here")
    args = ap.parse_args()
    log("devices:", jax.devices())

    tl = llama.LlamaConfig.tinyllama_1b()
    rows = []
    # TinyLlama-1.1B: nf4 (north star), nf4a, bf16-base control
    rows.append(bench_qlora("tinyllama nf4", tl, fmt="nf4", batch=4,
                            seq=512, quantized_init=True))
    rows.append(bench_qlora("tinyllama nf4a", tl, fmt="nf4a", batch=4,
                            seq=512, quantized_init=True))
    rows.append(bench_qlora("tinyllama bf16-base", tl, fmt="bf16",
                            batch=4, seq=512))
    # seq 1024: the length where attention takes the cuDNN route
    rows.append(bench_qlora("tinyllama nf4 s1024", tl, fmt="nf4", batch=2,
                            seq=1024, quantized_init=True, L0=2, L1=5))

    adam = bench_adam_bytes(tl)

    if not args.quick:
        for name, base, seqs in (("llama2-7b", llama.LlamaConfig.llama2_7b(),
                                  ((2, 512), (1, 1024))),
                                 ("llama2-13b", llama.LlamaConfig.llama2_13b(),
                                  ((1, 512),))):
            cfg = dataclasses.replace(base, max_seq_len=1024)
            for batch, seq in seqs:
                rows.append(bench_qlora(
                    f"{name} nf4 s{seq}", cfg, fmt="nf4", batch=batch,
                    seq=seq, quantized_init=True, L0=1, L1=3))
            rows.append(bench_qlora(
                f"{name} bf16-base (AOT plan)", cfg, fmt="bf16",
                batch=seqs[0][0], seq=seqs[0][1], compile_only=True))

    if args.out:
        lines = [
            "# QLoRA training benchmark",
            "",
            f"Device: `{jax.devices()[0].device_kind}` · frozen quantized "
            "base + bf16 LoRA (rank 8, wq/wv) + blockwise 8-bit Adam · "
            "`resident state` = weights + adapters + optimizer + batch, "
            "counted from the arrays; `XLA temps` = the compiler's "
            "buffer-plan temp bytes for one train step.",
            "",
            "| config | base fmt | batch x seq | weights | resident state | "
            "XLA temps | step ms | tok/s/chip |",
            "|---|---|---|---|---|---|---|---|",
        ]
        for r in rows:
            lines.append(
                f"| {r['name']} | {r['fmt']} | {r['batch']}x{r['seq']} | "
                f"{r['weights_gib']} GiB | {r.get('resident_gib', '—')} GiB"
                f" | {r['xla_temp_gib']} GiB | "
                f"{r.get('step_ms', 'AOT only')} | "
                f"{r.get('tok_s_chip', '—')} |")
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        log("wrote " + args.out)
    print(json.dumps({"train": rows, "adam_state": adam}))


if __name__ == "__main__":
    main()
