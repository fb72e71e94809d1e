"""Device mesh + GSPMD shardings for quantized models.

No distributed layer exists in the reference (SURVEY.md §2.5 — exhaustive:
no torch.distributed/NCCL anywhere; roadmap item /root/reference/TODO.md:50).
This is the realization here: a ('data', 'model') mesh, Megatron-
style tensor-parallel PartitionSpecs for the Llama decoder, and
quantization-aware sharding where packed codes *and their block scales*
shard together (SURVEY.md §7 hard part 3).

Sharding rules for a logical (K, N) weight with spec P(a, b):
  - dense kernel (K, N)            -> P(a, b)
  - QuantizedTensor.codes:
      split_k packed (K/2, N)      -> P(a, b)   (GSPMD shards the packed
        rows; correctness is layout-independent because the unpack/dequant
        graph is partitioned with it. The manual shard_map TP path instead
        quantizes per-shard so each device's kernel sees locally-packed
        rows — see quanta_tpu.parallel.tp.)
  - QuantizedTensor.scale (K/B, N) -> P(a, b)   (blocks live along K)
  - Int8Weight: codes P(a, b), scale (N,) P(b), outliers replicated.
  - LoRAWeight: base as above; lora_a (K, r) P(a, None); lora_b (r, N)
    P(None, b).

Collectives (all-gather on column-sharded outputs, psum after row-sharded
matmuls) are inserted by GSPMD from these specs — no NCCL-analog code.

TP support matrix per weight format (pinned by tests/test_parallel.py):

  | format          | GSPMD specs (shard_params)      | manual shard_map TP |
  |-----------------|----------------------------------|---------------------|
  | dense           | K and N                          | yes (tp.quantize_tp)|
  | QuantizedTensor | K and N (codes+scales together)  | yes, incl. bit-exact|
  |  (split_k)      |                                  | tp.from_global      |
  | Int8Weight      | codes K/N; scale+outliers N only | no — GSPMD only     |
  | Int4cWeight     | N only (nibble pairs span K)     | no — GSPMD only     |
  | LoRAWeight      | base as above; A row-/B col-split| base rules apply    |

Manual TP (quanta_tpu.parallel.tp) re-quantizes per shard so each
device's kernel sees locally-packed split_k rows; llm_int8's outlier set
and int4c's packed nibble pairs are global-K structures with no local
re-pairing implemented, so those formats serve TP through GSPMD specs
alone (tp.quantize_tp raises a clear error for them).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from quanta_tpu.core.qtensor import QuantizedTensor
from quanta_tpu.models.llama import LlamaConfig
from quanta_tpu.nn.lora import LoRAWeight
from quanta_tpu.ops.int4c import Int4cWeight
from quanta_tpu.ops.int8mm import Int8Weight


def make_mesh(
    data: int = 1, model: int = 1, devices=None
) -> Mesh:
    """Build a ('data', 'model') mesh. data*model must equal #devices used."""
    devices = devices if devices is not None else jax.devices()
    n = data * model
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(data, model)
    return Mesh(dev, axis_names=("data", "model"))


# ------------------------------------------------------- logical param specs


def llama_param_specs(cfg: LlamaConfig, params: Optional[dict] = None) -> dict:
    """PartitionSpec tree matching quanta_tpu.models.llama.init_params.

    Megatron mapping: wq/wk/wv/w_gate/w_up column-sharded on 'model'
    (heads / ffn-hidden live on the output axis), wo/w_down row-sharded
    (their input axis is the sharded one), norms and embeddings replicated,
    lm_head column-sharded over vocab.
    """
    col = P(None, "model")
    row = P("model", None)
    rep = P()
    layer = {
        "attn_norm": rep,
        "wq": col,
        "wk": col,
        "wv": col,
        "wo": row,
        "ffn_norm": rep,
        "w_gate": col,
        "w_up": col,
        "w_down": row,
    }
    n_layers = cfg.n_layers if params is None else len(params["layers"])
    specs = {
        "tok_emb": rep,
        "norm_f": rep,
        "layers": [dict(layer) for _ in range(n_layers)],
    }
    if params is None or "lm_head" in params:
        specs["lm_head"] = col
    return specs


def fsdp_param_specs(
    cfg: LlamaConfig, params: Optional[dict] = None, tp: bool = True
) -> dict:
    """ZeRO-3/FSDP-style weight specs (SURVEY.md §2.5 table, QLoRA memory row).

    Every 2-D weight is additionally sharded along the 'data' axis on the
    dimension tensor parallelism leaves unsharded, so each device holds
    1/(data*model) of the weights; XLA's SPMD partitioner inserts the
    per-layer all-gathers at use (the ZeRO-3 pattern) and overlaps them
    with compute. With ``tp=False`` the 'model' factor is dropped and
    weights shard on 'data' only (pure FSDP).

    For QuantizedTensor leaves the codes and their block scales shard with
    the same spec (scales live along K in blocks), so a 'data' shard of a
    split_k-packed weight is self-contained — same invariant as TP
    sharding. Call :func:`check_fsdp_divisibility` first.
    """
    mdl = "model" if tp else None
    col = P("data", mdl)  # (K, N) out-col sharded by TP -> shard K on data
    row = P(mdl, "data")  # (K, N) in-row sharded by TP -> shard N on data
    rep = P()
    layer = {
        "attn_norm": rep,
        "wq": col,
        "wk": col,
        "wv": col,
        "wo": row,
        "ffn_norm": rep,
        "w_gate": col,
        "w_up": col,
        "w_down": row,
    }
    n_layers = cfg.n_layers if params is None else len(params["layers"])
    specs = {
        "tok_emb": P("data", None),
        "norm_f": rep,
        "layers": [dict(layer) for _ in range(n_layers)],
    }
    if params is None or "lm_head" in params:
        specs["lm_head"] = col
    return specs


def check_fsdp_divisibility(
    cfg: LlamaConfig, data: int, tp: int = 1, block_size: int = 64
) -> None:
    """Validate FSDP sharding of packed codes + scale blocks divides evenly."""
    if tp > 1:
        check_divisibility(cfg, tp, block_size)
    problems = []
    for k_dim, what in ((cfg.dim, "dim"), (cfg.hidden_dim, "hidden_dim")):
        if (k_dim // 2) % data or (k_dim // block_size) % data:
            problems.append(
                f"data-shard of K={k_dim} ({what}): packed rows or scale "
                f"blocks not divisible by data={data}"
            )
    out_dims = (cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim,
                cfg.hidden_dim, cfg.dim)
    for n_dim in out_dims:
        if (n_dim // max(tp, 1)) % data:
            problems.append(f"data-shard of N={n_dim}/tp={tp} not divisible "
                            f"by data={data}")
    if problems:
        raise ValueError("; ".join(problems))


def cache_specs(cfg: LlamaConfig) -> dict:
    """KV cache (L, B, T, n_kv, hd): batch on 'data', kv heads on 'model'."""
    kv = P(None, "data", None, "model", None)
    return {"k": kv, "v": kv, "pos": P("data")}


# ----------------------------------------------- spec expansion per leaf type


def _expand_leaf_spec(leaf, spec: P):
    """Map a logical 2-D weight spec onto the arrays inside a weight leaf."""
    if isinstance(leaf, QuantizedTensor):
        return QuantizedTensor(
            codes=spec,
            scale=spec,
            zero_point=None if leaf.zero_point is None else spec,
            bits=leaf.bits,
            scheme=leaf.scheme,
            codebook=leaf.codebook,
            shape=leaf.shape,
            dtype=leaf.dtype,
            block_size=leaf.block_size,
            packed=leaf.packed,
        )
    if isinstance(leaf, Int8Weight):
        a, b = (spec + (None, None))[:2] if spec else (None, None)
        return Int8Weight(
            codes=spec,
            scale=P(b),
            outlier_idx=P(),
            w_outlier=P(None, b),
            threshold=leaf.threshold,
            shape=leaf.shape,
        )
    if isinstance(leaf, Int4cWeight):
        a, b = (spec + (None, None))[:2] if spec else (None, None)
        # codes pack two K-rows per byte: K-sharding would split nibble
        # pairs, so only the N axis shards; scales follow their columns
        return Int4cWeight(codes=P(None, b), scale=P(b), shape=leaf.shape)
    if isinstance(leaf, LoRAWeight):
        a, b = (spec + (None, None))[:2] if spec else (None, None)
        return LoRAWeight(
            base=_expand_leaf_spec(leaf.base, spec),
            lora_a=P(a, None),
            lora_b=P(None, b),
            alpha=leaf.alpha,
        )
    return spec


def _is_weight_leaf(x) -> bool:
    return isinstance(
        x, (QuantizedTensor, Int8Weight, Int4cWeight, LoRAWeight)
    ) or isinstance(
        x, jax.Array
    )


def expand_specs(params, specs):
    """Expand logical weight specs into per-array PartitionSpecs."""
    flat_p, treedef = jax.tree_util.tree_flatten(
        params, is_leaf=lambda x: isinstance(
            x, (QuantizedTensor, Int8Weight, Int4cWeight, LoRAWeight))
    )
    flat_s = treedef.flatten_up_to(specs)
    out = [_expand_leaf_spec(p, s) for p, s in zip(flat_p, flat_s)]
    return jax.tree_util.tree_unflatten(treedef, out)


def shard_params(params, mesh: Mesh, specs=None, cfg: Optional[LlamaConfig] = None):
    """device_put the param tree with quantization-aware NamedShardings."""
    if specs is None:
        specs = llama_param_specs(cfg, params)
    expanded = expand_specs(params, specs)

    def put(leaf, spec):
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, params, expanded)


def shard_cache(cache, mesh: Mesh, cfg: LlamaConfig):
    specs = cache_specs(cfg)
    return jax.tree_util.tree_map(
        lambda leaf, spec: jax.device_put(leaf, NamedSharding(mesh, spec)),
        cache,
        specs,
    )


def check_divisibility(cfg: LlamaConfig, tp: int, block_size: int = 64) -> None:
    """Validate that quantized sharding divides evenly (fail fast)."""
    hd = cfg.head_dim
    problems = []
    if (cfg.n_heads * hd) % tp:
        problems.append(f"q heads ({cfg.n_heads}) x hd not divisible by tp={tp}")
    if (cfg.n_kv_heads * hd) % tp:
        problems.append(f"kv dim not divisible by tp={tp}")
    if cfg.hidden_dim % tp:
        problems.append(f"hidden_dim {cfg.hidden_dim} % tp")
    for k_dim in (cfg.dim, cfg.hidden_dim):
        if (k_dim // 2) % tp or (k_dim // block_size) % tp:
            problems.append(
                f"row-shard of K={k_dim}: packed rows or scale blocks not divisible by tp={tp}"
            )
    if problems:
        raise ValueError("; ".join(problems))
