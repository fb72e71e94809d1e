"""Manual tensor parallelism: shard_map + locally-packed quantized shards.

The GSPMD path (quanta_tpu.parallel.sharding) lets XLA partition the
global unpack/dequant/matmul graph — correct, but the compiler chooses
the collective schedule. This module is the manual alternative promised
by sharding.py's docstring: every device holds a *locally packed* weight
shard (its split_k nibble pairing and scale blocks are entirely local),
the fused dequant-matmul kernel runs on local data only, and the
collectives are explicit:

  - column-parallel (wq/wk/wv/w_gate/w_up, lm_head): weights split along
    N; activations replicated in 'model'; no collective (heads stay
    local through attention).
  - row-parallel (wo, w_down): weights split along K; the partial-sum
    psum is issued per output chunk so XLA's async scheduler overlaps
    chunk i's all-reduce with chunk i+1's dequant-matmul compute.

No distributed layer exists in the reference (SURVEY.md §2.5); the
behavior contract is Megatron TP restated over quantized storage
(SURVEY.md §7 hard part 3: "pack along an axis that divides evenly under
TP, and shard scale blocks consistently").

Resharding: ``from_global`` converts a *global* split_k checkpoint
(core.quantize_matmul_weight layout) into per-device local shards for any
TP width without touching float values — codes are re-paired, never
re-quantized — so a checkpoint saved once serves every mesh shape
(SURVEY.md §5 checkpoint contract).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from quanta_tpu.core import codecs, packing
from quanta_tpu.core.qtensor import QuantizedTensor
from quanta_tpu.models.llama import LlamaConfig, _attention, _rope, rms_norm
from quanta_tpu.nn.linear import linear
from quanta_tpu.ops.matmul import MIN_TILE


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ShardedQuant:
    """A quantized 2-D weight stored as ``tp`` locally-packed shards.

    codes: (tp, k2_local, n_local) uint8 — each shard is an independent
      split_k-packed block (4-bit) or int8/uint8 codes (8-bit, k_local
      rows instead of k2).
    scale: (tp, kb_local, n_local) f32 — per-shard scale blocks.
    axis: 0 = row-parallel (K split), 1 = column-parallel (N split).
    shape: global logical (K, N).
    """

    codes: jax.Array
    scale: jax.Array

    # static, NOT derived from codes.shape[0]: inside shard_map each
    # device sees a leading dim of 1 but local_shape must still divide
    # the global shape by the true TP width.
    tp: int = dataclasses.field(metadata=dict(static=True), default=1)
    fmt: str = dataclasses.field(metadata=dict(static=True), default="nf4")
    bits: int = dataclasses.field(metadata=dict(static=True), default=4)
    block_size: int = dataclasses.field(metadata=dict(static=True), default=64)
    axis: int = dataclasses.field(metadata=dict(static=True), default=1)
    shape: tuple = dataclasses.field(metadata=dict(static=True), default=())
    dtype: str = dataclasses.field(metadata=dict(static=True),
                                   default="bfloat16")

    def local_shape(self) -> tuple:
        k, n = self.shape
        return (
            (k // self.tp, n) if self.axis == 0 else (k, n // self.tp)
        )

    def local_qt(self, codes2d: jax.Array, scale2d: jax.Array) -> QuantizedTensor:
        """Wrap one shard's local arrays as a standard QuantizedTensor."""
        return QuantizedTensor(
            codes=codes2d,
            scale=scale2d,
            zero_point=None,
            bits=self.bits,
            scheme="symmetric" if self.fmt == "int8" else "codebook",
            codebook=None if self.fmt == "int8" else self.fmt,
            shape=self.local_shape(),
            dtype=jnp.dtype(self.dtype),
            block_size=self.block_size,
            packed="split_k" if self.bits == 4 else "none",
        )


def quantize_tp(
    w: jax.Array, tp: int, *, axis: int, fmt: str = "nf4", block_size: int = 64
) -> ShardedQuant:
    """Quantize a dense (K, N) weight into ``tp`` locally-packed shards.

    Supports the fused-kernel QuantizedTensor formats (symmetric /
    codebook). llm_int8 and int4c have global-K structure (calibrated
    outlier rows; split_k nibble pairs with per-column scales) and no
    local re-pairing here — shard those with GSPMD specs instead
    (parallel.sharding support matrix).
    """
    if fmt in ("llm_int8", "int4c"):
        raise ValueError(
            f"manual TP does not support fmt={fmt!r}; use GSPMD sharding "
            "(quanta_tpu.parallel.shard_params) for this format"
        )
    k, n = w.shape
    if w.shape[axis] % tp:
        raise ValueError(f"axis {axis} of {w.shape} not divisible by tp={tp}")
    shards = jnp.split(w, tp, axis=axis)
    qts = [
        codecs.quantize_matmul_weight(s, fmt=fmt, block_size=block_size)
        for s in shards
    ]
    return ShardedQuant(
        codes=jnp.stack([q.codes for q in qts]),
        scale=jnp.stack([q.scale for q in qts]),
        tp=tp,
        fmt=fmt,
        bits=qts[0].bits,
        block_size=block_size,
        axis=axis,
        shape=(k, n),
        dtype=str(jnp.dtype(w.dtype)),
    )


def from_global(
    qt: QuantizedTensor, tp: int, *, axis: int
) -> ShardedQuant:
    """Re-shard a *global* matmul-layout checkpoint to ``tp`` local shards
    without requantizing (codes are re-paired bit-exactly).

    Column split just slices codes+scales along N. Row split must re-pair
    nibbles: global split_k couples rows (k, k+K/2), a local shard couples
    (k, k+K_loc/2) — so unpack, slice, re-pad, re-pack.
    """
    fmt = qt.codebook or "int8"
    block = qt.block_size
    k, n = qt.shape
    if (axis == 0 and k % tp) or (axis == 1 and n % tp):
        raise ValueError(f"shape {qt.shape} axis {axis} not divisible by {tp}")

    if axis == 1:
        n_loc = n // tp
        n_pad_loc = _cdiv(n_loc, 128) * 128
        cs, ss = [], []
        for i in range(tp):
            c = qt.codes[:, i * n_loc : (i + 1) * n_loc]
            s = qt.scale[:, i * n_loc : (i + 1) * n_loc]
            cs.append(jnp.pad(c, ((0, 0), (0, n_pad_loc - n_loc))))
            ss.append(
                jnp.pad(s, ((0, 0), (0, n_pad_loc - n_loc)),
                        constant_values=1.0)
            )
        # K_pad of the global tensor may exceed a shard's requirement but
        # stays tile-aligned; keep it.
        return ShardedQuant(
            codes=jnp.stack(cs), scale=jnp.stack(ss), tp=tp, fmt=fmt,
            bits=qt.bits, block_size=block, axis=1, shape=(k, n),
            dtype=str(jnp.dtype(qt.dtype)),
        )

    # axis == 0: row split with nibble re-pairing
    k_loc = k // tp
    if k_loc % (2 * block):
        raise ValueError(
            f"K/tp={k_loc} must be a multiple of 2*block={2 * block}"
        )
    unit = 16 * block
    k_pad_loc = _cdiv(k_loc, unit) * unit
    if qt.bits == 4:
        codes_full = packing.unpack_split_k(qt.codes)  # (K_pad, N_pad)
    else:
        codes_full = qt.codes
    n_pad = codes_full.shape[1]
    cs, ss = [], []
    for i in range(tp):
        c = codes_full[i * k_loc : (i + 1) * k_loc]
        c = jnp.pad(c, ((0, k_pad_loc - k_loc), (0, 0)))
        if qt.bits == 4:
            c = packing.pack_split_k(c)
        cs.append(c)
        s = qt.scale[i * (k_loc // block) : (i + 1) * (k_loc // block)]
        s = jnp.pad(
            s, ((0, (k_pad_loc - k_loc) // block), (0, 0)), constant_values=1.0
        )
        ss.append(s)
    return ShardedQuant(
        codes=jnp.stack(cs), scale=jnp.stack(ss), tp=tp, fmt=fmt,
        bits=qt.bits, block_size=block, axis=0, shape=(k, n),
        dtype=str(jnp.dtype(qt.dtype)),
    )


def dequantize_tp(sq: ShardedQuant) -> jax.Array:
    """Materialize the dense global weight (test oracle)."""
    outs = []
    for i in range(sq.tp):
        qt = sq.local_qt(sq.codes[i], sq.scale[i])
        outs.append(codecs.dequantize_matmul_weight(qt))
    return jnp.concatenate(outs, axis=sq.axis)


# ------------------------------------------------------------- tp forward


def _local_linear(x, sq: ShardedQuant, use_kernel=None,
                  interpret: bool = False):
    """Local-shard matmul inside shard_map (codes arrive with tp dim 1)."""
    qt = sq.local_qt(sq.codes[0], sq.scale[0])
    return linear(x, qt, use_kernel=use_kernel, interpret=interpret)


def _row_parallel(x, sq: ShardedQuant, use_kernel=None, n_chunks: int = 2,
                  interpret: bool = False):
    """Row-parallel linear: local partial GEMM + chunked psum.

    Chunking the output axis issues one psum per chunk; the chunks'
    all-reduces are independent of the later chunks' matmuls, so the
    async scheduler overlaps communication with dequant-matmul compute.
    """
    n = sq.shape[1]
    # a chunk narrower than the kernel's smallest N tile, or one that
    # does not divide N, falls back to fewer chunks rather than crash
    while n_chunks > 1 and (n % n_chunks or (n // n_chunks) % MIN_TILE):
        n_chunks -= 1
    step = n // n_chunks
    outs = []
    for c in range(n_chunks):
        qt_c = QuantizedTensor(
            codes=sq.codes[0][:, c * step : (c + 1) * step],
            scale=sq.scale[0][:, c * step : (c + 1) * step],
            zero_point=None,
            bits=sq.bits,
            scheme="symmetric" if sq.fmt == "int8" else "codebook",
            codebook=None if sq.fmt == "int8" else sq.fmt,
            shape=(sq.local_shape()[0], step),
            dtype=jnp.dtype(sq.dtype),
            block_size=sq.block_size,
            packed="split_k" if sq.bits == 4 else "none",
        )
        y = linear(x, qt_c, use_kernel=use_kernel, interpret=interpret)
        outs.append(jax.lax.psum(y, axis_name="model"))
    return jnp.concatenate(outs, axis=-1)


def tp_llama_params(
    params: dict, cfg: LlamaConfig, tp: int, *, fmt: str = "nf4",
    block_size: int = 64,
) -> dict:
    """Quantize a dense Llama param tree into locally-packed TP shards
    (Megatron mapping: qkv/gate/up column-split, o/down row-split)."""
    col = dict(axis=1)
    row = dict(axis=0)
    plan = {"wq": col, "wk": col, "wv": col, "wo": row,
            "w_gate": col, "w_up": col, "w_down": row}
    out = {
        "tok_emb": params["tok_emb"],
        "norm_f": params["norm_f"],
        "layers": [],
    }
    for lp in params["layers"]:
        nl = {"attn_norm": lp["attn_norm"], "ffn_norm": lp["ffn_norm"]}
        for name, kw in plan.items():
            nl[name] = quantize_tp(
                lp[name], tp, fmt=fmt, block_size=block_size, **kw
            )
        out["layers"].append(nl)
    if "lm_head" in params:
        out["lm_head"] = quantize_tp(
            params["lm_head"], tp, axis=1, fmt=fmt, block_size=block_size
        )
    return out


def _specs_for(tree):
    """shard_map in_specs matching a tp param tree: ShardedQuant shards on
    'model', dense leaves replicated."""

    def spec(leaf):
        if isinstance(leaf, ShardedQuant):
            return ShardedQuant(
                codes=P("model", None, None),
                scale=P("model", None, None),
                tp=leaf.tp,
                fmt=leaf.fmt,
                bits=leaf.bits,
                block_size=leaf.block_size,
                axis=leaf.axis,
                shape=leaf.shape,
                dtype=leaf.dtype,
            )
        return P()

    return jax.tree_util.tree_map(
        spec, tree, is_leaf=lambda x: isinstance(x, ShardedQuant)
    )


def tp_llama_forward(
    tp_params: dict,
    tokens: jax.Array,
    cfg: LlamaConfig,
    mesh: Mesh,
    *,
    use_kernel=None,
    interpret: bool = False,
):
    """Causal scoring forward under manual shard_map TP.

    tokens: (B, S) int32, batch sharded on 'data'. Returns full logits
    (B, S, V) gathered over the vocab-split lm_head. For KV-cache decode
    under the same manual schedule see :func:`tp_greedy_decode`.
    """
    tp = mesh.shape["model"]
    nh_loc, nkv_loc = cfg.n_heads // tp, cfg.n_kv_heads // tp
    lin = partial(_local_linear, use_kernel=use_kernel, interpret=interpret)
    rowp = partial(_row_parallel, use_kernel=use_kernel, interpret=interpret)

    def fwd(p, toks):
        b, s = toks.shape
        h = jnp.take(p["tok_emb"], toks, axis=0).astype(cfg.dtype)
        q_pos = jax.lax.broadcasted_iota(jnp.int32, (b, s), 1)
        mask = jnp.ones((b, s), bool)

        for lp in p["layers"]:
            x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
            q = lin(x, lp["wq"]).reshape(
                b, s, nh_loc, cfg.head_dim
            )
            k = lin(x, lp["wk"]).reshape(
                b, s, nkv_loc, cfg.head_dim
            )
            v = lin(x, lp["wv"]).reshape(
                b, s, nkv_loc, cfg.head_dim
            )
            q = _rope(q, q_pos, cfg.rope_theta)
            k = _rope(k, q_pos, cfg.rope_theta)
            attn = _attention(q, k, v, q_pos, mask, cfg)
            h = h + rowp(attn.reshape(b, s, -1), lp["wo"])
            x = rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
            gate = lin(x, lp["w_gate"])
            up = lin(x, lp["w_up"])
            act = jax.nn.silu(gate.astype(jnp.float32)).astype(up.dtype) * up
            h = h + rowp(act, lp["w_down"])

        h = rms_norm(h, p["norm_f"], cfg.norm_eps)
        logits_loc = lin(h, p["lm_head"])
        logits = jax.lax.all_gather(
            logits_loc.astype(jnp.float32), "model", axis=2, tiled=True
        )
        return logits

    in_specs = (_specs_for(tp_params), P("data", None))
    fn = jax.shard_map(
        fwd,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=P("data", None, None),
        check_vma=False,
    )
    return fn(tp_params, tokens)


# ------------------------------------------------------- tp cached decode


def tp_init_cache(cfg: LlamaConfig, batch: int, max_len: Optional[int] = None):
    """Global-shape KV cache for manual-TP decode.

    Shapes match models.llama.init_cache; under shard_map the KV-head axis
    (3) is split on 'model' so each device holds only its local heads —
    the head-sharded KV cache of SURVEY §2.5 realized on the manual path.
    """
    max_len = max_len or cfg.max_seq_len
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": jnp.zeros(shape, cfg.dtype),
        "v": jnp.zeros(shape, cfg.dtype),
        "pos": jnp.zeros((batch,), jnp.int32),
    }


def _cache_specs_tp():
    return {
        "k": P(None, "data", None, "model", None),
        "v": P(None, "data", None, "model", None),
        "pos": P("data"),
    }


def _fwd_cached_local(p, toks, cache, cfg: LlamaConfig, tp: int,
                      use_kernel=None, interpret: bool = False):
    """Per-device cached forward body (runs inside shard_map).

    Mirrors models.llama.forward's cache path with local head counts:
    wq/wk/wv are column-split so q/k/v and the KV cache slices are local;
    attention never crosses devices; wo/w_down issue chunked psums.
    """
    b, s = toks.shape
    nh_loc, nkv_loc = cfg.n_heads // tp, cfg.n_kv_heads // tp

    h = jnp.take(p["tok_emb"], toks, axis=0).astype(cfg.dtype)
    start = cache["pos"]
    q_pos = start[:, None] + jax.lax.broadcasted_iota(jnp.int32, (b, s), 1)
    t = cache["k"].shape[2]
    kv_positions = jax.lax.broadcasted_iota(jnp.int32, (b, t), 1)
    kv_len_mask = kv_positions < (start[:, None] + s)
    k_cache, v_cache = cache["k"], cache["v"]
    lin = partial(_local_linear, use_kernel=use_kernel, interpret=interpret)
    rowp = partial(_row_parallel, use_kernel=use_kernel, interpret=interpret)

    loc_cfg = dataclasses.replace(cfg, n_heads=nh_loc, n_kv_heads=nkv_loc)

    for i, lp in enumerate(p["layers"]):
        x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        q = lin(x, lp["wq"]).reshape(
            b, s, nh_loc, cfg.head_dim
        )
        k = lin(x, lp["wk"]).reshape(
            b, s, nkv_loc, cfg.head_dim
        )
        v = lin(x, lp["wv"]).reshape(
            b, s, nkv_loc, cfg.head_dim
        )
        q = _rope(q, q_pos, cfg.rope_theta)
        k = _rope(k, q_pos, cfg.rope_theta)

        def upd(buf, new):
            def one(row_buf, row_new, pos):
                return jax.lax.dynamic_update_slice_in_dim(
                    row_buf, row_new, pos, axis=0
                )

            return jax.vmap(one)(buf, new, start)

        k_all = upd(k_cache[i], k)
        v_all = upd(v_cache[i], v)
        k_cache = k_cache.at[i].set(k_all)
        v_cache = v_cache.at[i].set(v_all)
        attn = _attention(q, k_all, v_all, q_pos, kv_len_mask, loc_cfg)

        h = h + rowp(attn.reshape(b, s, -1), lp["wo"])
        x = rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
        gate = lin(x, lp["w_gate"])
        up = lin(x, lp["w_up"])
        act = jax.nn.silu(gate.astype(jnp.float32)).astype(up.dtype) * up
        h = h + rowp(act, lp["w_down"])

    h = rms_norm(h, p["norm_f"], cfg.norm_eps)
    logits_loc = lin(h, p["lm_head"])
    logits = jax.lax.all_gather(
        logits_loc.astype(jnp.float32), "model", axis=2, tiled=True
    )
    new_cache = {"k": k_cache, "v": v_cache, "pos": start + s}
    return logits, new_cache


def tp_llama_forward_cached(
    tp_params: dict,
    tokens: jax.Array,
    cfg: LlamaConfig,
    mesh: Mesh,
    cache: dict,
    *,
    use_kernel=None,
    interpret: bool = False,
):
    """One cached forward (prefill when S>1, decode when S==1) under
    manual shard_map TP. Returns (logits (B, S, V), new_cache)."""
    tp = mesh.shape["model"]
    fn = jax.shard_map(
        partial(_fwd_cached_local, cfg=cfg, tp=tp, use_kernel=use_kernel,
                interpret=interpret),
        mesh=mesh,
        in_specs=(_specs_for(tp_params), P("data", None), _cache_specs_tp()),
        out_specs=(P("data", None, None), _cache_specs_tp()),
        check_vma=False,
    )
    return fn(tp_params, tokens, cache)


def tp_greedy_decode(
    tp_params: dict,
    prompt: jax.Array,
    cfg: LlamaConfig,
    mesh: Mesh,
    max_new_tokens: int = 32,
    *,
    use_kernel=None,
    interpret: bool = False,
) -> jax.Array:
    """Greedy generation entirely under manual shard_map TP: one shard_map
    spans prefill + the lax.scan decode loop, so the per-step collectives
    are exactly one psum per row-parallel chunk plus the lm_head gather —
    no re-entry overhead per token. Mirrors models.llama.greedy_decode.
    """
    b, s = prompt.shape
    tp = mesh.shape["model"]
    cache = tp_init_cache(cfg, b, max_len=s + max_new_tokens)

    def run(p, prompt_toks, cache0):
        logits, cache1 = _fwd_cached_local(
            p, prompt_toks, cache0, cfg=cfg, tp=tp, use_kernel=use_kernel,
            interpret=interpret,
        )
        next_tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)

        def step(carry, _):
            c, tok = carry
            lg, c = _fwd_cached_local(
                p, tok[:, None], c, cfg=cfg, tp=tp, use_kernel=use_kernel,
                interpret=interpret,
            )
            nxt = jnp.argmax(lg[:, -1, :], axis=-1).astype(jnp.int32)
            return (c, nxt), tok

        _, toks = jax.lax.scan(
            step, (cache1, next_tok), None, length=max_new_tokens
        )
        return jnp.moveaxis(toks, 0, 1)

    fn = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(_specs_for(tp_params), P("data", None), _cache_specs_tp()),
        out_specs=P("data", None),
        check_vma=False,
    )
    out = fn(tp_params, prompt, cache)
    return jnp.concatenate([prompt, out], axis=1)
