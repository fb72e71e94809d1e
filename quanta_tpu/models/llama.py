"""Llama-family decoder, functional JAX (flagship model of the framework).

No analogue exists in the reference (its only model is a demo ConvNet,
/root/reference/example/model_quantization_example.py:10-29); this model
realizes the north-star serving configs (TinyLlama-1.1B / Llama-2-7B/13B,
BASELINE.json). Design:

  - params are a plain pytree; each projection goes through
    quanta_tpu.nn.linear, so quantization is a tree transform and any leaf
    may be dense / QuantizedTensor / Int8Weight / LoRAWeight;
  - static shapes everywhere: fixed-capacity KV cache + position scalars,
    so prefill and decode jit once each;
  - layers run in a Python loop (static unroll keeps per-layer weights
    2-D and independently quantizable / shardable).

Weight layout convention: all linears are (in_features, out_features),
i.e. y = x @ W — column-sharded heads live on the output axis of wq/wk/wv
and the input axis of wo (Megatron TP mapping, see quanta_tpu.parallel).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp

from quanta_tpu import ops
from quanta_tpu.nn.linear import linear
from quanta_tpu.ops.attention import causal_attention


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    hidden_dim: int = 11008
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_seq_len: int = 2048
    tie_embeddings: bool = False
    dtype: Any = jnp.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """CPU-testable config."""
        d = dict(
            vocab_size=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
            hidden_dim=256, max_seq_len=128,
        )
        d.update(kw)
        return LlamaConfig(**d)

    @staticmethod
    def tinyllama_1b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=32000, dim=2048, n_layers=22, n_heads=32, n_kv_heads=4,
            hidden_dim=5632, max_seq_len=2048,
        )

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama2_13b() -> "LlamaConfig":
        return LlamaConfig(
            dim=5120, n_layers=40, n_heads=40, n_kv_heads=40, hidden_dim=13824
        )


def init_params(rng: jax.Array, cfg: LlamaConfig) -> dict:
    """Random-init param pytree (layout documented in the module docstring)."""
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    keys = iter(jax.random.split(rng, 4 + 7 * cfg.n_layers))

    def dense(key, shape, scale=None):
        scale = scale or (1.0 / jnp.sqrt(shape[0]))
        return (jax.random.normal(key, shape, jnp.float32) * scale).astype(cfg.dtype)

    params = {
        "tok_emb": dense(next(keys), (cfg.vocab_size, cfg.dim), scale=0.02),
        "norm_f": jnp.ones((cfg.dim,), cfg.dtype),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append(
            {
                "attn_norm": jnp.ones((cfg.dim,), cfg.dtype),
                "wq": dense(next(keys), (cfg.dim, nh * hd)),
                "wk": dense(next(keys), (cfg.dim, nkv * hd)),
                "wv": dense(next(keys), (cfg.dim, nkv * hd)),
                "wo": dense(next(keys), (nh * hd, cfg.dim)),
                "ffn_norm": jnp.ones((cfg.dim,), cfg.dtype),
                "w_gate": dense(next(keys), (cfg.dim, cfg.hidden_dim)),
                "w_up": dense(next(keys), (cfg.dim, cfg.hidden_dim)),
                "w_down": dense(next(keys), (cfg.hidden_dim, cfg.dim)),
            }
        )
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(next(keys), (cfg.dim, cfg.vocab_size), scale=0.02)
    return params


def rms_norm(x: jax.Array, w: jax.Array, eps: float) -> jax.Array:
    x32 = x.astype(jnp.float32)
    rms = jax.lax.rsqrt(jnp.mean(x32 * x32, axis=-1, keepdims=True) + eps)
    return (x32 * rms).astype(x.dtype) * w


def _rope(x: jax.Array, positions: jax.Array, theta: float) -> jax.Array:
    """Rotary embedding. x: (B, S, H, hd); positions: (B, S) int32."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (jnp.arange(0, hd, 2, dtype=jnp.float32) / hd))
    angles = positions[..., None].astype(jnp.float32) * freqs  # (B, S, hd/2)
    cos = jnp.cos(angles)[:, :, None, :]
    sin = jnp.sin(angles)[:, :, None, :]
    x1, x2 = jnp.split(x.astype(jnp.float32), 2, axis=-1)
    out = jnp.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], axis=-1)
    return out.astype(x.dtype)


def init_cache(cfg: LlamaConfig, batch: int, max_len: Optional[int] = None) -> dict:
    """Fixed-capacity KV cache (static shapes: jit compiles once)."""
    max_len = max_len or cfg.max_seq_len
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": jnp.zeros(shape, cfg.dtype),
        "v": jnp.zeros(shape, cfg.dtype),
        "pos": jnp.zeros((batch,), jnp.int32),
    }


def _attention(q, k, v, q_positions, kv_len_mask, cfg):
    """Causal GQA attention with explicit masks (cache-aware).

    q: (B, S, nh, hd); k/v: (B, T, nkv, hd) where T is cache capacity or S.
    kv_len_mask: (B, T) bool — True where the cache slot holds a real token.
    q_positions: (B, S) absolute positions of the query tokens.

    Query heads are grouped by their shared KV head and contracted with
    grouped einsums — K/V are never materialized per-query-head (a
    ``jnp.repeat`` here would stream rep x the whole KV cache through HBM
    every decode step, which dominated the round-1 step time).
    """
    b, s, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    rep = nh // nkv
    qg = q.reshape(b, s, nkv, rep, hd)

    scores = jnp.einsum("bsgrd,btgd->bgrst", qg, k).astype(jnp.float32)
    scores = scores / jnp.sqrt(hd).astype(jnp.float32)

    kv_positions = jax.lax.broadcasted_iota(jnp.int32, (b, t), 1)
    causal = q_positions[:, :, None] >= kv_positions[:, None, :]  # (B, S, T)
    valid = causal & kv_len_mask[:, None, :]
    scores = jnp.where(valid[:, None, None, :, :], scores, -1e30)
    probs = jax.nn.softmax(scores, axis=-1).astype(q.dtype)
    out = jnp.einsum("bgrst,btgd->bsgrd", probs, v)
    return out.reshape(b, s, nh, hd)


def forward(
    params: dict,
    tokens: jax.Array,
    cfg: LlamaConfig,
    cache: Optional[dict] = None,
    *,
    cache_empty: bool = False,
    use_kernel=None,
    interpret: bool = False,
):
    """Run the decoder.

    tokens: (B, S) int32. Without a cache: plain causal forward (training /
    scoring). With a cache: tokens are appended at ``cache['pos']`` and an
    updated cache is returned (prefill when S>1, decode when S==1).
    ``cache_empty`` (static) promises that every row's ``cache['pos']`` is
    0, as after init_cache.

    A prefill from position 0 (no cache, an empty one, or one exactly S
    long, which can only start at 0) attends over its own S keys, not
    the cache's capacity. Attention takes the route ops.attention_impl
    picks: cuDNN's fused attention for such sequences when long and bf16,
    the plain _attention everywhere else.

    Returns (logits (B, S, V), new_cache | None).
    """
    b, s = tokens.shape
    lin = partial(linear, use_kernel=use_kernel, interpret=interpret)
    from_zero = s > 1 and (cache is None or cache_empty
                           or cache["k"].shape[2] == s)
    impl = ops.attention_impl(s, cfg.dtype, from_zero)
    h = jnp.take(params["tok_emb"], tokens, axis=0).astype(cfg.dtype)

    if cache is not None:
        start = cache["pos"]  # (B,)
        q_positions = start[:, None] + jax.lax.broadcasted_iota(
            jnp.int32, (b, s), 1
        )
        t = cache["k"].shape[2]
        kv_positions = jax.lax.broadcasted_iota(jnp.int32, (b, t), 1)
        kv_len_mask = kv_positions < (start[:, None] + s)
        # carry the stacked cache arrays and update layer slices in place
        # (.at[i].set on a carried buffer; a per-layer list + jnp.stack
        # would copy the whole cache every step)
        k_cache, v_cache = cache["k"], cache["v"]
    else:
        q_positions = jax.lax.broadcasted_iota(jnp.int32, (b, s), 1)
        kv_len_mask = jnp.ones((b, s), bool)

    if from_zero:
        kv_len_mask = jnp.ones((b, s), bool)

    def attend(q, k_all, v_all):
        if impl is not None:
            return causal_attention(q, k_all, v_all, implementation=impl)
        return _attention(q, k_all, v_all, q_positions, kv_len_mask, cfg)

    for i, lp in enumerate(params["layers"]):
        x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        q = lin(x, lp["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
        k = lin(x, lp["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        v = lin(x, lp["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        q = _rope(q, q_positions, cfg.rope_theta)
        k = _rope(k, q_positions, cfg.rope_theta)

        if cache is not None:
            # write new kv at each row's position (per-row dynamic slice)
            def upd(buf, new):
                def one(row_buf, row_new, p):
                    return jax.lax.dynamic_update_slice_in_dim(
                        row_buf, row_new, p, axis=0
                    )

                return jax.vmap(one)(buf, new, cache["pos"])

            k_all = upd(k_cache[i], k)
            v_all = upd(v_cache[i], v)
            k_cache = k_cache.at[i].set(k_all)
            v_cache = v_cache.at[i].set(v_all)
            attn = attend(q, k, v) if from_zero else attend(q, k_all, v_all)
        else:
            attn = attend(q, k, v)

        h = h + lin(attn.reshape(b, s, -1), lp["wo"])
        x = rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
        gate = lin(x, lp["w_gate"])
        up = lin(x, lp["w_up"])
        h = h + lin(jax.nn.silu(gate.astype(jnp.float32)).astype(up.dtype) * up, lp["w_down"])

    h = rms_norm(h, params["norm_f"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = lin(h, params["tok_emb"].T)
    else:
        logits = lin(h, params["lm_head"])
    logits = logits.astype(jnp.float32)

    if cache is not None:
        new_cache = {"k": k_cache, "v": v_cache, "pos": cache["pos"] + s}
        return logits, new_cache
    return logits, None


def greedy_decode(
    params: dict,
    prompt: jax.Array,
    cfg: LlamaConfig,
    max_new_tokens: int = 32,
    *,
    use_kernel=None,
    interpret: bool = False,
) -> jax.Array:
    """Greedy generation: jit-compiled prefill + lax.scan decode loop."""
    b, s = prompt.shape
    cache = init_cache(cfg, b, max_len=s + max_new_tokens)

    fwd = partial(forward, cfg=cfg, use_kernel=use_kernel, interpret=interpret)
    logits, cache = fwd(params, prompt, cache=cache, cache_empty=True)
    next_tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)

    def step(carry, _):
        cache, tok = carry
        logits, cache = fwd(params, tok[:, None], cache=cache)
        nxt = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)
        return (cache, nxt), tok

    # scan emits the carried token each step: toks = [t0 .. t_{n-1}], the n
    # generated tokens (the final carry token t_n is not part of the output).
    _, toks = jax.lax.scan(step, (cache, next_tok), None, length=max_new_tokens)
    out = jnp.moveaxis(toks, 0, 1)  # (B, max_new_tokens)
    return jnp.concatenate([prompt, out], axis=1)
