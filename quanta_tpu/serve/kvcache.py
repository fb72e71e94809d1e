"""Paged KV cache: fixed page pool + page-table indirection.

The reference has no serving layer at all (SURVEY.md §2.5; its roadmap
stops at module-level quantization). This realizes the north-star serving
requirement (BASELINE.json config 3: continuous batching):

  - one fixed-size page pool per model, shaped
    ``(n_layers, n_pages, page_size, n_kv_heads, head_dim)`` — static
    shapes, so every jitted step compiles exactly once;
  - a ``(n_slots, max_pages_per_slot)`` int32 page table maps each serving
    slot's logical token positions onto physical pages. The table is plain
    host data re-fed every step (tiny), so page allocation is host-side Python
    with zero recompilation;
  - memory is allocated lazily page-by-page as sequences grow, and freed
    when a request completes — device memory use tracks the *actual* token count,
    not n_slots * max_seq_len.

Sharding: pages carry the same head-axis TP sharding as the contiguous
cache (quanta_tpu.parallel.cache_specs) — P(None, None, None, 'model',
None); the page table is replicated.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from quanta_tpu.models.llama import LlamaConfig


def init_pool(
    cfg: LlamaConfig, n_pages: int, page_size: int, kv_quant: bool = False
) -> dict:
    """Allocate the page pool. Page 0 is reserved as the null page that
    unused page-table entries point at (always masked out in attention).

    kv_quant=True stores K/V as int8 codes with one f32 absmax scale per
    (token, kv-head) vector (SURVEY §5 "optionally-quantized KV cache"):
    ~1.9x less KV memory at head_dim 64 (8 + 32/64 bits vs 16 per element),
    and the decode step's pool read — its memory-bound floor — shrinks the same
    factor. Dequantization happens on the gathered (bucketed) slice only.
    """
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    if not kv_quant:
        return {"k": jnp.zeros(shape, cfg.dtype),
                "v": jnp.zeros(shape, cfg.dtype)}
    sshape = shape[:-1]
    return {
        "k": jnp.zeros(shape, jnp.int8),
        "v": jnp.zeros(shape, jnp.int8),
        "k_scale": jnp.zeros(sshape, jnp.float32),
        "v_scale": jnp.zeros(sshape, jnp.float32),
    }


def is_quantized(pool: dict) -> bool:
    return "k_scale" in pool


def quantize_kv(x: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Symmetric int8 per-vector quantization over the trailing head_dim:
    x (..., hd) -> (codes int8 (..., hd), scale f32 (...)). Plain XLA: the
    absmax and round fuse into the surrounding prefill or decode program.
    """
    xf = x.astype(jnp.float32)
    scale = jnp.max(jnp.abs(xf), axis=-1) / 127.0 + 1e-12
    codes = jnp.round(xf / scale[..., None]).astype(jnp.int8)
    return codes, scale


def dequantize_kv(codes: jax.Array, scale: jax.Array, dtype) -> jax.Array:
    return (codes.astype(jnp.float32) * scale[..., None]).astype(dtype)


def gather_layer(pool_l: jax.Array, page_table: jax.Array) -> jax.Array:
    """(n_pages, page, ...) gathered by (n_slots, max_pages) ->
    (n_slots, max_pages*page, ...): each slot's logical KV stream.
    Works for both the KV arrays (..., nkv, hd) and their scales (..., nkv).

    The caller controls the memory traffic here: reads scale with the page_table
    WIDTH, so passing a column-sliced table (engine decode buckets) reads
    only the pages active sequences can actually occupy, not
    max_seq_len/page_size pages per slot."""
    g = pool_l[page_table]  # (S, maxp, page, ...)
    s, mp, pg = g.shape[:3]
    return g.reshape(s, mp * pg, *g.shape[3:])


def write_token(
    pool_l: jax.Array,
    page_table: jax.Array,
    positions: jax.Array,
    kv_new: jax.Array,
    page_size: int,
) -> jax.Array:
    """Scatter one new token's K (or V) per slot into its current page.

    pool_l: (n_pages, page, nkv, hd); positions: (n_slots,) absolute token
    position being written; kv_new: (n_slots, nkv, hd).
    Inactive slots must point at distinct null positions or be masked by
    the caller — here slot i writes unconditionally to its mapped page.
    """
    page_idx = jnp.take_along_axis(
        page_table, (positions // page_size)[:, None], axis=1
    )[:, 0]
    offset = positions % page_size
    return pool_l.at[page_idx, offset].set(kv_new)


def write_token_layer(
    pool_a: jax.Array,
    layer: int,
    page_table: jax.Array,
    positions: jax.Array,
    kv_new: jax.Array,
    page_size: int,
) -> jax.Array:
    """write_token against the FULL stacked pool array (L, n_pages, ...),
    updating layer ``layer`` in place.

    The decode step must use this (not a per-layer list + jnp.stack):
    scattering into the donated full array lowers to an in-place
    dynamic-update-scatter, while rebuilding the stack copies the whole
    pool every step, so decode time would grow with pool capacity instead
    of active tokens.

    unique_indices: active slots each own their page (the allocator never
    double-books), so their targets are unique. Inactive slots all map to
    (null page 0, offset 0) — duplicate targets, but the null page is
    masked out of every attention read, so whichever write wins is
    irrelevant. The hint saves the scatter's combiner pass."""
    page_idx = jnp.take_along_axis(
        page_table, (positions // page_size)[:, None], axis=1
    )[:, 0]
    offset = positions % page_size
    return pool_a.at[layer, page_idx, offset].set(kv_new, unique_indices=True)


@partial(jax.jit, donate_argnums=(0,))
def write_prefill(
    pool: dict, pages: jax.Array, k_seq: jax.Array, v_seq: jax.Array
) -> dict:
    """Write a full prompt's KV into the given pages.

    pages: (n_prompt_pages,) int32 physical page ids.
    k_seq/v_seq: (n_layers, S_pad, nkv, hd) with S_pad == len(pages)*page.
    The pool is donated (in-place scatter in device memory). For a quantized pool the
    prompt KV is int8-quantized per (token, head) vector on the way in.
    """
    n_pages = pages.shape[0]
    L, s_pad, nkv, hd = k_seq.shape
    page = s_pad // n_pages

    def paged(x):
        return x.reshape(L, n_pages, page, *x.shape[2:])

    if not is_quantized(pool):
        return {
            "k": pool["k"].at[:, pages].set(paged(k_seq.astype(pool["k"].dtype))),
            "v": pool["v"].at[:, pages].set(paged(v_seq.astype(pool["v"].dtype))),
        }
    k_codes, k_scale = quantize_kv(k_seq)
    v_codes, v_scale = quantize_kv(v_seq)
    return {
        "k": pool["k"].at[:, pages].set(paged(k_codes)),
        "v": pool["v"].at[:, pages].set(paged(v_codes)),
        "k_scale": pool["k_scale"].at[:, pages].set(paged(k_scale)),
        "v_scale": pool["v_scale"].at[:, pages].set(paged(v_scale)),
    }


@dataclasses.dataclass
class PageAllocator:
    """Host-side free list over physical pages (page 0 reserved as null)."""

    n_pages: int

    def __post_init__(self):
        self._free: List[int] = list(range(self.n_pages - 1, 0, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"KV pool exhausted: need {n} pages, {len(self._free)} free"
            )
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if not 0 < p < self.n_pages:
                raise ValueError(f"bad page id {p}")
        self._free.extend(pages)
