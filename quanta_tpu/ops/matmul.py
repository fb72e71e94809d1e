"""Fused dequant-matmul kernel (Pallas, Triton route) for small-M decode.

Role-equivalent of the reference's (absent) CUDA kernel backend
(/root/reference/Quanta/backends/__init__.py:17-26 imports a package that
does not exist) and the seam identified at
/root/reference/Quanta/functional/tensor_ops.py:72-82, where quantized
matmul is dequant->fp32 GEMM->requant. Here packed weights stay packed in
device memory: each program loads one quant block of codes at a time,
dequantizes it in registers and feeds the tensor cores, so a bf16 copy of
the weight is never written or re-read.

Why a kernel at all: decode at M <= 16 is bound by the bytes read. XLA
turns ``x @ dequant(W)`` into a dequant fusion that writes a dense copy of
W, then a GEMM that reads it back; reading 4-bit codes instead is the
whole gain of the format. Large M (prefill, training) is compute-bound
and stays on XLA's dequant + cuBLAS (ops.use_fused_matmul decides).

Shape of the kernel (one block of the grid, no state shared between
blocks):

  grid = (M tiles, N tiles, K splits). Each program owns an (tm, tn)
  output tile and one contiguous range of quant blocks along K. It loops
  over that range inside the block (``lax.fori_loop``; Triton pipelines
  the loads over _NUM_STAGES stages), unpacks the split_k nibbles, applies the
  block's scale row and runs a bf16 dot into an f32 accumulator. At
  N = 2048 one program per N tile cannot fill the card's SMs, so K is
  split and the (splits, M, N) f32 partials are summed by XLA afterwards.

Layouts (see quanta_tpu.core.packing / codecs.quantize_matmul_weight):
  - 4-bit: codes (K/2, N) uint8 split_k-packed: byte row r holds K-rows
    r (low nibble) and r + K/2 (high nibble). scales (K/B, N) f32.
  - 8-bit: codes (K, N) int8 (symmetric) or uint8 (codebook), same scales.
  K and N are pre-padded by the quantizer (K % 16*block == 0, N % 128 == 0).

The dequant rule is codebooks.dequant_codes, shared with the plain path.
The 256-level fp8 table needs a gather, which Triton does not lower: that
format takes the plain path (kernel_supports).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from quanta_tpu.core import codebooks, codecs
from quanta_tpu.core.qtensor import QuantizedTensor

# Tensor-core dots through Triton need every operand dimension >= 16.
MIN_TILE = 16
# Programs to aim for when splitting K: four waves of the H100's 132 SMs.
_TARGET_PROGRAMS = 528
# Triton software-pipelining depth of the in-block K loop.
_NUM_STAGES = 3
# Warps per program (two were no faster than four in an H100 sweep).
_NUM_WARPS = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


def kernel_supports(qt: QuantizedTensor) -> bool:
    """True when the fused kernel can run this weight: a power-of-two
    block of at least 16 rows, an N padded to 16, and a codebook whose
    dequant is arithmetic (everything but the 256-level fp8 table)."""
    return (
        (qt.packed == "split_k" or qt.bits == 8)
        and _pow2(qt.block_size)
        and qt.block_size >= MIN_TILE
        and qt.codes.shape[-1] % MIN_TILE == 0
        and codebooks.has_arithmetic_dequant(qt.codebook)
    )


def pick_tiles(m: int, n: int, n_blocks: int) -> tuple[int, int, int]:
    """(tm, tn, splits) for an (m, ., n) product over ``n_blocks`` quant
    blocks: the smallest M tile that holds the rows (16 at decode), the
    widest N tile up to 64 that divides N, and K split in powers of two
    until the grid covers about four waves of SMs (a sweep at M=8 on an
    H100: PERF.md "Kernel decisions")."""
    tm = min(64, max(MIN_TILE, 1 << (m - 1).bit_length()))
    tn = next(t for t in (64, 32, 16) if n % t == 0)
    tiles = _cdiv(m, tm) * (n // tn)
    splits = 1
    while (tiles * splits * 2 <= _TARGET_PROGRAMS
           and n_blocks % (splits * 2) == 0
           and n_blocks // (splits * 2) >= 2):
        splits *= 2
    return tm, tn, splits


def _fused_kernel(x_ref, w_ref, s_ref, o_ref, *, codebook, block, packed,
                  blocks_per_split, half_blocks):
    """One (tm, tn) output tile over one K split.

    x_ref (tm, K_pad), w_ref (K_pad/2 or K_pad, tn), s_ref (K_pad/B, tn),
    o_ref (tm, tn) f32 partial for this split."""
    first = pl.program_id(2) * blocks_per_split
    tm, tn = o_ref.shape

    def deq(codes, row):
        return (codebooks.dequant_codes(codes, codebook)
                * s_ref[pl.ds(row, 1), :]).astype(x_ref.dtype)

    def body(i, acc):
        c = first + i
        rows = pl.ds(pl.multiple_of(c * block, block), block)
        codes = w_ref[rows, :].astype(jnp.int32)
        if packed:
            # split_k: low nibble is K-row c*B + r, high nibble is
            # K-row K/2 + c*B + r (scale row half_blocks + c)
            hi_rows = pl.ds(pl.multiple_of((c + half_blocks) * block, block),
                            block)
            acc += jnp.dot(x_ref[:, rows], deq(codes & 0x0F, c),
                           preferred_element_type=jnp.float32)
            acc += jnp.dot(x_ref[:, hi_rows],
                           deq(codes >> 4, c + half_blocks),
                           preferred_element_type=jnp.float32)
        else:
            acc += jnp.dot(x_ref[:, rows], deq(codes, c),
                           preferred_element_type=jnp.float32)
        return acc

    o_ref[...] = jax.lax.fori_loop(
        0, blocks_per_split, body, jnp.zeros((tm, tn), jnp.float32))


@functools.partial(
    jax.jit,
    static_argnames=("codebook", "block", "packed", "interpret", "out_dtype"),
)
def fused_matmul(
    x: jax.Array,
    codes: jax.Array,
    scales: jax.Array,
    *,
    codebook: str | None,
    block: int,
    packed: bool,
    interpret: bool = False,
    out_dtype=None,
) -> jax.Array:
    """``x (M, K) @ W (K_pad, N_pad)`` with W held as blockwise codes.

    codes: (K_pad/2, N_pad) uint8 split_k-packed (``packed``) or
    (K_pad, N_pad) int8/uint8; scales (K_pad/block, N_pad) f32. x may have
    logical K <= K_pad and any M: both are zero-padded here; pick_tiles
    chooses the tiles. Returns (M, N_pad) in out_dtype (x.dtype by
    default)."""
    m, k_dim = x.shape
    k_rows, n = codes.shape
    k_pad = 2 * k_rows if packed else k_rows
    if k_dim > k_pad:
        raise ValueError(f"x K={k_dim} > weight K={k_pad}")
    out_dtype = out_dtype or x.dtype
    n_blocks = k_rows // block  # quant blocks the loop walks (packed rows)
    tm, tn, splits = pick_tiles(m, n, n_blocks)
    m_pad = _cdiv(m, tm) * tm
    x = jnp.pad(x, ((0, m_pad - m), (0, k_pad - k_dim)))

    kernel = functools.partial(
        _fused_kernel, codebook=codebook, block=block, packed=packed,
        blocks_per_split=n_blocks // splits, half_blocks=n_blocks,
    )
    partial = pl.pallas_call(
        kernel,
        grid=(m_pad // tm, n // tn, splits),
        in_specs=[
            pl.BlockSpec((tm, k_pad), lambda i, j, s: (i, 0)),
            pl.BlockSpec((k_rows, tn), lambda i, j, s: (0, j)),
            pl.BlockSpec((k_pad // block, tn), lambda i, j, s: (0, j)),
        ],
        out_specs=pl.BlockSpec((None, tm, tn), lambda i, j, s: (s, i, j)),
        out_shape=jax.ShapeDtypeStruct((splits, m_pad, n), jnp.float32),
        compiler_params=pltriton.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_NUM_STAGES),
        backend="triton",
        interpret=interpret,
        name="quanta_fused_dequant_matmul",
    )(x, codes, scales)
    return partial.sum(axis=0)[:m].astype(out_dtype)


# ----------------------------------------------------------- QT entry point


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _mmq(x: jax.Array, qt: QuantizedTensor, opts: tuple) -> jax.Array:
    kw = dict(opts)
    if not kw.pop("kernel"):
        return x @ codecs.dequantize_matmul_weight(qt).astype(x.dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    out = fused_matmul(
        x2, qt.codes, qt.scale, codebook=qt.codebook, block=qt.block_size,
        packed=qt.packed == "split_k", **kw,
    )
    if qt.scheme == "affine":
        # zero-point term: x @ expand(zp) == blocksum(x) @ zp — a tiny
        # (M, K/B) x (K/B, N) GEMM, so the kernel needs no affine
        # variant (its unsigned codes*scale part ran above). Padded x
        # columns are zero, so padded blocks contribute nothing.
        b = qt.block_size
        k_pad = qt.zero_point.shape[0] * b
        xp = jnp.pad(x2.astype(jnp.float32),
                     ((0, 0), (0, k_pad - x2.shape[1])))
        xb = xp.reshape(xp.shape[0], k_pad // b, b).sum(axis=2)
        out = out + (xb @ qt.zero_point).astype(out.dtype)
    out = out[:, : qt.shape[1]]  # drop N padding
    return out.reshape(*lead, out.shape[-1])


def _mmq_fwd(x, qt, opts):
    return _mmq(x, qt, opts), (x, qt)


def _mmq_bwd(opts, res, g):
    # Quantized weights are frozen codes (QLoRA semantics): only dx flows.
    # dx = g @ W^T runs at training M, which is compute-bound: the plain
    # dequant + GEMM is the right engine there. Only the packed weight is
    # kept for the backward and the dense copy is rebuilt here. The
    # barrier ties that rebuild to g: without it XLA merges it with the
    # forward's dequant (CSE) and keeps every layer's dense weight alive
    # from the forward to the backward.
    x, qt = res
    _, qt = jax.lax.optimization_barrier((g, qt))
    w = codecs.dequantize_matmul_weight(qt).astype(g.dtype)
    dx = (g @ w.T).astype(x.dtype)
    return dx, jax.tree_util.tree_map(jnp.zeros_like, qt)


_mmq.defvjp(_mmq_fwd, _mmq_bwd)


def matmul_quantized(
    x: jax.Array, qt: QuantizedTensor, *, kernel: bool = True,
    interpret: bool = False, out_dtype=None
) -> jax.Array:
    """``x @ dequant(qt)`` through the fused kernel, or with
    ``kernel=False`` through the plain dequant + matmul.

    ``qt`` must be in matmul layout (from core.quantize_matmul_weight), and
    pass kernel_supports for the kernel. Accepts x of any leading batch
    shape; contracts over the last axis. Differentiable in ``x`` (custom
    VJP; weight codes are frozen). ``out_dtype`` is the kernel's output
    dtype (x.dtype by default).
    """
    if kernel and not kernel_supports(qt):
        raise ValueError(
            f"no fused kernel for {qt.codebook or qt.scheme} "
            f"block={qt.block_size} codes {qt.codes.shape}")
    opts = (("kernel", False),)
    if kernel:
        opts = (("interpret", interpret), ("kernel", True),
                ("out_dtype", out_dtype))
    return _mmq(x, qt, opts)
