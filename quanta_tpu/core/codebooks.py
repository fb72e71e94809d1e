"""Quantization codebooks (NF4 / NF8 / FP4 / FP8 / INT4 / INT8).

Every non-uniform format in this framework is expressed as a *codebook*:
a sorted vector of ``2**bits`` representative values normalized to
``[-1, 1]``. Dequantization is ``codebook[codes] * scale`` where ``scale``
is the per-block absmax; quantization is nearest-level rounding, done with
``searchsorted`` over level midpoints (O(log n) per element instead of the
O(n_levels) distance-matrix blowup of the reference,
/root/reference/Quanta/functional/quantization.py:114-116).

Codebook values mirror the reference's formats:
  - NF4: QLoRA NormalFloat-4 constants
    (/root/reference/Quanta/functional/quantization.py:105-110).
  - NF8: 256 tanh-warped levels ``tanh(linspace(-1,1)*2)`` (ibid.:170-183).
  - FP4: e2m1 (sign / 2-bit exp bias 1 / 1-bit mantissa) representable
    values (ibid.:120-142), absmax-normalized.
  - FP8: e4m3 (sign / 4-bit exp bias 7 / 3-bit mantissa) (ibid.:144-168).
  - INT4/INT8 "dynamic": signed uniform grids, provided as codebooks so the
    same kernel path serves every format.

Polynomial codebooks. A 16-level table lookup costs a select tree per
weight element (4 bit masks + 15 selects) inside a fused dequant-matmul.
A codebook whose levels are *defined* as a low-degree polynomial
evaluated at the code dequantizes in deg() fused multiply-adds instead:

  - "nf4a" (arithmetic NormalFloat-4): levels are a cubic whose
    coefficients were optimized for mean-squared reconstruction error of
    per-block-absmax-normalized N(0,1) data — the same objective NF4's
    quantile construction approximates. Measured MSE 1.143e-3 vs NF4's
    1.294e-3 (block=64): ~12% *better* than NF4, at 3 madds per element.
  - "int4" is the degree-1 special case (levels (c-8)/7; the c=0 slot is
    -8/7, outside [-1,1], so absmax-normalized inputs never produce it).

Kernels evaluate the polynomial with the same float32 Horner recurrence
used to build the level table here, so kernel and oracle agree exactly.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

# QLoRA NormalFloat-4 levels (exact constants used by the reference and
# bitsandbytes). Sorted ascending; index 7 is exactly 0.0.
NF4_LEVELS = np.array(
    [
        -1.0,
        -0.6961928009986877,
        -0.5250730514526367,
        -0.39491748809814453,
        -0.28444138169288635,
        -0.18477343022823334,
        -0.09105003625154495,
        0.0,
        0.07958029955625534,
        0.16093020141124725,
        0.24611230194568634,
        0.33791524171829224,
        0.44070982933044434,
        0.5626170039176941,
        0.7229568362236023,
        1.0,
    ],
    dtype=np.float32,
)


def _nf8_levels() -> np.ndarray:
    """256 tanh-warped levels over [-1, 1] (reference NF8 semantics)."""
    lin = np.linspace(-1.0, 1.0, 256, dtype=np.float64)
    lv = np.tanh(lin * 2.0)
    lv = lv / np.abs(lv).max()
    return lv.astype(np.float32)


def _fp4_levels() -> np.ndarray:
    """e2m1 representable magnitudes, absmax-normalized to [-1, 1].

    Grid: {0, 0.5, 1, 1.5, 2, 3, 4, 6} / 6 in both signs (sign-magnitude,
    so +0 and -0 both exist; we keep 16 entries with a duplicate zero to
    preserve the 4-bit code space).
    """
    mags = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0]) / 6.0
    lv = np.concatenate([-mags[::-1], mags])  # 16 values, one dup zero pair
    return np.sort(lv).astype(np.float32)


def _fp8_e4m3_levels() -> np.ndarray:
    """256-entry e4m3 value table, absmax-normalized (max finite = 448)."""
    vals = []
    for s in (1.0, -1.0):
        for e in range(16):
            for m in range(8):
                if e == 0:  # subnormal
                    v = s * (m / 8.0) * 2.0 ** (-6)
                elif e == 15 and m == 7:  # NaN slot in e4m3fn -> clamp to max
                    v = s * 448.0
                else:
                    v = s * (1.0 + m / 8.0) * 2.0 ** (e - 7)
                vals.append(v)
    lv = np.sort(np.array(vals, dtype=np.float64) / 448.0)
    return lv.astype(np.float32)


def _int_levels(bits: int) -> np.ndarray:
    """Symmetric signed uniform grid as a degree-1 polynomial codebook:
    level(c) = (c - 2^(b-1)) / (2^(b-1) - 1). The c=0 slot evaluates just
    below -1 and is never produced for absmax-normalized inputs."""
    offset = 2.0 ** (bits - 1)
    qmax = offset - 1.0
    return _poly_levels((1.0 / qmax, -offset / qmax), 2**bits)


# Polynomial codebooks: {name: coefficients, highest degree first}. Levels
# are the f32 Horner evaluation at c = 0..2^bits-1 (must be monotone).
# "nf4a" coefficients minimize E[(q(x)-x)^2] for x ~ N(0,1) normalized by
# per-64-block absmax (Nelder-Mead from a least-squares fit to NF4).
POLY_COEFFS: dict[str, tuple] = {
    "nf4a": (
        0.0006303362129204599,
        -0.014194327019966578,
        0.19776771619397554,
        -0.9496551767520744,
    ),
    "int4": (1.0 / 7.0, -8.0 / 7.0),
    "int8": (1.0 / 127.0, -128.0 / 127.0),
}


def _poly_levels(coeffs, n: int) -> np.ndarray:
    """f32 Horner evaluation at c = 0..n-1 (bit-identical to the kernels)."""
    c = np.arange(n, dtype=np.float32)
    out = np.full(n, np.float32(coeffs[0]), np.float32)
    for a in coeffs[1:]:
        out = out * c + np.float32(a)
    return out


_REGISTRY: dict[str, np.ndarray] = {}


def _register(name: str, levels: np.ndarray) -> None:
    assert levels.ndim == 1 and np.all(np.diff(levels) >= 0)
    _REGISTRY[name] = levels


_register("nf4", NF4_LEVELS)
_register("nf4a", _poly_levels(POLY_COEFFS["nf4a"], 16))
_register("nf8", _nf8_levels())
_register("fp4", _fp4_levels())
_register("fp8", _fp8_e4m3_levels())
_register("int4", _int_levels(4))
_register("int8", _int_levels(8))


def codebook_names() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def get_poly_coeffs(name: str):
    """Horner coefficients (highest first) if ``name`` is a polynomial
    codebook, else None. Kernels use these for arithmetic dequant."""
    return POLY_COEFFS.get(name)


def _lut_tree(codes, levels: np.ndarray):
    """16-entry lookup as a binary select tree: 4 bit masks + 15 selects."""
    b0 = (codes & 1) != 0
    b1 = (codes & 2) != 0
    b2 = (codes & 4) != 0
    b3 = (codes & 8) != 0
    lv = [float(v) for v in levels]
    t = [jnp.where(b0, lv[2 * j + 1], lv[2 * j]) for j in range(8)]
    u = [jnp.where(b1, t[2 * j + 1], t[2 * j]) for j in range(4)]
    v = [jnp.where(b2, u[2 * j + 1], u[2 * j]) for j in range(2)]
    return jnp.where(b3, v[1], v[0])


def has_arithmetic_dequant(codebook) -> bool:
    """True when :func:`dequant_codes` needs no table gather for this
    codebook (None is symmetric int8: the codes are the values)."""
    return codebook is None or codebook == "nf8" or (
        codebook in POLY_COEFFS or len(_REGISTRY[codebook]) == 16)


def dequant_codes(codes_i32, codebook):
    """Integer codes -> normalized f32 values: the one dequant rule shared
    by the fused matmul kernel and the plain XLA path.

    Polynomial codebooks run Horner (1 madd per degree), nf8 its defining
    tanh formula, other 16-level tables a select tree; only the 256-level
    tables (fp8) gather, which keeps them off the kernel
    (:func:`has_arithmetic_dequant`)."""
    if codebook is None:  # symmetric int8 / affine: codes ARE the values
        return codes_i32.astype(jnp.float32)
    coeffs = get_poly_coeffs(codebook)
    if coeffs is not None:
        cf = codes_i32.astype(jnp.float32)
        out = jnp.full(cf.shape, np.float32(coeffs[0]), jnp.float32)
        for a in coeffs[1:]:
            out = out * cf + np.float32(a)
        return out
    if codebook == "nf8":  # tanh(2*(2c/255 - 1)) / tanh(2)
        cf = codes_i32.astype(jnp.float32)
        return jnp.tanh((cf * np.float32(2.0 / 255.0) - 1.0) * 2.0) * np.float32(
            1.0 / np.tanh(2.0))
    levels = _REGISTRY[codebook]
    if len(levels) == 16:
        return _lut_tree(codes_i32, levels)
    return jnp.asarray(levels)[codes_i32]


# NOTE: these return fresh jnp constants per call (the numpy master copy is
# module-level). Caching device arrays here would leak tracers when the
# first call happens inside a jit trace.


def get_codebook(name: str) -> jnp.ndarray:
    """Sorted codebook levels, normalized to [-1, 1]."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown codebook {name!r}; have {codebook_names()}")
    return jnp.asarray(_REGISTRY[name])


@functools.lru_cache(maxsize=None)
def _midpoints_np(name: str) -> np.ndarray:
    lv = _REGISTRY[name]
    return (lv[1:] + lv[:-1]) / 2.0


def get_midpoints(name: str) -> jnp.ndarray:
    """Decision boundaries between adjacent codebook levels (len 2^bits-1)."""
    return jnp.asarray(_midpoints_np(name))


def bits_of(name: str) -> int:
    return int(np.log2(len(_REGISTRY[name])))
