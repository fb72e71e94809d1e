"""Activation calibration: stats collection, range reduction, fake-quant.

Behavior contract from the reference (implemented here for real; there the
hooks exist but `calibrate()` crashes on an undefined method,
/root/reference/Quanta/functional/model.py:366):

  - activation-stats hooks per layer: running min/max + a 256-bin
    histogram (`functional/model.py:120-135`);
  - calibration reductions minmax / entropy / percentile
    (`functional/model.py:137-194`);
  - activation fake-quant applied at layer inputs when the config says
    ``weights_only=False`` (`functional/model.py:196-246`).

Mechanism: PyTorch forward-hooks don't exist in functional JAX,
so stats collection is a *pytree transform* + *traced outputs* instead:

  1. ``add_taps(params)`` wraps each 2-D weight leaf in a ``TapWeight``
     carrying its tree path;
  2. ``quanta_tpu.nn.linear`` sees the wrapper and records statistics of
     its input activation into a trace-local buffer;
  3. ``collect_stats`` jits the model forward so the buffer's tracers
     become ordinary outputs — stats come back as device arrays, batched
     and merged on host. Two passes, like any honest histogram calibrator:
     pass 1 finds (min, max, per-feature absmax), pass 2 fills 256-bin
     histograms over the fixed pass-1 range.

Consumers:
  - LLM.int8() outlier selection: per-feature ``colmax`` feeds
    ``quantize_int8_weight(calib_colmax=...)`` (ops/int8mm.py);
  - activation fake-quant: ``ActQuantWeight`` wraps any weight leaf with a
    calibrated (lo, hi) so ``linear`` quantizes the incoming activation;
  - weight-range calibration: ``weight_clip_range`` applies the same
    reductions to a weight's own distribution (used by
    state.QuantizationState when calibration != minmax).
"""

from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from typing import Callable, Dict, Iterable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Histogram resolution. Must be >> the largest quant level count (256 for
# 8-bit) or entropy calibration degenerates (rebinning N bins to N levels
# is the identity, KL == 0 at zero trim). TensorRT uses 2048 for 128
# levels; 2048 gives 8x oversampling at 8-bit.
_NBINS = 2048


# ------------------------------------------------------------- tap wrapper


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TapWeight:
    """A weight leaf instrumented to record its input-activation stats."""

    w: jax.Array
    name: str = dataclasses.field(metadata=dict(static=True), default="")


class _TapState(threading.local):
    def __init__(self):
        self.active = False
        self.phase = "minmax"
        self.bounds: Dict[str, Tuple[jax.Array, jax.Array]] = {}
        self.buf: Dict[str, Dict[str, jax.Array]] = {}


_tap = _TapState()


@contextmanager
def taping(phase: str = "minmax", bounds=None):
    """Activate stat recording for the duration of one (traced) forward."""
    _tap.active, _tap.phase = True, phase
    _tap.bounds, _tap.buf = bounds or {}, {}
    try:
        yield _tap.buf
    finally:
        _tap.active = False


def tap_record(name: str, x: jax.Array) -> None:
    """Called by nn.linear when it hits a TapWeight under an active tap."""
    if not _tap.active:
        return
    x2 = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
    rec = {
        "amin": jnp.min(x2),
        "amax": jnp.max(x2),
        "colmax": jnp.max(jnp.abs(x2), axis=0),
    }
    if _tap.phase == "hist":
        lo, hi = _tap.bounds[name]
        width = jnp.maximum(hi - lo, 1e-12)
        idx = jnp.clip(
            ((x2 - lo) / width * _NBINS).astype(jnp.int32), 0, _NBINS - 1
        )
        rec["hist"] = (
            jnp.zeros((_NBINS,), jnp.int32).at[idx.ravel()].add(1)
        )
    prev = _tap.buf.get(name)
    if prev is not None:  # same weight used twice in one forward: merge
        rec["amin"] = jnp.minimum(rec["amin"], prev["amin"])
        rec["amax"] = jnp.maximum(rec["amax"], prev["amax"])
        rec["colmax"] = jnp.maximum(rec["colmax"], prev["colmax"])
        if "hist" in rec:
            rec["hist"] = rec["hist"] + prev["hist"]
    _tap.buf[name] = rec


def _path_name(path) -> str:
    return "/".join(
        str(getattr(p, "name", getattr(p, "key", getattr(p, "idx", ""))))
        for p in path
    )


def default_tap_predicate(path, leaf) -> bool:
    name = _path_name(path)
    return (
        isinstance(leaf, jax.Array)
        and leaf.ndim == 2
        and jnp.issubdtype(leaf.dtype, jnp.floating)
        and "emb" not in name
        and "wte" not in name
        and "wpe" not in name
    )


def add_taps(params, predicate: Optional[Callable] = None):
    """Wrap matching weight leaves in TapWeight (names = tree paths)."""
    pred = predicate or default_tap_predicate

    def wrap(path, leaf):
        if pred(path, leaf):
            return TapWeight(w=leaf, name=_path_name(path))
        return leaf

    return jax.tree_util.tree_map_with_path(wrap, params)


# -------------------------------------------------------- stats collection


@dataclasses.dataclass
class ActivationStats:
    """Merged calibration statistics for one layer input."""

    amin: float
    amax: float
    colmax: np.ndarray  # (K,) per-feature absmax
    hist: np.ndarray  # (256,) counts over [amin, amax]

    @property
    def edges(self) -> np.ndarray:
        return np.linspace(self.amin, self.amax, _NBINS + 1)


def collect_stats(
    forward: Callable, params, batches: Iterable, *, histogram: bool = True
) -> Dict[str, ActivationStats]:
    """Run ``forward(tapped_params, batch)`` over calibration batches and
    return merged per-layer activation statistics.

    ``forward`` must call quanta_tpu.nn.linear for its projections (any
    model in quanta_tpu.models qualifies). Two jitted passes over the same
    batches; batches must share a shape (one compile per pass).
    """
    tapped = add_taps(params)
    batches = list(batches)

    @jax.jit
    def pass_minmax(p, batch):
        with taping("minmax") as buf:
            forward(p, batch)
        return buf

    merged: Dict[str, Dict[str, np.ndarray]] = {}
    for batch in batches:
        out = jax.device_get(pass_minmax(tapped, batch))
        for name, rec in out.items():
            m = merged.setdefault(
                name,
                {"amin": np.inf, "amax": -np.inf, "colmax": 0.0},
            )
            m["amin"] = np.minimum(m["amin"], rec["amin"])
            m["amax"] = np.maximum(m["amax"], rec["amax"])
            m["colmax"] = np.maximum(m["colmax"], rec["colmax"])

    hists = {n: np.zeros(_NBINS, np.int64) for n in merged}
    if histogram:
        bounds = {
            n: (jnp.float32(m["amin"]), jnp.float32(m["amax"]))
            for n, m in merged.items()
        }

        @jax.jit
        def pass_hist(p, batch):
            with taping("hist", bounds) as buf:
                forward(p, batch)
            return {n: r["hist"] for n, r in buf.items()}

        for batch in batches:
            out = jax.device_get(pass_hist(tapped, batch))
            for name, h in out.items():
                hists[name] += h.astype(np.int64)

    return {
        n: ActivationStats(
            amin=float(m["amin"]),
            amax=float(m["amax"]),
            colmax=np.asarray(m["colmax"]),
            hist=hists[n],
        )
        for n, m in merged.items()
    }


# --------------------------------------------------------- range reduction


def _percentile_range(
    hist: np.ndarray, edges: np.ndarray, lo_pct: float, hi_pct: float
) -> Tuple[float, float]:
    cdf = np.cumsum(hist) / max(hist.sum(), 1)
    lo_idx = int(np.searchsorted(cdf, lo_pct / 100.0))
    hi_idx = int(np.searchsorted(cdf, hi_pct / 100.0))
    hi_idx = max(hi_idx, lo_idx + 1)
    return float(edges[lo_idx]), float(edges[min(hi_idx + 1, len(edges) - 1)])


def _entropy_range(
    hist: np.ndarray, edges: np.ndarray, bits: int
) -> Tuple[float, float]:
    """KL-divergence-minimizing clip threshold (the TensorRT algorithm).

    Works on the |x| histogram (signed bins folded about zero), with the
    left edge pinned at 0: candidate thresholds T sweep the right edge
    only, clamped-out mass folds into the last kept bin, and each
    candidate's reference distribution is compared against itself
    re-binned to 2**bits levels. Returns the symmetric range (-T, T)
    intersected with the observed [amin, amax]. The reference's
    'entropy' was a fixed 99.9% CDF cut (functional/model.py:159-170);
    this is the real thing.
    """
    levels = 2**bits
    total = int(hist.sum())
    if total == 0 or len(hist) < 4 * levels:  # too coarse: degenerate
        return float(edges[0]), float(edges[-1])

    # fold signed histogram about zero into an |x| histogram — at FULL
    # bin resolution (nabs == len(hist)): the KL sweep needs several
    # histogram bins per quantization level to discriminate (TensorRT
    # uses 2048 bins for 128 levels)
    centers = (edges[:-1] + edges[1:]) / 2
    abs_max = max(abs(float(edges[0])), abs(float(edges[-1])))
    nabs = len(hist)
    abs_idx = np.minimum(
        (np.abs(centers) / abs_max * nabs).astype(int), nabs - 1
    )
    ahist = np.zeros(nabs, np.float64)
    np.add.at(ahist, abs_idx, hist.astype(np.float64))
    awidth = abs_max / nabs

    best_i, best_kl = nabs, np.inf
    # start where quantization actually smears (>= 2 bins/level): at
    # i == levels each level maps to exactly one bin, q == p and
    # KL == 0 identically — a degenerate argmin that silently pinned
    # every threshold at the smallest candidate (found r5: every tensor
    # came back with T == amax * levels/nabs)
    for i in range(2 * levels, nabs + 1, 4):
        p = ahist[:i].copy()
        p[-1] += ahist[i:].sum()  # clamp outliers into the last kept bin
        splits = np.array_split(p, levels)
        q = np.concatenate(
            [np.full(len(s), s.sum() / max(len(s), 1)) for s in splits]
        )
        mask = p > 0
        pp = p[mask] / p.sum()
        qq = np.maximum(q[mask], 1e-12)
        qq = qq / qq.sum()
        kl = float(np.sum(pp * np.log(pp / qq)))
        if kl < best_kl:
            best_kl, best_i = kl, i
    t = best_i * awidth
    return max(-t, float(edges[0])), min(t, float(edges[-1]))


def reduce_range(
    stats: ActivationStats, method: str = "minmax", bits: int = 8,
    percentile: Tuple[float, float] = (0.1, 99.9),
) -> Tuple[float, float]:
    """Reduce collected stats to a quantization range (lo, hi).

    percentile: (lo, hi) clip percentiles for method="percentile" —
    configurable (QuantConfig.percentile) because the right clip is
    model-dependent: the reference pinned 1-99
    (/root/reference/Quanta/functional/model.py:176-193), which clips
    2% of activation mass; our default keeps 99.8%.
    """
    if method == "minmax":
        return stats.amin, stats.amax
    if method == "percentile":
        return _percentile_range(stats.hist, stats.edges, *percentile)
    if method == "entropy":
        return _entropy_range(stats.hist, stats.edges, bits)
    raise ValueError(f"unknown calibration method {method!r}")


def weight_clip_range(
    w: jax.Array, method: str = "minmax", bits: int = 8
) -> Tuple[float, float]:
    """Apply a calibration reduction to a weight's own distribution."""
    wf = np.asarray(jax.device_get(w), np.float32).ravel()
    lo, hi = float(wf.min()), float(wf.max())
    if method == "minmax":
        return lo, hi
    hist, edges = np.histogram(wf, bins=_NBINS, range=(lo, hi))
    st = ActivationStats(amin=lo, amax=hi, colmax=np.zeros(1), hist=hist)
    return reduce_range(st, method, bits)


# ------------------------------------------------------ activation quant


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ActQuantWeight:
    """Wraps any weight leaf; fake-quantizes the incoming activation to
    ``bits`` over the calibrated range before the matmul (the reference's
    forward-pre-hook, functional/model.py:196-246)."""

    w: object  # jax.Array | QuantizedTensor | Int8Weight | LoRAWeight
    lo: jax.Array  # f32 scalar
    hi: jax.Array  # f32 scalar
    bits: int = dataclasses.field(metadata=dict(static=True), default=8)


def fake_quant(x: jax.Array, lo, hi, bits: int) -> jax.Array:
    """Affine fake-quant of activations over [lo, hi]."""
    qmax = 2**bits - 1
    lo = jnp.minimum(lo, 0.0)  # range must include 0 (exact zero point)
    hi = jnp.maximum(hi, 1e-12)
    scale = (hi - lo) / qmax
    q = jnp.clip(jnp.round((x.astype(jnp.float32) - lo) / scale), 0, qmax)
    return (q * scale + lo).astype(x.dtype)


def apply_activation_quant(
    params,
    ranges: Dict[str, Tuple[float, float]],
    *,
    bits: int = 8,
):
    """Wrap weight leaves named in ``ranges`` with ActQuantWeight."""
    from quanta_tpu.core.qtensor import QuantizedTensor
    from quanta_tpu.nn.lora import LoRAWeight
    from quanta_tpu.ops.int8mm import Int8Weight

    def is_leaf(x):
        return isinstance(x, (QuantizedTensor, Int8Weight, LoRAWeight))

    def wrap(path, leaf):
        name = _path_name(path)
        if name in ranges:
            lo, hi = ranges[name]
            return ActQuantWeight(
                w=leaf,
                lo=jnp.float32(lo),
                hi=jnp.float32(hi),
                bits=bits,
            )
        return leaf

    return jax.tree_util.tree_map_with_path(wrap, params, is_leaf=is_leaf)
