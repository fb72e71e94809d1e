"""Profiling + roofline accounting (SURVEY.md §5 tracing/profiling row).

The reference has no profiling subsystem — only wall-clock loops
(/root/reference/example/benchmarks.py:40-45) and CUDA-event timing
(/root/reference/example/model_quantization_example.py:56-62). Here:

  - ``time_fn``: median wall time of a warm call that ends in
    ``block_until_ready`` (JAX returns before the device finishes, so a
    timing without it measures the enqueue).
  - ``matmul_roofline``: bytes-moved / tensor-core-flops accounting for a
    (possibly quantized) matmul against the device's peaks.
  - ``device_spec``: those peaks, one table keyed by ``device_kind``.
  - ``trace``: a jax.profiler trace context.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from typing import Callable

import jax


# --------------------------------------------------------------- device info


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    name: str
    hbm_gbps: float      # device memory bandwidth, GB/s
    bf16_tflops: float   # dense tensor-core peak, bf16
    int8_tops: float     # dense tensor-core peak, int8


# Dense peaks (no sparsity) by jax ``device_kind``. Source: NVIDIA H100
# Tensor Core GPU data sheet, SXM part, at its 700 W limit. A card set to
# a lower power limit cannot hold these rates under a matmul-heavy load.
_DEVICE_TABLE = {
    "NVIDIA H100 80GB HBM3": DeviceSpec("H100 SXM", 3350.0, 989.0, 1979.0),
}


def device_spec(device=None) -> DeviceSpec:
    """Peaks of ``device`` (default: the first device). A DeviceSpec
    passes through, so CPU tests give one explicitly. A device kind that
    is not in the table raises: there is no default device."""
    if isinstance(device, DeviceSpec):
        return device
    device = device or jax.devices()[0]
    kind = getattr(device, "device_kind", str(device))
    if kind not in _DEVICE_TABLE:
        raise KeyError(
            f"no peak table entry for device kind {kind!r}; known: "
            f"{sorted(_DEVICE_TABLE)} (pass a DeviceSpec)")
    return _DEVICE_TABLE[kind]


# ------------------------------------------------------------------- timing


def time_fn(fn: Callable, *args, reps: int = 5, warmup: int = 1) -> float:
    """Median seconds of ``fn(*args)`` after ``warmup`` calls (which
    compile), each timed call ended by ``jax.block_until_ready``."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


# ----------------------------------------------------------------- roofline


@dataclasses.dataclass(frozen=True)
class Roofline:
    flops: int
    bytes: int
    t_compute_s: float   # compute-bound floor (tensor cores)
    t_hbm_s: float       # memory-bound floor (device memory)
    t_roofline_s: float  # max of the two: the speed-of-light time

    def pct(self, measured_s: float) -> float:
        """Percent of roofline achieved by a measured time."""
        return 100.0 * self.t_roofline_s / max(measured_s, 1e-12)


def matmul_roofline(
    m: int,
    k: int,
    n: int,
    *,
    weight_bits: int = 16,
    block_size: int = 0,
    act_bytes: int = 2,
    out_bytes: int = 2,
    scale_bytes: int = 4,
    device=None,
) -> Roofline:
    """Roofline for ``(m,k) @ (k,n)`` with a ``weight_bits`` weight.

    bytes = activations in + packed weight (+ block scales) + output out;
    flops = 2mkn on the tensor cores. The dequant is modeled as compute
    *hidden* behind the weight fetch — the roofline is the bound, not a
    prediction.
    """
    spec = device_spec(device)
    w_bytes = k * n * weight_bits // 8
    s_bytes = (k // block_size) * n * scale_bytes if block_size else 0
    total_bytes = m * k * act_bytes + w_bytes + s_bytes + m * n * out_bytes
    flops = 2 * m * k * n
    t_compute = flops / (spec.bf16_tflops * 1e12)
    t_hbm = total_bytes / (spec.hbm_gbps * 1e9)
    return Roofline(flops, total_bytes, t_compute, t_hbm,
                    max(t_compute, t_hbm))


def decode_step_roofline(cfg, batch: int = 8, weight_bits: int = 16,
                         block_size: int = 0, kv_len: int = 512,
                         kv_bytes: int = 2, device=None) -> Roofline:
    """Whole-decoder single-token roofline: all projections + KV reads."""
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    shapes = [
        (cfg.dim, nh * hd), (cfg.dim, nkv * hd), (cfg.dim, nkv * hd),
        (nh * hd, cfg.dim), (cfg.dim, cfg.hidden_dim),
        (cfg.dim, cfg.hidden_dim), (cfg.hidden_dim, cfg.dim),
    ]
    flops = bytes_ = 0
    for k, n in shapes:
        r = matmul_roofline(batch, k, n, weight_bits=weight_bits,
                            block_size=block_size, device=device)
        flops += r.flops * cfg.n_layers
        bytes_ += r.bytes * cfg.n_layers
    head = matmul_roofline(batch, cfg.dim, cfg.vocab_size,
                           weight_bits=weight_bits, block_size=block_size,
                           device=device)
    flops += head.flops
    bytes_ += head.bytes
    # KV cache read (k+v) per layer + attention flops
    kv = cfg.n_layers * 2 * batch * kv_len * nkv * hd
    bytes_ += kv * kv_bytes
    flops += cfg.n_layers * 2 * 2 * batch * nh * kv_len * hd
    spec = device_spec(device)
    t_compute = flops / (spec.bf16_tflops * 1e12)
    t_hbm = bytes_ / (spec.hbm_gbps * 1e9)
    return Roofline(flops, bytes_, t_compute, t_hbm,
                    max(t_compute, t_hbm))


# -------------------------------------------------------------------- trace


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace of the enclosed block into ``logdir``."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
