"""The dispatch policy, the fused kernel wrapper's tiles and padding, the
device peak table, the compile-cache directory, and the entry points'
behaviour without a GPU."""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quanta_tpu import compile_cache, core, ops
from quanta_tpu.ops import matmul as mm

ROOT = Path(__file__).resolve().parent.parent
# the module (quanta_tpu.nn re-exports the function under the same name)
linear_mod = importlib.import_module("quanta_tpu.nn.linear")


def _qt(fmt="nf4", k=256, n=192, block=64):
    w = jax.random.normal(jax.random.PRNGKey(0), (k, n), jnp.float32)
    return core.quantize_matmul_weight(w, fmt=fmt, block_size=block)


def _on(monkeypatch, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)


def test_policy_cpu_picks_plain(monkeypatch):
    qt = _qt()
    assert not ops.use_fused_matmul(1, qt)
    assert ops.attention_impl(4096, jnp.bfloat16, from_zero=True) is None
    calls = []
    monkeypatch.setattr(linear_mod, "matmul_quantized",
                        lambda x, w, **kw: calls.append(kw["kernel"])
                        or mm.matmul_quantized(x, w, **kw))
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 256))
    linear_mod.linear(x, qt)
    linear_mod.linear(x, qt, interpret=True)  # the tests' way in
    assert calls == [False, True]


def test_policy_unknown_platform_raises(monkeypatch):
    _on(monkeypatch, "rocm")
    with pytest.raises(NotImplementedError, match="rocm"):
        ops.use_fused_matmul(8, _qt())
    with pytest.raises(NotImplementedError):
        ops.attention_impl(2048, jnp.bfloat16, from_zero=True)


def test_policy_gpu_choice_by_m_and_format(monkeypatch):
    nf4, nf4a32 = _qt("nf4"), _qt("nf4a", block=32)
    fp8, int8 = _qt("fp8"), _qt("int8")
    _on(monkeypatch, "gpu")
    for qt in (nf4, nf4a32, int8):
        assert ops.use_fused_matmul(1, qt)
        assert ops.use_fused_matmul(ops.FUSED_MAX_M, qt)
        assert not ops.use_fused_matmul(ops.FUSED_MAX_M + 1, qt)
    assert not ops.use_fused_matmul(1, fp8)  # 256-level table: plain
    s = ops.CUDNN_ATTENTION_MIN_S
    assert ops.attention_impl(s, jnp.bfloat16, from_zero=True) == "cudnn"
    assert ops.attention_impl(s - 1, jnp.bfloat16, from_zero=True) is None
    assert ops.attention_impl(s, jnp.float32, from_zero=True) is None
    assert ops.attention_impl(s, jnp.bfloat16, from_zero=False) is None


def test_linear_counts_m_over_leading_dims(monkeypatch):
    """linear() asks the policy with M = product of x's leading dims and
    takes the kernel only where the policy says so."""
    qt = _qt()
    seen = []
    monkeypatch.setattr(ops, "use_fused_matmul",
                        lambda m, w: seen.append(m) or m <= 16)
    calls = []
    monkeypatch.setattr(
        linear_mod, "matmul_quantized",
        lambda x, w, kernel, interpret: calls.append(kernel)
        or mm.matmul_quantized(x, w, kernel=kernel, interpret=True))
    ref_w = core.dequantize_matmul_weight(qt)
    for shape in ((2, 4, 256), (3, 7, 256)):
        x = jax.random.normal(jax.random.PRNGKey(2), shape)
        np.testing.assert_allclose(np.asarray(linear_mod.linear(x, qt)),
                                   np.asarray(x @ ref_w),
                                   rtol=1e-5, atol=1e-4)
    assert seen == [8, 21] and calls == [True, False]


@pytest.mark.parametrize("m,k,n,want", [
    (8, 2048, 2048, (16, 64, 8)),      # TinyLlama wq/wo at decode
    (8, 2048, 256, (16, 64, 8)),       # wk/wv: splits capped by K blocks
    (8, 6144, 2048, (16, 64, 16)),     # w_down (K 5632 padded)
    (8, 2048, 32000, (16, 64, 1)),     # lm_head: 500 N tiles, no split
    (512, 2048, 5632, (64, 64, 1)),    # prefill M
    (20, 1024, 80, (32, 16, 4)),       # N = 80: widest dividing tile
])
def test_pick_tiles(m, k, n, want):
    assert mm.pick_tiles(m, n, k // 2 // 64) == want


@pytest.mark.parametrize("m", [1, 17, 33, 70])
def test_wrapper_pads_m_and_n(m):
    """fused_matmul pads M to its tile and K to the packed rows, slices
    both back, and returns the padded N the codes carry."""
    k, n = 200, 100  # quantizer pads to K 1024, N 128
    x = jax.random.normal(jax.random.PRNGKey(3), (m, k), jnp.float32)
    qt = _qt("nf4", k=k, n=n)
    out = mm.fused_matmul(x, qt.codes, qt.scale, codebook="nf4", block=64,
                          packed=True, interpret=True)
    assert out.shape == (m, 128) and out.dtype == jnp.float32
    ref = x @ core.dequantize_matmul_weight(qt)
    np.testing.assert_allclose(np.asarray(out[:, :n]), np.asarray(ref),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(out[:, n:]), 0.0)


def test_kernel_refuses_unsupported_blocks():
    assert mm.kernel_supports(_qt("nf4", block=16))
    assert not mm.kernel_supports(_qt("nf4", block=8))  # dot needs 16
    assert not mm.kernel_supports(_qt("nf4", block=48))  # not 2^k
    with pytest.raises(ValueError, match="no fused kernel"):
        mm.matmul_quantized(jnp.ones((2, 256)), _qt("nf4", block=48),
                            interpret=True)


# ------------------------------------------------------------ device peaks


class _FakeDevice:
    platform = "gpu"

    def __init__(self, kind):
        self.device_kind = kind


def test_device_spec_h100():
    from quanta_tpu.profiling import device_spec

    spec = device_spec(_FakeDevice("NVIDIA H100 80GB HBM3"))
    assert (spec.hbm_gbps, spec.bf16_tflops, spec.int8_tops) == (
        3350.0, 989.0, 1979.0)


def test_device_spec_unknown_raises():
    from quanta_tpu.profiling import device_spec

    with pytest.raises(KeyError, match="A100"):
        device_spec(_FakeDevice("NVIDIA A100-SXM4-80GB"))
    with pytest.raises(KeyError):
        device_spec()  # the CPU is not in the table either


# ----------------------------------------------------------- compile cache


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: updates.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert updates == []  # JAX reads the variable itself


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: updates.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable()
    assert got == str(ROOT / ".jax_cache")
    assert updates == [("jax_compilation_cache_dir", got)]
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


# ------------------------------------------------------- no GPU, no flax


def _run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update({"JAX_PLATFORMS": "cpu", **(env_extra or {})})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu(tmp_path):
    r = _run([str(ROOT / "chip_smoke.py")], cwd=ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    # alone in a directory (no package beside it) it fails too
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    r = _run([str(alone)], cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_main_path_imports_without_flax():
    code = (
        "import sys; sys.modules['flax'] = None\n"
        "import quanta_tpu.models.llama, quanta_tpu.serve, quanta_tpu.train\n"
        "import quanta_tpu.nn as qnn\n"
        "try:\n"
        "    qnn.Linear4bit\n"
        "except ImportError:\n"
        "    print('linen-lazy')\n"
    )
    r = _run(["-c", code], cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "linen-lazy"
