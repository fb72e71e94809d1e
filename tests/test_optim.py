"""8-bit blockwise Adam: convergence, parity with fp32 Adam, memory."""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from quanta_tpu import optim as qoptim


def _quad_problem(n=1000, seed=0):
    target = jax.random.normal(jax.random.PRNGKey(seed), (n,))

    def loss(p):
        return jnp.sum((p["w"] - target) ** 2)

    params = {"w": jnp.zeros((n,))}
    return loss, params, target


def _run(tx, loss, params, steps=200):
    state = tx.init(params)

    @jax.jit
    def step(params, state):
        g = jax.grad(loss)(params)
        upd, state = tx.update(g, state, params)
        return optax.apply_updates(params, upd), state

    for _ in range(steps):
        params, state = step(params, state)
    return params, state


def test_adam8bit_converges():
    loss, params, target = _quad_problem()
    tx = qoptim.adam8bit(learning_rate=0.05)
    params, _ = _run(tx, loss, params, steps=300)
    err = float(jnp.abs(params["w"] - target).mean())
    assert err < 0.05, err


def test_adam8bit_tracks_fp32_adam():
    loss, params, _ = _quad_problem(n=512, seed=1)
    p8, _ = _run(qoptim.adam8bit(1e-2), loss, dict(params), steps=100)
    p32, _ = _run(optax.adam(1e-2), loss, dict(params), steps=100)
    # trajectories diverge slightly from state quantization but stay close
    diff = float(jnp.abs(p8["w"] - p32["w"]).max())
    assert diff < 0.15, diff


def test_state_is_8bit():
    loss, params, _ = _quad_problem(n=4096)
    tx = qoptim.adam8bit(1e-3)
    state = tx.init(params)
    q = state.qstate["w"]
    assert q.m_codes.dtype == jnp.int8
    assert q.v_codes.dtype == jnp.uint8
    # ~2 bytes/param for codes + ~2*4/256 for scales
    bytes_per_param = qoptim.state_nbytes(state) / 4096
    assert bytes_per_param < 2.2, bytes_per_param


def test_adamw_decay():
    params = {"w": jnp.ones((256,))}
    tx = qoptim.adamw8bit(learning_rate=0.1, weight_decay=0.5)
    state = tx.init(params)
    g = {"w": jnp.zeros((256,))}
    upd, state = tx.update(g, state, params)
    # zero gradient: update is pure decay, -lr*wd*w
    np.testing.assert_allclose(np.asarray(upd["w"]), -0.05, rtol=1e-5)


def test_masked_for_lora():
    params = {"base": jnp.ones((64,)), "lora_a": jnp.ones((64,))}
    mask = {"base": False, "lora_a": True}
    tx = qoptim.adam8bit(0.1, mask=mask)
    state = tx.init(params)
    g = {"base": jnp.ones((64,)), "lora_a": jnp.ones((64,))}
    upd, _ = tx.update(g, state, params)
    assert float(jnp.abs(upd["base"]).max()) == 0.0
    assert float(jnp.abs(upd["lora_a"]).max()) > 0.0


def test_profiling_roofline_math():
    """Roofline accounting: bytes/flops bookkeeping and bound selection."""
    from quanta_tpu.profiling import DeviceSpec, device_spec, matmul_roofline

    dev = DeviceSpec("test", hbm_gbps=1000.0, bf16_tflops=500.0,
                     int8_tops=1000.0)
    # decode shape, 4-bit weight: memory-bound (t_hbm > t_compute)
    r4 = matmul_roofline(8, 2048, 2048, weight_bits=4, block_size=64,
                         device=dev)
    assert r4.flops == 2 * 8 * 2048 * 2048
    expect_bytes = (8 * 2048 * 2 + 2048 * 2048 // 2
                    + (2048 // 64) * 2048 * 4 + 8 * 2048 * 2)
    assert r4.bytes == expect_bytes
    assert r4.t_roofline_s == r4.t_hbm_s > r4.t_compute_s
    # same shape bf16 moves ~3.4x the bytes
    r16 = matmul_roofline(8, 2048, 2048, weight_bits=16, device=dev)
    assert 3.0 < r16.bytes / r4.bytes < 4.0
    # huge-M prefill: compute-bound
    rc = matmul_roofline(4096, 4096, 4096, weight_bits=16, device=dev)
    assert rc.t_roofline_s == rc.t_compute_s
    # pct is monotone: slower measurement -> lower pct
    assert r4.pct(r4.t_roofline_s) == 100.0
    assert r4.pct(2 * r4.t_roofline_s) == 50.0
    assert device_spec(dev) is dev


def test_profiling_measure_cpu():
    """time_fn() returns a sane positive median time on CPU and waits for
    the result (block_until_ready) on every call."""
    from quanta_tpu.profiling import time_fn

    x = jnp.ones((256, 256), jnp.float32)
    w = jnp.ones((256, 256), jnp.float32)
    calls = []

    def f(a):
        calls.append(1)
        return a @ w

    t = time_fn(jax.jit(f), x, reps=3)
    assert 0 < t < 1.0
    assert len(calls) == 1  # traced once: warm-up compiled, reps reuse it
