"""The attention route (jax.nn.dot_product_attention: cuDNN on the GPU)
vs the llama._attention oracle. On the CPU the route runs with
implementation="xla", forward and gradient; the cuDNN compile is compared
on the card by chip_smoke.py and the `gpu`-marked tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quanta_tpu import ops
from quanta_tpu.models import llama
from quanta_tpu.ops.attention import causal_attention


def _oracle(q, k, v, q_start, kv_len):
    b, s = q.shape[0], q.shape[1]
    t = k.shape[1]
    q_positions = q_start[:, None] + jax.lax.broadcasted_iota(
        jnp.int32, (b, s), 1
    )
    kv_positions = jax.lax.broadcasted_iota(jnp.int32, (b, t), 1)
    kv_len_mask = kv_positions < kv_len[:, None]
    return llama._attention(q, k, v, q_positions, kv_len_mask, cfg=None)


def _rand(shape, seed, dtype=jnp.float32):
    return jax.random.normal(jax.random.PRNGKey(seed), shape, dtype)


def _route(q, k, v, kv_len):
    return causal_attention(q, k, v, kv_len, implementation="xla")


@pytest.fixture
def route_on_cpu(monkeypatch):
    """Make the policy pick the route (as "xla") wherever it would pick
    cuDNN on the GPU, at any length and dtype."""
    monkeypatch.setattr(
        ops, "attention_impl",
        lambda s, dtype, from_zero: "xla" if from_zero else None)


@pytest.mark.parametrize(
    "b,s,t,nh,nkv,hd",
    [
        (2, 64, 64, 4, 2, 64),     # GQA, self-attention
        (1, 128, 128, 4, 4, 64),   # MHA
        (2, 48, 80, 4, 2, 64),     # kv longer than q, valid prefix = s
    ],
)
def test_flash_matches_oracle(b, s, t, nh, nkv, hd):
    q = _rand((b, s, nh, hd), 0)
    k = _rand((b, t, nkv, hd), 1)
    v = _rand((b, t, nkv, hd), 2)
    q_start = jnp.zeros((b,), jnp.int32)
    kv_len = jnp.full((b,), s, jnp.int32)  # kv valid prefix = s rows
    want = _oracle(q, k, v, q_start, kv_len)
    got = _route(q, k, v, kv_len)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_flash_cached_prefill_offset():
    """Prefill at a cache offset stays on the plain attention: a prompt
    fed as two chunks through the cache gives the logits of one uncached
    forward, and the policy never sends an offset chunk to the route."""
    assert ops.attention_impl(4096, jnp.bfloat16, from_zero=False) is None
    cfg = llama.LlamaConfig.tiny(dtype=jnp.float32)
    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 48), 0,
                              cfg.vocab_size)
    want, _ = llama.forward(params, toks, cfg)
    cache = llama.init_cache(cfg, 2, max_len=64)
    lo_a, cache = llama.forward(params, toks[:, :16], cfg, cache=cache)
    lo_b, _ = llama.forward(params, toks[:, 16:], cfg, cache=cache)
    got = jnp.concatenate([lo_a, lo_b], axis=1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_flash_bf16():
    b, s, nh, nkv, hd = 1, 64, 4, 2, 64
    q = _rand((b, s, nh, hd), 6, jnp.bfloat16)
    k = _rand((b, s, nkv, hd), 7, jnp.bfloat16)
    v = _rand((b, s, nkv, hd), 8, jnp.bfloat16)
    q_start = jnp.zeros((b,), jnp.int32)
    kv_len = jnp.full((b,), s, jnp.int32)
    want = _oracle(q, k, v, q_start, kv_len)
    got = _route(q, k, v, None)
    assert got.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32),
        rtol=2e-2, atol=2e-2,
    )


def test_flash_in_llama_forward(route_on_cpu):
    """llama.forward sends from-zero multi-token attention through the
    route (uncached, and a prefill that fills its whole cache) and
    matches the plain-attention forward."""
    cfg = llama.LlamaConfig.tiny(dtype=jnp.float32)
    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 64), 0,
                              cfg.vocab_size)
    calls = []
    real = llama.causal_attention

    def spy(*a, **kw):
        calls.append(kw["implementation"])
        return real(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(llama, "causal_attention", spy)
        got, _ = llama.forward(params, toks, cfg)
        cache = llama.init_cache(cfg, 2, max_len=64)
        got_c, _ = llama.forward(params, toks, cfg, cache=cache)
    assert calls == ["xla"] * (2 * cfg.n_layers), calls
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "attention_impl", lambda s, dtype, from_zero: None)
        want, _ = llama.forward(params, toks, cfg)
        cache = llama.init_cache(cfg, 2, max_len=64)
        want_c, _ = llama.forward(params, toks, cfg, cache=cache)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(got_c), np.asarray(want_c),
                               rtol=2e-4, atol=2e-4)


def test_flash_in_greedy_prefill(route_on_cpu):
    """greedy_decode's prefill writes a cache longer than the prompt but
    empty before it: it takes the route over the prompt's own keys, its
    decode steps stay plain, and the tokens and cache equal the
    all-plain decode's (the cache to round-off)."""
    cfg = llama.LlamaConfig.tiny(dtype=jnp.float32)
    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    toks = jax.random.randint(jax.random.PRNGKey(2), (2, 40), 0,
                              cfg.vocab_size)
    calls = []
    real = llama.causal_attention

    def spy(*a, **kw):
        calls.append((a[1].shape[1], kw["implementation"]))
        return real(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(llama, "causal_attention", spy)
        got = llama.greedy_decode(params, toks, cfg, max_new_tokens=4)
        cache = llama.init_cache(cfg, 2, max_len=44)
        lg, cache = llama.forward(params, toks, cfg, cache=cache,
                                  cache_empty=True)
    # prefill only (one trace each), over the 40 prompt keys
    assert calls == [(40, "xla")] * (2 * cfg.n_layers), calls
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "attention_impl", lambda s, dtype, from_zero: None)
        want = llama.greedy_decode(params, toks, cfg, max_new_tokens=4)
        cache_w = llama.init_cache(cfg, 2, max_len=44)
        lg_w, cache_w = llama.forward(params, toks, cfg, cache=cache_w)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_allclose(np.asarray(lg), np.asarray(lg_w),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(np.asarray(cache["pos"]),
                                  np.asarray(cache_w["pos"]))
    for name in ("k", "v"):  # later layers see the route's rounding
        np.testing.assert_allclose(np.asarray(cache[name]),
                                   np.asarray(cache_w[name]),
                                   rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------- backward


@pytest.mark.parametrize(
    "b,s,t,nh,nkv,hd",
    [
        (2, 64, 64, 4, 2, 64),     # GQA
        (1, 128, 128, 4, 4, 64),   # MHA
        (2, 48, 80, 4, 2, 64),     # kv longer than q, valid prefix = s
    ],
)
def test_flash_grad_matches_oracle(b, s, t, nh, nkv, hd):
    """jax.grad through the route == jax.grad through the oracle."""
    q = _rand((b, s, nh, hd), 10)
    k = _rand((b, t, nkv, hd), 11)
    v = _rand((b, t, nkv, hd), 12)
    q_start = jnp.zeros((b,), jnp.int32)
    kv_len = jnp.full((b,), s, jnp.int32)
    w = _rand((b, s, nh, hd), 13)  # random cotangent direction

    def loss_route(q, k, v):
        return jnp.sum(_route(q, k, v, kv_len) * w)

    def loss_oracle(q, k, v):
        return jnp.sum(_oracle(q, k, v, q_start, kv_len) * w)

    got = jax.grad(loss_route, argnums=(0, 1, 2))(q, k, v)
    want = jax.grad(loss_oracle, argnums=(0, 1, 2))(q, k, v)
    for g, wnt, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(wnt), rtol=2e-4, atol=2e-4,
            err_msg=f"d{name}",
        )


def test_flash_grad_cached_offset():
    """Offset geometry (q_start > 0, the plain path's case) agrees with
    the route, forward and gradient: queries at q_start..q_start+s-1 are
    the last s rows of a from-zero causal attention over q_start+s
    queries."""
    b, s, t, nh, nkv, hd, q0 = 2, 32, 96, 8, 2, 64, 40
    q = _rand((b, s, nh, hd), 14)
    k = _rand((b, t, nkv, hd), 15)
    v = _rand((b, t, nkv, hd), 16)
    q_start = jnp.full((b,), q0, jnp.int32)
    kv_len = q_start + s

    def loss_oracle(q, k, v):
        return jnp.sum(_oracle(q, k, v, q_start, kv_len) ** 2)

    def loss_route(q, k, v):
        q_full = jnp.concatenate(
            [jnp.zeros((b, q0, nh, hd), q.dtype), q], axis=1)
        out = _route(q_full, k, v, kv_len)[:, q0:]
        return jnp.sum(out ** 2)

    np.testing.assert_allclose(float(loss_route(q, k, v)),
                               float(loss_oracle(q, k, v)), rtol=1e-5)
    got = jax.grad(loss_route, argnums=(0, 1, 2))(q, k, v)
    want = jax.grad(loss_oracle, argnums=(0, 1, 2))(q, k, v)
    for g, wnt, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(wnt), rtol=2e-4, atol=2e-4,
            err_msg=f"d{name}",
        )


@pytest.mark.slow
def test_flash_grad_long_seq_llama(route_on_cpu):
    """jax.grad through llama.forward at S=1024 (the length where the
    policy takes the route on the GPU) matches the plain attention."""
    cfg = llama.LlamaConfig.tiny(dtype=jnp.float32, max_seq_len=1024)
    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    toks = jax.random.randint(jax.random.PRNGKey(1), (1, 1024), 0,
                              cfg.vocab_size)

    def loss(params):
        logits, _ = llama.forward(params, toks, cfg)
        return jnp.mean(logits ** 2)

    g_route = jax.grad(loss)(params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "attention_impl", lambda s, dtype, from_zero: None)
        g_plain = jax.grad(loss)(params)
    flat_r, _ = jax.tree_util.tree_flatten(g_route)
    flat_p, _ = jax.tree_util.tree_flatten(g_plain)
    for gr, gp in zip(flat_r, flat_p):
        np.testing.assert_allclose(np.asarray(gr), np.asarray(gp),
                                   rtol=5e-3, atol=5e-4)
