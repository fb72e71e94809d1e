"""8-bit blockwise Adam / AdamW as optax gradient transformations.

The reference's ``Adam8bit`` declares blockwise-quantized optimizer state
(`block_wise=True`, `quantize_momentum`, `quantize_variance`) but steps in
fp32 (/root/reference/Quanta/optim/adam.py:25-56, placeholder note at :95).
This is the real thing: the state pytree holds int8/uint8 codes
plus per-block scales; each step dequantizes, applies the Adam update, and
requantizes per block — all fused by XLA into one elementwise pass per
leaf (SURVEY.md §7 hard part 4: no fp32 materialization of the full state
across steps — fp32 exists only tile-wise inside the fused update).

Quantization choices (bitsandbytes-style dynamic blockwise):
  - m (1st moment, signed): symmetric int8 absmax per block of 256.
  - v (2nd moment, non-negative): uint8 with 4th-root companding,
    ``code = round(255 * (v/blockmax)^(1/4))``. A *linear* 8-bit code
    cannot span v's dynamic range — elements far below the block max round
    to zero and ``m/(sqrt(0)+eps)`` explodes; companding gives ~1e-10
    relative dynamic range (the role of bitsandbytes' dynamic data type).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax

_EPS = 1e-12
BLOCK = 256


class _QState(NamedTuple):
    m_codes: Any  # int8 (nb, BLOCK) per leaf
    m_scale: Any  # f32 (nb, 1)
    v_codes: Any  # uint8 (nb, BLOCK)
    v_scale: Any  # f32 (nb, 1)


class Adam8bitState(NamedTuple):
    count: jax.Array
    qstate: Any  # pytree of _QState


def _blockify(x: jax.Array):
    flat = x.reshape(-1).astype(jnp.float32)
    n = flat.shape[0]
    nb = -(-n // BLOCK)
    pad = nb * BLOCK - n
    if pad:
        flat = jnp.pad(flat, (0, pad))
    return flat.reshape(nb, BLOCK), n


def _quant_m(m: jax.Array):
    blocks, _ = _blockify(m)
    scale = jnp.maximum(jnp.max(jnp.abs(blocks), axis=1, keepdims=True) / 127.0, _EPS)
    codes = jnp.clip(jnp.round(blocks / scale), -127, 127).astype(jnp.int8)
    return codes, scale


def _quant_v(v: jax.Array):
    blocks, _ = _blockify(v)
    scale = jnp.maximum(jnp.max(blocks, axis=1, keepdims=True), _EPS)
    comp = jnp.sqrt(jnp.sqrt(jnp.clip(blocks / scale, 0.0, 1.0)))
    codes = jnp.clip(jnp.round(comp * 255.0), 0, 255).astype(jnp.uint8)
    return codes, scale


def _deq_m(codes, scale, shape):
    n = 1
    for d in shape:
        n *= d
    flat = codes.astype(jnp.float32) * scale
    return flat.reshape(-1)[:n].reshape(shape)


def _deq_v(codes, scale, shape):
    n = 1
    for d in shape:
        n *= d
    comp = codes.astype(jnp.float32) / 255.0
    flat = (comp**4) * scale
    return flat.reshape(-1)[:n].reshape(shape)


def adam8bit(
    learning_rate: optax.ScalarOrSchedule = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    mask: Optional[Any] = None,
) -> optax.GradientTransformation:
    """Blockwise 8-bit Adam(W). Drop-in optax transform.

    ``weight_decay > 0`` gives AdamW (decoupled decay, applied via the
    update like optax.adamw). ``mask``: optional pytree/callable selecting
    leaves to optimize (e.g. quanta_tpu.nn.lora_params_filter for QLoRA).
    XLA fuses each leaf's dequant -> update -> requant chain.
    """

    def init_fn(params):
        def leaf_init(p):
            z = jnp.zeros(p.shape, jnp.float32)
            mc, ms = _quant_m(z)
            vc, vs = _quant_v(z)
            return _QState(mc, ms, vc, vs)

        return Adam8bitState(
            count=jnp.zeros((), jnp.int32),
            qstate=jax.tree_util.tree_map(leaf_init, params),
        )

    def update_fn(grads, state, params=None):
        count = state.count + 1
        bc1 = 1.0 - b1 ** count.astype(jnp.float32)
        bc2 = 1.0 - b2 ** count.astype(jnp.float32)
        lr = (
            learning_rate(count) if callable(learning_rate) else learning_rate
        )

        def leaf_update(g, q, p):
            g32 = g.astype(jnp.float32)
            m = _deq_m(q.m_codes, q.m_scale, g.shape)
            v = _deq_v(q.v_codes, q.v_scale, g.shape)
            m = b1 * m + (1.0 - b1) * g32
            v = b2 * v + (1.0 - b2) * g32 * g32
            m_hat = m / bc1
            v_hat = v / bc2
            upd = -lr * m_hat / (jnp.sqrt(v_hat) + eps)
            mc, ms = _quant_m(m)
            vc, vs = _quant_v(v)
            if weight_decay and p is not None:
                upd = upd - lr * weight_decay * p.astype(jnp.float32)
            return upd.astype(g.dtype), _QState(mc, ms, vc, vs)

        g_leaves, treedef = jax.tree_util.tree_flatten(grads)
        q_leaves = treedef.flatten_up_to(state.qstate)  # each leaf a _QState
        p_leaves = (
            treedef.flatten_up_to(params)
            if params is not None
            else [None] * len(g_leaves)
        )
        results = [
            leaf_update(g, q, p) for g, q, p in zip(g_leaves, q_leaves, p_leaves)
        ]
        updates = jax.tree_util.tree_unflatten(treedef, [r[0] for r in results])
        qstate = jax.tree_util.tree_unflatten(treedef, [r[1] for r in results])
        return updates, Adam8bitState(count=count, qstate=qstate)

    tx = optax.GradientTransformation(init_fn, update_fn)
    if mask is not None:
        # freeze semantics: masked-out leaves get *zero* updates (optax.masked
        # alone would pass their raw gradients through as updates)
        def _inv(m):
            if callable(m):
                return lambda params: jax.tree_util.tree_map(
                    lambda b: not b, m(params)
                )
            return jax.tree_util.tree_map(lambda b: not b, m)

        tx = optax.chain(
            optax.masked(optax.set_to_zero(), _inv(mask)),
            optax.masked(tx, mask),
        )
    return tx


def adamw8bit(
    learning_rate: optax.ScalarOrSchedule = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-2,
    mask: Optional[Any] = None,
) -> optax.GradientTransformation:
    return adam8bit(learning_rate, b1, b2, eps, weight_decay, mask)


def state_nbytes(state: Adam8bitState) -> int:
    """Total bytes of optimizer state (diagnostic: ~2.03 bytes/param)."""
    return sum(x.nbytes for x in jax.tree_util.tree_leaves(state.qstate))
