"""QLoRA fine-tuning driver: frozen quantized base + bf16 LoRA + 8-bit Adam.

Realizes north-star config 4 (BASELINE.md): the base model is NF4
QuantizedTensor leaves (decode-size products run the fused kernel; larger
ones dequantize one layer at a time), adapters are the only trainable leaves, optimizer state is
blockwise 8-bit. The reference only roadmaps this (TODO.md:47-50).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Iterable, Optional

import jax
import jax.numpy as jnp
import optax

from quanta_tpu.models import llama
from quanta_tpu.nn.lora import LoRAWeight, init_lora

DEFAULT_TARGETS = ("wq", "wv")


def add_lora(
    params: dict,
    rng: jax.Array,
    *,
    targets: Iterable[str] = DEFAULT_TARGETS,
    rank: int = 8,
    alpha: float = 16.0,
    dtype=jnp.bfloat16,
) -> dict:
    """Wrap target projection leaves of a llama param tree with LoRA."""
    params = dict(params)
    layers = []
    keys = jax.random.split(rng, len(params["layers"]) * len(tuple(targets)))
    ki = 0
    for lp in params["layers"]:
        lp = dict(lp)
        for name in targets:
            base = lp[name]
            shape = getattr(base, "shape", None)
            lp[name] = init_lora(
                base, keys[ki], rank=rank, alpha=alpha,
                in_features=shape[0], out_features=shape[1], dtype=dtype,
            )
            ki += 1
        layers.append(lp)
    params["layers"] = layers
    return params


def extract_adapters(params: dict) -> list:
    """Trainable subtree: [{name: {'a': A, 'b': B}} per layer]."""
    out = []
    for lp in params["layers"]:
        d = {}
        for name, leaf in lp.items():
            if isinstance(leaf, LoRAWeight):
                d[name] = {"a": leaf.lora_a, "b": leaf.lora_b}
        out.append(d)
    return out


def merge_adapters(params: dict, adapters: list) -> dict:
    """Rebuild the param tree with adapter arrays swapped in."""
    params = dict(params)
    layers = []
    for lp, ad in zip(params["layers"], adapters):
        lp = dict(lp)
        for name, ab in ad.items():
            lp[name] = dataclasses.replace(
                lp[name], lora_a=ab["a"], lora_b=ab["b"]
            )
        layers.append(lp)
    params["layers"] = layers
    return params


def causal_lm_loss(logits: jax.Array, targets: jax.Array, mask=None) -> jax.Array:
    """Mean next-token cross-entropy. logits (B,S,V) vs targets (B,S)."""
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    ll = jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    if mask is None:
        mask = jnp.ones_like(ll)
    mask = mask.astype(jnp.float32)
    return -(ll * mask).sum() / jnp.maximum(mask.sum(), 1.0)


def make_train_step(
    cfg,
    tx: optax.GradientTransformation,
    *,
    forward=None,
    use_kernel: Optional[bool] = None,
    interpret: bool = False,
):
    """Full-parameter training step (pretraining / from-scratch models).

    Model-agnostic: ``forward(params, tokens, cfg, ...) -> (logits, _)``
    defaults to the Llama forward. Returns a jittable
    ``(params, opt_state, batch) -> (params, opt_state, loss)``.
    """
    fwd = partial(
        forward or llama.forward, cfg=cfg, use_kernel=use_kernel,
        interpret=interpret,
    )

    def loss_fn(params, batch):
        logits, _ = fwd(params, batch["inputs"])
        return causal_lm_loss(logits, batch["targets"], batch.get("mask"))

    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def make_qlora_train_step(
    cfg: llama.LlamaConfig,
    tx: optax.GradientTransformation,
    *,
    use_kernel: Optional[bool] = None,
    interpret: bool = False,
):
    """Build a jittable (adapters, opt_state, params, batch) -> ... step.

    batch: {"inputs": (B,S) int32, "targets": (B,S) int32, "mask": optional}.
    The frozen base `params` tree (with LoRAWeight leaves) is a step input,
    so jit keeps it sharded/donatable; only `adapters` receives gradients.
    """
    fwd = partial(
        llama.forward, cfg=cfg, use_kernel=use_kernel, interpret=interpret
    )

    def loss_fn(adapters, params, batch):
        p = merge_adapters(params, adapters)
        logits, _ = fwd(p, batch["inputs"])
        return causal_lm_loss(logits, batch["targets"], batch.get("mask"))

    def step(adapters, opt_state, params, batch):
        loss, grads = jax.value_and_grad(loss_fn)(adapters, params, batch)
        updates, opt_state = tx.update(grads, opt_state, adapters)
        adapters = optax.apply_updates(adapters, updates)
        return adapters, opt_state, loss

    return step
