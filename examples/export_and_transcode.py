"""Checkpoint interchange: import -> transcode -> serve -> export.

The round-trip story for checkpoints that live OUTSIDE this framework:

  1. a tiny Llama is exported to HF safetensors layout (stand-in for any
     LlamaForCausalLM directory; models/hf.save_llama is the inverse of
     load_llama and is transformers-compatible),
  2. re-imported and quantized to exact NF4 (what a bitsandbytes/QLoRA
     checkpoint arrives as),
  3. transcoded to nf4a at load time (utils.transcode_params: a pure
     16-entry code remap, scales untouched) so it dequantizes with
     multiply-adds instead of a per-element select tree,
  4. served with the continuous-batching Engine, and
  5. exported back to HF layout as dense merged weights.

Runs on CPU in under a minute: python examples/export_and_transcode.py
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from quanta_tpu import nn as qnn  # noqa: E402
from quanta_tpu.models import hf, llama  # noqa: E402
from quanta_tpu.serve import Engine, Request  # noqa: E402
from quanta_tpu.utils import transcode_params  # noqa: E402

cfg = llama.LlamaConfig.tiny(dtype=jnp.float32)
params = llama.init_params(jax.random.PRNGKey(0), cfg)

with tempfile.TemporaryDirectory() as d:
    # 1. export a "pretrained checkpoint"
    hf.save_llama(params, cfg, d)
    print(f"exported HF checkpoint to {d}")

    # 2. import + quantize to exact NF4 (the bitsandbytes interchange fmt)
    loaded, lcfg = hf.load_llama(d, dtype=jnp.float32)
    nf4 = qnn.quantize_params(loaded, mode="nf4", block_size=64, min_size=0)

    # 3. load-time transcode: nf4 codes -> nf4a codes, scales unchanged
    nf4a = transcode_params(nf4)
    leaf = nf4a["layers"][0]["wq"]
    print(f"transcoded: layers[0].wq codebook={leaf.codebook} "
          f"codes={leaf.codes.shape} {leaf.codes.dtype}")

    # 4. serve both; the outputs differ only by the documented extra
    #    rounding (docs/ACCURACY.md gates the ppl cost)
    prompt = np.asarray([1, 2, 3, 4, 5], np.int32)
    outs = {}
    for name, p in (("nf4", nf4), ("nf4a(transcoded)", nf4a)):
        eng = Engine(p, lcfg, n_slots=2, page_size=8,
                     prefill_buckets=(8, 16), use_kernel=False)
        done = eng.run([Request(uid=0, prompt=prompt, max_new_tokens=8)])
        outs[name] = done[0].output
        print(f"{name:18s} -> {done[0].output}")

    # 5. export the quantized model back out as dense weights
    out_dir = d + "_dense"
    hf.save_llama(nf4a, lcfg, out_dir)
    back, _ = hf.load_llama(out_dir, dtype=jnp.float32)
    w0 = np.asarray(back["layers"][0]["wq"])
    print(f"re-exported dense checkpoint round-trips: wq {w0.shape}, "
          f"finite={np.isfinite(w0).all()}")
