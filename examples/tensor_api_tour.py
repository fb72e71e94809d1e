"""Tensor-level API tour: every quantization format, round-trip accuracy,
packing storage math, .qtn serialization, precision conversion, config.

Role of the reference's example/examples.py, tensor_utils_example.py,
tensor_serialization_example.py and state_example.py, on the functional
JAX core of this framework.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

from quanta_tpu.core import codecs
from quanta_tpu.state.config import ConfigTree, QuantConfig
from quanta_tpu.utils import convert, serialization


def mae(a, b):
    return float(jnp.mean(jnp.abs(a - b)))


def main():
    x = jax.random.normal(jax.random.PRNGKey(0), (512, 512)) * 0.5

    print("== Blockwise quantize/dequantize round trips (block=64) ==")
    formats = [
        ("int8 symmetric", dict(bits=8, scheme="symmetric")),
        ("uint8 affine", dict(bits=8, scheme="affine")),
        ("nf8 codebook", dict(bits=8, scheme="codebook", codebook="nf8")),
        ("fp8 bitfield", dict(bits=8, scheme="codebook", codebook="fp8")),
        ("int4 symmetric", dict(bits=4, scheme="symmetric", pack=True)),
        ("nf4 (QLoRA levels)", dict(bits=4, scheme="codebook", codebook="nf4",
                                    pack=True)),
        ("nf4a (arithmetic NF4)", dict(bits=4, scheme="codebook",
                                       codebook="nf4a", pack=True)),
        ("fp4 bitfield", dict(bits=4, scheme="codebook", codebook="fp4",
                              pack=True)),
    ]
    for name, kw in formats:
        qt = codecs.quantize(x, block_size=64, **kw)
        err = mae(codecs.dequantize(qt), x)
        nbytes = qt.codes.size * qt.codes.dtype.itemsize + qt.scale.nbytes
        ratio = x.nbytes / nbytes
        print(f"  {name:24s} MAE {err:.5f}   {ratio:4.1f}x smaller than f32")

    print("\n== 4-bit packing storage math ==")
    qt4 = codecs.quantize(x, bits=4, scheme="symmetric", block_size=64,
                          pack=True)
    print(f"  f32 tensor:      {x.nbytes:9d} bytes")
    print(f"  packed codes:    {qt4.codes.nbytes:9d} bytes "
          f"(2 values per byte)")
    print(f"  block scales:    {qt4.scale.nbytes:9d} bytes "
          f"({qt4.scale.size} blocks of 64)")

    print("\n== .qtn serialization round trip ==")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "w.qtn")
        serialization.save_qtn(qt4, path)
        back = serialization.load_qtn(path)
        assert mae(codecs.dequantize(back), codecs.dequantize(qt4)) == 0.0
        print(f"  saved+loaded {os.path.getsize(path)} bytes, "
              "bit-exact round trip")

    print("\n== Precision conversion (8-bit -> 4-bit -> 8-bit) ==")
    qt8 = codecs.quantize(x, bits=8, scheme="symmetric", block_size=64)
    down = convert.convert_8bit_to_4bit(qt8)
    up = convert.convert_4bit_to_8bit(down)
    print(f"  8-bit MAE {mae(codecs.dequantize(qt8), x):.5f} -> "
          f"4-bit MAE {mae(codecs.dequantize(down), x):.5f} -> "
          f"back-to-8 MAE {mae(codecs.dequantize(up), x):.5f}")

    print("\n== Hardware-target presets (requantize an existing tensor) ==")
    for hw in ("gpu", "cpu", "mobile", "edge"):
        qt = convert.optimize_for_target_hardware(qt8, hw)
        print(f"  {hw:7s} -> {qt.bits}-bit {qt.codebook or qt.scheme}")

    print("\n== Three-tier config resolution ==")
    tree = ConfigTree(default=QuantConfig(bits=4, scheme="codebook",
                                          codebook="nf4a"))
    tree.config_layer(r"lm_head", bits=8, scheme="symmetric", codebook=None)
    tree.config_layer(r"layers\.0\.", bits=8, scheme="llm_int8", codebook=None)
    for name in ("layers.0.wq", "layers.5.w_gate", "lm_head"):
        cfg = tree.resolve(name)
        print(f"  {name:18s} -> {cfg.bits}-bit {cfg.codebook or cfg.scheme}")


if __name__ == "__main__":
    main()
