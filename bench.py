"""Headline benchmark entry point (needs a GPU).

The implementation lives in quanta_tpu/benchmarks/decode_bench.py (shipped
with the package; also reachable as `quanta-tpu bench headline`). Prints
ONE JSON line on stdout; per-format tables go to stderr. JAX's compilation
cache follows quanta_tpu.compile_cache.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from quanta_tpu import compile_cache  # noqa: E402
from quanta_tpu.benchmarks.decode_bench import main  # noqa: E402

if __name__ == "__main__":
    compile_cache.enable()
    main()
