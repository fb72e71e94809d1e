"""Benchmark drivers, shipped inside the package so the installed
``quanta-tpu bench`` console script can run them from site-packages
(they used to live in a repo-root benchmarks/ dir the wheel never
shipped). Each module is runnable via ``python -m``:

  python -m quanta_tpu.benchmarks.kernel_bench     # kernels vs plain (GPU)
  python -m quanta_tpu.benchmarks.accuracy_bench   # docs/ACCURACY.md
  python -m quanta_tpu.benchmarks.serve_bench      # engine TTFT/throughput
"""
