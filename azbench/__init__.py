"""The benchmark of alphazero_tpu_torch on one H100: ``python3 -m
azbench.run`` (see ``azbench/run.py``), driven by ``BENCHMARK.json``."""
