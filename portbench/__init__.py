"""The benchmark of the PyTorch/CUDA face detector.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Configurations (``configs/``), traffic mixes (``mixes/``),
request loops (``entries/``), end-to-end metrics (``e2e/``), per-layer
metrics (``metrics/``) and correctness limits (``limits/``) are files
found by the names ``BENCHMARK.json`` gives them.
"""
