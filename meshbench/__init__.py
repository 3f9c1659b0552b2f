"""meshbench: the benchmark of ``turbomesh_tpu_torch`` on an NVIDIA GPU.

``python -m meshbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line (README.md). Everything that belongs to one cell, one
configuration, one traffic mix or one metric is a file of its own that
the harness finds by the name in the manifest.
"""
