"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that measures lives here, outside the program
that later changes edit: the input generator (:mod:`bench.inputs`), the
plain reference operator (:mod:`bench.reference`), the frozen work model
and peaks (:mod:`bench.workmodel`), the trace reduction
(:mod:`bench.tracing`), the harness (:mod:`bench.harness`) and one reader
per metric (``bench/metrics/<metric>.py``).  Configurations and traffic
mixes are data files (``bench/configs/``, ``bench/traffic/``) found by
the names in ``BENCHMARK.json``.  Nothing here imports ``jax`` or the
JAX package ``repro``.
"""
