"""The benchmark of the PyTorch/CUDA port (``dsvt_ai_trt_tpu_torch``) on
one H100.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  What belongs to one configuration, workload or per-layer metric is
a file of its own (``configs/``, ``workloads/``, ``metrics/``), found by
its name; ``reference/`` is the plain fp32 detector that decides
``correct`` and imports nothing of the port.
"""
