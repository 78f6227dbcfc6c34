"""The benchmark of hyperspace_tpu_torch, the PyTorch and CUDA port.

``python -m hsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on one H100: it builds the cell's
deployment from the seed, serves its traffic through
``hyperspace_tpu_torch.serving.QueryServer`` in an open loop, checks
the answers against the plain references in ``hsbench/reference/`` and prints
one JSON line. Everything that belongs to one configuration, traffic mix,
template or per-layer metric sits in a file of its own, found by its name.
"""
