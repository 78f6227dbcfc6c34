"""Query observability: the span tracer (``obs/spans.py``, a verbatim copy
of the JAX package's). The metrics registry, query profiles and the rest of
the JAX package's ``obs`` wait for the serving slice; importing this package
loads nothing else."""
