"""Runtime checks: the lock-order watcher (:mod:`hyperspace_tpu_torch.check.locks`,
a verbatim copy of the JAX package's, whose ``named_lock`` the metrics
registry and the invalidation bus take their locks from). The
static-analysis passes wait for ROADMAP A11; this package imports nothing
at import time."""
