"""Live-data lifecycle: the commit/invalidation bus
(:mod:`hyperspace_tpu_torch.lifecycle.invalidation`). Every index mutation
publishes one commit event, and the roster, IO and device caches purge in
one place. The JAX package's snapshot pins and background refresh manager
wait for ROADMAP A9."""

from hyperspace_tpu_torch.lifecycle.invalidation import CommitEvent, InvalidationBus

__all__ = ["CommitEvent", "InvalidationBus"]
