"""Scale-out serving fabric: the piece a single process already needs.

A verbatim copy of the JAX package's ``fabric/records.py`` (the node id a
``QueryServer`` labels its series with, and the commit-record layout). The
refresh lease, the commit watcher, the coherence sidecar, the front door,
health tracking and fsck are not in the port yet (ROADMAP A9): with
``hyperspace.fabric.enabled`` the invalidation bus raises "not yet in the
port", and with ``hyperspace.fabric.lease.enabled`` as well a refresh does.
"""

from hyperspace_tpu_torch.fabric.records import local_node_id

__all__ = ["local_node_id"]
