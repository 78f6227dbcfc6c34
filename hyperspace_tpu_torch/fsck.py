"""``python -m hyperspace_tpu_torch.fsck`` — fabric lake garbage collection.

Thin CLI shim over :func:`hyperspace_tpu_torch.fabric.fsck.main` (which holds
the actual pass logic and its documentation)."""

from hyperspace_tpu_torch.fabric.fsck import main

if __name__ == "__main__":
    raise SystemExit(main())
