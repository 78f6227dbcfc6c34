"""Signature providers.

``FileBasedSignatureProvider`` fingerprints a relation by folding each file's
(mtime, length, path) and hashing (ref: HS/index/FileBasedSignatureProvider.scala:30-62).
``IndexSignatureProvider`` adds a fingerprint of the plan structure on top
(ref: HS/index/IndexSignatureProvider.scala).
"""

from __future__ import annotations

from typing import Optional

from hyperspace_tpu_torch.utils.hashing import md5_hex

FILE_BASED_SIGNATURE_PROVIDER = "FileBasedSignatureProvider"
# /v2: the plan-structure token canonicalizes Scan by format instead of by
# root-path spelling (glob/dir/file-list addressing of the same files now
# signature-equal). Entries recorded under an older provider are disqualified
# with an explicit provider-mismatch reason until refreshed.
INDEX_SIGNATURE_PROVIDER = "IndexSignatureProvider/v2"


def file_based_signature(file_infos) -> str:
    parts = sorted(f"{fi.modified_time}:{fi.size}:{fi.name}" for fi in file_infos)
    return md5_hex("\n".join(parts))


def plan_structure_string(plan) -> str:
    """A canonical string of the plan's node kinds + shapes (stands in for
    Catalyst canonicalization; ref: HS/index/PlanSignatureProvider.scala)."""
    from hyperspace_tpu_torch.plan import logical as L

    def walk(p) -> str:
        if isinstance(p, L.Scan):
            # canonicalize by format, not path spelling: the same file set is
            # addressable as a directory, a glob, or an explicit list, and
            # data identity is already carried by the file-based signature
            # (the reference needs a globbingPattern conf for this,
            # HS/index/IndexConstants + DataPathFilter; resolved-file identity
            # subsumes it)
            return f"Scan({p.relation.file_format})"
        name = type(p).__name__
        inner = ",".join(walk(c) for c in p.children())
        if isinstance(p, L.Project):
            name += f"[{','.join(c.lower() for c in p.columns)}]"
        return f"{name}({inner})"

    return walk(plan)


def index_signature(plan) -> Optional[str]:
    """Signature of the full source plan: plan structure + every relation's
    file-based signature (ref: HS/index/IndexSignatureProvider.scala)."""
    from hyperspace_tpu_torch.plan import logical as L

    scans = L.collect(plan, lambda p: isinstance(p, L.Scan))
    if not scans:
        return None
    rel_sigs = sorted(s.relation.signature() for s in scans)
    return md5_hex(plan_structure_string(plan) + "|" + "|".join(rel_sigs))
