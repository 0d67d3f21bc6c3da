"""Evidence verification (reference: internal/evidence/verify.go): the
checks of the evidence the light client's detector produces.  The pool,
its reactor and the full verify(evpool, ev) come later."""

from .verify import (
    EvidenceVerificationError,
    is_evidence_expired,
    verify_duplicate_vote,
    verify_light_client_attack,
)

__all__ = [
    "EvidenceVerificationError",
    "is_evidence_expired",
    "verify_duplicate_vote",
    "verify_light_client_attack",
]
