"""Evidence subsystem: the pool and the verification of evidence against
a node's stores (reference: internal/evidence/; the port of
cometbft_tpu/evidence/pool.py and verify.py).  The gossip reactor needs
p2p and comes with it."""

from .pool import ErrInvalidEvidence, EvidenceError, EvidencePool, evidence_from_proto_bytes
from .verify import (
    EvidenceVerificationError,
    is_evidence_expired,
    verify_duplicate_vote,
    verify_light_client_attack,
)

__all__ = [
    "EvidencePool",
    "EvidenceError",
    "ErrInvalidEvidence",
    "EvidenceVerificationError",
    "evidence_from_proto_bytes",
    "is_evidence_expired",
    "verify_duplicate_vote",
    "verify_light_client_attack",
]
