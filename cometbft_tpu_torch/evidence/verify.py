"""Evidence verification against full-node state (reference:
internal/evidence/verify.go; the host checks of
cometbft_tpu/evidence/verify.py): the expiry gate (:20-46),
VerifyDuplicateVote (:164) and VerifyLightClientAttack (:110).

The commit checks of a light-client attack go through
types/validation.py, so through the verify service and the card's
ed25519 kernels, under Klass.CONSENSUS: evidence carried by a proposed
block is checked on the consensus critical path, and every signature is
counted (the evidence will punish validators, so every flag must be
right).  ``device`` and ``comb_cache`` reach both checks.
"""

from __future__ import annotations

from fractions import Fraction

from ..types.evidence import DuplicateVoteEvidence, LightClientAttackEvidence
from ..types.validation import (
    verify_commit_light,
    verify_commit_light_trusting,
)
from ..verifysvc.service import Klass as _VerifyKlass

DEFAULT_TRUST_LEVEL = Fraction(1, 3)  # light.DefaultTrustLevel


class EvidenceVerificationError(Exception):
    pass


def is_evidence_expired(
    chain_height: int,
    chain_time_ns: int,
    ev_height: int,
    ev_time_ns: int,
    params,
) -> bool:
    """Both age bounds must be exceeded (evidence params, pool.go:320)."""
    age_blocks = chain_height - ev_height
    age_ns = chain_time_ns - ev_time_ns
    return (
        age_blocks > params.max_age_num_blocks
        and age_ns > params.max_age_duration_ns
    )


def verify_duplicate_vote(ev: DuplicateVoteEvidence, chain_id: str, val_set) -> None:
    """verify.go:164; the two signatures on the host."""
    a, b = ev.vote_a, ev.vote_b
    _, val = val_set.get_by_address(a.validator_address)
    if val is None:
        raise EvidenceVerificationError(
            f"address {a.validator_address.hex()} was not a validator at "
            f"height {ev.height()}"
        )
    if (a.height, a.round, a.type) != (b.height, b.round, b.type):
        raise EvidenceVerificationError("votes differ in height/round/type")
    if a.validator_address != b.validator_address:
        raise EvidenceVerificationError("validator addresses do not match")
    if a.block_id == b.block_id:
        raise EvidenceVerificationError(
            "block IDs are the same — this is not equivocation"
        )
    if val.pub_key.address() != a.validator_address:
        raise EvidenceVerificationError("address does not match pubkey")
    if val.voting_power != ev.validator_power:
        raise EvidenceVerificationError(
            f"validator power {ev.validator_power} != {val.voting_power}"
        )
    if val_set.total_voting_power() != ev.total_voting_power:
        raise EvidenceVerificationError(
            f"total power {ev.total_voting_power} != "
            f"{val_set.total_voting_power()}"
        )
    if not val.pub_key.verify_signature(a.sign_bytes(chain_id), a.signature):
        raise EvidenceVerificationError("invalid signature on vote A")
    if not val.pub_key.verify_signature(b.sign_bytes(chain_id), b.signature):
        raise EvidenceVerificationError("invalid signature on vote B")


def verify_light_client_attack(
    ev: LightClientAttackEvidence,
    common_sh,
    trusted_sh,
    common_vals,
    chain_id: str,
    *,
    device="cuda",
    comb_cache=None,
) -> None:
    """verify.go:110 — 1/3 of the common set signed the conflicting
    header; 2/3 of its claimed set signed it; and it genuinely conflicts."""
    cb = ev.conflicting_block
    if common_sh.header.height != cb.height:
        # lunatic: single trusting jump from the common header, under
        # CONSENSUS (a lower class would let mempool load starve prevotes
        # on exactly the blocks that carry evidence)
        verify_commit_light_trusting(
            chain_id,
            common_vals,
            cb.signed_header.commit,
            DEFAULT_TRUST_LEVEL,
            count_all_signatures=True,
            klass=_VerifyKlass.CONSENSUS,
            device=device,
            comb_cache=comb_cache,
        )
    elif ev.conflicting_header_is_invalid(trusted_sh.header):
        raise EvidenceVerificationError(
            "common height equals conflicting height, but the conflicting "
            "header is not correctly derived"
        )

    verify_commit_light(
        chain_id,
        cb.validator_set,
        cb.signed_header.commit.block_id,
        cb.height,
        cb.signed_header.commit,
        count_all_signatures=True,
        klass=_VerifyKlass.CONSENSUS,
        device=device,
        comb_cache=comb_cache,
    )

    if ev.total_voting_power != common_vals.total_voting_power():
        raise EvidenceVerificationError(
            f"total power {ev.total_voting_power} != "
            f"{common_vals.total_voting_power()}"
        )

    if cb.height > trusted_sh.header.height:
        # forward lunatic: must violate monotonic time
        if cb.time.unix_ns() > trusted_sh.header.time.unix_ns():
            raise EvidenceVerificationError(
                "conflicting block does not violate monotonic time"
            )
    elif trusted_sh.header.hash() == cb.hash:
        raise EvidenceVerificationError(
            "conflicting header is identical to the trusted header"
        )

    # the reported byzantine validators must be exactly the derivable set
    want = ev.get_byzantine_validators(common_vals, trusted_sh)
    got = ev.byzantine_validators
    if len(want) != len(got) or any(
        w.address != g.address or w.voting_power != g.voting_power
        for w, g in zip(want, got)
    ):
        raise EvidenceVerificationError(
            "byzantine validator list does not match the evidence"
        )
