"""Evidence verification against full-node state (reference:
internal/evidence/verify.go; a copy of cometbft_tpu/evidence/verify.py):
verify() with its time and expiry gates (:20-46), VerifyDuplicateVote
(:164) and VerifyLightClientAttack (:110).

The commit checks of a light-client attack go through
types/validation.py, so through the verify service and the card's
ed25519 kernels, under Klass.CONSENSUS: evidence carried by a proposed
block is checked on the consensus critical path, and every signature is
counted (the evidence will punish validators, so every flag must be
right).  ``device`` and ``comb_cache`` reach both checks; verify()
takes them from the pool.
"""

from __future__ import annotations

from fractions import Fraction

from ..types.block import Header
from ..types.evidence import DuplicateVoteEvidence, LightClientAttackEvidence
from ..types.light_block import SignedHeader
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


def verify(evpool, ev) -> None:
    """Full verification of one piece of evidence against pool state
    (verify.go:20): the block time at the evidence's height, expiry, then
    the kind's own check on the stored validator set and headers, on the
    pool's ``device`` and ``comb_cache``."""
    state = evpool.state
    params = state.consensus_params.evidence

    meta = evpool.block_store.load_block_meta(ev.height())
    if meta is None:
        raise EvidenceVerificationError(
            f"no header at evidence height {ev.height()}"
        )
    ev_time = meta.header.time
    if ev.time().unix_ns() != ev_time.unix_ns():
        raise EvidenceVerificationError(
            f"evidence time {ev.time()} differs from block time {ev_time}"
        )
    if is_evidence_expired(
        state.last_block_height,
        state.last_block_time.unix_ns(),
        ev.height(),
        ev_time.unix_ns(),
        params,
    ):
        raise EvidenceVerificationError(
            f"evidence from height {ev.height()} is too old "
            f"(min height {state.last_block_height - params.max_age_num_blocks})"
        )

    if isinstance(ev, DuplicateVoteEvidence):
        val_set = evpool.state_store.load_validators(ev.height())
        if val_set is None:
            raise EvidenceVerificationError(
                f"no validator set stored for height {ev.height()}"
            )
        verify_duplicate_vote(ev, state.chain_id, val_set)
    elif isinstance(ev, LightClientAttackEvidence):
        common_sh = _signed_header_at(evpool.block_store, ev.height())
        common_vals = evpool.state_store.load_validators(ev.height())
        if common_vals is None:
            raise EvidenceVerificationError(
                f"no validator set stored for height {ev.height()}"
            )
        conflict_h = ev.conflicting_block.height
        if conflict_h != ev.height():
            trusted_sh = _signed_header_at_or_latest(
                evpool.block_store, conflict_h, ev
            )
        else:
            trusted_sh = common_sh
        verify_light_client_attack(
            ev, common_sh, trusted_sh, common_vals, state.chain_id,
            device=evpool.device, comb_cache=evpool.comb_cache,
        )
    else:
        raise EvidenceVerificationError(
            f"unrecognized evidence type {type(ev).__name__}"
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


def _signed_header_at(block_store, height: int) -> SignedHeader:
    meta = block_store.load_block_meta(height)
    commit = block_store.load_block_commit(height)
    if meta is None or commit is None:
        raise EvidenceVerificationError(f"no header/commit at height {height}")
    return SignedHeader(Header.from_proto(meta.header), commit)


def _signed_header_at_or_latest(block_store, height: int, ev) -> SignedHeader:
    try:
        return _signed_header_at(block_store, height)
    except EvidenceVerificationError:
        # forward lunatic attack: fall back to our latest header — for the
        # attack to be provable, monotonic time must be violated, i.e. our
        # newest block must NOT be older than the conflicting one
        # (verify.go:70-84)
        latest = block_store.height
        sh = _signed_header_at(block_store, latest)
        if sh.header.time.unix_ns() < ev.conflicting_block.time.unix_ns():
            raise EvidenceVerificationError(
                f"latest block time {sh.header.time} is before conflicting "
                f"block time {ev.conflicting_block.time}"
            )
        return sh
