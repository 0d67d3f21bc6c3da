"""Fork/attack detection for the light client
(reference: light/detector.go:27 detectDivergence; a copy of
cometbft_tpu/light/detector.py).

After a verification trace lands, every witness is asked for the target
height; a witness serving a different hash triggers the bifurcation
search (examine_conflicting_header_against_trace), evidence construction
(newLightClientAttackEvidence, detector.go:414), and evidence submission
to both the primary and the witness.  The search verifies each source's
blocks through the client's own bisection (its device and comb cache).
"""

from __future__ import annotations

import logging

from ..types.evidence import LightClientAttackEvidence
from .provider import ErrHeightTooHigh, ErrLightBlockNotFound, ProviderError

logger = logging.getLogger("cometbft_tpu_torch.light-detector")


class DivergenceError(Exception):
    pass


class ErrLightClientAttackDetected(DivergenceError):
    def __init__(self, evidence):
        super().__init__("light client attack detected and evidence submitted")
        self.evidence = evidence


class ErrFailedHeaderCrossReferencing(DivergenceError):
    def __init__(self):
        super().__init__(
            "all witnesses failed to confirm the header — cannot proceed"
        )


def detect_divergence(client, primary_trace, now_ns: int) -> None:
    """detector.go:27 — cross-check the last verified block against every
    witness; at least one must agree."""
    if not primary_trace or len(primary_trace) < 2:
        raise DivergenceError("nil or single block primary trace")
    if not client.witnesses:
        from .client import ErrNoWitnesses

        raise ErrNoWitnesses("divergence detection requires witnesses")
    last = primary_trace[-1]
    header_matched = False
    to_remove = []
    for i, witness in enumerate(client.witnesses):
        try:
            w_lb = witness.light_block(last.height)
        except (ErrLightBlockNotFound, ErrHeightTooHigh):
            continue  # benign: witness is behind
        except ProviderError as e:
            logger.info(f"witness {i} errored during comparison: {e}")
            to_remove.append(i)
            continue
        if w_lb.hash == last.hash:
            header_matched = True
            continue
        # conflicting headers: find the bifurcation and build evidence
        try:
            _handle_conflicting_headers(client, primary_trace, w_lb, witness, now_ns)
        except ErrLightClientAttackDetected:
            raise
        except DivergenceError as e:
            logger.info(f"witness {i} could not substantiate its header: {e}")
            to_remove.append(i)
    client.remove_witnesses(to_remove)
    if not header_matched:
        raise ErrFailedHeaderCrossReferencing()


def _handle_conflicting_headers(
    client, primary_trace, challenging_block, witness, now_ns: int
) -> None:
    """detector.go:215 handleConflictingHeaders."""
    witness_trace, primary_block = _examine_trace(
        client, primary_trace, challenging_block, witness, now_ns
    )
    common, trusted = witness_trace[0], witness_trace[-1]
    ev_against_primary = _new_attack_evidence(primary_block, trusted, common)
    logger.error(
        "ATTEMPTED ATTACK DETECTED — submitting evidence against the primary"
    )
    witness.report_evidence(ev_against_primary)

    # reverse roles: validate the witness's trace against the primary and
    # build the mirror evidence (the witness itself may be the liar)
    evidence = [ev_against_primary]
    try:
        primary_rev_trace, witness_block = _examine_trace(
            client, witness_trace, primary_trace[-1], client.primary, now_ns
        )
        ev_against_witness = _new_attack_evidence(
            witness_block, primary_rev_trace[-1], primary_rev_trace[0]
        )
        client.primary.report_evidence(ev_against_witness)
        evidence.append(ev_against_witness)
    except DivergenceError as e:
        logger.info(f"error validating primary's divergent header: {e}")
    raise ErrLightClientAttackDetected(evidence)


def _examine_trace(client, trace, target_block, source, now_ns: int):
    """detector.go:301 examineConflictingHeaderAgainstTrace — verify the
    source at each intermediate trace height until the hashes diverge;
    returns (source_trace_to_bifurcation, divergent_trace_block)."""
    if target_block.height < trace[0].height:
        raise DivergenceError(
            f"target height {target_block.height} below trusted trace root "
            f"{trace[0].height}"
        )
    prev = None
    source_trace = []
    for idx, trace_block in enumerate(trace):
        if trace_block.height > target_block.height:
            # forward lunatic: the next trace block past the target is the
            # divergent one — but its time must not exceed the target's
            if trace_block.time.unix_ns() > target_block.time.unix_ns():
                raise DivergenceError("invalid block time in trace")
            if prev.height != target_block.height:
                source_trace = client._verify_skipping(
                    source, prev, target_block, now_ns
                )
            return source_trace, trace_block
        if trace_block.height == target_block.height:
            source_block = target_block
        else:
            try:
                source_block = source.light_block(trace_block.height)
            except ProviderError as e:
                raise DivergenceError(f"examining trace: {e}") from e
        if idx == 0:
            if source_block.hash != trace_block.hash:
                raise DivergenceError("trace root mismatch between providers")
            prev = source_block
            continue
        try:
            source_trace = client._verify_skipping(source, prev, source_block, now_ns)
        except Exception as e:  # noqa: BLE001
            raise DivergenceError(f"verify skipping failed: {e}") from e
        if source_block.hash != trace_block.hash:
            return source_trace, trace_block  # bifurcation point
        prev = source_block
    raise DivergenceError("no divergence found in trace")


def _new_attack_evidence(conflicted, trusted, common) -> LightClientAttackEvidence:
    """detector.go:414."""
    ev = LightClientAttackEvidence(
        conflicting_block=conflicted,
        common_height=0,
    )
    if ev.conflicting_header_is_invalid(trusted.signed_header.header):
        ev.common_height = common.height
        ev.timestamp = common.signed_header.header.time
        ev.total_voting_power = common.validator_set.total_voting_power()
    else:
        ev.common_height = trusted.height
        ev.timestamp = trusted.signed_header.header.time
        ev.total_voting_power = trusted.validator_set.total_voting_power()
    ev.byzantine_validators = ev.get_byzantine_validators(
        common.validator_set, trusted.signed_header
    )
    return ev
