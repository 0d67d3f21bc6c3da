"""Commit verification — the framework's hot path (reference:
types/validation.go), ported from cometbft_tpu/types/validation.py.

verify_commit* assemble a batch of (pubkey, sign-bytes, signature)
triples and hand it to the BatchVerifier seam
(crypto/batch.create_batch_verifier), a client of the verify service
under the caller's ``klass`` (default CONSENSUS), which binds an ed25519
set to its comb tables on the card or routes it to the uncached verifier
(small sets, tables still building); on batch failure the per-signature validity
vector assigns blame exactly like the reference (validation.go:384-399),
and the sequential host path covers commits that do not batch
(shouldBatchVerify, validation.go:17-21).

Every entry point takes ``device`` (default ``"cuda"``) and raises when
no card is present unless the caller passes ``device="cpu"``, which runs
the kernels' plain PyTorch versions.  ``comb_cache`` selects the table
cache (default: the process-wide one).
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

from .._device import resolve_device
from ..crypto import batch as crypto_batch
from .block import BlockID, Commit
from .validators import ValidatorSet

BATCH_VERIFY_THRESHOLD = 2  # validation.go:15


class CommitVerificationError(Exception):
    pass


class NotEnoughVotingPowerError(CommitVerificationError):
    def __init__(self, got: int, needed: int):
        super().__init__(f"invalid commit -- insufficient voting power: got {got}, needed more than {needed}")
        self.got = got
        self.needed = needed


@dataclass
class SignatureCacheValue:
    validator_address: bytes
    vote_sign_bytes: bytes


class SignatureCache:
    """Cross-call dedup of verified signatures (validation.go SignatureCache);
    shared between the 1/3-trusting and 2/3 passes of light verification."""

    def __init__(self, max_size: int = 1 << 16):
        self._d: dict[bytes, SignatureCacheValue] = {}
        self._max = max_size

    def get(self, sig: bytes) -> SignatureCacheValue | None:
        return self._d.get(sig)

    def add(self, sig: bytes, value: SignatureCacheValue) -> None:
        if len(self._d) >= self._max:
            self._d.pop(next(iter(self._d)))
        self._d[sig] = value

    def __len__(self):
        return len(self._d)


def should_batch_verify(vals: ValidatorSet, commit: Commit) -> bool:
    """(validation.go:17) >= 2 sigs, key type batchable, homogeneous set."""
    proposer = vals.get_proposer()
    return (
        len(commit.signatures) >= BATCH_VERIFY_THRESHOLD
        and proposer is not None
        and crypto_batch.supports_batch_verifier(proposer.pub_key.type)
        and vals.all_keys_have_same_type()
    )


def verify_commit(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
    klass=None,
    *,
    device="cuda",
    comb_cache=None,
) -> None:
    """+2/3 of the set signed this commit; checks ALL signatures (the ABCI
    app's incentive logic depends on every flag being right)
    (validation.go:30)."""
    device = resolve_device(device)
    _verify_basic_vals_and_commit(vals, commit, height, block_id)
    voting_power_needed = vals.total_voting_power() * 2 // 3
    ignore = lambda cs: cs.absent_flag()
    count = lambda cs: cs.for_block()
    if should_batch_verify(vals, commit):
        _verify_commit_batch(
            chain_id, vals, commit, voting_power_needed, ignore, count,
            count_all_signatures=True, lookup_by_index=True, cache=None,
            klass=klass, device=device, comb_cache=comb_cache,
        )
    else:
        _verify_commit_single(
            chain_id, vals, commit, voting_power_needed, ignore, count,
            count_all_signatures=True, lookup_by_index=True, cache=None,
        )


def verify_commit_light(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
    count_all_signatures: bool = False,
    cache: SignatureCache | None = None,
    klass=None,
    *,
    device="cuda",
    comb_cache=None,
) -> None:
    """+2/3 check that may exit early — the light-client / blocksync path
    (validation.go:65-147)."""
    device = resolve_device(device)
    _verify_basic_vals_and_commit(vals, commit, height, block_id)
    voting_power_needed = vals.total_voting_power() * 2 // 3
    ignore = lambda cs: not cs.for_block()
    count = lambda cs: True
    if should_batch_verify(vals, commit):
        _verify_commit_batch(
            chain_id, vals, commit, voting_power_needed, ignore, count,
            count_all_signatures=count_all_signatures, lookup_by_index=True,
            cache=cache, klass=klass, device=device, comb_cache=comb_cache,
        )
    else:
        _verify_commit_single(
            chain_id, vals, commit, voting_power_needed, ignore, count,
            count_all_signatures=count_all_signatures, lookup_by_index=True,
            cache=cache,
        )


def verify_commit_light_trusting(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    trust_level: Fraction = Fraction(1, 3),
    count_all_signatures: bool = False,
    cache: SignatureCache | None = None,
    klass=None,
    *,
    device="cuda",
    comb_cache=None,
) -> None:
    """trustLevel of a *trusted* set signed this commit; validators are
    looked up by address since the sets differ (validation.go:150-253)."""
    device = resolve_device(device)
    if vals is None:
        raise CommitVerificationError("nil validator set")
    if commit is None:
        raise CommitVerificationError("nil commit")
    if trust_level.denominator == 0:
        raise CommitVerificationError("trustLevel has zero Denominator")
    total = vals.total_voting_power()
    voting_power_needed = total * trust_level.numerator // trust_level.denominator
    ignore = lambda cs: not cs.for_block()
    count = lambda cs: True
    if should_batch_verify(vals, commit):
        _verify_commit_batch(
            chain_id, vals, commit, voting_power_needed, ignore, count,
            count_all_signatures=count_all_signatures, lookup_by_index=False,
            cache=cache, klass=klass, device=device, comb_cache=comb_cache,
        )
    else:
        _verify_commit_single(
            chain_id, vals, commit, voting_power_needed, ignore, count,
            count_all_signatures=count_all_signatures, lookup_by_index=False,
            cache=cache,
        )


# ------------------------------------------------------------------ internal


def _verify_basic_vals_and_commit(vals, commit, height, block_id):
    """(validation.go:507)."""
    if vals is None:
        raise CommitVerificationError("nil validator set")
    if commit is None:
        raise CommitVerificationError("nil commit")
    if vals.size() != len(commit.signatures):
        raise CommitVerificationError(
            f"invalid commit -- wrong set size: {vals.size()} vs {len(commit.signatures)}"
        )
    if height != commit.height:
        raise CommitVerificationError(
            f"invalid commit -- wrong height: {height} vs {commit.height}"
        )
    if block_id != commit.block_id:
        raise CommitVerificationError(
            f"invalid commit -- wrong block ID: want {block_id}, got {commit.block_id}"
        )


def _assemble_commit_batch(
    bv,
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    voting_power_needed: int,
    ignore_sig,
    count_sig,
    count_all_signatures: bool,
    lookup_by_index: bool,
    cache: SignatureCache | None,
):
    """(validation.go:265, assembly half) — fill the batch verifier and
    tally power; raises on insufficient power / double votes.  Returns
    (batch_sig_idxs, sign_bytes_at) for the judging half."""
    seen_vals: dict[int, int] = {}
    batch_sig_idxs: list[int] = []
    tallied = 0
    sign_bytes_at = commit.vote_sign_bytes_fn(chain_id)

    for idx, cs in enumerate(commit.signatures):
        if ignore_sig(cs):
            continue
        if lookup_by_index:
            val = vals.validators[idx]
        else:
            val_idx, val = vals.get_by_address(cs.validator_address)
            if val is None:
                continue
            if val_idx in seen_vals:
                raise CommitVerificationError(
                    f"double vote from {val} ({seen_vals[val_idx]} and {idx})"
                )
            seen_vals[val_idx] = idx

        sign_bytes = sign_bytes_at(idx)

        cache_hit = False
        if cache is not None:
            cv = cache.get(cs.signature)
            cache_hit = (
                cv is not None
                and cv.validator_address == val.pub_key.address()
                and cv.vote_sign_bytes == sign_bytes
            )
        if not cache_hit:
            bv.add(val.pub_key.bytes(), sign_bytes, cs.signature)
            batch_sig_idxs.append(idx)

        if count_sig(cs):
            tallied += val.voting_power
        if not count_all_signatures and tallied > voting_power_needed:
            break

    if tallied <= voting_power_needed:
        raise NotEnoughVotingPowerError(got=tallied, needed=voting_power_needed)
    return batch_sig_idxs, sign_bytes_at


def _judge_batch_result(
    ok: bool,
    valid_sigs: list[bool],
    commit: Commit,
    batch_sig_idxs: list[int],
    sign_bytes_at,
    cache: SignatureCache | None,
) -> None:
    """(validation.go:384-399, judging half) — blame order + cache fill."""
    if ok:
        if cache is not None:
            for idx in batch_sig_idxs:
                cs = commit.signatures[idx]
                cache.add(
                    cs.signature,
                    SignatureCacheValue(
                        validator_address=cs.validator_address,
                        vote_sign_bytes=sign_bytes_at(idx),
                    ),
                )
        return

    # per-signature blame: report the first invalid one (validation.go:384)
    for i, sig_ok in enumerate(valid_sigs):
        idx = batch_sig_idxs[i]
        cs = commit.signatures[idx]
        if not sig_ok:
            raise CommitVerificationError(
                f"wrong signature (#{idx}): {cs.signature.hex()}"
            )
        if cache is not None:
            cache.add(
                cs.signature,
                SignatureCacheValue(
                    validator_address=cs.validator_address,
                    vote_sign_bytes=sign_bytes_at(idx),
                ),
            )
    raise CommitVerificationError(
        "BUG: batch verification failed with no invalid signatures"
    )


def _verify_commit_batch(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    voting_power_needed: int,
    ignore_sig,
    count_sig,
    count_all_signatures: bool,
    lookup_by_index: bool,
    cache: SignatureCache | None,
    klass,
    device,
    comb_cache,
) -> None:
    """(validation.go:265) — batch assembly, power tally, verify-service
    dispatch under ``klass`` on ``device``, blame."""
    proposer = vals.get_proposer()
    bv = crypto_batch.create_batch_verifier(
        proposer.pub_key.type, pubkeys=vals.pub_keys_bytes(), klass=klass,
        device=device, comb_cache=comb_cache,
    )
    batch_sig_idxs, sign_bytes_at = _assemble_commit_batch(
        bv, chain_id, vals, commit, voting_power_needed, ignore_sig,
        count_sig, count_all_signatures, lookup_by_index, cache,
    )
    if not batch_sig_idxs:
        return  # everything came from the cache

    ok, valid_sigs = bv.verify()
    _judge_batch_result(ok, valid_sigs, commit, batch_sig_idxs, sign_bytes_at, cache)


class PendingCommitVerification:
    """An in-flight verify_commit_light: the device kernel was dispatched
    by submit_verify_commit_light and is running while the caller does
    other host work (the blocksync verify-ahead pipeline).  collect()
    waits for the result and raises exactly what verify_commit_light
    would have."""

    __slots__ = ("_bv", "_ticket", "_commit", "_idxs", "_sign_bytes_at", "_cache")

    def __init__(self, bv, ticket, commit, idxs, sign_bytes_at, cache):
        self._bv = bv
        self._ticket = ticket
        self._commit = commit
        self._idxs = idxs
        self._sign_bytes_at = sign_bytes_at
        self._cache = cache

    def collect(self) -> None:
        if self._bv is None:
            return  # everything came from the signature cache
        ok, valid_sigs = self._bv.collect(self._ticket)
        _judge_batch_result(
            ok, valid_sigs, self._commit, self._idxs, self._sign_bytes_at,
            self._cache,
        )


def submit_verify_commit_light(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
    count_all_signatures: bool = False,
    cache: SignatureCache | None = None,
    klass=None,
    *,
    device="cuda",
    comb_cache=None,
) -> PendingCommitVerification | None:
    """Asynchronous verify_commit_light (reactor.go:547's hot path,
    pipelined): run every host-side phase that can raise immediately —
    basic checks, batch assembly, power tally — and enqueue the device
    work WITHOUT waiting for its verdict.  The request goes to the verify
    service under ``klass`` (the blocksync replay passes
    Klass.BLOCKSYNC, as the JAX reactor does); a comb batch's submit
    there only hands it to the staging thread, which fills the payload,
    copies it and launches the kernels, so a pipelined caller overlaps
    the next block's host work with this one's fill and kernels
    (blocksync/replay.verify_ahead).  Returns None when the commit
    doesn't take the batch path at all (small set, heterogeneous keys):
    the caller must then run verify_commit_light synchronously."""
    device = resolve_device(device)
    _verify_basic_vals_and_commit(vals, commit, height, block_id)
    if not should_batch_verify(vals, commit):
        return None
    proposer = vals.get_proposer()
    bv = crypto_batch.create_batch_verifier(
        proposer.pub_key.type, pubkeys=vals.pub_keys_bytes(), klass=klass,
        device=device, comb_cache=comb_cache,
    )
    voting_power_needed = vals.total_voting_power() * 2 // 3
    batch_sig_idxs, sign_bytes_at = _assemble_commit_batch(
        bv, chain_id, vals, commit, voting_power_needed,
        ignore_sig=lambda cs: not cs.for_block(),
        count_sig=lambda cs: True,
        count_all_signatures=count_all_signatures,
        lookup_by_index=True,
        cache=cache,
    )
    if not batch_sig_idxs:
        return PendingCommitVerification(None, None, commit, [], sign_bytes_at, cache)
    return PendingCommitVerification(
        bv, bv.submit(), commit, batch_sig_idxs, sign_bytes_at, cache
    )


def _verify_commit_single(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    voting_power_needed: int,
    ignore_sig,
    count_sig,
    count_all_signatures: bool,
    lookup_by_index: bool,
    cache: SignatureCache | None,
) -> None:
    """(validation.go:413) — the sequential fallback."""
    seen_vals: dict[int, int] = {}
    tallied = 0
    sign_bytes_at = commit.vote_sign_bytes_fn(chain_id)
    for idx, cs in enumerate(commit.signatures):
        if ignore_sig(cs):
            continue
        try:
            cs.validate_basic()
        except ValueError as e:
            raise CommitVerificationError(
                f"invalid signature at index {idx}: {e}"
            ) from e
        if lookup_by_index:
            val = vals.validators[idx]
        else:
            val_idx, val = vals.get_by_address(cs.validator_address)
            if val is None:
                continue
            if val_idx in seen_vals:
                raise CommitVerificationError(
                    f"double vote from {val} ({seen_vals[val_idx]} and {idx})"
                )
            seen_vals[val_idx] = idx

        if val.pub_key is None:
            raise CommitVerificationError(f"validator {val} has a nil PubKey at index {idx}")

        sign_bytes = sign_bytes_at(idx)

        cache_hit = False
        if cache is not None:
            cv = cache.get(cs.signature)
            cache_hit = (
                cv is not None
                and cv.validator_address == val.pub_key.address()
                and cv.vote_sign_bytes == sign_bytes
            )
        if not cache_hit:
            if not val.pub_key.verify_signature(sign_bytes, cs.signature):
                raise CommitVerificationError(
                    f"wrong signature (#{idx}): {cs.signature.hex()}"
                )
            if cache is not None:
                cache.add(
                    cs.signature,
                    SignatureCacheValue(
                        validator_address=val.pub_key.address(),
                        vote_sign_bytes=sign_bytes,
                    ),
                )

        if count_sig(cs):
            tallied += val.voting_power
        if not count_all_signatures and tallied > voting_power_needed:
            return

    if tallied <= voting_power_needed:
        raise NotEnoughVotingPowerError(got=tallied, needed=voting_power_needed)
