"""Validator and ValidatorSet (reference: types/validator.go,
types/validator_set.go): sorting, total power, proposer, and the pubkey
list that keys the comb-table cache.  The part of
cometbft_tpu/types/validators.py that commit verification reads; the
set's proto form, hash and priority rotation are not ported yet.
"""

from __future__ import annotations

MAX_INT64 = (1 << 63) - 1
MAX_TOTAL_VOTING_POWER = MAX_INT64 // 8


class Validator:
    __slots__ = ("address", "pub_key", "voting_power", "proposer_priority")

    def __init__(self, pub_key, voting_power: int, proposer_priority: int = 0):
        self.pub_key = pub_key
        self.address: bytes = pub_key.address()
        self.voting_power = int(voting_power)
        self.proposer_priority = int(proposer_priority)

    def copy(self) -> "Validator":
        return Validator(self.pub_key, self.voting_power, self.proposer_priority)

    def compare_proposer_priority(self, other: "Validator") -> "Validator":
        """Higher priority wins; ties broken by smaller address
        (validator.go CompareProposerPriority)."""
        if other is None:
            return self
        if self.proposer_priority > other.proposer_priority:
            return self
        if self.proposer_priority < other.proposer_priority:
            return other
        if self.address < other.address:
            return self
        if self.address > other.address:
            return other
        raise ValueError("cannot compare identical validators")

    def __eq__(self, other):
        return (
            isinstance(other, Validator)
            and self.address == other.address
            and self.voting_power == other.voting_power
            and self.proposer_priority == other.proposer_priority
        )

    def __repr__(self):
        return (
            f"Validator(addr={self.address.hex()[:12]}, "
            f"power={self.voting_power}, prio={self.proposer_priority})"
        )


def _val_sort_key(v: Validator):
    """Primary: voting power descending; secondary: address ascending
    (validator_set.go ValidatorsByVotingPower)."""
    return (-v.voting_power, v.address)


class ValidatorSet:
    """Sorted validator set (validator_set.go:43)."""

    def __init__(self, validators: list[Validator]):
        self.validators: list[Validator] = sorted(
            (v.copy() for v in validators), key=_val_sort_key
        )
        self._total_voting_power: int | None = None
        self._pub_keys_bytes: list[bytes] | None = None
        self.proposer: Validator | None = None
        if self.validators:
            self._update_total_voting_power()
            self.proposer = self._find_proposer()

    def size(self) -> int:
        return len(self.validators)

    def __len__(self):
        return len(self.validators)

    def _update_total_voting_power(self) -> None:
        total = 0
        for v in self.validators:
            total += v.voting_power
            if total > MAX_TOTAL_VOTING_POWER:
                raise ValueError(
                    f"total voting power exceeds max {MAX_TOTAL_VOTING_POWER}"
                )
        self._total_voting_power = total

    def total_voting_power(self) -> int:
        if self._total_voting_power is None:
            self._update_total_voting_power()
        return self._total_voting_power

    def get_by_address(self, address: bytes) -> tuple[int, Validator | None]:
        for i, v in enumerate(self.validators):
            if v.address == address:
                return i, v
        return -1, None

    def get_proposer(self) -> Validator | None:
        if not self.validators:
            return None
        if self.proposer is None:
            self.proposer = self._find_proposer()
        return self.proposer

    def _find_proposer(self) -> Validator:
        res = None
        for v in self.validators:
            res = v.compare_proposer_priority(res) if res is not None else v
        return res

    def all_keys_have_same_type(self) -> bool:
        """Batch-verification precondition (validator_set.go AllKeysHaveSameType)."""
        if not self.validators:
            return True
        t = self.validators[0].pub_key.type
        return all(v.pub_key.type == t for v in self.validators)

    def pub_keys_bytes(self) -> list[bytes]:
        """Raw pubkeys in set order, cached — the key of the comb-table
        cache (models/comb_verifier.ValsetCombCache)."""
        if self._pub_keys_bytes is None:
            self._pub_keys_bytes = [v.pub_key.bytes() for v in self.validators]
        return self._pub_keys_bytes

    def __repr__(self):
        return f"ValidatorSet({len(self.validators)} validators, power={self.total_voting_power()})"
