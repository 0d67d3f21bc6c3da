"""Validator and ValidatorSet (reference: types/validator.go,
types/validator_set.go): sorting, total power, proposer, the pubkey
list that keys the comb-table cache, and the set's RFC-6962 hash over
SimpleValidator encodings.  The part of cometbft_tpu/types/validators.py
that commit and light-client verification read; the set's proto form
and priority rotation are not ported yet.
"""

from __future__ import annotations

from ..crypto import merkle
from ..wire.types import PublicKey, SimpleValidator

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

    def bytes(self) -> bytes:
        """SimpleValidator proto encoding — the hashing form
        (types/validator.go Validator.Bytes).  The port carries ed25519
        keys only."""
        if self.pub_key.type != "ed25519":
            raise ValueError(f"key type {self.pub_key.type!r} not supported")
        sv = SimpleValidator(
            pub_key=PublicKey(ed25519=self.pub_key.bytes()),
            voting_power=self.voting_power,
        )
        return sv.encode()

    def validate_basic(self) -> None:
        if self.pub_key is None:
            raise ValueError("validator does not have a public key")
        if self.voting_power < 0:
            raise ValueError("validator has negative voting power")
        if len(self.address) != 20:
            raise ValueError("validator address is the wrong size")

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
        # memos of hash() and get_by_address(): the set is never changed in place
        self._hash: bytes | None = None
        self._by_address: dict[bytes, int] | None = None
        self.proposer: Validator | None = None
        if self.validators:
            self._update_total_voting_power()
            self.proposer = self._find_proposer()

    def size(self) -> int:
        return len(self.validators)

    def is_nil_or_empty(self) -> bool:
        return not self.validators

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
        """(index, validator) of the first validator with this address, or
        (-1, None).  An index built once per set (the JAX package scans
        the list, which makes a trusting check O(signatures x set))."""
        if self._by_address is None:
            n = len(self.validators)
            self._by_address = {
                v.address: n - 1 - j for j, v in enumerate(reversed(self.validators))
            }
        i = self._by_address.get(address, -1)
        return (i, self.validators[i]) if i >= 0 else (-1, None)

    def has_address(self, address: bytes) -> bool:
        return self.get_by_address(address)[1] is not None

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

    def validate_basic(self) -> None:
        if self.is_nil_or_empty():
            raise ValueError("validator set is nil or empty")
        for v in self.validators:
            v.validate_basic()
        p = self.get_proposer()
        if p is None:
            raise ValueError("proposer failed validate basic")
        p.validate_basic()
        if not self.has_address(p.address):
            raise ValueError("proposer not in validator set")

    def hash(self, device="cuda") -> bytes:
        """RFC-6962 root over the SimpleValidator encodings
        (validator_set.go:386), memoised.  Sets of at least
        crypto/merkle.DEVICE_THRESHOLD validators take the kernel route
        on ``device`` (K7, then one K8 per level), smaller sets hashlib,
        as the JAX package routes them."""
        if self._hash is None:
            items = [v.bytes() for v in self.validators]
            route = device if len(items) >= merkle.DEVICE_THRESHOLD else False
            self._hash = merkle.hash_from_byte_slices(items, device=route)
        return self._hash

    def __repr__(self):
        return f"ValidatorSet({len(self.validators)} validators, power={self.total_voting_power()})"
