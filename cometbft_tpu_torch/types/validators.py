"""Validator and ValidatorSet (reference: types/validator.go,
types/validator_set.go), as cometbft_tpu/types/validators.py has them:
sorting, total power capped at MaxInt64/8, proposer selection by
priority increment (validator_set.go:131 IncrementProposerPriority),
change sets, the proto round trip, the pubkey list that keys the
comb-table cache, and the set's RFC-6962 hash over SimpleValidator
encodings (validator_set.go:386) on the card for large sets.
"""

from __future__ import annotations

from ..crypto import encoding as keyenc
from ..crypto import merkle
from ..wire import types as pb

MAX_INT64 = (1 << 63) - 1
MIN_INT64 = -(1 << 63)
MAX_TOTAL_VOTING_POWER = MAX_INT64 // 8
PRIORITY_WINDOW_SIZE_FACTOR = 2


def _clip(v: int) -> int:
    """Saturating int64 (safeAddClip/safeSubClip in the reference)."""
    return max(MIN_INT64, min(MAX_INT64, v))


class Validator:
    __slots__ = ("address", "pub_key", "voting_power", "proposer_priority")

    def __init__(self, pub_key, voting_power: int, proposer_priority: int = 0):
        self.pub_key = pub_key
        self.address: bytes = pub_key.address()
        self.voting_power = int(voting_power)
        self.proposer_priority = int(proposer_priority)

    def copy(self) -> "Validator":
        """The same validator; the address is carried over, not hashed
        again from the key."""
        v = Validator.__new__(Validator)
        v.pub_key, v.address = self.pub_key, self.address
        v.voting_power, v.proposer_priority = self.voting_power, self.proposer_priority
        return v

    def bytes(self) -> bytes:
        """SimpleValidator proto encoding — the hashing form
        (types/validator.go Validator.Bytes): the key in its PublicKey
        arm (crypto/encoding.go PubKeyToProto)."""
        sv = pb.SimpleValidator(
            pub_key=keyenc.pubkey_to_proto(self.pub_key),
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

    def to_proto(self) -> pb.Validator:
        return pb.Validator(
            address=self.address,
            pub_key_bytes=self.pub_key.bytes(),
            pub_key_type=self.pub_key.type,
            voting_power=self.voting_power,
            proposer_priority=self.proposer_priority,
        )

    @classmethod
    def from_proto(cls, msg: pb.Validator) -> "Validator":
        if msg.pub_key_bytes:
            key = keyenc.pubkey_from_type_and_bytes(msg.pub_key_type, msg.pub_key_bytes)
        elif msg.pub_key is not None:
            key = keyenc.pubkey_from_proto(msg.pub_key)
        else:
            raise ValueError("validator proto missing public key")
        return cls(key, msg.voting_power, msg.proposer_priority)

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
    """Sorted validator set with proposer rotation (validator_set.go:43).

    Memos of membership (the hash, the address index, the pubkey list)
    live until update_with_change_set changes the members; copy() keeps
    them, and the priority rotation leaves them be."""

    def __init__(self, validators: list[Validator]):
        self.validators: list[Validator] = sorted(
            (v.copy() for v in validators), key=_val_sort_key
        )
        self._total_voting_power: int | None = None
        self._pub_keys_bytes: list[bytes] | None = None
        # memos of hash() and get_by_address(), dropped by update_with_change_set
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

    def copy(self) -> "ValidatorSet":
        new = ValidatorSet.__new__(ValidatorSet)
        new.validators = [v.copy() for v in self.validators]
        new._total_voting_power = self._total_voting_power
        # the same membership: the memos hold
        new._pub_keys_bytes = self._pub_keys_bytes
        new._hash = self._hash
        new._by_address = self._by_address
        new.proposer = None
        if self.proposer is not None:
            for v in new.validators:
                if v.address == self.proposer.address:
                    new.proposer = v
                    break
            else:
                new.proposer = self.proposer.copy()
        return new

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

    def validator_blocks_the_chain(self, address: bytes) -> bool:
        """True if this validator alone holds > 1/3 power, i.e. the chain
        cannot progress without it (validator_set.go:374)."""
        _, val = self.get_by_address(address)
        if val is None:
            return False
        return val.voting_power > (self.total_voting_power() - 1) // 3

    def get_by_index(self, index: int) -> tuple[bytes, Validator | None]:
        if index < 0 or index >= len(self.validators):
            return b"", None
        v = self.validators[index]
        return v.address, v

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
        on ``device`` (K7, then one K8 for the tree), smaller sets hashlib,
        as the JAX package routes them."""
        if self._hash is None:
            items = [v.bytes() for v in self.validators]
            route = device if len(items) >= merkle.DEVICE_THRESHOLD else False
            self._hash = merkle.hash_from_byte_slices(items, device=route)
        return self._hash

    # ------------------------------------------- proposer priority cycle

    def increment_proposer_priority(self, times: int) -> None:
        """Advance the proposer rotation `times` rounds
        (validator_set.go:131)."""
        if self.is_nil_or_empty():
            raise ValueError("empty validator set")
        if times <= 0:
            raise ValueError("cannot call increment_proposer_priority with non-positive times")
        diff_max = PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        self.rescale_priorities(diff_max)
        self._shift_by_avg_proposer_priority()
        proposer = None
        for _ in range(times):
            proposer = self._increment_proposer_priority()
        self.proposer = proposer

    def _increment_proposer_priority(self) -> Validator:
        for v in self.validators:
            v.proposer_priority = _clip(v.proposer_priority + v.voting_power)
        mostest = self._find_proposer()
        mostest.proposer_priority = _clip(
            mostest.proposer_priority - self.total_voting_power()
        )
        return mostest

    def rescale_priorities(self, diff_max: int) -> None:
        """Keep max-min priority distance under diff_max (validator_set.go:158)."""
        if self.is_nil_or_empty():
            raise ValueError("empty validator set")
        if diff_max <= 0:
            return
        diff = self._max_min_priority_diff()
        ratio = (diff + diff_max - 1) // diff_max
        if diff > diff_max:
            for v in self.validators:
                # Go integer division truncates toward zero.
                q = abs(v.proposer_priority) // ratio
                v.proposer_priority = q if v.proposer_priority >= 0 else -q

    def _max_min_priority_diff(self) -> int:
        prios = [v.proposer_priority for v in self.validators]
        return max(prios) - min(prios)

    def _compute_avg_proposer_priority(self) -> int:
        n = len(self.validators)
        total = sum(v.proposer_priority for v in self.validators)
        # Go big.Int Div floors toward negative infinity; Python // matches.
        return total // n

    def _shift_by_avg_proposer_priority(self) -> None:
        avg = self._compute_avg_proposer_priority()
        for v in self.validators:
            v.proposer_priority = _clip(v.proposer_priority - avg)

    # ------------------------------------------------------------ updates

    def update_with_change_set(self, changes: list[Validator]) -> None:
        """Apply validator updates (power 0 = removal), recompute priorities
        (validator_set.go UpdateWithChangeSet + computeNewPriorities:534).
        Drops the membership memos (hash, address index, pubkey list)."""
        if not changes:
            return
        # no duplicates allowed
        seen = set()
        for c in changes:
            if c.address in seen:
                raise ValueError(f"duplicate address in changes: {c.address.hex()}")
            seen.add(c.address)
            if c.voting_power < 0:
                raise ValueError("voting power cannot be negative")

        removals = {c.address for c in changes if c.voting_power == 0}
        updates = [c.copy() for c in changes if c.voting_power > 0]

        for addr in removals:
            if not self.has_address(addr):
                raise ValueError(
                    f"failed to find validator {addr.hex()} to remove"
                )

        by_addr = {v.address: v for v in self.validators}
        # compute what the new total will be, for new-validator priorities
        new_total = 0
        merged = dict(by_addr)
        for u in updates:
            merged[u.address] = u
        for addr in removals:
            merged.pop(addr, None)
        if not merged:
            raise ValueError("applying the validator changes would result in empty set")
        for v in merged.values():
            new_total += v.voting_power
        if new_total > MAX_TOTAL_VOTING_POWER:
            raise ValueError("total voting power of resulting valset exceeds max")

        for u in updates:
            existing = by_addr.get(u.address)
            if existing is None:
                # new validator starts at -1.125 * new total power
                # (validator_set.go:547)
                u.proposer_priority = -(new_total + (new_total >> 3))
            else:
                u.proposer_priority = existing.proposer_priority
            merged[u.address] = u

        self.validators = sorted(merged.values(), key=_val_sort_key)
        self._total_voting_power = None
        self._pub_keys_bytes = None  # membership changed: drop the memos
        self._hash = None
        self._by_address = None
        self._update_total_voting_power()
        if self.proposer is not None and self.proposer.address not in merged:
            self.proposer = None
        self._shift_by_avg_proposer_priority()

    # ------------------------------------------------------------- proto

    def to_proto(self) -> pb.ValidatorSet:
        return pb.ValidatorSet(
            validators=[v.to_proto() for v in self.validators],
            proposer=self.proposer.to_proto() if self.proposer else None,
            total_voting_power=self.total_voting_power(),
        )

    @classmethod
    def from_proto(cls, msg: pb.ValidatorSet) -> "ValidatorSet":
        decoded = [Validator.from_proto(v) for v in msg.validators]
        vs = cls(decoded)
        # restore exact priorities (sorting in __init__ copies; map back)
        prio = {v.address: v.proposer_priority for v in decoded}
        for v in vs.validators:
            v.proposer_priority = prio[v.address]
        if msg.proposer is not None:
            _, p = vs.get_by_address(Validator.from_proto(msg.proposer).address)
            vs.proposer = p
        return vs

    def __eq__(self, other):
        return (
            isinstance(other, ValidatorSet)
            and self.validators == other.validators
        )

    def __repr__(self):
        return f"ValidatorSet({len(self.validators)} validators, power={self.total_voting_power()})"
