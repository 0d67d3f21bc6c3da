"""ConsensusParams (reference: types/params.go; a copy of
cometbft_tpu/types/params.py): block size and gas, evidence aging,
allowed key types, vote-extension and PBTS feature heights, synchrony
bounds, the hash that Header.consensus_hash carries and the proto round
trip."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto import hash as tmhash
from ..wire import types as pb

MAX_BLOCK_SIZE_BYTES = 104857600  # 100MB hard cap (params.go)
ABCI_PUBKEY_TYPE_ED25519 = "ed25519"

_HOUR_NS = 3600 * 1_000_000_000
_MS_NS = 1_000_000
_SEC_NS = 1_000_000_000


@dataclass
class BlockParams:
    max_bytes: int = 4194304  # 4MB (params.go:187)
    max_gas: int = 10000000

    def validate(self) -> None:
        if self.max_bytes == 0 or self.max_bytes < -1:
            raise ValueError("block.MaxBytes must be -1 or greater than 0")
        if self.max_bytes > MAX_BLOCK_SIZE_BYTES:
            raise ValueError(f"block.MaxBytes is too big, max {MAX_BLOCK_SIZE_BYTES}")
        if self.max_gas < -1:
            raise ValueError("block.MaxGas must be greater or equal to -1")


@dataclass
class EvidenceParams:
    max_age_num_blocks: int = 100000
    max_age_duration_ns: int = 48 * _HOUR_NS
    max_bytes: int = 1048576

    def validate(self, block_max_bytes: int) -> None:
        if self.max_age_num_blocks <= 0:
            raise ValueError("evidence.MaxAgeNumBlocks must be greater than 0")
        if self.max_age_duration_ns <= 0:
            raise ValueError("evidence.MaxAgeDuration must be greater than 0")
        cap_ = block_max_bytes if block_max_bytes >= 0 else MAX_BLOCK_SIZE_BYTES
        if self.max_bytes > cap_ or self.max_bytes < 0:
            raise ValueError("evidence.MaxBytes out of range")


@dataclass
class ValidatorParams:
    pub_key_types: list[str] = field(
        default_factory=lambda: [ABCI_PUBKEY_TYPE_ED25519]
    )

    def validate(self) -> None:
        if not self.pub_key_types:
            raise ValueError("validator.PubKeyTypes must not be empty")


@dataclass
class VersionParams:
    app: int = 0


@dataclass
class SynchronyParams:
    precision_ns: int = 505 * _MS_NS  # params.go:225
    message_delay_ns: int = 15 * _SEC_NS

    MAX_MESSAGE_DELAY_NS = 24 * 3600 * _SEC_NS  # params.go:39

    def in_round(self, round: int) -> "SynchronyParams":
        """Adaptive relaxation: MessageDelay grows 10% per round so an
        honest proposal eventually counts as timely (params.go:159)."""
        if round <= 0:
            return self
        # cap in float space first: 1.1**round overflows float range near
        # round ~7450, and int() of an inf raises
        scaled = (1.1 ** min(round, 1000)) * float(self.message_delay_ns)
        d = (
            self.MAX_MESSAGE_DELAY_NS
            if scaled >= self.MAX_MESSAGE_DELAY_NS
            else int(scaled)
        )
        return SynchronyParams(
            precision_ns=self.precision_ns, message_delay_ns=d
        )

    def validate(self) -> None:
        if self.precision_ns < 0 or self.message_delay_ns < 0:
            raise ValueError("synchrony params must be non-negative")


@dataclass
class FeatureParams:
    vote_extensions_enable_height: int = 0
    pbts_enable_height: int = 0

    def vote_extensions_enabled(self, height: int) -> bool:
        h = self.vote_extensions_enable_height
        return h > 0 and height >= h

    def pbts_enabled(self, height: int) -> bool:
        h = self.pbts_enable_height
        return h > 0 and height >= h


@dataclass
class ConsensusParams:
    block: BlockParams = field(default_factory=BlockParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)
    validator: ValidatorParams = field(default_factory=ValidatorParams)
    version: VersionParams = field(default_factory=VersionParams)
    synchrony: SynchronyParams = field(default_factory=SynchronyParams)
    feature: FeatureParams = field(default_factory=FeatureParams)

    def validate_basic(self) -> None:
        self.block.validate()
        self.evidence.validate(self.block.max_bytes)
        self.validator.validate()
        self.synchrony.validate()

    def hash(self) -> bytes:
        """SHA-256 of HashedParams (params.go Hash) — goes into
        Header.consensus_hash."""
        hp = pb.HashedParams(
            block_max_bytes=self.block.max_bytes, block_max_gas=self.block.max_gas
        )
        return tmhash.sum(hp.encode())

    def to_proto(self) -> pb.ConsensusParamsProto:
        return pb.ConsensusParamsProto(
            block=pb.BlockParams(max_bytes=self.block.max_bytes, max_gas=self.block.max_gas),
            evidence=pb.EvidenceParams(
                max_age_num_blocks=self.evidence.max_age_num_blocks,
                max_age_duration=pb.Duration.from_ns(self.evidence.max_age_duration_ns),
                max_bytes=self.evidence.max_bytes,
            ),
            validator=pb.ValidatorParams(pub_key_types=list(self.validator.pub_key_types)),
            version=pb.VersionParams(app=self.version.app),
            synchrony=pb.SynchronyParams(
                precision=pb.Duration.from_ns(self.synchrony.precision_ns),
                message_delay=pb.Duration.from_ns(self.synchrony.message_delay_ns),
            ),
            feature=pb.FeatureParams(
                vote_extensions_enable_height=pb.Int64Value(
                    value=self.feature.vote_extensions_enable_height
                ),
                pbts_enable_height=pb.Int64Value(value=self.feature.pbts_enable_height),
            ),
        )

    @classmethod
    def from_proto(cls, m: pb.ConsensusParamsProto) -> "ConsensusParams":
        p = cls()
        if m.block is not None:
            p.block = BlockParams(max_bytes=m.block.max_bytes, max_gas=m.block.max_gas)
        if m.evidence is not None:
            dur = m.evidence.max_age_duration or pb.Duration()
            p.evidence = EvidenceParams(
                max_age_num_blocks=m.evidence.max_age_num_blocks,
                max_age_duration_ns=dur.ns(),
                max_bytes=m.evidence.max_bytes,
            )
        if m.validator is not None:
            p.validator = ValidatorParams(pub_key_types=list(m.validator.pub_key_types))
        if m.version is not None:
            p.version = VersionParams(app=m.version.app)
        if m.synchrony is not None:
            p.synchrony = SynchronyParams(
                precision_ns=(m.synchrony.precision or pb.Duration()).ns(),
                message_delay_ns=(m.synchrony.message_delay or pb.Duration()).ns(),
            )
        if m.feature is not None:
            veh = m.feature.vote_extensions_enable_height
            pbh = m.feature.pbts_enable_height
            p.feature = FeatureParams(
                vote_extensions_enable_height=veh.value if veh else 0,
                pbts_enable_height=pbh.value if pbh else 0,
            )
        return p

    def update(self, updates: pb.ConsensusParamsProto | None) -> "ConsensusParams":
        """Apply an ABCI ConsensusParams update (params.go Update)."""
        if updates is None:
            return self
        merged = ConsensusParams.from_proto(self.to_proto())
        if updates.block is not None:
            merged.block = BlockParams(
                max_bytes=updates.block.max_bytes, max_gas=updates.block.max_gas
            )
        if updates.evidence is not None:
            dur = updates.evidence.max_age_duration or pb.Duration()
            merged.evidence = EvidenceParams(
                max_age_num_blocks=updates.evidence.max_age_num_blocks,
                max_age_duration_ns=dur.ns(),
                max_bytes=updates.evidence.max_bytes,
            )
        if updates.validator is not None:
            merged.validator = ValidatorParams(
                pub_key_types=list(updates.validator.pub_key_types)
            )
        if updates.version is not None:
            merged.version = VersionParams(app=updates.version.app)
        if updates.synchrony is not None:
            merged.synchrony = SynchronyParams(
                precision_ns=(updates.synchrony.precision or pb.Duration()).ns(),
                message_delay_ns=(updates.synchrony.message_delay or pb.Duration()).ns(),
            )
        if updates.feature is not None:
            veh = updates.feature.vote_extensions_enable_height
            pbh = updates.feature.pbts_enable_height
            if veh is not None:
                merged.feature.vote_extensions_enable_height = veh.value
            if pbh is not None:
                merged.feature.pbts_enable_height = pbh.value
        return merged


def default_consensus_params() -> ConsensusParams:
    return ConsensusParams()
