"""GenesisDoc: the chain bootstrap document (reference: types/genesis.go;
a copy of cometbft_tpu/types/genesis.py).  JSON on disk, like the
reference's genesis.json."""

from __future__ import annotations

import json
import hashlib
from dataclasses import dataclass, field

from ..crypto import encoding as keyenc
from ..crypto import hash as tmhash
from ..wire.canonical import Timestamp
from .params import ConsensusParams, default_consensus_params
from .validators import Validator, ValidatorSet

MAX_CHAIN_ID_LEN = 50


@dataclass
class GenesisValidator:
    pub_key_type: str
    pub_key_bytes: bytes
    power: int
    name: str = ""

    @property
    def address(self) -> bytes:
        return keyenc.pubkey_from_type_and_bytes(
            self.pub_key_type, self.pub_key_bytes
        ).address()

    def to_validator(self) -> Validator:
        key = keyenc.pubkey_from_type_and_bytes(self.pub_key_type, self.pub_key_bytes)
        return Validator(key, self.power)


@dataclass
class GenesisDoc:
    chain_id: str
    genesis_time: Timestamp = field(default_factory=lambda: Timestamp(seconds=0))
    initial_height: int = 1
    consensus_params: ConsensusParams = field(default_factory=default_consensus_params)
    validators: list[GenesisValidator] = field(default_factory=list)
    app_hash: bytes = b""
    app_state: bytes = b"{}"

    def validate_and_complete(self) -> None:
        """(genesis.go ValidateAndComplete)."""
        if not self.chain_id:
            raise ValueError("genesis doc must include non-empty chain_id")
        if len(self.chain_id) > MAX_CHAIN_ID_LEN:
            raise ValueError(f"chain_id in genesis doc is too long (max {MAX_CHAIN_ID_LEN})")
        if self.initial_height < 0:
            raise ValueError("initial_height cannot be negative")
        if self.initial_height == 0:
            self.initial_height = 1
        self.consensus_params.validate_basic()
        for v in self.validators:
            if v.power < 0:
                raise ValueError("genesis file cannot contain validators with negative power")

    def validator_set(self) -> ValidatorSet:
        return ValidatorSet([v.to_validator() for v in self.validators])

    def validator_hash(self, device="cuda") -> bytes:
        return self.validator_set().hash(device)

    # ----------------------------------------------------------- JSON io

    def to_json(self) -> str:
        return json.dumps(
            {
                "genesis_time": self.genesis_time.unix_ns(),
                "chain_id": self.chain_id,
                "initial_height": str(self.initial_height),
                "consensus_params": _params_to_json(self.consensus_params),
                "validators": [
                    {
                        "pub_key": {
                            "type": v.pub_key_type,
                            "value": v.pub_key_bytes.hex(),
                        },
                        "power": str(v.power),
                        "name": v.name,
                    }
                    for v in self.validators
                ],
                "app_hash": self.app_hash.hex(),
                "app_state": self.app_state.decode("utf-8"),
            },
            indent=2,
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, data: str) -> "GenesisDoc":
        # a genesis file is operator-supplied input: every malformation
        # (missing key, wrong type, bad hex) must surface as ValueError,
        # never a raw KeyError/TypeError from half-parsed fields
        try:
            d = json.loads(data)
            doc = cls(
                chain_id=d["chain_id"],
                genesis_time=Timestamp.from_unix_ns(int(d.get("genesis_time", 0))),
                initial_height=int(d.get("initial_height", 1)),
                consensus_params=_params_from_json(d.get("consensus_params")),
                validators=[
                    GenesisValidator(
                        pub_key_type=v["pub_key"]["type"],
                        pub_key_bytes=bytes.fromhex(v["pub_key"]["value"]),
                        power=int(v["power"]),
                        name=v.get("name", ""),
                    )
                    for v in d.get("validators", [])
                ],
                app_hash=bytes.fromhex(d.get("app_hash", "")),
                app_state=d.get("app_state", "{}").encode("utf-8"),
            )
        except ValueError:
            raise
        except Exception as e:  # noqa: BLE001 — malformed document shape
            raise ValueError(f"malformed genesis doc: {e!r}") from e
        doc.validate_and_complete()
        return doc

    def save_as(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "GenesisDoc":
        with open(path) as f:
            return cls.from_json(f.read())

    def sha256(self) -> bytes:
        return hashlib.sha256(self.to_json().encode()).digest()


def _params_to_json(p: ConsensusParams) -> dict:
    return {
        "block": {"max_bytes": str(p.block.max_bytes), "max_gas": str(p.block.max_gas)},
        "evidence": {
            "max_age_num_blocks": str(p.evidence.max_age_num_blocks),
            "max_age_duration": str(p.evidence.max_age_duration_ns),
            "max_bytes": str(p.evidence.max_bytes),
        },
        "validator": {"pub_key_types": p.validator.pub_key_types},
        "version": {"app": str(p.version.app)},
        "synchrony": {
            "precision": str(p.synchrony.precision_ns),
            "message_delay": str(p.synchrony.message_delay_ns),
        },
        "feature": {
            "vote_extensions_enable_height": str(
                p.feature.vote_extensions_enable_height
            ),
            "pbts_enable_height": str(p.feature.pbts_enable_height),
        },
    }


def _params_from_json(d: dict | None) -> ConsensusParams:
    p = default_consensus_params()
    if not d:
        return p
    if "block" in d:
        p.block.max_bytes = int(d["block"]["max_bytes"])
        p.block.max_gas = int(d["block"]["max_gas"])
    if "evidence" in d:
        p.evidence.max_age_num_blocks = int(d["evidence"]["max_age_num_blocks"])
        p.evidence.max_age_duration_ns = int(d["evidence"]["max_age_duration"])
        p.evidence.max_bytes = int(d["evidence"]["max_bytes"])
    if "validator" in d:
        p.validator.pub_key_types = list(d["validator"]["pub_key_types"])
    if "version" in d:
        p.version.app = int(d["version"]["app"])
    if "synchrony" in d:
        p.synchrony.precision_ns = int(d["synchrony"]["precision"])
        p.synchrony.message_delay_ns = int(d["synchrony"]["message_delay"])
    if "feature" in d:
        p.feature.vote_extensions_enable_height = int(
            d["feature"]["vote_extensions_enable_height"]
        )
        p.feature.pbts_enable_height = int(d["feature"]["pbts_enable_height"])
    return p
