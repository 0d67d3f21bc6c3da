"""JSON shapes for RPC results (reference: rpc/core/types/responses.go +
the amino-JSON conventions: hashes hex-uppercase, binary payloads
base64, times RFC3339 with nanoseconds, int64s as strings; a copy of
cometbft_tpu/rpc/serializers.py, printing the same JSON).
"""

from __future__ import annotations

import base64
import datetime


def hex_up(b: bytes) -> str:
    return b.hex().upper()


def b64(b: bytes) -> str:
    return base64.b64encode(b or b"").decode()


def ts_json(t) -> str:
    if t is None:
        return "0001-01-01T00:00:00Z"
    return _rfc3339(t)


def _rfc3339(t) -> str:
    ns = t.unix_ns()
    dt = datetime.datetime.fromtimestamp(ns // 10**9, datetime.timezone.utc)
    frac = ns % 10**9
    # strftime %Y does NOT zero-pad years < 1000 on glibc: the zero time
    # (year 1, absent commit signatures) must still round-trip as
    # RFC 3339 "0001-01-01T00:00:00Z"
    base = (
        f"{dt.year:04d}-{dt.month:02d}-{dt.day:02d}"
        f"T{dt.hour:02d}:{dt.minute:02d}:{dt.second:02d}"
    )
    return f"{base}.{frac:09d}Z" if frac else base + "Z"


def block_id_json(bid) -> dict:
    return {
        "hash": hex_up(bid.hash),
        "parts": {
            "total": bid.part_set_header.total,
            "hash": hex_up(bid.part_set_header.hash),
        },
    }


def header_json(h) -> dict:
    return {
        "version": {"block": str(h.version.block), "app": str(h.version.app or 0)},
        "chain_id": h.chain_id,
        "height": str(h.height),
        "time": ts_json(h.time),
        "last_block_id": block_id_json(h.last_block_id),
        "last_commit_hash": hex_up(h.last_commit_hash),
        "data_hash": hex_up(h.data_hash),
        "validators_hash": hex_up(h.validators_hash),
        "next_validators_hash": hex_up(h.next_validators_hash),
        "consensus_hash": hex_up(h.consensus_hash),
        "app_hash": hex_up(h.app_hash),
        "last_results_hash": hex_up(h.last_results_hash),
        "evidence_hash": hex_up(h.evidence_hash),
        "proposer_address": hex_up(h.proposer_address),
    }


def commit_sig_json(cs) -> dict:
    return {
        "block_id_flag": cs.block_id_flag,
        "validator_address": hex_up(cs.validator_address),
        "timestamp": ts_json(cs.timestamp),
        "signature": b64(cs.signature) if cs.signature else None,
    }


def commit_json(c) -> dict:
    return {
        "height": str(c.height),
        "round": c.round,
        "block_id": block_id_json(c.block_id),
        "signatures": [commit_sig_json(s) for s in c.signatures],
    }


def block_json(b) -> dict:
    return {
        "header": header_json(b.header),
        "data": {"txs": [b64(tx) for tx in b.data.txs]},
        "evidence": {"evidence": []},  # typed evidence JSON: indexer work
        "last_commit": commit_json(b.last_commit) if b.last_commit else None,
    }


_AMINO_PUBKEY_NAMES = {
    "ed25519": "tendermint/PubKeyEd25519",
    "secp256k1": "tendermint/PubKeySecp256k1",
    "bls12_381": "cometbft/PubKeyBls12_381",
    "secp256k1eth": "cometbft/PubKeySecp256k1eth",
}


def validator_json(v) -> dict:
    kt = v.pub_key.type
    return {
        "address": hex_up(v.address),
        "pub_key": {
            "type": _AMINO_PUBKEY_NAMES.get(kt, kt),
            "value": b64(v.pub_key.bytes()),
        },
        "voting_power": str(v.voting_power),
        "proposer_priority": str(v.proposer_priority),
    }


def tx_result_json(r) -> dict:
    return {
        "code": r.code,
        "data": b64(r.data) if r.data else None,
        "log": r.log,
        "codespace": getattr(r, "codespace", ""),
        "gas_wanted": str(getattr(r, "gas_wanted", 0)),
        "gas_used": str(getattr(r, "gas_used", 0)),
        "events": events_json(getattr(r, "events", []) or []),
    }


def events_json(events) -> list:
    return [
        {
            "type": ev.type,
            "attributes": [
                {"key": a.key, "value": a.value, "index": bool(getattr(a, "index", False))}
                for a in ev.attributes
            ],
        }
        for ev in events
    ]
