"""Light-client-verified RPC: an RPC client whose answers are checked
against light-client-verified headers before being returned
(reference: light/rpc/client.go, 676 LoC), plus the HTTP light-block
provider that feeds the light client from a full node's RPC
(light/provider/http), and the proxy that serves the verified answers
(a copy of cometbft_tpu/light/rpc.py).

Every result that commits to chain state is cross-checked:
  - block/commit: the fetched header must hash to the light client's
    verified header hash at that height (client.go Block/Commit).
  - validators: the fetched set must hash to the verified header's
    validators_hash (client.go Validators).
  - tx: the tx bytes must Merkle-prove into the verified header's
    data_hash (client.go Tx with inclusion proof).
  - abci_query: prove=True is forced and the ValueOp proof chain must
    verify against the app_hash of the NEXT verified header; responses
    without a verifiable proof are rejected (fail closed, matching
    light/rpc/client.go:129-134).  The kvstore app serves proofs when
    constructed with merkle_state=True; the plain parity-mode kvstore
    ships none, so verified queries against it error rather than trust.

``HTTPProvider`` takes ``device`` (default ``"cuda"``, resolved when it
is made: without a card it raises ``NoCudaDevice``): a served block's
validator-set hash is checked there, on K7 + K8 for 512 validators and
more.  ``VerifyingClient`` checks a fetched set's hash on its light
client's device.  No route falls back to the host on its own.
"""

from __future__ import annotations

import base64
import datetime
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .._device import resolve_device
from ..crypto import merkle
from ..crypto.encoding import pubkey_from_type_and_bytes
from ..rpc.client import RPCClientError
from ..types.block import BlockID, Commit, CommitSig, Header, PartSetHeader
from ..types.evidence import evidence_to_proto
from ..types.light_block import LightBlock, SignedHeader
from ..types.params import (
    BlockParams,
    ConsensusParams,
    EvidenceParams,
    FeatureParams,
    SynchronyParams,
    ValidatorParams,
    VersionParams,
)
from ..types.tx import tx_hash, tx_proof
from ..types.validators import Validator, ValidatorSet
from ..wire import types as pb
from ..wire.canonical import Timestamp
from .provider import ErrBadLightBlock, ErrHeightTooHigh, ErrLightBlockNotFound

_log = logging.getLogger("cometbft_tpu_torch.light.rpc")

_AMINO_TO_KEY_TYPE = {
    "tendermint/PubKeyEd25519": "ed25519",
    "tendermint/PubKeySecp256k1": "secp256k1",
    "cometbft/PubKeyBls12_381": "bls12_381",
    "cometbft/PubKeySecp256k1eth": "secp256k1eth",
}


# ---------------------------------------------------------------- parsers
# exact inverses of rpc/serializers.py


def _ts_from_rfc3339(s: str) -> Timestamp:
    # "1-01-01" tolerates pre-fix serializers whose %Y didn't zero-pad
    if not s or s.startswith("0001-01-01") or s.startswith("1-01-01"):
        return Timestamp()
    frac_ns = 0
    if "." in s:
        base, rest = s.split(".", 1)
        digits = rest.rstrip("Z")
        frac_ns = int(digits.ljust(9, "0")[:9])
        s = base + "Z"
    dt = datetime.datetime.strptime(s, "%Y-%m-%dT%H:%M:%SZ").replace(
        tzinfo=datetime.timezone.utc
    )
    return Timestamp.from_unix_ns(int(dt.timestamp()) * 10**9 + frac_ns)


def block_id_from_json(j: dict) -> BlockID:
    return BlockID(
        hash=bytes.fromhex(j["hash"]),
        part_set_header=PartSetHeader(
            total=j["parts"]["total"], hash=bytes.fromhex(j["parts"]["hash"])
        ),
    )


def header_from_json(j: dict) -> Header:
    return Header(
        version=pb.Consensus(
            block=int(j["version"]["block"]), app=int(j["version"].get("app", 0))
        ),
        chain_id=j["chain_id"],
        height=int(j["height"]),
        time=_ts_from_rfc3339(j["time"]),
        last_block_id=block_id_from_json(j["last_block_id"]),
        last_commit_hash=bytes.fromhex(j["last_commit_hash"]),
        data_hash=bytes.fromhex(j["data_hash"]),
        validators_hash=bytes.fromhex(j["validators_hash"]),
        next_validators_hash=bytes.fromhex(j["next_validators_hash"]),
        consensus_hash=bytes.fromhex(j["consensus_hash"]),
        app_hash=bytes.fromhex(j["app_hash"]),
        last_results_hash=bytes.fromhex(j["last_results_hash"]),
        evidence_hash=bytes.fromhex(j["evidence_hash"]),
        proposer_address=bytes.fromhex(j["proposer_address"]),
    )


def commit_from_json(j: dict) -> Commit:
    return Commit(
        height=int(j["height"]),
        round=j["round"],
        block_id=block_id_from_json(j["block_id"]),
        signatures=[
            CommitSig(
                block_id_flag=s["block_id_flag"],
                validator_address=bytes.fromhex(s["validator_address"]),
                timestamp=_ts_from_rfc3339(s["timestamp"]),
                signature=base64.b64decode(s["signature"]) if s["signature"] else b"",
            )
            for s in j["signatures"]
        ],
    )


def validator_set_from_json(vals_json: list[dict]) -> ValidatorSet:
    vals = []
    for v in vals_json:
        kt = _AMINO_TO_KEY_TYPE.get(v["pub_key"]["type"], v["pub_key"]["type"])
        pk = pubkey_from_type_and_bytes(kt, base64.b64decode(v["pub_key"]["value"]))
        val = Validator(
            pk, int(v["voting_power"]), int(v.get("proposer_priority", 0))
        )
        vals.append(val)
    return ValidatorSet(vals)


# --------------------------------------------------------------- provider


def _fetch_all_validators(rpc, height) -> list[dict]:
    """Page through /validators until the full set is in hand — the server
    clamps per_page, and a truncated set would fail the validators_hash
    check on every light block (provider/http paginates the same way)."""
    out: list[dict] = []
    page = 1
    while True:
        resp = rpc.validators(height, page=page, per_page=100)
        out.extend(resp["validators"])
        total = int(resp.get("total", len(out)))
        if len(out) >= total or not resp["validators"]:
            return out
        page += 1


class HTTPProvider:
    """light.Provider over a full node's JSON-RPC
    (reference: light/provider/http/http.go)."""

    def __init__(self, chain_id: str, rpc_client, *, device="cuda"):
        resolve_device(device)
        self._chain_id = chain_id
        self.rpc = rpc_client
        self.device = device

    def chain_id(self) -> str:
        return self._chain_id

    def light_block(self, height: int) -> LightBlock:
        try:
            commit_resp = self.rpc.commit(height or None)
            vals_json = _fetch_all_validators(self.rpc, height or None)
        except RPCClientError as e:
            if "not in store range" in str(e) or "must be less" in str(e):
                raise ErrHeightTooHigh(str(e)) from e
            raise ErrLightBlockNotFound(str(e)) from e
        sh = SignedHeader(
            header_from_json(commit_resp["signed_header"]["header"]),
            commit_from_json(commit_resp["signed_header"]["commit"]),
        )
        vs = validator_set_from_json(vals_json)
        lb = LightBlock(sh, vs)
        try:
            lb.validate_basic(self._chain_id, self.device)
        except Exception as e:  # noqa: BLE001
            raise ErrBadLightBlock(str(e)) from e
        return lb

    def report_evidence(self, ev) -> None:
        """broadcast_evidence over RPC (provider/http reports attacks back),
        as the proto bytes the route decodes (base64 on the wire); the JAX
        provider passes the evidence object, which its JSON encoder
        refuses, so its report never leaves."""
        try:
            self.rpc.call("broadcast_evidence", evidence=evidence_to_proto(ev).encode())
        except Exception as e:  # noqa: BLE001 — best-effort report to one provider
            _log.warning(f"evidence report to provider failed: {e!r}")

    def consensus_params(self, height: int):
        """params_source seam for the statesync state provider
        (statesync/stateprovider.go fetches params over RPC the same
        way); the caller verifies the result against the light-verified
        header's consensus_hash, so this source is untrusted."""
        j = self.rpc.call("consensus_params", height=height)["consensus_params"]
        return ConsensusParams(
            block=BlockParams(
                max_bytes=int(j["block"]["max_bytes"]),
                max_gas=int(j["block"]["max_gas"]),
            ),
            evidence=EvidenceParams(
                max_age_num_blocks=int(j["evidence"]["max_age_num_blocks"]),
                max_age_duration_ns=int(j["evidence"]["max_age_duration"]),
                max_bytes=int(j["evidence"]["max_bytes"]),
            ),
            validator=ValidatorParams(
                pub_key_types=list(j["validator"]["pub_key_types"])
            ),
            version=VersionParams(app=int(j.get("version", {}).get("app", 0))),
            synchrony=SynchronyParams(
                precision_ns=int(j["synchrony"]["precision"]),
                message_delay_ns=int(j["synchrony"]["message_delay"]),
            ),
            feature=FeatureParams(
                vote_extensions_enable_height=int(
                    j["feature"]["vote_extensions_enable_height"]
                ),
                pbts_enable_height=int(j["feature"]["pbts_enable_height"]),
            ),
        )


# ----------------------------------------------------------- verifying client


class AppQueryError(Exception):
    """abci_query returned a non-zero code.  The error itself is
    app-level and unverifiable, so nothing from the response may be
    trusted; the reference errors the same way (light/rpc/client.go
    ABCIQueryWithOptions: resp.IsErr() -> err)."""

    def __init__(self, code: int, log: str) -> None:
        super().__init__(f"abci_query failed: code={code} log={log!r}")
        self.code = code
        self.log = log


class VerificationFailed(Exception):
    pass


class VerifyingClient:
    """RPC client that refuses to return state it cannot verify
    (reference: light/rpc/client.go)."""

    def __init__(self, rpc_client, light_client, next_header_timeout: float = 15.0):
        self.rpc = rpc_client
        self.lc = light_client
        # how long abci_query waits for the header anchoring a fresh
        # query result (one block interval on a live chain)
        self.next_header_timeout = next_header_timeout

    # -- helpers

    def _resolve_height(self, height: int) -> int:
        """0/None = the chain's latest height (then verified like any
        other — the reference resolves latest the same way)."""
        if height:
            return height
        return int(self.rpc.status()["sync_info"]["latest_block_height"])

    def _verified_header(self, height: int) -> Header:
        lb = self.lc.verify_light_block_at_height(height)
        return lb.signed_header.header

    def status(self) -> dict:
        return self.rpc.status()

    def block(self, height: int = 0) -> dict:
        height = self._resolve_height(height)
        resp = self.rpc.block(height)
        got = header_from_json(resp["block"]["header"])
        want = self._verified_header(height)
        if got.hash() != want.hash():
            raise VerificationFailed(
                f"block {height}: header hash {got.hash().hex()} != verified "
                f"{want.hash().hex()}"
            )
        return resp

    def commit(self, height: int = 0) -> dict:
        height = self._resolve_height(height)
        resp = self.rpc.commit(height)
        got = header_from_json(resp["signed_header"]["header"])
        want = self._verified_header(height)
        if got.hash() != want.hash():
            raise VerificationFailed(f"commit {height}: header mismatch")
        return resp

    def validators(self, height: int = 0) -> dict:
        height = self._resolve_height(height)
        vals_json = _fetch_all_validators(self.rpc, height)
        vs = validator_set_from_json(vals_json)
        want = self._verified_header(height)
        if vs.hash(self.lc.device) != want.validators_hash:
            raise VerificationFailed(
                f"validators {height}: set hash does not match verified header"
            )
        return {"block_height": str(height), "validators": vals_json,
                "count": str(len(vals_json)), "total": str(len(vals_json))}

    def tx(self, tx_hash_hex: str) -> dict:
        """Fetch a tx and prove its inclusion in the verified block's
        data_hash (client.go Tx: requires the proof)."""
        resp = self.rpc.call("tx", hash=tx_hash_hex)
        height = int(resp["height"])
        tx = base64.b64decode(resp["tx"])
        index = int(resp.get("index", 0))
        hdr = self._verified_header(height)
        blk = self.rpc.block(height)
        txs = [base64.b64decode(t) for t in blk["block"]["data"]["txs"]]
        if index >= len(txs) or txs[index] != tx:
            raise VerificationFailed("tx not at claimed index")
        root, proof = tx_proof(txs, index)
        if root != hdr.data_hash:
            raise VerificationFailed("tx set does not hash to verified data_hash")
        proof.verify(root, tx_hash(tx))  # leaves are TxIDs (types/tx.go:51)
        return resp

    def data_proof(self, height: int = 0, index: int = 0) -> dict:
        """Fetch an inclusion proof for tx ``index`` of block ``height``
        (the merkle_proof route, served by the node's PROOF plane) and
        verify it against the light-client-verified header's data_hash
        before returning it.  Unlike tx(), this never downloads the
        block's tx set — the proof alone anchors the returned leaf_hash
        (the TxID) to verified chain state; a caller holding the tx
        bytes completes the chain with tx_hash(tx) == leaf_hash."""
        height = self._resolve_height(height)
        want = self._verified_header(height)
        resp = self.rpc.call("merkle_proof", height=height, indices=str(index))
        # Everything the serving node controls parses inside this try:
        # malformed hex/base64/ints must surface as the same fail-closed
        # VerificationFailed as a wrong proof.
        try:
            root = bytes.fromhex(resp["root_hash"])
            total = int(resp["total"])
            rows = resp["proofs"]
            if len(rows) != 1:
                raise VerificationFailed(
                    f"data_proof: expected 1 proof, got {len(rows)}"
                )
            pj = rows[0]
            proof = merkle.Proof(
                total=int(pj["total"]),
                index=int(pj["index"]),
                leaf_hash=base64.b64decode(pj["leaf_hash"]),
                aunts=[base64.b64decode(a) for a in pj.get("aunts") or []],
            )
        except VerificationFailed:
            raise
        except Exception as e:  # noqa: BLE001 — fail closed on any garbage
            raise VerificationFailed(
                f"data_proof: malformed response: {e}"
            ) from e
        if proof.total != total or proof.index != index:
            raise VerificationFailed("data_proof: proof row does not match query")
        if root != want.data_hash:
            raise VerificationFailed(
                f"data_proof {height}: root {root.hex()} != verified "
                f"data_hash {want.data_hash.hex()}"
            )
        if proof.compute_root_hash() != want.data_hash:
            raise VerificationFailed(
                "data_proof: proof does not verify against data_hash"
            )
        return resp

    def abci_query(self, path: str, data: bytes, height: int = 0) -> dict:
        """Fail-closed verified query (reference: light/rpc/client.go:110-160
        ABCIQueryWithOptions forces opts.Prove and errors when the proof is
        missing or unverifiable).

        prove=True is always requested; the response's ValueOp proof chain
        is verified against the app hash of the NEXT verified header (the
        app hash of state at height h lands in header h+1).  Responses
        without a verifiable proof — including apps that ship no proofs,
        like the plain kvstore — are rejected, never trusted."""
        resp = self.rpc.abci_query(path, data, height=height, prove=True)
        r = resp["response"]
        # Everything a byzantine server controls parses inside this try:
        # malformed heights, base64, or proof bytes must surface as the
        # same fail-closed VerificationFailed as a wrong proof.
        try:
            code = int(r.get("code", 0) or 0)
            if code != 0:
                # Error responses carry no proof and cannot be verified;
                # returning them would hand a byzantine node's value/log/
                # height to callers that skip the code check.  Fail like
                # the reference (resp.IsErr() -> error).
                raise AppQueryError(code, str(r.get("log", "")))
            rh = int(r.get("height", 0) or 0)
            if rh <= 0:
                raise VerificationFailed("abci_query: response carries no height")
            value = base64.b64decode(r.get("value") or "")
            key = base64.b64decode(r.get("key") or "")
            ops_json = (r.get("proof_ops") or {}).get("ops") or []
            if not value:
                raise VerificationFailed(
                    "abci_query: empty value (absence proofs not supported)"
                )
            if not ops_json:
                raise VerificationFailed(
                    "abci_query: response carries no proof (fail closed)"
                )
            ops: list[merkle.ProofOp] = []
            for op in ops_json:
                if op.get("type") != "simple:v":
                    raise VerificationFailed(
                        f"abci_query: unregistered proof op {op.get('type')!r}"
                    )
                vop = pb.ValueOpProto.decode(base64.b64decode(op["data"]))
                proof = merkle.Proof(
                    total=vop.proof.total,
                    index=vop.proof.index,
                    leaf_hash=vop.proof.leaf_hash,
                    aunts=list(vop.proof.aunts),
                )
                ops.append(merkle.ValueOp(base64.b64decode(op["key"]), proof))
        except (VerificationFailed, AppQueryError):
            raise
        except Exception as e:  # noqa: BLE001 — fail closed on any garbage
            raise VerificationFailed(f"abci_query: malformed response: {e}") from e
        # The proven root is the app hash of the NEXT header, which only
        # exists once block rh+1 commits — on a live chain that's one
        # block interval away.  Wait for it briefly instead of failing:
        # the captured value+proof stay anchored to state rh regardless
        # of later writes (client.go waits for the next header the same
        # way via WaitForHeight).
        hdr = None
        deadline = time.monotonic() + self.next_header_timeout
        while True:
            try:
                hdr = self._verified_header(rh + 1)
                break
            except (ErrHeightTooHigh, ErrLightBlockNotFound) as e:
                # genuinely not produced yet: wait one block interval
                if time.monotonic() >= deadline:
                    raise VerificationFailed(
                        f"abci_query: header {rh + 1} unavailable: {e}"
                    ) from e
                time.sleep(0.25)
            except Exception as e:  # noqa: BLE001
                # anything else (bad header, failed commit verification,
                # divergence) is a real verification failure: fail fast,
                # don't spin re-verifying a forged header for the timeout
                raise VerificationFailed(
                    f"abci_query: header {rh + 1} failed verification: {e}"
                ) from e
        keypath = merkle.key_path_to_string([key])
        try:
            merkle.ProofOperators(ops).verify_value(hdr.app_hash, keypath, value)
        except Exception as e:  # noqa: BLE001
            raise VerificationFailed(f"abci_query: proof invalid: {e}") from e
        return resp


# --------------------------------------------------------------- the proxy


class LightProxy:
    """`light` daemon: a JSON-RPC server whose handlers go through the
    VerifyingClient (reference: light/proxy/proxy.go + routes.go)."""

    def __init__(self, verifying_client: VerifyingClient):
        self.vc = verifying_client
        self._httpd = None
        self.listen_addr: str | None = None

    def start(self, addr: str) -> None:
        vc = self.vc

        ROUTES = {
            "status": lambda p: vc.status(),
            "block": lambda p: vc.block(int(p.get("height") or 0)),
            "commit": lambda p: vc.commit(int(p.get("height") or 0)),
            "validators": lambda p: vc.validators(int(p.get("height") or 0)),
            "tx": lambda p: vc.tx(p["hash"]),
            "data_proof": lambda p: vc.data_proof(
                int(p.get("height") or 0), int(p.get("index") or 0)
            ),
            "abci_query": lambda p: vc.abci_query(
                p.get("path", ""),
                base64.b64decode(p.get("data", "")),
                height=int(p.get("height") or 0),
            ),
            "broadcast_tx_sync": lambda p: vc.rpc.broadcast_tx_sync(
                base64.b64decode(p["tx"])
            ),
            "broadcast_tx_commit": lambda p: vc.rpc.broadcast_tx_commit(
                base64.b64decode(p["tx"])
            ),
        }

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n))
                    method = req.get("method", "")
                    params = req.get("params") or {}
                    fn = ROUTES.get(method)
                    if fn is None:
                        out = {
                            "jsonrpc": "2.0",
                            "id": req.get("id"),
                            "error": {"code": -32601, "message": "method not found"},
                        }
                    else:
                        out = {
                            "jsonrpc": "2.0",
                            "id": req.get("id"),
                            "result": fn(params),
                        }
                except Exception as e:  # noqa: BLE001
                    out = {
                        "jsonrpc": "2.0",
                        "id": None,
                        "error": {"code": -32603, "message": str(e)},
                    }
                body = json.dumps(out).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        host, _, port = addr.rpartition(":")
        self._httpd = ThreadingHTTPServer((host or "127.0.0.1", int(port)), Handler)
        self.listen_addr = f"{self._httpd.server_address[0]}:{self._httpd.server_address[1]}"
        threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="light-proxy"
        ).start()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
