"""A full node's stores and its JSON-RPC front, built with the port alone
(no JAX): the server side of tests/test_torch_light_rpc.py and of
chip_smoke.py's phase 28, as tests/torch_light_corpus.py is the chain of
phase 27.

``NodeChain`` fills a port ``BlockStore`` and ``StateStore`` with a real
chain: ``GenesisDoc`` -> ``make_genesis_state``, then a height at a time
``State.make_block`` (seeded txs), ``PartSet``, a commit signed by every
validator of the height (host ed25519), ``BlockStore.save_block``, the
FinalizeBlock response and ``StateStore.save`` of the next state.  The set
can move by ``shift`` keys after a height (validator updates of power 0
and of ``power``, effective two heights later, as the executor's
update_state makes them).  Every artifact is kept, so a test can replay
the chain into the JAX package's stores.

``RPCNode`` is a loopback ``ThreadingHTTPServer`` on port 0 that answers
``status``, ``block``, ``commit``, ``validators`` (``per_page`` capped at
100), ``consensus_params``, ``tx``, ``merkle_proof`` (through the port's
``models/proof_server.prove``) and, where given, ``abci_query`` and
``broadcast_evidence``, in the shapes of the JAX routes
(cometbft_tpu/rpc/core.py), through the port's ``rpc/serializers.py``.
It can serve a forged block (``forged``) or answer a route with anything
(``answers``), for the refusal cases.  It decodes a height's
validator set once and pages from that copy (the JAX route loads it for
every page: 100 decodes of a 10,000-key set for one light block).  Stop
it in a ``finally``.

``time_limit`` bounds a test: a hung server fails its test with
``TimeoutError`` instead of running down the suite's clock."""

from __future__ import annotations

import base64
import contextlib
import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from cometbft_tpu_torch import types as T
from cometbft_tpu_torch.crypto import ed25519 as host
from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.models import proof_server
from cometbft_tpu_torch.rpc import serializers as S
from cometbft_tpu_torch.state import State, StateStore, make_genesis_state
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.types.evidence import DuplicateVoteEvidence, LightClientAttackEvidence
from cometbft_tpu_torch.types.light_block import LightBlock, SignedHeader
from cometbft_tpu_torch.wire import abci
from cometbft_tpu_torch.wire import types as pb
from cometbft_tpu_torch.wire.canonical import PRECOMMIT_TYPE, Timestamp

NS = 1_000_000_000
GENESIS_NS = 1_760_000_000 * NS
BLOCK_NS = NS  # a commit's votes, a second after their block


@contextlib.contextmanager
def time_limit(seconds: int):
    """Raise TimeoutError in the main thread after ``seconds``."""

    def expired(*_):
        raise TimeoutError(f"the test ran past its {seconds}-s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def make_keys(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [host.PrivKey.from_seed(rng.bytes(32)) for _ in range(n)]


def next_state(state: State, block_id: T.BlockID, header: T.Header, fb: abci.FinalizeBlockResponse,
               updates: list) -> State:
    """The State after a block (cometbft_tpu/state/execution.py:237
    update_state), with the params unchanged."""
    n_val_set = state.next_validators.copy()
    last_changed = state.last_height_validators_changed
    if updates:
        n_val_set.update_with_change_set(updates)
        last_changed = header.height + 1 + 1
    n_val_set.increment_proposer_priority(1)
    results = [abci.ExecTxResult(code=r.code, data=r.data, gas_wanted=r.gas_wanted, gas_used=r.gas_used).encode()
               for r in fb.tx_results]
    return State(
        chain_id=state.chain_id,
        initial_height=state.initial_height,
        last_block_height=header.height,
        last_block_id=block_id,
        last_block_time=header.time,
        next_validators=n_val_set,
        validators=state.next_validators.copy(),
        last_validators=state.validators.copy(),
        last_height_validators_changed=last_changed,
        consensus_params=state.consensus_params,
        last_height_consensus_params_changed=state.last_height_consensus_params_changed,
        last_results_hash=merkle.hash_from_byte_slices(results, device=False),
        app_hash=fb.app_hash,
        next_block_delay_ns=state.next_block_delay_ns,
        app_version=state.app_version,
    )


class NodeChain:
    """A chain of ``n_vals`` validators of ``power`` over ``keys`` (the
    first ``n_vals`` at genesis), saved into ``block_store`` and
    ``state_store`` a height at a time by ``advance``.  ``shift_after``:
    the height whose FinalizeBlock replaces the first ``shift`` members by
    the next ``shift`` keys.  ``app_hash_fn(h)``: the app hash after block
    h (default sha256 of b"app%d")."""

    def __init__(self, chain_id: str, keys: list, n_vals: int, block_store: BlockStore, state_store: StateStore,
                 *, txs_per_block: int = 4, tx_bytes: int = 32, power: int = 10, shift_after: int | None = None,
                 shift: int = 0, app_hash_fn=None, seed: int = 0, device="cuda"):
        self.chain_id, self.keys, self.n_vals, self.power = chain_id, keys, n_vals, power
        self.block_store, self.state_store = block_store, state_store
        self.txs_per_block, self.tx_bytes = txs_per_block, tx_bytes
        self.shift_after, self.shift = shift_after, shift
        self.app_hash_fn = app_hash_fn or (lambda h: T.tx_hash(b"app%d" % h))
        self.rng = np.random.default_rng(seed)
        self.device = device
        self.by_addr = {k.pub_key().address(): k for k in keys}
        self.genesis = T.GenesisDoc(
            chain_id=chain_id, genesis_time=Timestamp.from_unix_ns(GENESIS_NS),
            validators=[T.GenesisValidator("ed25519", k.pub_key().bytes(), power) for k in keys[:n_vals]],
        )
        self.state = make_genesis_state(self.genesis)
        self.states = [self.state]  # the state after each height, genesis first
        self.blocks: dict[int, T.Block] = {}
        self.part_sets: dict[int, T.PartSet] = {}
        self.commits: dict[int, T.Commit] = {}  # the seen commit of each height
        self.responses: dict[int, abci.FinalizeBlockResponse] = {}
        self.ms: dict[str, list[float]] = {k: [] for k in (
            "make_block", "part_set", "sign", "save_block", "state_save")}
        state_store.save(self.state)

    @property
    def height(self) -> int:
        return self.state.last_block_height

    def txs(self, h: int) -> list[bytes]:
        raw = self.rng.bytes(self.txs_per_block * self.tx_bytes)
        return [b"%d:" % h + raw[i * self.tx_bytes + len(b"%d:" % h):(i + 1) * self.tx_bytes]
                for i in range(self.txs_per_block)]

    def sign(self, vals: T.ValidatorSet, bid: T.BlockID, h: int, time_ns: int) -> T.Commit:
        """Height h's commit for bid, every member signing."""
        sigs = [T.CommitSig(T.BLOCK_ID_FLAG_COMMIT, v.address, Timestamp.from_unix_ns(time_ns + i), b"")
                for i, v in enumerate(vals.validators)]
        commit = T.Commit(height=h, round=0, block_id=bid, signatures=sigs)
        sign_bytes = commit.vote_sign_bytes_fn(self.chain_id)
        for i, cs in enumerate(sigs):
            cs.signature = self.by_addr[cs.validator_address].sign(sign_bytes(i))
        return commit

    def _updates(self, h: int) -> list:
        if h != self.shift_after or not self.shift:
            return []
        members = {v.address for v in self.state.next_validators.validators}
        gone = [k for k in self.keys if k.pub_key().address() in members][:self.shift]
        new = [k for k in self.keys if k.pub_key().address() not in members][:self.shift]
        return [T.Validator(k.pub_key(), 0) for k in gone] + [T.Validator(k.pub_key(), self.power) for k in new]

    def advance(self, txs: list[bytes] | None = None, evidence=()) -> T.Block:
        """Make, sign and save the next height; returns its block."""
        st, h = self.state, self.state.last_block_height + 1
        txs = self.txs(h) if txs is None else txs
        t0 = time.perf_counter()
        block = st.make_block(h, txs, self.commits.get(h - 1), list(evidence),
                              st.validators.get_proposer().address, device=self.device)
        t1 = time.perf_counter()
        ps = block.make_part_set()
        bid = T.BlockID(hash=block.hash(), part_set_header=ps.header)
        t2 = time.perf_counter()
        commit = self.sign(st.validators, bid, h, block.header.time.unix_ns() + BLOCK_NS)
        t3 = time.perf_counter()
        self.block_store.save_block(block, ps, commit)
        t4 = time.perf_counter()
        updates = self._updates(h)
        fb = abci.FinalizeBlockResponse(
            tx_results=[abci.ExecTxResult(code=0) for _ in txs],
            validator_updates=[abci.ValidatorUpdate(power=v.voting_power, pub_key_bytes=v.pub_key.bytes(),
                                                    pub_key_type=v.pub_key.type) for v in updates],
            app_hash=self.app_hash_fn(h),
        )
        self.state_store.save_finalize_block_response(h, fb)
        self.state = next_state(st, bid, block.header, fb, updates)
        self.state_store.save(self.state)
        t5 = time.perf_counter()
        for key, a, b in (("make_block", t0, t1), ("part_set", t1, t2), ("sign", t2, t3), ("save_block", t3, t4),
                          ("state_save", t4, t5)):
            self.ms[key].append((b - a) * 1e3)
        self.blocks[h], self.part_sets[h], self.commits[h], self.responses[h] = block, ps, commit, fb
        self.states.append(self.state)
        return block

    # ----------------------------------------------------------- evidence

    def duplicate_vote(self, h: int, index: int = 0, tag: bytes = b"dv") -> DuplicateVoteEvidence:
        """Validator ``index`` of height h's set signs two precommits for
        two other blocks; the evidence carries h's block time."""
        vals = self.states[h - 1].validators
        val = vals.validators[index]
        votes = []
        for side in (b"a", b"b"):
            bid = T.BlockID(hash=T.tx_hash(tag + side), part_set_header=T.PartSetHeader(1, T.tx_hash(tag + side + b"p")))
            vote = T.Vote(type=PRECOMMIT_TYPE, height=h, round=0, block_id=bid,
                          timestamp=self.blocks[h].header.time, validator_address=val.address, validator_index=index)
            vote.signature = self.by_addr[val.address].sign(vote.sign_bytes(self.chain_id))
            votes.append(vote)
        return DuplicateVoteEvidence.from_votes(votes[0], votes[1], self.blocks[h].header.time, vals)

    def lunatic(self, common: int, target: int, time_ns: int | None = None) -> LightClientAttackEvidence:
        """A lunatic attack from ``common``: a header at ``target`` with
        another app hash, claiming the common height's set and signed by
        all of it (``time_ns`` its time, by default the stored block's at
        target, or a block later past the top)."""
        common_vals = self.states[common - 1].validators
        stored = self.blocks.get(target)
        top = self.blocks[self.height]
        if time_ns is None:
            time_ns = (stored or top).header.time.unix_ns() + (0 if stored is not None else NS)
        vals = T.ValidatorSet([v.copy() for v in common_vals.validators])
        set_hash = vals.hash(device=False)
        hdr = T.Header(
            chain_id=self.chain_id, height=target, time=Timestamp.from_unix_ns(time_ns),
            last_block_id=(stored or top).header.last_block_id,
            validators_hash=set_hash, next_validators_hash=set_hash,
            consensus_hash=self.state.consensus_params.hash(), app_hash=T.tx_hash(b"lunatic%d" % target),
            last_results_hash=T.tx_hash(b"lunatic"), proposer_address=vals.validators[0].address,
        )
        bid = T.BlockID(hash=hdr.hash(), part_set_header=T.PartSetHeader(1, T.tx_hash(b"lunatic-parts")))
        commit = self.sign(vals, bid, target, time_ns + BLOCK_NS)
        lb = LightBlock(SignedHeader(hdr, commit), vals)
        ev = LightClientAttackEvidence(lb, common, total_voting_power=common_vals.total_voting_power(),
                                       timestamp=self.blocks[common].header.time)
        trusted_sh = SignedHeader((stored or top).header, self.commits[target if stored else self.height])
        ev.byzantine_validators = ev.get_byzantine_validators(common_vals, trusted_sh)
        return ev


# ------------------------------------------------------------------ server


class RPCError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class RPCNode:
    """JSON-RPC over a node's stores, on a loopback port (see the module
    docstring).  ``abci_query(path, data, height, prove)`` and
    ``evidence_pool`` are optional; ``device`` is where merkle_proof's
    PROOF requests run."""

    def __init__(self, block_store: BlockStore, state_store: StateStore, *, device="cuda", abci_query=None,
                 evidence_pool=None):
        self.block_store, self.state_store = block_store, state_store
        self.device = device
        self.abci_query_fn = abci_query
        self.evidence_pool = evidence_pool
        self.forged: dict[int, T.Block] = {}
        self.answers: dict[str, object] = {}  # route -> fn(**params) -> result
        self.calls: dict[str, int] = {}
        self._tx_index: dict[bytes, tuple[int, int, bytes]] | None = None
        self._vals: dict[int, T.ValidatorSet] = {}
        self._mtx = threading.Lock()
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self.addr = ""

    # ------------------------------------------------------------ routes

    def _height_or_latest(self, height) -> int:
        latest = self.block_store.height
        if height in (None, 0, "0", ""):
            return latest
        h = int(height)
        if h <= 0:
            raise RPCError(-32603, f"height must be positive, got {h}")
        if h > latest:
            raise RPCError(-32603, f"height {h} must be less than or equal to {latest}")
        return h

    def _meta(self, h: int) -> pb.BlockMeta:
        meta = self.block_store.load_block_meta(h)
        if meta is None:
            raise RPCError(-32603, f"no block at height {h}")
        return meta

    def status(self) -> dict:
        latest = self.block_store.height
        meta = self.block_store.load_block_meta(latest)
        base = self.block_store.load_base_meta()
        state = self.state_store.load()
        return {
            "node_info": {"network": state.chain_id if state else ""},
            "sync_info": {
                "latest_block_hash": S.hex_up(meta.block_id.hash if meta else b""),
                "latest_app_hash": S.hex_up(state.app_hash if state else b""),
                "latest_block_height": str(latest),
                "latest_block_time": S.ts_json(meta.header.time) if meta else "0001-01-01T00:00:00Z",
                "earliest_block_height": str(base.header.height if base else self.block_store.base),
                "catching_up": False,
            },
            "validator_info": {"address": "", "voting_power": "0"},
        }

    def block(self, height=None) -> dict:
        h = self._height_or_latest(height)
        blk = self.forged.get(h) or self.block_store.load_block(h)
        if blk is None:
            raise RPCError(-32603, f"no block at height {h}")
        meta = self._meta(h)
        bid = meta.block_id if h not in self.forged else T.BlockID(
            hash=blk.hash(), part_set_header=blk.make_part_set().header).to_proto()
        return {
            "block_id": {"hash": S.hex_up(bid.hash), "parts": {
                "total": bid.part_set_header.total, "hash": S.hex_up(bid.part_set_header.hash)}},
            "block": S.block_json(blk),
        }

    def commit(self, height=None) -> dict:
        h = self._height_or_latest(height)
        meta = self._meta(h)
        commit = self.block_store.load_block_commit(h)
        canonical = True
        if commit is None:
            commit = self.block_store.load_seen_commit(h)
            canonical = False
        if commit is None:
            raise RPCError(-32603, f"no commit for height {h}")
        return {"signed_header": {"header": S.header_json(T.Header.from_proto(meta.header)),
                                  "commit": S.commit_json(commit)}, "canonical": canonical}

    def validators(self, height=None, page=1, per_page=30) -> dict:
        h = self._height_or_latest(height)
        with self._mtx:
            if h not in self._vals:
                self._vals[h] = self.state_store.load_validators(h)
            vals = self._vals[h]
        if vals is None:
            raise RPCError(-32603, f"no validator set at height {h}")
        page = max(1, int(page or 1))
        per_page = min(100, max(1, int(per_page or 30)))
        start = (page - 1) * per_page
        sel = vals.validators[start:start + per_page]
        return {"block_height": str(h), "validators": [S.validator_json(v) for v in sel],
                "count": str(len(sel)), "total": str(vals.size())}

    def consensus_params(self, height=None) -> dict:
        h = self._height_or_latest(height)
        p = self.state_store.load_consensus_params(h) or self.state_store.load().consensus_params
        return {"block_height": str(h), "consensus_params": {
            "block": {"max_bytes": str(p.block.max_bytes), "max_gas": str(p.block.max_gas)},
            "evidence": {"max_age_num_blocks": str(p.evidence.max_age_num_blocks),
                         "max_age_duration": str(p.evidence.max_age_duration_ns),
                         "max_bytes": str(p.evidence.max_bytes)},
            "validator": {"pub_key_types": list(p.validator.pub_key_types)},
            "version": {"app": str(p.version.app)},
            "synchrony": {"precision": str(p.synchrony.precision_ns),
                          "message_delay": str(p.synchrony.message_delay_ns)},
            "feature": {"vote_extensions_enable_height": str(p.feature.vote_extensions_enable_height),
                        "pbts_enable_height": str(p.feature.pbts_enable_height)},
        }}

    def _index(self) -> dict:
        with self._mtx:
            if self._tx_index is None:
                index = {}
                for h in range(self.block_store.base, self.block_store.height + 1):
                    blk = self.block_store.load_block(h)
                    for i, tx in enumerate(blk.data.txs if blk else []):
                        index.setdefault(T.tx_hash(tx), (h, i, tx))
                self._tx_index = index
            return self._tx_index

    def tx(self, hash="", prove=False) -> dict:
        h = bytes.fromhex(hash)
        rec = self._index().get(h)
        if rec is None:
            raise RPCError(-32603, f"tx {h.hex()} not found")
        height, index, tx = rec
        return {"hash": S.hex_up(h), "height": str(height), "index": index,
                "tx_result": S.tx_result_json(abci.ExecTxResult(code=0)), "tx": S.b64(tx)}

    def merkle_proof(self, height=None, indices="") -> dict:
        h = self._height_or_latest(height)
        blk = self.block_store.load_block(h)
        if blk is None:
            raise RPCError(-32603, f"block {h} not found")
        txs = blk.data.txs
        parts = [p for p in str(indices).split(",") if p.strip()]
        if not txs or not parts:
            raise RPCError(-32602, f"block {h}: nothing to prove")
        idxs = [int(p) for p in parts]
        if any(i < 0 or i >= len(txs) for i in idxs):
            raise RPCError(-32602, f"an index of {idxs} is out of range for {len(txs)} txs")
        root, proofs = proof_server.prove([T.tx_hash(tx) for tx in txs], idxs, device=self.device)
        return {"height": str(h), "total": str(len(txs)), "root_hash": S.hex_up(root), "proofs": [
            {"total": str(p.total), "index": str(p.index), "leaf_hash": S.b64(p.leaf_hash),
             "aunts": [S.b64(a) for a in p.aunts]} for p in proofs]}

    def abci_query(self, path="", data="", height=0, prove=False) -> dict:
        if self.abci_query_fn is None:
            raise RPCError(-32601, "Method not found: abci_query")
        return self.abci_query_fn(path, bytes.fromhex(data) if data else b"", int(height or 0), bool(prove))

    def broadcast_evidence(self, evidence="") -> dict:
        from cometbft_tpu_torch.evidence import evidence_from_proto_bytes

        if self.evidence_pool is None:
            raise RPCError(-32603, "evidence pool not available")
        ev = evidence_from_proto_bytes(base64.b64decode(evidence))
        self.evidence_pool.add_evidence(ev)
        return {"hash": S.hex_up(ev.hash())}

    ROUTES = ("status", "block", "commit", "validators", "consensus_params", "tx", "merkle_proof", "abci_query",
              "broadcast_evidence")

    # ------------------------------------------------------------ server

    def handle(self, body: bytes) -> dict:
        req = json.loads(body or b"{}")
        rid, method, params = req.get("id", -1), req.get("method", ""), req.get("params") or {}
        if method not in self.ROUTES:
            return {"jsonrpc": "2.0", "id": rid, "error": {"code": -32601, "message": f"Method not found: {method}"}}
        with self._mtx:
            self.calls[method] = self.calls.get(method, 0) + 1
        try:
            route = self.answers.get(method) or getattr(self, method)
            return {"jsonrpc": "2.0", "id": rid, "result": route(**params)}
        except RPCError as e:
            return {"jsonrpc": "2.0", "id": rid, "error": {"code": e.code, "message": str(e), "data": ""}}
        except Exception as e:  # noqa: BLE001 — a route's failure is the caller's answer
            return {"jsonrpc": "2.0", "id": rid, "error": {"code": -32603, "message": f"Internal error: {e}"}}

    def start(self) -> str:
        node = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", "0"))
                data = json.dumps(node.handle(self.rfile.read(n))).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True, name="torch-rpc-node")
        self._thread.start()
        self.addr = f"127.0.0.1:{self._httpd.server_address[1]}"
        return self.addr

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=10)
            self._httpd = None
