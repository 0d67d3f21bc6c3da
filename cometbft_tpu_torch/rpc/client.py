"""Minimal JSON-RPC HTTP client (reference: rpc/client/http; the HTTP
half of cometbft_tpu/rpc/client.py): what the light client's HTTP
provider and verifying client talk to a full node through.  Every
request carries the client's timeout.  The WebSocket client comes with
the RPC server's port.
"""

from __future__ import annotations

import base64
import json
from urllib.request import Request, urlopen


class RPCClientError(Exception):
    pass


class HTTPClient:
    def __init__(self, addr: str, timeout: float = 10.0):
        if addr.startswith("tcp://"):
            addr = addr[len("tcp://"):]
        if not addr.startswith("http"):
            addr = "http://" + addr
        self.base = addr.rstrip("/")
        self.timeout = timeout
        self._rid = 0

    def call(self, method: str, **params):
        self._rid += 1
        payload = {
            "jsonrpc": "2.0",
            "id": self._rid,
            "method": method,
            "params": {
                k: (base64.b64encode(v).decode() if isinstance(v, bytes) else v)
                for k, v in params.items()
                if v is not None
            },
        }
        req = Request(
            self.base,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urlopen(req, timeout=self.timeout) as resp:
            out = json.loads(resp.read())
        if "error" in out:
            raise RPCClientError(out["error"])
        return out["result"]

    # conveniences mirroring rpc/client/http
    def status(self):
        return self.call("status")

    def health(self):
        return self.call("health")

    def block(self, height: int | None = None):
        return self.call("block", height=height)

    def commit(self, height: int | None = None):
        return self.call("commit", height=height)

    def validators(self, height: int | None = None, page=1, per_page=30):
        return self.call("validators", height=height, page=page, per_page=per_page)

    def abci_info(self):
        return self.call("abci_info")

    def abci_query(self, path: str, data: bytes, height: int = 0, prove: bool = False):
        return self.call(
            "abci_query", path=path, data=data.hex(), height=height, prove=prove
        )

    def broadcast_tx_sync(self, tx: bytes):
        return self.call("broadcast_tx_sync", tx=tx)

    def broadcast_tx_commit(self, tx: bytes):
        return self.call("broadcast_tx_commit", tx=tx)

    def net_info(self):
        return self.call("net_info")
