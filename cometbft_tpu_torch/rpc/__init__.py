"""JSON-RPC layer (reference: rpc/): the HTTP client and the result
shapes.  The node's routes, the server and the WebSocket client come
with the node's host modules."""

from .client import HTTPClient, RPCClientError

__all__ = ["HTTPClient", "RPCClientError"]
