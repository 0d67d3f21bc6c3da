"""The verify service: priority-scheduled batching for every signature
check of the port (service.py has the design).

Clients:
  * consensus VerifyCommit        — Klass.CONSENSUS (types/validation.py)
  * blocksync replay              — Klass.BLOCKSYNC (blocksync/replay.py)
  * light client                  — Klass.BACKGROUND (light/)
  * mempool CheckTx               — Klass.MEMPOOL (checktx.py)
  * proof serving                 — Klass.PROOF (models/proof_server.py)

A workload joins through ``global_service(device).submit(items, klass)``
or a :class:`ServiceBatchVerifier` (crypto/batch.create_batch_verifier),
never by driving a verifier of models/ itself.
"""

from .client import ServiceBatchVerifier, resolve_mode
from .service import (
    MODE_BLS,
    MODE_PLAIN,
    MODE_PROOF,
    MODE_SECP,
    Klass,
    Ticket,
    VerifyService,
    VerifyServiceBackpressure,
    global_service,
    reset_global_service,
)

__all__ = [
    "Klass",
    "MODE_BLS",
    "MODE_PLAIN",
    "MODE_PROOF",
    "MODE_SECP",
    "ServiceBatchVerifier",
    "Ticket",
    "VerifyService",
    "VerifyServiceBackpressure",
    "global_service",
    "reset_global_service",
    "resolve_mode",
]
