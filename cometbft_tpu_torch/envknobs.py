"""Environment knobs, read as cometbft_tpu/utils/envknobs reads them, so
the port routes by the JAX package's variables with its defaults."""

from __future__ import annotations

import os

_DEFAULTS: dict[str, object] = {}


def _declare(name: str, default):
    """Register a knob's default under its variable's name."""
    _DEFAULTS[name] = default
    return name


def get_int(name: str, default: int | None = None) -> int:
    """An unset, empty or malformed value gives the default (the
    declared one when none is passed)."""
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return _DEFAULTS[name] if default is None else default


def get_str(name: str) -> str:
    """The variable's value; unset gives the declared default."""
    v = os.environ.get(name)
    return v if v is not None else _DEFAULTS[name]


def get_bool(name: str, default: bool | None = None) -> bool:
    """1 / true / yes / on and 0 / false / no / off (any case); anything
    else, unset or empty, gives the default (the declared one when none
    is passed)."""
    v = os.environ.get(name, "").strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    return _DEFAULTS[name] if default is None else default


# Ranks of the sharded comb path (cometbft_tpu/utils/envknobs.py:86):
# N > 1 shards comb tables and signature rows over the first N ranks of
# the initialized process group; unset, 0 or 1 keeps the one-device path.
MESH = "COMETBFT_TPU_MESH"
MESH_DEFAULT = 0

# The verify service (verifysvc/service.py), with the JAX package's
# defaults (cometbft_tpu/utils/envknobs.py:182-255, 322-333).
# A class queue flushes as "full" at this many signatures.
VERIFYSVC_BATCH_MAX = _declare("COMETBFT_TPU_VERIFYSVC_BATCH_MAX", 4096)
# Signatures a class may hold queued; a submit beyond it is refused.
VERIFYSVC_QUEUE_MAX = _declare("COMETBFT_TPU_VERIFYSVC_QUEUE_MAX", 16384)
# Each class's flush deadline (ms): its oldest request waits at most this
# long for others to merge with (0: dispatch at once).
VERIFYSVC_DEADLINE_CONSENSUS_MS = _declare("COMETBFT_TPU_VERIFYSVC_DEADLINE_CONSENSUS_MS", 0)
VERIFYSVC_DEADLINE_BLOCKSYNC_MS = _declare("COMETBFT_TPU_VERIFYSVC_DEADLINE_BLOCKSYNC_MS", 2)
VERIFYSVC_DEADLINE_MEMPOOL_MS = _declare("COMETBFT_TPU_VERIFYSVC_DEADLINE_MEMPOOL_MS", 5)
VERIFYSVC_DEADLINE_BACKGROUND_MS = _declare("COMETBFT_TPU_VERIFYSVC_DEADLINE_BACKGROUND_MS", 25)
# Weighted interleave of ready classes ("consensus=8,mempool=2"); empty
# is strict priority.
VERIFYSVC_WEIGHTS = _declare("COMETBFT_TPU_VERIFYSVC_WEIGHTS", "")
# The tenant this process submits under.
VERIFYSVC_TENANT = _declare("COMETBFT_TPU_VERIFYSVC_TENANT", "default")
# A (tenant, class)'s bound on outstanding signatures (queued and in
# flight); 0 is the class bound.
VERIFYSVC_TENANT_QUOTA = _declare("COMETBFT_TPU_VERIFYSVC_TENANT_QUOTA", 0)
# Weighted-fair shares of ready tenants within a class ("a=4,b=1").
VERIFYSVC_TENANT_WEIGHTS = _declare("COMETBFT_TPU_VERIFYSVC_TENANT_WEIGHTS", "")
# How long a client waits on a ticket (ms); 0 waits forever.
VERIFYSVC_COLLECT_TIMEOUT_MS = _declare("COMETBFT_TPU_VERIFYSVC_COLLECT_TIMEOUT_MS", 120000)
# The PROOF class's flush deadline (ms) and queue bound (0: the class bound).
PROOF_DEADLINE_MS = _declare("COMETBFT_TPU_PROOF_DEADLINE_MS", 5)
PROOF_QUEUE_MAX = _declare("COMETBFT_TPU_PROOF_QUEUE_MAX", 8192)

# The span tracer (utils/tracing.py), with the JAX package's names and
# defaults (cometbft_tpu/utils/envknobs.py:467-483).
# Any truthy value records; a path (holding the os separator or ending
# in .json) also writes a Chrome trace there at interpreter exit.
TRACE = _declare("COMETBFT_TPU_TRACE", "")
# The ring's capacity in events (at least 1).
TRACE_RING = _declare("COMETBFT_TPU_TRACE_RING", 65536)
# 0 records no trace_id / span_id args on events.
TRACE_CTX = _declare("COMETBFT_TPU_TRACE_CTX", True)
