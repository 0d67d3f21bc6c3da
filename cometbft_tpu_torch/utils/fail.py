"""Fault injection: the armable runtime fault registry (the port of
cometbft_tpu/utils/fail.py:94-270).

Named, parameterized faults, armed through the ``COMETBFT_TPU_FAULT_*``
variables at process start or with :func:`arm` at run time; the verify
service's seams read the registry and misbehave deterministically while
a fault is armed, so a card that wedges mid-batch is injectable on a
machine without one.  The faults the port's seams read:

  ====================  ====================================================
  ``wedge_device``      The verify service's wait for a batch on the card
                        parks until the fault clears, and the card probe
                        (utils/healthmon.probe_devices) reports a hang.
  ``slow_collect``      That wait takes an extra <value> seconds.
  ``fail_dispatch``     The verify service's dispatch raises InjectedFault.
  ====================  ====================================================

Left out until their seams are ported: the crash points
(``fail_point``), the p2p, consensus and remote-plane faults, and their
helpers (``should_drop``, ``jittered_sleep``).

Nothing armed costs one module-level bool read a seam.
"""

from __future__ import annotations

import threading
import time

FAULTS = (
    "wedge_device",
    "slow_collect",
    "fail_dispatch",
)

_ANY_ARMED = False  # fast-path bool: every seam checks this first
_MTX = threading.Lock()
_ARMED: dict[str, float] = {}
_FIRED: dict[str, int] = {}
# cleared-or-armed notification so wedge_wait() wakes promptly
_CHANGED = threading.Event()


class InjectedFault(RuntimeError):
    """Raised by a seam whose fault is armed (e.g. ``fail_dispatch``)."""


def arm(name: str, value: float = 1.0) -> None:
    """Arm a fault.  ``value`` parameterizes it (seconds for
    ``slow_collect``); unknown names raise, so a misspelt fault fails
    loudly instead of injecting nothing."""
    global _ANY_ARMED
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r} (known: {', '.join(FAULTS)})")
    with _MTX:
        _ARMED[name] = float(value)
        _ANY_ARMED = True
        _CHANGED.set()
        _CHANGED.clear()


def clear(name: str) -> None:
    global _ANY_ARMED
    with _MTX:
        _ARMED.pop(name, None)
        _ANY_ARMED = bool(_ARMED)
        _CHANGED.set()
        _CHANGED.clear()


def clear_all() -> None:
    global _ANY_ARMED
    with _MTX:
        _ARMED.clear()
        _ANY_ARMED = False
        _CHANGED.set()
        _CHANGED.clear()


def armed(name: str) -> float | None:
    """The fault's armed value, or None.  One bool read when nothing is
    armed — safe on every hot path."""
    if not _ANY_ARMED:
        return None
    with _MTX:
        v = _ARMED.get(name)
        if v is not None:
            _FIRED[name] = _FIRED.get(name, 0) + 1
    return v


def consume(name: str) -> float | None:
    """Like :func:`armed` but decrements a shot count: a fault armed with
    value N fires N times then disarms itself."""
    global _ANY_ARMED
    if not _ANY_ARMED:
        return None
    with _MTX:
        v = _ARMED.get(name)
        if v is None:
            return None
        _FIRED[name] = _FIRED.get(name, 0) + 1
        if v <= 1.0:
            _ARMED.pop(name, None)
            _ANY_ARMED = bool(_ARMED)
        else:
            _ARMED[name] = v - 1.0
    return v


def active() -> dict[str, float]:
    """Snapshot of the armed faults."""
    with _MTX:
        return dict(_ARMED)


def fired() -> dict[str, int]:
    """How many times each fault's seam has observed it armed."""
    with _MTX:
        return dict(_FIRED)


def _peek(name: str) -> float | None:
    """armed() without bumping the fire tally — for poll loops, so a
    fault's count means 'times a seam bit', not 'times a parked seam
    re-checked'."""
    if not _ANY_ARMED:
        return None
    with _MTX:
        return _ARMED.get(name)


def wedge_wait(name: str = "wedge_device", poll_s: float = 0.05) -> float:
    """Block while ``name`` is armed — the injected analogue of a wait
    for the card that never completes.  Returns the seconds blocked (0.0
    on the unarmed fast path).  The wait polls a shared change event so
    clearing the fault releases every parked seam within ``poll_s``.
    Counts as ONE fire however long it parks."""
    if not _ANY_ARMED or armed(name) is None:
        return 0.0
    t0 = time.monotonic()
    while _peek(name) is not None:
        _CHANGED.wait(poll_s)
    return time.monotonic() - t0


def _arm_from_env() -> None:
    """Arm the faults named by the COMETBFT_TPU_FAULT_* variables (a test
    harness sets them per process; production never does)."""
    from .. import envknobs

    for name, knob in (
        ("wedge_device", envknobs.FAULT_WEDGE_DEVICE),
        ("slow_collect", envknobs.FAULT_SLOW_COLLECT),
        ("fail_dispatch", envknobs.FAULT_FAIL_DISPATCH),
    ):
        spec = envknobs.get_str(knob).strip()
        if not spec:
            continue
        try:
            arm(name, float(spec))
        except ValueError:
            arm(name, 1.0)  # any non-numeric truthy spec arms with 1


_arm_from_env()
