"""Stall forensics: all-thread stacks, the flight recorder's ring and a
report file that bundles them (the port of
cometbft_tpu/utils/debugdump.py:18-101).

Left out until the node is ported: ``heap_summary`` and
``crash_report``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback


def thread_dump() -> str:
    """Stack trace of every live thread."""
    frames = sys._current_frames()
    by_id = {t.ident: t for t in threading.enumerate()}
    out = [f"{len(frames)} threads\n"]
    for tid, frame in frames.items():
        t = by_id.get(tid)
        name = t.name if t else "?"
        daemon = " daemon" if (t and t.daemon) else ""
        out.append(f"--- thread {tid} [{name}]{daemon} ---")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out)


def flight_record_text() -> str:
    """The flight recorder's ring as pretty JSON."""
    from .flightrec import recorder

    return json.dumps(recorder().dump(), indent=1, default=str)


def stall_report(
    reason: str,
    extra_sections: list[tuple[str, str]] | None = None,
    directory: str | None = None,
) -> str:
    """Write a stall-forensics bundle — reason, caller-supplied sections
    (the health sentinel's snapshot, the verify service's stats with the
    in-flight batch ages, a trace-ring drain), the flight recorder's
    ring, all-thread stacks — and return its path.  ``directory`` None is
    the temporary directory (``tempfile.gettempdir()``, as in the JAX
    package)."""
    import tempfile

    directory = directory or tempfile.gettempdir()
    path = os.path.join(
        directory, f"cometbft-health-{os.getpid()}-{time.time_ns()}.txt"
    )
    sections = [
        f"=== stall forensics ===\nreason: {reason}\nwall_ns: {time.time_ns()}\n"
    ]
    for title, body in extra_sections or []:
        sections.append(f"=== {title} ===")
        sections.append(body)
    sections.extend(
        [
            "=== consensus flight recorder ===",
            flight_record_text(),
            "=== threads ===",
            thread_dump(),
        ]
    )
    with open(path, "w") as f:
        f.write("\n".join(sections))
    return path
