"""Batch signature verifiers: the BatchVerifier contract of the reference
(crypto/crypto.go:47-55).  add(pubkey, msg, sig) accumulates work,
verify() returns (all_valid, per_signature_validity) — per-signature
blame is what lets commit verification tally honest voting power even
when some signatures are bad (types/validation.go:384-399).

Ed25519BatchVerifier is the uncached device verifier (K2 -> K5) for
any batch: sets below the comb threshold, light-client checks, keys
outside a cached set, calls without a validator set.
CpuEd25519BatchVerifier is the host oracle: sequential ZIP-215
verification with the same semantics as the kernels.
"""

from __future__ import annotations

import time
from typing import Protocol

import numpy as np
import torch

from .._device import resolve_device
from ..crypto import ed25519 as host_ed25519
from ..ops import ed25519 as E
from ..ops import sha2
from ..utils import tracing


class BatchVerifier(Protocol):
    def add(self, pub_key: bytes, msg: bytes, sig: bytes) -> None: ...

    def verify(self) -> tuple[bool, list[bool]]: ...


class CpuEd25519BatchVerifier:
    """Sequential ZIP-215 verification on the host."""

    def __init__(self) -> None:
        self._items: list[tuple[bytes, bytes, bytes]] = []

    def __len__(self) -> int:
        return len(self._items)

    def add(self, pub_key: bytes, msg: bytes, sig: bytes) -> None:
        if len(pub_key) != 32 or len(sig) != 64:
            raise ValueError("malformed ed25519 pubkey or signature")
        self._items.append((pub_key, msg, sig))

    def verify(self) -> tuple[bool, list[bool]]:
        res = [host_ed25519.verify_signature(p, m, s) for (p, m, s) in self._items]
        return all(res) and bool(res), res


def _next_bucket(n: int) -> int:
    """Power-of-two lane count, at least 16 (cometbft_tpu/models/verifier.py:61)."""
    b = 16
    while b < n:
        b *= 2
    return b


def stage_batch(items: list[tuple[bytes, bytes, bytes]], device) -> tuple:
    """Host assembly and ONE host-to-device copy of an uncached batch.

    items are (pubkey, msg, sig); the batch is padded to ``_next_bucket``
    lanes with copies of row 0 (real work whose verdicts are dropped).
    The rows go into one flat buffer — page-locked when ``device`` is a
    card — laid out as A | R | s (bucket x 32 bytes each) | active
    (bucket int32) | SHA-512-padded R || A || M blocks (bucket x nb x 128),
    and the returned tensors are views of its device copy:
    (a_enc, r_enc, s_bytes, blocks, active)."""
    n = len(items)
    bucket = _next_bucket(n)
    pad = [0] * (bucket - n)
    order = list(range(n)) + pad
    pubs = np.frombuffer(b"".join(items[i][0] for i in order), np.uint8).reshape(bucket, 32)
    sigs = np.frombuffer(b"".join(items[i][2] for i in order), np.uint8).reshape(bucket, 64)
    hashed = [sig[:32] + pub + msg for pub, msg, sig in items]
    blocks, active = sha2.pad_messages_sha512(hashed + [hashed[0]] * len(pad))
    nb = blocks.shape[1]
    sizes = [bucket * 32, bucket * 32, bucket * 32, bucket * 4, bucket * nb * 128]
    offs = np.cumsum([0] + sizes).tolist()
    host = torch.empty((offs[-1],), dtype=torch.uint8, pin_memory=device.type == "cuda")
    hb = host.numpy()
    hb[offs[0] : offs[1]] = pubs.reshape(-1)
    hb[offs[1] : offs[2]] = sigs[:, :32].reshape(-1)
    hb[offs[2] : offs[3]] = sigs[:, 32:].reshape(-1)
    hb[offs[3] : offs[4]] = active.view(np.uint8)
    hb[offs[4] : offs[5]] = blocks.reshape(-1)
    flat = host.to(device, non_blocking=True) if device.type == "cuda" else host
    return (
        flat[offs[0] : offs[1]].view(bucket, 32),
        flat[offs[1] : offs[2]].view(bucket, 32),
        flat[offs[2] : offs[3]].view(bucket, 32),
        flat[offs[4] : offs[5]].view(bucket, nb, 128),
        flat[offs[3] : offs[4]].view(torch.int32),
    )


class Ed25519BatchVerifier:
    """Batched ZIP-215 verification through the uncached kernels: K2
    (challenge hash) then K5 (Straus verify) on ``device`` — the port of
    cometbft_tpu/models/verifier.py:83 TpuEd25519BatchVerifier.

    Batches are padded to power-of-two buckets (floor 16) with copies of
    row 0.  A call makes one host-to-device copy of a page-locked buffer
    and one device-to-host copy of the verdicts.  The JAX class sends
    batches under 32 signatures to the host (its _device_batch_min, for
    the TPU link's latency); on the card every batch takes the kernels."""

    def __init__(self, device="cuda") -> None:
        self._dev = resolve_device(device)
        self._items: list[tuple[bytes, bytes, bytes]] = []
        self.last_timings: dict[str, float] = {}  # ms per phase, set by verify()

    def __len__(self) -> int:
        return len(self._items)

    def add(self, pub_key: bytes, msg: bytes, sig: bytes) -> None:
        if len(pub_key) != 32 or len(sig) != 64:
            raise ValueError("malformed ed25519 pubkey or signature")
        self._items.append((pub_key, msg, sig))

    def submit(self):
        """Stage the batch, copy it to the card and enqueue K2 -> K5 and
        the copy of the verdicts back, WITHOUT waiting.  Returns an
        opaque ticket for collect()."""
        n = len(self._items)
        if n == 0:
            return ("sync", (False, []))
        t0 = time.perf_counter()
        with tracing.span("verify.uncached_assemble"):
            a, r, s, blocks, active = stage_batch(self._items, self._dev)
        t1 = time.perf_counter()
        with tracing.span("verify.h2d_dispatch"):
            ok = E.verify_batch(a, r, s, blocks, active)[:n]
            if self._dev.type == "cuda":
                host = torch.empty((n,), dtype=torch.bool, pin_memory=True)
                host.copy_(ok, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(ok.device))
            else:
                host, done = ok, None
        t2 = time.perf_counter()
        timings = {"assembly_ms": (t1 - t0) * 1e3, "h2d_dispatch_ms": (t2 - t1) * 1e3}
        return ("dev", (done, host, timings))

    def collect(self, ticket) -> tuple[bool, list[bool]]:
        """Wait for a submit() ticket: (all_ok, per-signature) in add() order."""
        kind, payload = ticket
        if kind == "sync":
            return payload
        done, host, timings = payload
        t0 = time.perf_counter()
        with tracing.span("verify.device_wait"):
            if done is not None:
                done.synchronize()
        timings["device_wait_ms"] = (time.perf_counter() - t0) * 1e3
        self.last_timings.update(timings)
        res = host.tolist()
        return all(res), res

    def verify(self) -> tuple[bool, list[bool]]:
        self.last_timings = {}
        t0 = time.perf_counter()
        ticket = self.submit()
        t1 = time.perf_counter()
        result = self.collect(ticket)
        t2 = time.perf_counter()
        if ticket[0] == "dev":
            self.last_timings["submit_ms"] = (t1 - t0) * 1e3
            self.last_timings["kernel_ms"] = (t2 - t1) * 1e3
        return result
