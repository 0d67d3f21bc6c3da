"""Build and load the CUDA kernels: ``nvcc`` into shared libraries with a
plain C interface, loaded with ``ctypes``; and the host libraries of
``hostsrc/`` (``g++``, :func:`host_lib`).

Each ``csrc/*.cu`` source builds into its own ``build/cuda/lib<name>-<hash>.so``,
all sources compiling in parallel (one ``nvcc`` process each), at first
use.  A library is rebuilt when the hash of the sources it was built from
changes.  A failed build raises :class:`BuildError`; there is no fallback.

The C entry points take device pointers and the CUDA stream as
``c_void_p`` and ints as ``c_int``, and return ``cudaGetLastError()``
after their launch; :func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cuda")
HOSTSRC = os.path.join(_PKG, "hostsrc")
HOST_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "host")
HOST_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-shared"]
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

# C signature of every exported entry: name -> argtypes (restype is int)
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "sha2": {
        # payload, pubs, blocks, active, V, width(68+maxm), nblocks, stream
        "k1_parse_verify_payload": [_P, _P, _P, _P, _I, _I, _I, _P],
        # blocks, active, digest, V, nblocks, stream
        "k2_sha512_blocks": [_P, _P, _P, _I, _I, _P],
    },
    "comb": {
        # pubs, tables, valid, V, stream
        "k3_build_a_tables": [_P, _P, _P, _I, _P],
        # tables, valid, payload, width, digest, b_tables, scratch, out, V, stream
        "k4_verify_cached": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _P],
    },
    "ed25519": {
        # a_enc, r_enc, s_enc, digest, b_window, out, n, stream
        "k5_verify_batch": [_P, _P, _P, _P, _P, _P, _I, _P],
    },
    "churn": {
        # base, base_valid, fresh, fresh_valid, src, out, valid, V, stream
        "k6_assemble_churn": [_P, _P, _P, _P, _P, _P, _P, _I, _P],
    },
    "merkle": {
        # blocks, active, digest, n, nblocks, stream
        "k7_sha256_blocks": [_P, _P, _P, _I, _I, _P],
        # flat, in_off, n, out_off, stream
        "k8_merkle_level": [_P, _I, _I, _I, _P],
        # flat, coord, out, k, nnodes, stream
        "k9_merkle_gather": [_P, _P, _P, _I, _I, _P],
    },
    "keccak": {
        # blocks, active, digest, n, nblocks, stream
        "k10_keccak256_blocks": [_P, _P, _P, _I, _I, _P],
    },
    "secp": {
        # qx, qy, q_valid, e, r, s, is_eth, v, is_rec, addr, gtab, out,
        # n, glv, recover, stream
        "k11_secp_verify": [_P] * 12 + [_I, _I, _I, _P],
        # sha_blocks, sha_active, sha_nb, kec_blocks, kec_active, kec_nb,
        # qx, qy, q_valid, r, s, is_eth, v, is_rec, addr, gtab, out,
        # n, glv, recover, stream
        "k12_secp_hash_verify": [_P, _P, _I, _P, _P, _I] + [_P] * 11 + [_I, _I, _I, _P],
    },
    "bls": {
        # X, Y, valid, ok, all_ok, n, stream
        "k13_bls_validate": [_P] * 5 + [_I, _P],
        # X, Y, Z, partials, n, stream
        "k14_bls_aggregate": [_P] * 4 + [_I, _P],
        # partials, g, out, stream
        "k14_bls_aggregate_finish": [_P, _I, _P, _P],
        # X, Y, valid, ok, all_ok, partials, n, stream
        "k15_bls_validate_aggregate": [_P] * 6 + [_I, _P],
    },
}


class BuildError(RuntimeError):
    pass


class KernelError(RuntimeError):
    pass


_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# name -> {"seconds", "ptxas", "cached"}; a cached library's ptxas report
# is the one kept beside it (lib<name>-<hash>.so.ptxas) from its build
BUILD_LOG: dict[str, dict] = {}


def _sources_hash(name: str) -> str:
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith(".cuh") or fn == f"{name}.cu":
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        exe = "/usr/local/cuda/bin/nvcc"
    if exe is None:
        raise BuildError("nvcc not found (on PATH or under /usr/local/cuda/bin)")
    return exe


def build_all(names=None) -> dict[str, ctypes.CDLL]:
    """Build (if stale) and load every kernel library, compiling the
    stale sources in parallel.  Returns name -> loaded library."""
    names = list(SIGNATURES) if names is None else list(names)
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        if not todo:
            return {n: _LIBS[n] for n in names}
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for n in todo:
            out = os.path.join(BUILD_DIR, f"lib{n}-{_sources_hash(n)}.so")
            if os.path.exists(out) and os.path.exists(out + ".ptxas"):
                with open(out + ".ptxas") as f:
                    BUILD_LOG[n] = {"seconds": 0.0, "ptxas": f.read(), "cached": True}
                continue
            tmp = f"{out}.{os.getpid()}.tmp"  # concurrent builders never share it
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
            procs[n] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ), out, tmp, time.perf_counter())
        failed = []
        for n, (proc, out, tmp, t0) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[n] = {"seconds": time.perf_counter() - t0, "ptxas": log, "cached": False}
            if proc.returncode != 0:
                failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
            else:
                # the ptxas report first: a library on disk always has one
                with open(f"{tmp}.ptxas", "w") as f:
                    f.write(log)
                os.replace(f"{tmp}.ptxas", out + ".ptxas")
                os.replace(tmp, out)
        if failed:
            raise BuildError("nvcc failed for " + "\n".join(failed))
        for n in todo:
            out = os.path.join(BUILD_DIR, f"lib{n}-{_sources_hash(n)}.so")
            lib = ctypes.CDLL(out)
            for fn, argtypes in SIGNATURES[n].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[n] = lib
        return {n: _LIBS[n] for n in names}


def lib(name: str) -> ctypes.CDLL:
    return build_all([name])[name]


_HOST_LIBS: dict[str, ctypes.CDLL] = {}


def host_lib(name: str) -> ctypes.CDLL:
    """Build (if stale) and load ``hostsrc/<name>.cc`` with the host C++
    compiler (``$CXX``, default g++) into
    ``build/host/lib<name>-<source hash>.so``.  A failed build or load
    raises :class:`BuildError`."""
    with _LOCK:
        if name in _HOST_LIBS:
            return _HOST_LIBS[name]
        src = os.path.join(HOSTSRC, f"{name}.cc")
        with open(src, "rb") as f:
            h = hashlib.sha256(f.read() + " ".join(HOST_FLAGS).encode()).hexdigest()[:16]
        out = os.path.join(HOST_BUILD_DIR, f"lib{name}-{h}.so")
        try:
            if not os.path.exists(out):
                os.makedirs(HOST_BUILD_DIR, exist_ok=True)
                tmp = f"{out}.{os.getpid()}.tmp"
                cmd = [os.environ.get("CXX", "g++"), *HOST_FLAGS, "-o", tmp, src]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise BuildError(f"{name}.cc (exit {proc.returncode}):\n{proc.stderr}")
                os.replace(tmp, out)
            lib_ = ctypes.CDLL(out)
        except BuildError:
            raise
        except Exception as e:  # noqa: BLE001 — no compiler, or an unloadable library
            raise BuildError(f"host library {name}: {e}") from e
        _HOST_LIBS[name] = lib_
        return lib_


def check(code: int, what: str) -> None:
    if code != 0:
        raise KernelError(f"{what}: CUDA error {code}")
