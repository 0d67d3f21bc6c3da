"""The port stands alone: no file of cometbft_tpu_torch/, and not
chip_smoke.py, imports jax or the JAX package; and its entry points run
on the card by default — without one they raise rather than drop to the
CPU (checked where no CUDA device is present)."""

import ast
import hashlib
import pathlib

import numpy as np
import pytest
import torch

# One intra-op thread: these tensors are tiny, and the suite's other
# workers run timing-sensitive consensus tests beside this file.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "cometbft_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "cometbft_tpu")


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__",
        ):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    roots.add(arg.value.split(".")[0])
    return roots


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "cometbft_tpu_torch/models/comb_verifier.py" in names
    assert "chip_smoke.py" in names
    assert len(names) >= 20


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_jax_package_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scanner_catches_forbidden_imports(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import jax.numpy as jnp\nfrom cometbft_tpu.ops import comb\n")
    assert _imported_roots(f) >= {"jax", "cometbft_tpu"}


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card default cannot be observed")


def _small_set():
    from cometbft_tpu_torch.crypto import ed25519 as host

    return [host.PrivKey.from_seed(bytes([i + 1]) * 32) for i in range(4)]


def test_verify_commit_default_device_raises_without_card(no_card):
    from cometbft_tpu_torch import types as T
    from cometbft_tpu_torch._device import NoCudaDevice
    from cometbft_tpu_torch.types import validation

    keys = _small_set()
    vals = T.ValidatorSet([T.Validator(k.pub_key(), 10) for k in keys])
    with pytest.raises(NoCudaDevice):
        validation.verify_commit("c", vals, T.BlockID(), 1, T.Commit())
    with pytest.raises(NoCudaDevice):
        validation.verify_commit_light("c", vals, T.BlockID(), 1, T.Commit())


def test_factory_cache_and_convert_default_device_raise_without_card(no_card):
    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch._device import NoCudaDevice
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.models import comb_verifier as cv

    pubs = [k.pub_key().data for k in _small_set()]
    with pytest.raises(NoCudaDevice):
        batch.create_batch_verifier("ed25519", pubkeys=pubs)
    with pytest.raises(NoCudaDevice):
        cv.ValsetCombCache().ensure(pubs)
    with pytest.raises(NoCudaDevice):
        convert.b_tables_from_jax(np.zeros((22, 66, 4096), np.float32))


def test_kernel_wrappers_run_plain_only_for_cpu_tensors(no_card):
    """A wrapper picks its plain version because its tensor lies on the
    CPU; any other device is refused, never silently moved."""
    from cometbft_tpu_torch.ops import sha2

    payload = torch.zeros((2, 100), dtype=torch.uint8, device="meta")
    pubs = torch.zeros((2, 32), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sha2.parse_verify_payload(payload, pubs)


def test_merkle_default_route_raises_without_card(no_card):
    """At DEVICE_THRESHOLD leaves the default route is the kernels on the
    card: with no card it raises, where the JAX package would fall back
    to hashlib; below the threshold the host route answers."""
    from cometbft_tpu_torch._device import NoCudaDevice
    from cometbft_tpu_torch.crypto import merkle as cm

    leaves = [b"leaf-%d" % i for i in range(cm.DEVICE_THRESHOLD)]
    with pytest.raises(NoCudaDevice):
        cm.hash_from_byte_slices(leaves)
    with pytest.raises(NoCudaDevice):
        cm.hash_from_byte_slices(leaves[:3], device=True)
    with pytest.raises(NoCudaDevice):
        cm.device_proofs_from_byte_slices(leaves[:3], [0])
    with pytest.raises(NoCudaDevice):
        cm.device_multiproof(leaves[:3], [0])
    small = leaves[: cm.DEVICE_THRESHOLD - 1]
    assert cm.hash_from_byte_slices(small) == cm.hash_from_byte_slices(small, device=False)


def test_validator_set_hash_and_prover_raise_without_card(no_card):
    from cometbft_tpu_torch import types as T
    from cometbft_tpu_torch._device import NoCudaDevice
    from cometbft_tpu_torch.crypto import ed25519 as host
    from cometbft_tpu_torch.crypto import merkle as cm
    from cometbft_tpu_torch.models import proof_server

    pubs = [host.PubKey(hashlib.sha256(b"%d" % i).digest()) for i in range(cm.DEVICE_THRESHOLD)]
    vals = T.ValidatorSet([T.Validator(p, 1) for p in pubs])
    with pytest.raises(NoCudaDevice):
        vals.hash()
    assert vals.hash(device="cpu") == cm.hash_from_byte_slices(
        [v.bytes() for v in vals.validators], device=False)
    with pytest.raises(NoCudaDevice):
        proof_server.ProofProver()


def test_secp_entry_points_raise_without_card(no_card):
    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch._device import NoCudaDevice
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.models import secp_verifier as sv
    from cometbft_tpu_torch.ops import keccak

    with pytest.raises(NoCudaDevice):
        sv.SecpBatchVerifier()
    for kt in ("secp256k1", "secp256k1eth", "ecrecover"):
        with pytest.raises(NoCudaDevice):
            batch.create_batch_verifier(kt)
    with pytest.raises(NoCudaDevice):
        keccak.keccak256_device([b""])
    with pytest.raises(NoCudaDevice):
        convert.g_table_from_jax(np.zeros((16, 66), np.int32))


def test_secp_wrappers_refuse_other_devices(no_card):
    from cometbft_tpu_torch.ops import secp256k1 as S

    m = "meta"
    w = torch.zeros((2, 8), dtype=torch.int32, device=m)
    f = torch.zeros((2,), dtype=torch.uint8, device=m)
    v = torch.zeros((2,), dtype=torch.int32, device=m)
    a = torch.zeros((2, 20), dtype=torch.uint8, device=m)
    g = torch.zeros((2, 8, 2, 8), dtype=torch.int32, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        S.verify_batch(w, w, f, w, w, w, f, v, f, a, g)


def test_bls_entry_points_raise_without_card(no_card, monkeypatch):
    from cometbft_tpu_torch._device import NoCudaDevice
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.crypto import bls12381 as H
    from cometbft_tpu_torch.models import bls_verifier as bv
    from cometbft_tpu_torch.ops import bls381 as B

    with pytest.raises(NoCudaDevice):
        bv.BlsAggregateVerifier()
    with pytest.raises(NoCudaDevice):
        batch.create_batch_verifier("bls12_381", pubkeys=[b"\x80" * 48])
    pt = [H.G1_GEN]
    for route in (B.validate_pubkeys_device, B.validate_aggregate_device, B.aggregate_pubkeys_device):
        with pytest.raises(NoCudaDevice):
            route(pt)
    keys = [H.PrivKey(3 + i) for i in range(8)]
    monkeypatch.setenv("COMETBFT_TPU_BLS_DEVICE", "1")
    with pytest.raises(NoCudaDevice):  # the pubkey sum goes to K14 on the card
        H.fast_aggregate_verify([k.pub_key() for k in keys], b"m", b"\x00" * 96)


def test_bls_wrappers_refuse_other_devices(no_card):
    from cometbft_tpu_torch.ops import bls381 as B

    w = torch.zeros((2, 12), dtype=torch.int32, device="meta")
    f = torch.zeros((2,), dtype=torch.uint8, device="meta")
    for call in (lambda: B.validate_g1(w, w, f), lambda: B.aggregate_g1(w, w, w),
                 lambda: B.validate_aggregate_g1(w, w, f)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    with pytest.raises(ValueError, match="must be"):
        B.validate_g1(w[:, :8], w[:, :8], f)
