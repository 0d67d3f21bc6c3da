"""The port stands alone: no file of cometbft_tpu_torch/, and neither
chip_smoke.py nor the node helper it serves from (tests/torch_rpc_node.py),
imports jax or the JAX package; and its entry points run
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
PORT_FILES = sorted((ROOT / "cometbft_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                   ROOT / "tests" / "torch_rpc_node.py"]
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
    # the light client's modules, the evidence checks, the stores and the key codec
    assert {"cometbft_tpu_torch/light/client.py", "cometbft_tpu_torch/light/detector.py",
            "cometbft_tpu_torch/light/provider.py", "cometbft_tpu_torch/light/store.py",
            "cometbft_tpu_torch/evidence/verify.py", "cometbft_tpu_torch/store/db.py",
            "cometbft_tpu_torch/crypto/encoding.py", "cometbft_tpu_torch/types/evidence.py"} <= names
    # the node's stores, the evidence pool and the light client's RPC front
    assert {"cometbft_tpu_torch/store/block_store.py", "cometbft_tpu_torch/state/state.py",
            "cometbft_tpu_torch/state/store.py", "cometbft_tpu_torch/evidence/pool.py",
            "cometbft_tpu_torch/light/rpc.py", "cometbft_tpu_torch/rpc/client.py",
            "cometbft_tpu_torch/rpc/serializers.py", "cometbft_tpu_torch/types/params.py",
            "cometbft_tpu_torch/types/part_set.py", "cometbft_tpu_torch/types/genesis.py",
            "cometbft_tpu_torch/types/tx.py", "cometbft_tpu_torch/wire/state.py",
            "cometbft_tpu_torch/wire/abci.py", "tests/torch_rpc_node.py"} <= names
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


def test_light_client_and_evidence_default_device_raise_without_card(no_card):
    """The light client's root check, a provider's served block and the
    attack evidence's check run on the card by default."""
    from cometbft_tpu_torch import light, types as T
    from cometbft_tpu_torch._device import NoCudaDevice
    from cometbft_tpu_torch.evidence import verify_light_client_attack
    from cometbft_tpu_torch.store import MemDB
    from cometbft_tpu_torch.types.evidence import LightClientAttackEvidence

    keys = _small_set()
    vals = T.ValidatorSet([T.Validator(k.pub_key(), 10) for k in keys])
    hdr = T.Header(chain_id="c", height=1, validators_hash=vals.hash(device=False),
                   next_validators_hash=vals.hash(device=False))
    bid = T.BlockID(hash=hdr.hash(), part_set_header=T.PartSetHeader(1, b"\1" * 32))
    sigs = [T.CommitSig(2, v.address, None, b"\2" * 64) for v in vals.validators]
    lb = T.LightBlock(T.SignedHeader(hdr, T.Commit(height=1, round=0, block_id=bid, signatures=sigs)),
                      T.ValidatorSet([T.Validator(k.pub_key(), 10) for k in keys]))

    class Primary:
        def light_block(self, h):
            return lb

    with pytest.raises(NoCudaDevice):
        light.Client("c", light.TrustOptions(10**18, 1, lb.hash), Primary(), [], light.LightStore(MemDB()))
    ev = LightClientAttackEvidence(lb, 1, total_voting_power=40)
    with pytest.raises(NoCudaDevice):
        verify_light_client_attack(ev, lb.signed_header, lb.signed_header, vals, "c")


def test_node_stores_pool_and_rpc_front_default_device_raise_without_card(no_card):
    """The HTTP provider and the evidence pool resolve their device when
    they are made; a block's data hash and its make_block's set hashes run
    K7 + K8 on the card at 512 txs or validators and more."""
    from cometbft_tpu_torch import types as T
    from cometbft_tpu_torch._device import NoCudaDevice
    from cometbft_tpu_torch.crypto import merkle as cm
    from cometbft_tpu_torch.evidence import EvidencePool
    from cometbft_tpu_torch.light.rpc import HTTPProvider
    from cometbft_tpu_torch.rpc import HTTPClient
    from cometbft_tpu_torch.state import StateStore, make_genesis_state
    from cometbft_tpu_torch.store import BlockStore, MemDB

    with pytest.raises(NoCudaDevice):
        HTTPProvider("c", HTTPClient("127.0.0.1:1"))
    HTTPProvider("c", HTTPClient("127.0.0.1:1"), device="cpu")
    keys = _small_set()
    doc = T.GenesisDoc(chain_id="c", validators=[T.GenesisValidator("ed25519", k.pub_key().bytes(), 10)
                                                 for k in keys])
    state = make_genesis_state(doc)
    ss = StateStore(MemDB())
    ss.save(state)
    with pytest.raises(NoCudaDevice):
        EvidencePool(MemDB(), ss, BlockStore(MemDB()))
    EvidencePool(MemDB(), ss, BlockStore(MemDB()), device="cpu")
    txs = [b"tx-%d" % i for i in range(cm.DEVICE_THRESHOLD)]
    with pytest.raises(NoCudaDevice):
        T.Data(txs).hash()
    with pytest.raises(NoCudaDevice):
        T.txs_hash(txs)
    with pytest.raises(NoCudaDevice):
        state.make_block(1, txs, None, [], keys[0].pub_key().address())
    assert T.Data(txs[:3]).hash() == T.txs_hash(txs[:3], device=False)
    assert state.make_block(1, txs[:3], None, [], keys[0].pub_key().address()).header.data_hash == \
        T.txs_hash(txs[:3], device=False)


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


def test_mesh_defaults_to_the_card(no_card, monkeypatch):
    """A mesh's rank runs on the card unless the caller asks for the CPU;
    COMETBFT_TPU_MESH = N > 1 binds such a mesh."""
    from cometbft_tpu_torch import parallel as P
    from cometbft_tpu_torch._device import NoCudaDevice
    from cometbft_tpu_torch.models import comb_verifier as cv

    with pytest.raises(NoCudaDevice):
        P.make_mesh()
    monkeypatch.setattr(cv, "_MESH", cv._UNSET)
    monkeypatch.setenv("COMETBFT_TPU_MESH", "2")
    with pytest.raises(NoCudaDevice):
        cv.active_mesh()
