"""ValidatorSet.hash of sets of every key type the reference encodes
(types/validator.go Validator.Bytes through crypto/encoding PubKeyToProto:
PublicKey arms 1-4) against the JAX package's: the port once encoded only
the ed25519 arm and raised for secp256k1, bls12_381 and secp256k1eth
sets."""

import hashlib

import pytest
import torch

import cometbft_tpu.types as JT
from cometbft_tpu.crypto import bls12381 as jbls
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.crypto import secp256k1 as jsecp
from cometbft_tpu.crypto import secp256k1eth as jeth

import cometbft_tpu_torch.types as PT
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import bls12381 as pbls
from cometbft_tpu_torch.crypto import ed25519 as ped
from cometbft_tpu_torch.crypto import secp256k1 as psecp
from cometbft_tpu_torch.crypto import secp256k1eth as peth

torch.set_num_threads(1)


def _pubs(key_type):
    if key_type == "bls12_381":
        return [pbls.PrivKey(101 + 7 * i).pub_key().data for i in range(3)]
    mod = {"ed25519": ped, "secp256k1": psecp, "secp256k1eth": peth}[key_type]
    return [mod.PrivKey.from_seed(hashlib.sha256(b"valset-%d" % i).digest()).pub_key().data for i in range(3)]


@pytest.mark.parametrize("key_type", ["ed25519", "secp256k1", "secp256k1eth", "bls12_381"])
def test_validator_set_hash_matches_jax_for_every_key_type(key_type):
    jmod = {"ed25519": jed, "secp256k1": jsecp, "secp256k1eth": jeth, "bls12_381": jbls}[key_type]
    pubs = _pubs(key_type)
    powers = [10, 30, 20]
    jvals = JT.ValidatorSet([JT.Validator(jmod.PubKey(p), w) for p, w in zip(pubs, powers)])
    pvals = convert.validator_set(list(zip(pubs, powers)), key_type=key_type)
    assert [v.pub_key.type for v in pvals.validators] == [key_type] * 3
    assert [v.bytes() for v in pvals.validators] == [v.bytes() for v in jvals.validators]
    assert pvals.hash(device="cpu") == jvals.hash()
    direct = PT.ValidatorSet([PT.Validator(v.pub_key, v.voting_power) for v in pvals.validators])
    assert direct.hash(device="cpu") == jvals.hash()


def test_unknown_key_type_is_refused():
    class _Key:
        type = "sr25519"

        def address(self):
            return b"\x01" * 20

        def bytes(self):
            return b"\x02" * 32

    with pytest.raises(ValueError, match="sr25519"):
        PT.Validator(_Key(), 1).bytes()
