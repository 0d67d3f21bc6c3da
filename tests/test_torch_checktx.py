"""The port's CheckTx envelope codec against the JAX package's
(cometbft_tpu/verifysvc/checktx.py:61-128): the same bytes out of
make_signed_tx for every key type, the same parse of well-formed,
truncated, unknown-type and unsigned transactions."""

import pytest

from cometbft_tpu.verifysvc import checktx as jax_ctx
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.crypto import secp256k1 as host
from cometbft_tpu_torch.crypto import secp256k1eth as heth
from cometbft_tpu_torch.verifysvc import checktx as ctx

KEYS = {
    "ed25519": lambda: ed25519.PrivKey.from_seed(b"\x07" * 32),
    "secp256k1": lambda: host.PrivKey.from_seed(b"ctx-cosmos"),
    "secp256k1eth": lambda: heth.PrivKey.from_seed(b"ctx-eth"),
    "ecrecover": lambda: heth.RecoverPrivKey.from_seed(b"ctx-rec"),
}


def test_constants_match():
    assert (ctx.MAGIC, ctx.MAGIC_V2, ctx.SIGN_DOMAIN) == (jax_ctx.MAGIC, jax_ctx.MAGIC_V2, jax_ctx.SIGN_DOMAIN)
    assert ctx.KEY_TYPE_BYTES == jax_ctx.KEY_TYPE_BYTES and ctx._KT_SHAPES == jax_ctx._KT_SHAPES


@pytest.mark.parametrize("kt", list(KEYS))
def test_make_and_parse_match_the_jax_package(kt):
    sk = KEYS[kt]()
    payload = b"payload of " + kt.encode()
    tx = ctx.make_signed_tx(sk, payload)
    assert tx == jax_ctx.make_signed_tx(sk, payload)
    parsed = ctx.parse_signed_tx(tx)
    assert parsed == jax_ctx.parse_signed_tx(tx)
    got_kt, pub, sig, body = parsed
    assert (got_kt, pub, body) == (kt, sk.pub_key().data, payload)
    assert sk.pub_key().verify_signature(ctx.SIGN_DOMAIN + body, sig)


@pytest.mark.parametrize("cut", [0, 5, 8, 9, 30, 60, 100])
def test_truncated_and_foreign_envelopes(cut):
    tx = ctx.make_signed_tx(KEYS["secp256k1eth"](), b"x")
    for t in (tx[:cut], ctx.MAGIC_V2 + b"\x09" + bytes(200), b"plain tx", ctx.MAGIC + bytes(cut)):
        assert ctx.parse_signed_tx(t) == jax_ctx.parse_signed_tx(t)
