"""The incremental (churn) table build after a validator-set change:
ValsetCombCache._build with a base entry, K3 on a padded bucket of the
fresh keys, and K6 assemble_churn (cometbft_tpu_torch/models/
comb_verifier.py; device="cpu" runs K3's and K6's plain versions).  At
V = 8 the churn-built tables must equal a full build of the new set, and
assemble_churn must equal the JAX package's _assemble_churn on the same
tables (carried across with convert.tables_from_jax).  Exact equality of
canonical table encodings and valid flags."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cometbft_tpu.crypto import _ref25519 as jref
from cometbft_tpu.models.comb_verifier import _assemble_churn as jax_assemble_churn
from cometbft_tpu.ops import comb as jcomb
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import ed25519 as host
from cometbft_tpu_torch.models import comb_verifier as cv
from cometbft_tpu_torch.ops import comb

# One intra-op thread: these tensors are tiny, and the suite's other
# workers run timing-sensitive consensus tests beside this file.
torch.set_num_threads(1)

V = 8


def _off_curve() -> bytes:
    return next(
        y.to_bytes(32, "little") for y in range(2, 1000)
        if jref.decompress(y.to_bytes(32, "little")) is None
    )


def _pub(seed: int) -> bytes:
    return host.PrivKey.from_seed(bytes([seed]) * 32).pub_key().data


OLD = [_pub(40 + i) for i in range(V)]
OLD[2] = _off_curve()  # an invalid key, reused by every case below


def _new_set(case: str) -> list[bytes]:
    if case == "swap_one":
        new = list(OLD)
        new[3] = _pub(70)
    elif case == "reorder":
        new = [OLD[i] for i in (5, 2, 7, 0, 1, 6, 3, 4)]
    elif case == "all_fresh":
        new = [_pub(80 + i) for i in range(V)]
    else:  # "padded_bucket": three fresh keys (one invalid) in a bucket of 4
        new = [OLD[i] for i in (7, 1, 2, 4, 0, 6, 5, 3)]
        new[0], new[5], new[7] = _pub(90), _pub(91), _off_curve()[:31] + b"\x80"
    return new


CASES = {"swap_one": (1, 1), "reorder": (0, None), "all_fresh": (8, 8), "padded_bucket": (3, 4)}


def _arr(pubs):
    return np.frombuffer(b"".join(pubs), np.uint8).reshape(-1, 32)


@pytest.fixture(scope="module")
def old_entry():
    return cv.ValsetCombCache().ensure(OLD, device="cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_churn_build_equals_full_build(case, old_entry, monkeypatch):
    n_fresh, bucket = CASES[case]
    cache = cv.ValsetCombCache()
    cache._entries[("cpu", cache.fingerprint(OLD))] = old_entry  # the churn base
    built = []
    real = comb.build_a_tables
    monkeypatch.setattr(comb, "build_a_tables", lambda a: built.append(a.shape[0]) or real(a))
    new = _new_set(case)
    entry = cache.ensure(new, device="cpu")
    # K3 ran on the fresh keys' bucket only (the whole set when nothing is reused)
    assert built == ([] if bucket is None else [bucket])
    full_t, full_v = real(torch.from_numpy(_arr(new).copy()))
    assert torch.equal(entry.tables, full_t) and torch.equal(entry.valid, full_v)
    assert entry.index == {pk: i for i, pk in enumerate(new)}
    assert torch.equal(entry.pubs, torch.from_numpy(_arr(new).copy()))
    assert sum(pk not in OLD for pk in new) == n_fresh


@pytest.mark.parametrize("case", ["swap_one", "reorder", "padded_bucket"])
def test_assemble_churn_matches_jax(case):
    """The port's assemble_churn (K6's plain version) against the JAX
    package's _assemble_churn, both on the JAX host-built tables."""
    new = _new_set(case)
    old_index = {pk: i for i, pk in enumerate(OLD)}
    reuse = [(i, old_index[pk]) for i, pk in enumerate(new) if pk in old_index]
    fresh = [i for i, pk in enumerate(new) if pk not in old_index]
    padded = []
    if fresh:  # the bucket: fresh keys padded to a power of two with the first
        bucket = 1 << (len(fresh) - 1).bit_length()
        padded = [new[i] for i in fresh] + [new[fresh[0]]] * (bucket - len(fresh))
    jt, jv = jcomb.build_a_tables_host(_arr(OLD))
    base = convert.tables_from_jax(jt, jv, _arr(OLD), device="cpu")
    if padded:
        nt, nv = jcomb.build_a_tables_host(_arr(padded))
        fresh_entry = convert.tables_from_jax(nt, nv, _arr(padded), device="cpu")
        new_t, new_v = fresh_entry.tables, fresh_entry.valid
    else:
        nt, nv = jt[..., :0], jv[:0]
        new_t, new_v = base.tables[:0], base.valid[:0]
    rows = [np.asarray(x, np.int64) for x in ([i for i, _ in reuse], [j for _, j in reuse], fresh)]
    tables, valid = cv.assemble_churn(base.tables, base.valid, new_t, new_v,
                                      *(torch.from_numpy(x) for x in rows), V)
    jtab, jval = jax_assemble_churn(jnp.asarray(jt), jnp.asarray(jv), jnp.asarray(nt),
                                    jnp.asarray(nv), *(jnp.asarray(x.astype(np.int32)) for x in rows), V)
    assert np.array_equal(convert.a_tables_to_canonical(tables),
                          convert.jax_a_tables_to_canonical(np.asarray(jtab)))
    assert valid.tolist() == np.asarray(jval).tolist()


def test_assemble_churn_zero_fills_unnamed_rows():
    """A row that neither index names stays zero and invalid, as the JAX
    version's zero-initialised scatter leaves it."""
    g = torch.Generator().manual_seed(3)
    base = torch.randint(-100, 100, (5, 64, 8, 3, 8), generator=g, dtype=torch.int32)
    fresh = torch.randint(-100, 100, (2, 64, 8, 3, 8), generator=g, dtype=torch.int32)
    t, v = cv.assemble_churn(base, torch.ones(5, dtype=torch.bool), fresh,
                             torch.ones(2, dtype=torch.bool), torch.tensor([0, 3]),
                             torch.tensor([4, 1]), torch.tensor([1]), 4)
    assert torch.equal(t[0], base[4]) and torch.equal(t[3], base[1]) and torch.equal(t[1], fresh[0])
    assert int(t[2].abs().sum()) == 0 and v.tolist() == [True, True, False, True]
    with pytest.raises(ValueError):
        cv.assemble_churn(base, torch.ones(5, dtype=torch.bool), fresh[:0],
                          torch.ones(0, dtype=torch.bool), torch.tensor([0]),
                          torch.tensor([1]), torch.tensor([1]), 2)
