"""The blocksync verify-ahead under a mesh of two spawned gloo ranks
(CPU, the kernels' plain versions): submit_verify_commit_light pipelined
at depth 2 over a 2,048-validator set that changes mid-stream, one rank's
host lagging; then the raw commit stream with a foreign key in one block.
Every collective of the comb route — the stages' and the
readiness agreement — must run on the comb path's staging thread in the
caller's order, so both ranks give the same routes and verdicts and no
collective pairs with another's.  The spawn's join limit is the test's
timeout: a hang fails it (tests/torch_parallel_ranks.py)."""

import pytest
import torch

import torch_parallel_ranks as R
from cometbft_tpu_torch.ops import comb

torch.set_num_threads(1)

PIPE_LIMIT_S = 420  # the test's own timeout: ranks still running then are killed and it fails


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline")
    return R.spawn(2, out, ("pipeline",), {"seed": 2027}, comb.build_b_tables(), timeout=PIPE_LIMIT_S)


def test_pipelined_stream_agrees_across_ranks(ranks):
    """Both ranks: every height in order, the same route a height, every
    commit verified but the tampered one, blamed on its row."""
    runs = [r["pipeline"]["blocks"] for r in ranks]
    assert runs[0] == runs[1]
    heights = [100 + b for b in range(R.PIPE_BLOCKS)]
    assert [h for h, _, _ in runs[0]] == heights
    bad = 100 + R.PIPE_TAMPER[0]
    for h, route, err in runs[0]:
        assert route in ("comb", "plain")
        assert err == (f"wrong signature (#{R.PIPE_TAMPER[1]})" if h == bad else None), h
    # the first set's tables were warm: its heights took the comb route
    assert [route for _, route, _ in runs[0][: R.PIPE_CHANGE]] == ["comb"] * R.PIPE_CHANGE


def test_a_foreign_key_demotes_only_its_block_under_the_mesh(ranks):
    """The raw commit stream at depth 2 on the sharded tables: both ranks
    blame the foreign key's row of its block alone, and that block, sent
    to the uncached verifier, issues no collective (each other block's
    stage one all_gather and one all_reduce)."""
    streams = [r["pipeline"]["stream"] for r in ranks]
    assert streams[0] == streams[1]
    b, row = R.PIPE_FOREIGN
    assert streams[0] == [(False, [row]) if i == b else (True, []) for i in range(R.PIPE_CHANGE)]
    assert [r["pipeline"]["stream_collectives"] for r in ranks] == [2 * (R.PIPE_CHANGE - 1)] * 2


def test_every_collective_ran_on_the_staging_thread(ranks):
    for r in ranks:
        threads = r["pipeline"]["collective_threads"]
        # each comb height's stage (all_gather + all_reduce), and a
        # readiness agreement (all_reduce) for each height of the
        # second set, which builds in the background
        assert len(threads) >= 2 * R.PIPE_CHANGE + (R.PIPE_BLOCKS - R.PIPE_CHANGE)
        assert set(threads) == {"comb-stage_0"}, threads

