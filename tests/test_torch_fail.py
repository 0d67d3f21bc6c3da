"""The port's fault registry (cometbft_tpu_torch/utils/fail.py) against
the JAX package's (cometbft_tpu/utils/fail.py): the same script of arm,
armed, consume, clear and fired on both, the wedge wait, the env arming
of the three faults the verify service reads, and the knobs' names and
defaults (cometbft_tpu_torch/envknobs.py against
cometbft_tpu/utils/envknobs.py) for the failover, fault, health and
flight-recorder variables."""

import importlib
import threading
import time

import pytest

from cometbft_tpu.utils import envknobs as jknobs
from cometbft_tpu.utils import fail as jfail

from cometbft_tpu_torch import envknobs
from cometbft_tpu_torch.utils import fail as pfail

SERVICE_FAULTS = ("wedge_device", "slow_collect", "fail_dispatch")


@pytest.fixture(autouse=True)
def _clean():
    for f in (pfail, jfail):
        f.clear_all()
    yield
    for f in (pfail, jfail):
        f.clear_all()


def _script(f):
    """One sequence of registry calls -> everything it observed."""
    out = [f.armed("wedge_device")]
    f.arm("wedge_device")
    out.append(f.armed("wedge_device"))
    f.arm("slow_collect", 0.25)
    out.append(f.active())
    f.clear("wedge_device")
    out += [f.armed("wedge_device"), f.active()]
    f.arm("fail_dispatch", 2)
    out += [f.consume("fail_dispatch"), f.consume("fail_dispatch"), f.consume("fail_dispatch"), f.active()]
    out.append({k: v for k, v in f.fired().items() if k in SERVICE_FAULTS})
    with pytest.raises(ValueError, match="unknown fault"):
        f.arm("not_a_fault")
    f.clear_all()
    out += [f.active(), f.armed("slow_collect"), f.consume("slow_collect")]
    return out


def test_the_registry_answers_as_the_jax_registry():
    fired0 = [{k: f.fired().get(k, 0) for k in SERVICE_FAULTS} for f in (pfail, jfail)]
    got = [_script(f) for f in (pfail, jfail)]
    for out, base in zip(got, fired0):  # the fire tallies are process-wide: take the script's deltas
        out[9] = {k: v - base.get(k, 0) for k, v in out[9].items()}
    assert got[0] == got[1]
    assert got[0][:3] == [None, 1.0, {"wedge_device": 1.0, "slow_collect": 0.25}]
    assert got[0][5:8] == [2.0, 1.0, None]


def test_the_service_faults_are_known_to_both_and_others_refused():
    assert set(SERVICE_FAULTS) == set(pfail.FAULTS) <= set(jfail.FAULTS)
    for name in set(jfail.FAULTS) - set(SERVICE_FAULTS):  # faults of seams the port does not have
        with pytest.raises(ValueError, match="unknown fault"):
            pfail.arm(name)


@pytest.mark.parametrize("f", [pfail, jfail], ids=["port", "jax"])
def test_wedge_wait_blocks_until_cleared(f):
    assert f.wedge_wait() == 0.0  # unarmed: at once
    f.arm("wedge_device")
    released = []
    t = threading.Thread(target=lambda: released.append(f.wedge_wait(poll_s=0.01)))
    t.start()
    time.sleep(0.15)
    assert not released  # still parked
    f.clear("wedge_device")
    t.join(10)
    assert released and released[0] >= 0.1


def test_the_env_arms_the_service_faults_as_the_jax_package(monkeypatch):
    """A number is the fault's value, any other text arms it with 1, an
    empty value arms nothing."""
    monkeypatch.setenv("COMETBFT_TPU_FAULT_SLOW_COLLECT", "2.5")
    monkeypatch.setenv("COMETBFT_TPU_FAULT_FAIL_DISPATCH", "junk")
    monkeypatch.setenv("COMETBFT_TPU_FAULT_WEDGE_DEVICE", "")
    try:
        got = []
        for f in (pfail, jfail):
            importlib.reload(f)
            got.append({k: v for k, v in f.active().items() if k in SERVICE_FAULTS})
        assert got[0] == got[1] == {"slow_collect": 2.5, "fail_dispatch": 1.0}
    finally:
        for name in ("COMETBFT_TPU_FAULT_SLOW_COLLECT", "COMETBFT_TPU_FAULT_FAIL_DISPATCH",
                     "COMETBFT_TPU_FAULT_WEDGE_DEVICE"):
            monkeypatch.delenv(name)
        for f in (pfail, jfail):
            importlib.reload(f)
            f.clear_all()


KNOBS = ("FAILOVER", "FAILOVER_BATCH_DEADLINE_MS", "FAILOVER_PROBATION_OK", "FAILOVER_PROBE_PERIOD_MS",
         "FAILOVER_PROBE_TIMEOUT_MS", "FAULT_WEDGE_DEVICE", "FAULT_SLOW_COLLECT", "FAULT_FAIL_DISPATCH",
         "FLIGHTREC", "HEALTH", "HEALTH_PERIOD_MS", "HEALTH_PROBE_TIMEOUT_MS", "HEALTH_WEDGE_AFTER",
         "HEALTH_ARTIFACT_MIN_INTERVAL_MS", "HEALTH_DIR", "VERIFYSVC_TENANT_LABEL_MAX")


@pytest.mark.parametrize("name", KNOBS)
def test_knobs_read_the_jax_names_and_defaults(name):
    ours, theirs = getattr(envknobs, name), getattr(jknobs, name)
    assert ours == theirs
    assert envknobs._DEFAULTS[ours] == jknobs._REGISTRY[theirs].default


@pytest.mark.parametrize("value", ["0", "off", "1", "", "maybe"])
def test_the_failover_switch_parses_as_the_jax_package(monkeypatch, value):
    monkeypatch.setenv("COMETBFT_TPU_FAILOVER", value)
    assert envknobs.get_bool(envknobs.FAILOVER) is jknobs.get_bool(jknobs.FAILOVER)
