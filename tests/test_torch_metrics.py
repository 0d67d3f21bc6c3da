"""The port's metrics (cometbft_tpu_torch/utils/metrics.py) against the
JAX package's (cometbft_tpu/utils/metrics.py): the cases of
tests/test_metrics_exposition.py on the port's registry, the same
observations exposed byte for byte by both registries, and the port's
Hub equal to the JAX Hub on every series it keeps — names, HELP, TYPE,
bucket bounds, label escaping — with the series it leaves out named."""

import math

import pytest

from cometbft_tpu.utils import metrics as J

from cometbft_tpu_torch.utils import metrics as P

# the JAX Hub's series the port leaves out until their modules are ported
LEFT_OUT = {
    "consensus_round_duration_seconds", "consensus_validators_power", "consensus_missing_validators",
    "consensus_missing_validators_power", "consensus_proposal_create_count", "consensus_proposal_receive_count",
    "consensus_block_size_bytes", "consensus_late_votes", "consensus_duplicate_vote",
    "consensus_duplicate_block_part", "mempool_tx_size_bytes", "mempool_failed_txs", "mempool_evicted_txs",
    "mempool_recheck_times", "mempool_already_received_txs", "p2p_message_send_bytes_total",
    "p2p_message_receive_bytes_total", "p2p_message_send_count", "p2p_message_receive_count", "p2p_errors_total",
    "consensus_timeout_fired_total", "consensus_height_phase_seconds",
    "verify_rpc_requests_total", "verify_rpc_resends_total", "verify_rpc_reconnects_total",
    "verify_rpc_breaker_state", "verify_rpc_breaker_transitions_total",
}

_ESCAPES = {"\\": "\\", '"': '"', "n": "\n"}


def _parse_labels(s: str) -> dict:
    labels = {}
    i = 0
    while i < len(s):
        j = s.index("=", i)
        key = s[i:j]
        assert s[j + 1] == '"', f"label value must be quoted: {s!r}"
        i = j + 2
        out = []
        while True:
            c = s[i]
            if c == "\\":
                out.append(_ESCAPES[s[i + 1]])  # KeyError = illegal escape
                i += 2
            elif c == '"':
                i += 1
                break
            else:
                assert c != "\n", "raw newline inside a label value"
                out.append(c)
                i += 1
        labels[key] = "".join(out)
        if i < len(s):
            assert s[i] == ","
            i += 1
    return labels


def parse_exposition(text: str):
    """-> (types: {name: type}, samples: [(name, labels, value)])."""
    assert text.endswith("\n"), "exposition must end with a line feed"
    types: dict[str, str] = {}
    samples: list[tuple[str, dict, float]] = []
    for line in text.rstrip("\n").split("\n"):
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            _, _, name, typ = line.split(" ", 3)
            assert typ in ("counter", "gauge", "histogram")
            assert name not in types, f"duplicate TYPE for {name}"
            types[name] = typ
            continue
        assert not line.startswith("#"), f"unknown comment line {line!r}"
        if "{" in line:
            name, rest = line.split("{", 1)
            labels_str, value_str = rest.rsplit("} ", 1)
            labels = _parse_labels(labels_str)
        else:
            name, value_str = line.rsplit(" ", 1)
            labels = {}
        samples.append((name, labels, float(value_str)))
    return types, samples


def _blocks(text: str) -> dict[str, str]:
    """An exposition split into one text block a metric (its HELP, TYPE
    and samples), by name."""
    out, name = {}, None
    for line in text.rstrip("\n").split("\n"):
        if line.startswith("# HELP "):
            name = line.split(" ", 3)[2]
            out[name] = line + "\n"
        elif line.startswith("# TYPE ") and line.split(" ", 3)[2] != name:
            name = line.split(" ", 3)[2]
            out[name] = line + "\n"
        else:
            out[name] += line + "\n"
    return out


@pytest.mark.parametrize("M", [P, J], ids=["port", "jax"])
def test_label_escaping_round_trips(M):
    nasty = 'he said "hi",\nthen a back\\slash'
    r = M.Registry(namespace="t")
    c = r.counter("events_total", "with weird labels")
    c.inc(3, kind=nasty)
    c.inc(2, kind="plain")
    types, samples = parse_exposition(r.expose_text())
    assert types["t_events_total"] == "counter"
    by_label = {s[1].get("kind"): s[2] for s in samples}
    assert by_label[nasty] == 3.0 and by_label["plain"] == 2.0


@pytest.mark.parametrize("M", [P, J], ids=["port", "jax"])
def test_histogram_invariants_per_labelset(M):
    r = M.Registry(namespace="t")
    h = r.histogram("lat_seconds", "l", buckets=(0.1, 1.0, 5.0))
    obs = {"a": [0.05, 0.5, 0.5, 2.0, 99.0], "b": [0.2]}
    for phase, vals in obs.items():
        for v in vals:
            h.observe(v, phase=phase)
    types, samples = parse_exposition(r.expose_text())
    assert types["t_lat_seconds"] == "histogram"
    for phase, vals in obs.items():
        buckets = [(float(lbl["le"]) if lbl["le"] != "+Inf" else math.inf, val)
                   for name, lbl, val in samples if name == "t_lat_seconds_bucket" and lbl.get("phase") == phase]
        counts = [c for _, c in buckets]
        assert counts == sorted(counts), "bucket counts must be cumulative"
        for le, c in buckets:
            assert c == sum(1 for v in vals if v <= le)
        (count,) = [v for n, lbl, v in samples if n == "t_lat_seconds_count" and lbl.get("phase") == phase]
        (total,) = [v for n, lbl, v in samples if n == "t_lat_seconds_sum" and lbl.get("phase") == phase]
        assert buckets[-1][0] == math.inf and buckets[-1][1] == count == len(vals)
        assert total == pytest.approx(sum(vals))


def _observe_all(M):
    """The same observations on a fresh registry of either package,
    every kind of series and a label value that needs escaping."""
    r = M.Registry(namespace="t")
    c = r.counter("c_total", "a counter")
    g = r.gauge("g", "a gauge")
    h = r.histogram("h_seconds", "a histogram", buckets=(0.001, 0.5, 2))
    c.inc(tenant='q"\\\n')
    c.inc(2.5, tenant="b")
    g.set(3, loop="x")
    g.add(-1, loop="x")
    g.set(9, loop="gone")
    g.remove(loop="gone")
    for v in (0.0005, 0.25, 0.75, 7.0):
        h.observe(v, phase="p")
    r.histogram("empty_seconds", "never observed")
    return r.expose_text()


def test_the_same_observations_expose_the_same_text():
    assert _observe_all(P) == _observe_all(J)


@pytest.mark.parametrize("M", [P, J], ids=["port", "jax"])
def test_registry_deduplicates_and_refuses_conflicts(M):
    r = M.Registry(namespace="t")
    c1 = r.counter("dup_total", "first")
    assert r.counter("dup_total", "second declaration") is c1
    c1.inc(5)
    _, samples = parse_exposition(r.expose_text())
    assert [s for s in samples if s[0] == "t_dup_total"] == [("t_dup_total", {}, 5.0)]
    assert r.gauge("g", "") is r.gauge("g", "") and r.histogram("h", "") is r.histogram("h", "")
    with pytest.raises(ValueError):
        r.histogram("h", "", buckets=(1.0, 2.0))
    with pytest.raises(ValueError):
        r.gauge("dup_total", "")
    M.Counter("t_direct", registry=r)
    with pytest.raises(ValueError):
        M.Gauge("t_direct", registry=r)


@pytest.mark.parametrize("M", [P, J], ids=["port", "jax"])
def test_label_guard_bounds_cardinality(M):
    g = M.LabelGuard(3)
    assert [g.bound(f"t{i}") for i in range(3)] == ["t0", "t1", "t2"]
    assert g.bound("t3") == "__overflow__" and g.bound("t0") == "t0" and g.bound("t4") == "__overflow__"
    assert g.admitted() == 3 and g.overflowed() == 2
    r = M.Registry("guardtest")
    c = r.counter("tenant_hits_total")
    g2 = M.LabelGuard(2)
    for i in range(10):
        c.inc(tenant=g2.bound(f"ten{i}"))
    _, samples = parse_exposition(r.expose_text())
    by_tenant = {lbl["tenant"]: v for n, lbl, v in samples if n == "guardtest_tenant_hits_total"}
    assert by_tenant == {"ten0": 1.0, "ten1": 1.0, "__overflow__": 8.0}


def _hub_observations(hub):
    """Every ported series observed once, as the port's call sites do."""
    g = hub.tenant_labels.bound
    hub.verify_submit_queue_depth.add(1)
    hub.verify_slab_requests.inc(result="hit")
    hub.verify_batch_width.observe(10_000.0)
    hub.verify_staging_busy.inc(0.004)
    hub.comb_table_cache.inc(result="miss")
    hub.secp_pubkey_cache.inc(result="hit")
    hub.verify_svc_queue_depth.set(3, **{"class": "consensus"})
    hub.verify_svc_flush.inc(**{"class": "mempool", "reason": "deadline"})
    hub.verify_svc_rejected.inc(**{"class": "mempool"})
    hub.verify_svc_queue_wait.observe(0.0003, **{"class": "consensus"})
    hub.verify_svc_tenant_queue_depth.set(2, tenant=g('chain "a"'), **{"class": "mempool"})
    hub.verify_svc_tenant_dispatched.inc(tenant=g("chain-b"), **{"class": "consensus"})
    hub.verify_svc_tenant_rejected.inc(tenant=g("rogue\n"), scope="tenant", **{"class": "mempool"})
    hub.verify_svc_collect_timeout.inc(**{"class": "blocksync"})
    hub.verify_svc_backend_mode.set(1)
    hub.verify_svc_failover.inc(direction="to_cpu")
    hub.verify_svc_host_reverify.inc(3, cause="wedge")
    hub.verify_proof_queries.inc(64, route="device")
    hub.verify_proof_tree_cache.inc(result="miss")
    hub.health_state.set(2)
    hub.health_probe_seconds.observe(4.2)
    hub.health_probe_total.inc(result="hang")
    hub.health_probe_consec_failures.set(2)
    hub.health_beat_age.set(0.5, loop="verifysvc-sched")
    hub.health_transitions.inc(state="wedged")
    hub.health_forensics.inc()
    for phase, v in (("assembly", 0.0012), ("device_wait", 0.0004), ("table_build_device", 0.3),
                     ("bls_pairing", 0.05), ("secp_device", 0.002)):
        hub.verify_phase_seconds.observe(v, phase=phase)


def test_the_hub_exposes_the_jax_hubs_series_byte_for_byte():
    """For the same observations, each series of the port's Hub is the
    JAX Hub's block of text: name, HELP, TYPE, buckets, samples; in the
    JAX order.  The JAX series left out are exactly LEFT_OUT."""
    p_hub, j_hub = P.Hub(P.Registry()), J.Hub(J.Registry())
    _hub_observations(p_hub)
    _hub_observations(j_hub)
    p_text, j_text = p_hub.registry.expose_text(), j_hub.registry.expose_text()
    parse_exposition(p_text)  # a parseable document, unique names
    pb, jb = _blocks(p_text), _blocks(j_text)
    assert {n.removeprefix("cometbft_") for n in set(jb) - set(pb)} == LEFT_OUT
    assert set(pb) <= set(jb)
    assert list(pb) == [n for n in jb if n in pb]
    for name, block in pb.items():
        assert block == jb[name], name


def test_the_hub_is_one_a_process():
    assert P.hub() is P.hub()
    assert isinstance(P.hub().tenant_labels, P.LabelGuard)
    assert P.hub().tenant_labels.max_values == J.hub().tenant_labels.max_values == 32
