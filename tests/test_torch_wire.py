"""The port's wire observatory (``telemetry/wire.py``): the ports of
``tests/test_wire.py``'s 25 cases.

The context codec (round trip and every degraded shape: torn,
crc-damaged, version-skewed, always context-free and never a protocol
error), chaos on the real framing seam (``install_wire_chaos``
corrupting or dropping frames leaves transfers correct, with
``engine.fired`` pinned), the cross-process trace stitch (a real-socket
peer pull merges into one parent -> child span pair), the fleet metrics
plane (bounded crc-guarded ``__obs/`` snapshots, torn and stale entries
skipped, publisher keys reaped on close), and the fleet-scope doctor
rules, with the acceptance case that a peer server whose listen backlog
is clamped to 5 produces the whole-second dial latencies
``wire-dial-stalled`` fires on, while the default backlog of 128 stays
quiet. Every socket wait has its own timeout.
"""

import pickle
import socket
import threading
import time

import pytest

from torchsnapshot_tpu_torch import telemetry
from torchsnapshot_tpu_torch.chaos.engine import (
    ChaosEngine,
    install_wire_chaos,
    uninstall_wire_chaos,
)
from torchsnapshot_tpu_torch.chaos.plan import FaultPlan, FaultSpec
from torchsnapshot_tpu_torch.dist_store import (
    InProcessStore,
    recv_frame,
    send_frame,
)
from torchsnapshot_tpu_torch.integrity import compute_checksum_entry
from torchsnapshot_tpu_torch.scheduler import PeerCacheBudget
from torchsnapshot_tpu_torch.telemetry import doctor, names, trace, wire
from torchsnapshot_tpu_torch.telemetry.registry import series_key
from torchsnapshot_tpu_torch.telemetry.trace import (
    chrome_trace,
    merge_traces,
    stitched_wire_pairs,
    write_trace_file,
)
from torchsnapshot_tpu_torch.telemetry.watchdog import reset_watchdog
from torchsnapshot_tpu_torch.tiered import peer


@pytest.fixture(autouse=True)
def _fresh_wire():
    """Wire tests read process-global state (registry, recorder, the
    recent-dial ring, the chaos hook): isolate every test."""
    telemetry.reset_metrics()
    telemetry.reset_trace()
    reset_watchdog()
    wire.reset_recent_dials()
    wire.set_received_context(None)
    yield
    uninstall_wire_chaos()
    reset_watchdog()
    telemetry.reset_metrics()
    telemetry.reset_trace()
    wire.reset_recent_dials()
    wire.set_received_context(None)


def _degraded(reason):
    counters = telemetry.metrics().counters_snapshot()
    return counters.get(
        series_key(names.WIRE_CONTEXT_DEGRADED_TOTAL, {"reason": reason}), 0.0
    )


# ---------------------------------------------------------------------------
# Codec: round trip + every degraded shape
# ---------------------------------------------------------------------------


def test_codec_round_trip():
    ctx = wire.WireContext(wire.new_id(), wire.new_id(), names.RPC_PEER_PULL)
    framed = wire.encode_frame(ctx, b"body-bytes")
    assert len(framed) == wire.HEADER_LEN + len(b"body-bytes")
    decoded, body = wire.decode_frame(framed)
    assert body == b"body-bytes"
    assert decoded == ctx


def test_codec_context_free_passthrough():
    # No magic: the payload is untouched and nothing is counted.
    payload = b"\x00plain frame with no header"
    assert wire.decode_frame(payload) == (None, payload)
    assert _degraded("torn") == _degraded("crc") == 0.0


def test_codec_torn_header_passes_raw_payload():
    ctx = wire.WireContext(wire.new_id(), wire.new_id(), names.RPC_PEER_PING)
    torn = wire.encode_frame(ctx, b"")[: wire.HEADER_LEN - 1]
    decoded, body = wire.decode_frame(torn)
    assert decoded is None and body == torn
    assert _degraded("torn") == 1.0


def test_codec_crc_damage_strips_header_keeps_body():
    ctx = wire.WireContext(wire.new_id(), wire.new_id(), names.RPC_PEER_PULL)
    framed = bytearray(wire.encode_frame(ctx, b"intact-body"))
    framed[10] ^= 0xFF  # damage inside the op field
    decoded, body = wire.decode_frame(bytes(framed))
    assert decoded is None and body == b"intact-body"
    assert _degraded("crc") == 1.0


def test_codec_version_skew_strips_header_keeps_body():
    import struct
    import zlib

    ctx = wire.WireContext(wire.new_id(), wire.new_id(), names.RPC_PEER_PING)
    framed = bytearray(wire.encode_frame(ctx, b"vbody"))
    framed[4] = 99  # future version...
    head = bytes(framed[: wire.HEADER_LEN - 4])
    framed[wire.HEADER_LEN - 4 : wire.HEADER_LEN] = struct.pack(
        "<I", zlib.crc32(head)
    )  # ...with a VALID crc, so only the version gate trips
    decoded, body = wire.decode_frame(bytes(framed))
    assert decoded is None and body == b"vbody"
    assert _degraded("version") == 1.0


def test_propagate_nests_under_one_trace():
    assert wire.current_context() is None
    with wire.propagate(names.RPC_CDN_SYNC) as outer:
        with wire.propagate(names.RPC_PEER_PULL) as inner:
            assert inner.trace_id == outer.trace_id
            assert inner.span_id != outer.span_id
            assert wire.current_context() is inner
        assert wire.current_context() is outer
    assert wire.current_context() is None


# ---------------------------------------------------------------------------
# Framing seam: context rides send_frame/recv_frame
# ---------------------------------------------------------------------------


def test_send_recv_frame_carries_context_across_socket():
    a, b = socket.socketpair()
    try:
        with wire.propagate(names.RPC_PEER_PING) as ctx:
            send_frame(a, b"ping-body", endpoint="peer")
        b.settimeout(5)
        got = recv_frame(b, endpoint="peer")
    finally:
        a.close()
        b.close()
    assert got == b"ping-body"
    received = wire.last_received_context()
    assert received is not None
    assert received.op == names.RPC_PEER_PING
    assert received.trace_id == ctx.trace_id
    assert received.span_id == ctx.span_id


def test_send_frame_without_context_is_headerless():
    a, b = socket.socketpair()
    try:
        send_frame(a, b"bare", endpoint="peer")
        b.settimeout(5)
        got = recv_frame(b, endpoint="peer")
    finally:
        a.close()
        b.close()
    assert got == b"bare"
    assert wire.last_received_context() is None
    counters = telemetry.metrics().counters_snapshot()
    sent = counters[
        series_key(names.WIRE_FRAMES_TOTAL, {"endpoint": "peer", "dir": "send"})
    ]
    recvd = counters[
        series_key(names.WIRE_FRAMES_TOTAL, {"endpoint": "peer", "dir": "recv"})
    ]
    assert sent == recvd == 1.0


# ---------------------------------------------------------------------------
# Chaos interop: corruption/drops degrade context, never the transfer
# ---------------------------------------------------------------------------


def test_wire_chaos_corrupt_header_degrades_context_not_payload():
    engine = ChaosEngine(
        FaultPlan(seed=0, faults=[FaultSpec(point="wire-send", mode="corrupt")])
    )
    install_wire_chaos(engine)
    # Body short enough that the corrupt hook's middle-byte bit flip
    # lands inside the 50-byte context header, not the body.
    body = b"x" * 30
    a, b = socket.socketpair()
    try:
        with wire.propagate(names.RPC_PEER_PULL):
            send_frame(a, body, endpoint="peer")
        b.settimeout(5)
        got = recv_frame(b, endpoint="peer")
    finally:
        uninstall_wire_chaos()
        a.close()
        b.close()
    assert got == body  # the transfer is CORRECT...
    assert wire.last_received_context() is None  # ...just context-free
    assert engine.fired == [
        ("wire-send", str(wire.HEADER_LEN + len(body)), "corrupt")
    ]
    assert _degraded("crc") == 1.0


def test_wire_chaos_drop_swallows_frame_and_the_retry_lands():
    engine = ChaosEngine(
        FaultPlan(faults=[FaultSpec(point="wire-send", mode="drop", times=1)])
    )
    install_wire_chaos(engine)
    a, b = socket.socketpair()
    try:
        with wire.propagate(names.RPC_PEER_PING):
            send_frame(a, b"first", endpoint="peer")  # vanishes on the floor
            send_frame(a, b"retry", endpoint="peer")
        b.settimeout(5)
        got = recv_frame(b, endpoint="peer")
    finally:
        uninstall_wire_chaos()
        a.close()
        b.close()
    # The receiver waited the dropped frame out and saw only the retry,
    # context intact (the retry's header was not damaged).
    assert got == b"retry"
    received = wire.last_received_context()
    assert received is not None and received.op == names.RPC_PEER_PING
    assert [(point, mode) for point, _, mode in engine.fired] == [
        ("wire-send", "drop")
    ]


def _serve(cache):
    server = peer._PeerServer(("127.0.0.1", 0), cache)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def test_peer_rpc_survives_corrupted_context_header():
    """End-to-end over the real peer transport: chaos flips a header
    bit on the request frame; the serving peer still answers correctly
    (the header degrades, the pickled body never does)."""
    engine = ChaosEngine(
        FaultPlan(faults=[FaultSpec(point="wire-send", mode="corrupt", times=1)])
    )
    cache = peer.PeerCache(budget=PeerCacheBudget(1 << 20))
    server = _serve(cache)
    install_wire_chaos(engine)
    try:
        client = peer.PeerClient(
            "127.0.0.1", server.server_address[1], timeout=5
        )
        assert client.request(names.RPC_PEER_PING) == "pong"
        client.close()
    finally:
        uninstall_wire_chaos()
        server.shutdown()
        server.server_close()
    expected_len = wire.HEADER_LEN + len(
        pickle.dumps((names.RPC_PEER_PING, ()))
    )
    assert engine.fired == [("wire-send", str(expected_len), "corrupt")]
    assert _degraded("crc") == 1.0


# ---------------------------------------------------------------------------
# Cross-process stitch: client RPC span <-> serving handler span
# ---------------------------------------------------------------------------


def test_peer_pull_stitches_client_and_handler_spans(tmp_path):
    """A clean real-socket peer pull exports a client-side ``wire:rpc``
    span and a server-side ``wire:handler`` span; merged as two ranks,
    they form one parent->child pair under one trace id, and the merge
    appends the Perfetto flow arrows."""
    rec = trace.get_recorder()
    mark = rec.mark()
    cache = peer.PeerCache(budget=PeerCacheBudget(1 << 20))
    server = _serve(cache)
    try:
        client = peer.PeerClient(
            "127.0.0.1", server.server_address[1], timeout=5
        )
        entry = compute_checksum_entry(b"payload")
        assert client.push("s", 0, "blob", entry, b"payload")[0]
        client.commit("s", 0)
        got = client.pull("s", "blob")
        assert got is not None and bytes(got[1]) == b"payload"
        client.close()
    finally:
        server.shutdown()
        server.server_close()
    events = rec.events_since(mark)
    tids = rec.tid_names()
    client_events = [e for e in events if e["name"] == names.SPAN_WIRE_RPC]
    handler_events = [e for e in events if e["name"] == names.SPAN_WIRE_HANDLER]
    assert client_events and handler_events
    # Export each side as its own rank file — the 2-process shape the
    # merge CLI sees.
    p0 = str(tmp_path / ".trace-restore-rank0.json")
    p1 = str(tmp_path / ".trace-restore-rank1.json")
    write_trace_file(p0, chrome_trace(client_events, tids, rank=0))
    write_trace_file(p1, chrome_trace(handler_events, tids, rank=1))
    merged = merge_traces([p0, p1], {0: 0.0, 1: 0.0})
    pairs = stitched_wire_pairs(merged)
    assert merged["otherData"]["wire_stitched"] == len(pairs) >= 1
    pull_pairs = [
        (c, h)
        for c, h in pairs
        if c["args"].get("op") == names.RPC_PEER_PULL
    ]
    assert pull_pairs
    client_span, handler_span = pull_pairs[0]
    assert client_span["pid"] == 0 and handler_span["pid"] == 1
    assert handler_span["args"]["trace_id"] == client_span["args"]["trace_id"]
    assert (
        handler_span["args"]["parent_span_id"]
        == client_span["args"]["span_id"]
    )
    flows = [e for e in merged["traceEvents"] if e.get("cat") == "wire"]
    assert {e["ph"] for e in flows} == {"s", "f"}


# ---------------------------------------------------------------------------
# Per-endpoint metric folds
# ---------------------------------------------------------------------------


def test_local_wire_summary_folds_endpoint_series():
    wire.observe_frame("peer", "send", 100)
    wire.observe_frame("peer", "recv", 50)
    wire.observe_rpc("peer", names.RPC_PEER_PULL, 0.2)
    wire.observe_dial("peer", 0.01)
    wire.observe_dial("peer", 0.0, ok=False)  # errors stay out of the ring
    wire.observe_pool_checkout("peer", "reused")
    with wire.rpc_inflight("peer"):
        pass  # balanced enter/exit must never throw
    telemetry.metrics().counter_inc(
        names.COORD_STORE_SHARD_REQUESTS_TOTAL, 7, shard="0"
    )
    summary = wire.local_wire_summary()
    ep = summary["endpoints"]["peer"]
    assert ep["frames"] == 2 and ep["bytes"] == 150
    assert ep["rpcs"] == 1 and ep["dials"] == 2
    assert summary["dials_s"] == [0.01]
    assert summary["store_shards"] == {"0": 7.0}
    assert "context_degraded" not in summary  # only rendered when nonzero


def test_quantized_dial_fraction_signature():
    # Whole-second clustering (SYN retransmits) vs. a smeared tail.
    slow, frac = wire.quantized_dial_fraction([0.01, 0.02, 1.01, 1.98, 3.0])
    assert (slow, frac) == (3, 1.0)
    slow, frac = wire.quantized_dial_fraction([0.6, 0.7, 1.4])
    assert (slow, frac) == (3, 0.0)
    assert wire.quantized_dial_fraction([0.001, 0.002]) == (0, 0.0)


# ---------------------------------------------------------------------------
# Fleet metrics plane: bounded, crc-guarded, reaped
# ---------------------------------------------------------------------------


def test_fleet_entry_round_trip_bounds_and_shedding():
    snap = wire.fleet_snapshot(
        "trainer",
        3,
        7,
        phase="write",
        written_bytes=1234,
        extra={"bulk": "x" * (2 * wire.SNAPSHOT_MAX_BYTES)},
    )
    raw = wire.encode_fleet_entry(snap)
    # "<crc32-hex>:" prefix is 9 bytes; the json body itself is bounded.
    assert len(raw) - 9 <= wire.SNAPSHOT_MAX_BYTES
    entry = wire.decode_fleet_entry(raw)
    assert entry is not None
    assert entry["role"] == "trainer" and entry["id"] == "3"
    assert entry["seq"] == 7 and entry["written_bytes"] == 1234
    assert "extra" not in entry  # shed first to fit the bound...
    assert "wire" in entry  # ...keeping the wire summary


def test_fleet_entry_torn_and_stale_are_skipped():
    snap = wire.fleet_snapshot("trainer", 0, 1)
    raw = wire.encode_fleet_entry(snap)
    assert wire.decode_fleet_entry(None) is None
    assert wire.decode_fleet_entry(b"not-a-fleet-entry") is None
    assert wire.decode_fleet_entry(raw[:-3]) is None  # torn write
    assert wire.decode_fleet_entry(raw, now=snap["t"] + 1e6) is None  # stale
    fresh = wire.decode_fleet_entry(raw, now=snap["t"] + 1.0)
    assert fresh is not None and 0.0 <= fresh["age_s"] <= 2.0


def test_fleet_reporter_paces_publishes_and_reaps_on_close():
    store = InProcessStore()
    reporter = wire.FleetReporter(store, "trainer", 3, interval_s=3600)
    assert reporter.publish(phase="a") is True
    assert reporter.publish(phase="b") is False  # paced out
    assert reporter.publish(phase="c", force=True) is True
    # Torn and stale residue on the same prefix is skipped by readers.
    store.multi_set({f"{wire.OBS_PREFIX}/trainer/9": b"garbage"})
    stale = wire.fleet_snapshot("trainer", 8, 1)
    stale["t"] -= 10_000
    store.multi_set(
        {f"{wire.OBS_PREFIX}/trainer/8": wire.encode_fleet_entry(stale)}
    )
    entries = wire.collect_fleet(store)
    assert [e["id"] for e in entries] == ["3"]
    assert entries[0]["seq"] == 2 and entries[0]["phase"] == "c"
    table = wire.render_fleet_table(entries)
    assert "ROLE" in table and "trainer" in table
    reporter.close()
    assert reporter.key not in store.scan(wire.OBS_PREFIX + "/")
    assert wire.collect_fleet(store) == []
    assert wire.render_fleet_table([]).startswith("(no live fleet entries")


def test_fleet_reporter_swallows_store_errors():
    class _ExplodingStore(InProcessStore):
        def multi_set(self, items):
            raise ConnectionError("store down")

        def multi_delete(self, keys):
            raise ConnectionError("store down")

    reporter = wire.FleetReporter(_ExplodingStore(), "trainer", 0, interval_s=0)
    assert reporter.publish(force=True) is False
    reporter.close()  # reap failure is swallowed too


def test_publish_interval_scales_with_world():
    assert wire.publish_interval_for_world(1) == 0.25
    assert wire.publish_interval_for_world(1000) == 5.0
    assert (
        wire.publish_interval_for_world(64)
        <= wire.publish_interval_for_world(512)
    )


def test_fleet_endpoint_file_round_trip(tmp_path):
    wire.write_fleet_endpoint(str(tmp_path), "10.0.0.7", 29400)
    assert wire.read_fleet_endpoint(str(tmp_path)) == ("10.0.0.7", 29400)


def test_render_fleet_table_flags_stragglers_and_stale():
    entries = [
        {"role": "trainer", "id": "0", "seq": 9, "age_s": 1.0, "wire": {}},
        {"role": "trainer", "id": "1", "seq": 9, "age_s": 1.0, "wire": {}},
        {"role": "trainer", "id": "2", "seq": 3, "age_s": 9.0, "wire": {}},
    ]
    table = wire.render_fleet_table(entries)
    row = [line for line in table.splitlines() if line.startswith("trainer  2")]
    assert row and "straggler" in row[0] and "stale" in row[0]


# ---------------------------------------------------------------------------
# Fleet doctor rules
# ---------------------------------------------------------------------------


def _entry(ident, wire_summary):
    return {"role": "trainer", "id": str(ident), "seq": 1, "wire": wire_summary}


def test_wire_hot_endpoint_rule_flags_byte_skew():
    hot = _entry(
        0,
        {
            "endpoints": {
                "peer-7": {"bytes": 8 * 1024 * 1024},
                "peer-1": {"bytes": 40_000},
                "peer-2": {"bytes": 40_000},
                "peer-3": {"bytes": 40_000},
                "peer-4": {"bytes": 40_000},
                "peer-5": {"bytes": 40_000},
            }
        },
    )
    verdicts = doctor.diagnose_fleet([hot])
    hits = [v for v in verdicts if v.rule == names.RULE_WIRE_HOT_ENDPOINT]
    assert len(hits) == 1
    assert hits[0].evidence["endpoint"] == "peer-7"
    # Balanced traffic stays quiet.
    balanced = _entry(
        0,
        {
            "endpoints": {
                f"peer-{i}": {"bytes": 2 * 1024 * 1024} for i in range(6)
            }
        },
    )
    assert not [
        v
        for v in doctor.diagnose_fleet([balanced])
        if v.rule == names.RULE_WIRE_HOT_ENDPOINT
    ]


def test_store_hot_shard_rule_flags_request_skew():
    skewed = _entry(
        0,
        {"store_shards": {"0": 2000.0, "1": 10.0, "2": 10.0, "3": 10.0, "4": 10.0}},
    )
    verdicts = doctor.diagnose_fleet([skewed])
    hits = [v for v in verdicts if v.rule == names.RULE_STORE_HOT_SHARD]
    assert len(hits) == 1
    assert hits[0].evidence["shard"] == "0"
    # Low-volume or balanced shard maps stay quiet.
    quiet = _entry(0, {"store_shards": {"0": 30.0, "1": 28.0}})
    assert not [
        v
        for v in doctor.diagnose_fleet([quiet])
        if v.rule == names.RULE_STORE_HOT_SHARD
    ]


def test_wire_dial_stalled_rule_reads_fleet_entries():
    stalled = _entry(
        0,
        {"dials_s": [0.01, 1.02, 0.99, 2.03, 0.02], "dial_p95_s": 2.03},
    )
    verdicts = doctor.diagnose_fleet([stalled])
    hits = [v for v in verdicts if v.rule == names.RULE_WIRE_DIAL_STALLED]
    assert len(hits) == 1
    assert hits[0].severity == "critical"
    assert hits[0].source == "trainer/0"
    # Slow but smeared (no whole-second clustering) stays quiet: slow
    # storage is not the backlog signature.
    smeared = _entry(1, {"dials_s": [0.6, 0.7, 1.4, 1.6]})
    assert not [
        v
        for v in doctor.diagnose_fleet([smeared])
        if v.rule == names.RULE_WIRE_DIAL_STALLED
    ]


# ---------------------------------------------------------------------------
# Acceptance: a clamped listen backlog produces the stall signature
# ---------------------------------------------------------------------------


def _dial_burst(monkeypatch, backlog, dials=12, accept_delay_s=0.8):
    """Burst-dial a peer server whose accept loop starts late: with the
    backlog clamped to 5 the excess SYNs ride kernel retransmits and
    the dials quantize at whole seconds; with the default 128 the
    backlog absorbs the whole burst and every dial is fast."""
    monkeypatch.setattr(peer._PeerServer, "request_queue_size", backlog)
    cache = peer.PeerCache(budget=PeerCacheBudget(1 << 20))
    server = peer._PeerServer(("127.0.0.1", 0), cache)
    port = server.server_address[1]
    wire.reset_recent_dials()
    clients = [
        peer.PeerClient("127.0.0.1", port, timeout=15) for _ in range(dials)
    ]

    def dial(client):
        try:
            client._connect()
        except OSError:
            pass

    threads = [
        threading.Thread(target=dial, args=(c,), daemon=True) for c in clients
    ]
    try:
        for t in threads:
            t.start()
        time.sleep(accept_delay_s)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        for t in threads:
            t.join(timeout=20)
    finally:
        for c in clients:
            c.close()
        server.shutdown()
        server.server_close()
    return wire.recent_dial_seconds("peer")


def test_wire_dial_stalled_fires_on_clamped_backlog_only(monkeypatch):
    """The listen-backlog fault end to end: backlog 5 -> dropped SYNs ->
    whole-second dial quanta -> ``wire-dial-stalled`` fires from the
    fleet plane; the default backlog of 128 stays quiet."""
    dials = _dial_burst(monkeypatch, backlog=5)
    assert len(dials) >= 8  # most dials eventually succeeded
    entry = wire.decode_fleet_entry(
        wire.encode_fleet_entry(wire.fleet_snapshot("trainer", 0, 1))
    )
    verdicts = doctor.diagnose_fleet([entry])
    hits = [v for v in verdicts if v.rule == names.RULE_WIRE_DIAL_STALLED]
    assert hits and hits[0].severity == "critical"

    dials = _dial_burst(monkeypatch, backlog=128)
    assert len(dials) >= 8
    entry = wire.decode_fleet_entry(
        wire.encode_fleet_entry(wire.fleet_snapshot("trainer", 0, 2))
    )
    assert not [
        v
        for v in doctor.diagnose_fleet([entry])
        if v.rule == names.RULE_WIRE_DIAL_STALLED
    ]
