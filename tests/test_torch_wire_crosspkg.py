"""The wire observatory across the two packages, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX
package's ``telemetry/wire.py`` and the port's: the frame header, the
fleet entries and the rendered fleet table are byte for byte the same;
each decoder reads the other's intact, torn, crc-damaged and
version-skewed frames alike; each package's store and peer servers see
the other's propagated context; the fleet doctor rules give the same
verdicts; and the two scale-model harnesses count the same store
requests where the JAX tests pin a count. Nothing here is floating
point: every comparison is exact. Every socket wait has its own timeout.
"""

import struct
import threading
import time
import zlib

import numpy as np
import pytest

from torchsnapshot_tpu import dist_store as jdist
from torchsnapshot_tpu import scalemodel as jscale
from torchsnapshot_tpu import telemetry as jtel
from torchsnapshot_tpu.scheduler import PeerCacheBudget as JaxBudget
from torchsnapshot_tpu.telemetry import doctor as jdoctor
from torchsnapshot_tpu.telemetry import wire as jwire
from torchsnapshot_tpu.tiered import peer as jpeer
from torchsnapshot_tpu_torch import dist_store as pdist
from torchsnapshot_tpu_torch import scalemodel as pscale
from torchsnapshot_tpu_torch import telemetry as ptel
from torchsnapshot_tpu_torch.scheduler import PeerCacheBudget
from torchsnapshot_tpu_torch.telemetry import doctor as pdoctor
from torchsnapshot_tpu_torch.telemetry import names
from torchsnapshot_tpu_torch.telemetry import wire as pwire
from torchsnapshot_tpu_torch.telemetry.registry import series_key
from torchsnapshot_tpu_torch.tiered import peer as ppeer

WIRES = {"jax": jwire, "port": pwire}
TELS = {"jax": jtel, "port": ptel}
RPC_IDS = sorted(v for k, v in vars(names).items() if k.startswith("RPC_") and isinstance(v, str))
SOCKET_TIMEOUT_S = 5.0


@pytest.fixture(autouse=True)
def _fresh():
    def reset():
        for tel in TELS.values():
            tel.reset_metrics()
            tel.reset_trace()
        for w in WIRES.values():
            w.reset_recent_dials()
            w.set_received_context(None)

    reset()
    yield
    reset()


def _context(seed, op):
    rng = np.random.default_rng(seed)
    return rng.bytes(8).hex(), rng.bytes(8).hex(), op


def _frames(seed):
    """One context and body per seed, and the degraded shapes of its frame."""
    rng = np.random.default_rng(seed)
    trace_id, span_id, op = _context(seed, RPC_IDS[seed % len(RPC_IDS)])
    body = rng.bytes(int(rng.integers(1, 200)))
    return trace_id, span_id, op, body


def _damage(framed, shape):
    hl = pwire.HEADER_LEN
    if shape == "intact":
        return framed
    if shape == "torn":
        return framed[: hl - 1]
    if shape == "crc":
        out = bytearray(framed)
        out[10] ^= 0xFF
        return bytes(out)
    out = bytearray(framed)  # "version": a future version with a valid crc
    out[4] = 99
    out[hl - 4 : hl] = struct.pack("<I", zlib.crc32(bytes(out[: hl - 4])))
    return bytes(out)


def _degraded(pkg, reason):
    return TELS[pkg].metrics().counters_snapshot().get(
        series_key(names.WIRE_CONTEXT_DEGRADED_TOTAL, {"reason": reason}), 0.0
    )


@pytest.mark.parametrize("seed", range(4))
def test_both_encoders_give_identical_header_bytes(seed):
    trace_id, span_id, op, body = _frames(seed)
    for op_id in RPC_IDS:
        jframed = jwire.encode_frame(jwire.WireContext(trace_id, span_id, op_id), body)
        pframed = pwire.encode_frame(pwire.WireContext(trace_id, span_id, op_id), body)
        assert pframed == jframed
        assert pframed[: pwire.HEADER_LEN] == jframed[: jwire.HEADER_LEN]
    assert pwire.HEADER_LEN == jwire.HEADER_LEN == 50


@pytest.mark.parametrize("shape", ["intact", "torn", "crc", "version"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_decoder_reads_the_others_frames_alike(writer, shape):
    reader = "port" if writer == "jax" else "jax"
    trace_id, span_id, op, body = _frames(7)
    framed = WIRES[writer].encode_frame(WIRES[writer].WireContext(trace_id, span_id, op), body)
    payload = _damage(framed, shape)
    results = {}
    for pkg in (writer, reader):
        ctx, got = WIRES[pkg].decode_frame(payload)
        results[pkg] = (None if ctx is None else (ctx.trace_id, ctx.span_id, ctx.op), got)
    assert results[reader] == results[writer]
    if shape == "intact":
        assert results[reader] == ((trace_id, span_id, op), body)
    else:
        expect_body = payload if shape == "torn" else body
        assert results[reader] == (None, expect_body)
        assert _degraded(reader, shape) == _degraded(writer, shape) == 1.0


def _record_received(monkeypatch, mod):
    """The contexts a package's server-side ``recv_frame`` hands its
    handlers (captured at ``wire.set_received_context``)."""
    seen = []
    original = mod.set_received_context

    def record(ctx):
        if ctx is not None:
            seen.append((ctx.trace_id, ctx.span_id, ctx.op))
        original(ctx)

    monkeypatch.setattr(mod, "set_received_context", record)
    return seen


@pytest.mark.parametrize("client_pkg", ["jax", "port"])
def test_store_server_sees_the_other_packages_context(monkeypatch, client_pkg):
    """A store client of one package inside ``propagate`` sets and reads
    keys on the other package's ``TCPStore`` server (a prefix scan
    included); the server's handler receives the sender's trace id and
    span id with the op."""
    server_mod, client_mod = (pdist, jdist) if client_pkg == "jax" else (jdist, pdist)
    server_wire = pwire if client_pkg == "jax" else jwire
    client_wire = WIRES[client_pkg]
    seen = _record_received(monkeypatch, server_wire)
    server = server_mod.TCPStore("127.0.0.1", 0, is_server=True)
    client = client_mod.TCPStore("127.0.0.1", server.port, is_server=False, connect_timeout=SOCKET_TIMEOUT_S)
    try:
        with client_wire.propagate(names.RPC_CDN_SYNC) as ctx:
            client.set("__obs/a", b"1")
            assert client.try_get("__obs/a") == b"1"
            assert client.scan("__obs/") == ["__obs/a"]
        client.set("plain", b"2")  # outside the block: no header
    finally:
        client.close()
        server.close()
    assert len(seen) == 3
    assert {(t, s, o) for t, s, o in seen} == {(ctx.trace_id, ctx.span_id, names.RPC_CDN_SYNC)}


def _serve_peer(mod, budget):
    server = mod._PeerServer(("127.0.0.1", 0), mod.PeerCache(budget=budget(1 << 20)))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


@pytest.mark.parametrize("client_pkg", ["jax", "port"])
def test_peer_handler_links_to_the_other_packages_client(client_pkg):
    """A peer client of one package, inside a CDN sync's ``propagate``,
    pulls from the other package's peer server: the server's
    ``wire:handler`` span carries the sync's trace id and, as parent, the
    span id of the client's ``wire:rpc`` span."""
    server_pkg = "port" if client_pkg == "jax" else "jax"
    server_mod, budget = (ppeer, PeerCacheBudget) if server_pkg == "port" else (jpeer, JaxBudget)
    client_mod = jpeer if client_pkg == "jax" else ppeer
    server = _serve_peer(server_mod, budget)
    client_rec = TELS[client_pkg].trace.get_recorder()
    server_rec = TELS[server_pkg].trace.get_recorder()
    cmark, smark = client_rec.mark(), server_rec.mark()
    try:
        client = client_mod.PeerClient("127.0.0.1", server.server_address[1], timeout=SOCKET_TIMEOUT_S)
        with WIRES[client_pkg].propagate(names.RPC_CDN_SYNC) as sync:
            assert client.ping()
            assert client.pull("s", "missing") is None
        client.close()
    finally:
        server.shutdown()
        server.server_close()
    rpcs = [e for e in client_rec.events_since(cmark) if e["name"] == names.SPAN_WIRE_RPC]
    handlers = [e for e in server_rec.events_since(smark) if e["name"] == names.SPAN_WIRE_HANDLER]
    assert [e["args"]["op"] for e in rpcs] == [names.RPC_PEER_PING, names.RPC_PEER_PULL]
    assert [e["args"]["op"] for e in handlers] == [names.RPC_PEER_PING, names.RPC_PEER_PULL]
    for rpc, handler in zip(rpcs, handlers):
        assert rpc["args"]["trace_id"] == handler["args"]["trace_id"] == sync.trace_id
        assert handler["args"]["parent_span_id"] == rpc["args"]["span_id"]


def _snapshots(seed, now):
    rng = np.random.default_rng(seed)
    out = []
    for i, role in enumerate(["publisher", "subscriber", "subscriber", "rank", "subscriber"]):
        endpoints = {
            ep: {"frames": float(rng.integers(1, 500)), "bytes": float(rng.integers(1, 1 << 24))}
            for ep in ("store", "peer")[: 1 + i % 2]
        }
        snap = {
            "v": 1,
            "role": role,
            "id": str(i),
            "seq": int(rng.integers(1, 6)),
            "t": now - float(rng.integers(0, 8)),
            "wire": {
                "endpoints": endpoints,
                "dial_p50_s": 0.001,
                "dial_p95_s": round(float(rng.integers(1, 3000)) / 1000.0, 3),
                "dials_s": [round(float(x) / 1000.0, 3) for x in rng.integers(1, 3000, size=4)],
            },
        }
        if i % 2:
            snap["phase"] = f"serving:{i}"
            snap["written_bytes"] = int(rng.integers(0, 1 << 20))
            snap["extra"] = {"seq": i, "slo_burn": round(float(rng.integers(0, 300)) / 100.0, 2)}
        out.append(snap)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_fleet_entries_and_table_are_the_same_in_both_packages(seed):
    now = 1.7e9
    for snap in _snapshots(seed, now):
        raw = pwire.encode_fleet_entry(snap)
        assert raw == jwire.encode_fleet_entry(snap)
        assert len(raw) - 9 <= pwire.SNAPSHOT_MAX_BYTES
        assert pwire.decode_fleet_entry(raw, now=now) == jwire.decode_fleet_entry(raw, now=now)
        assert pwire.decode_fleet_entry(raw[:-3], now=now) is None
        assert jwire.decode_fleet_entry(raw[:-3], now=now) is None
    entries = [pwire.decode_fleet_entry(pwire.encode_fleet_entry(s), now=now) for s in _snapshots(seed, now)]
    assert pwire.render_fleet_table(entries) == jwire.render_fleet_table(entries)
    assert pwire.render_fleet_table([]) == jwire.render_fleet_table([])


def test_oversized_fleet_entry_sheds_alike():
    snap = {"v": 1, "role": "rank", "id": "0", "seq": 1, "t": 1.7e9, "wire": {"x": "y" * 5000}, "extra": {"b": "z"}}
    assert pwire.encode_fleet_entry(snap) == jwire.encode_fleet_entry(snap)


def _observe(w, tel):
    w.observe_frame("peer", "send", 100)
    w.observe_frame("store", "recv", 61)
    w.observe_rpc("peer", names.RPC_PEER_PULL, 0.25)
    w.observe_dial("peer", 1.01)
    w.observe_dial("store", 0.0, ok=False)
    tel.metrics().counter_inc(names.COORD_STORE_SHARD_REQUESTS_TOTAL, 7, shard="1")


def test_local_wire_summary_is_the_same_for_the_same_observations():
    for pkg in ("jax", "port"):
        _observe(WIRES[pkg], TELS[pkg])
    assert pwire.local_wire_summary() == jwire.local_wire_summary()


def _fleet_cases():
    hot = {"endpoints": {f"peer-{i}": {"bytes": 40_000.0} for i in range(5)}}
    hot["endpoints"]["peer-7"] = {"bytes": float(8 << 20)}
    return {
        "healthy": [{"role": "rank", "id": "0", "seq": 1, "wire": {"dials_s": [0.01, 0.02]}}],
        "hot-endpoint": [{"role": "rank", "id": "0", "seq": 1, "wire": hot}],
        "hot-shard": [
            {"role": "rank", "id": str(i), "seq": 1, "wire": {"store_shards": {"0": 1000.0, "1": 5.0, "2": 5.0, "3": 5.0, "4": 5.0}}}
            for i in range(2)
        ],
        "dial-stalled": [{"role": "subscriber", "id": "3", "seq": 1, "wire": {"dials_s": [1.01, 0.99, 2.02, 0.01]}}],
        "empty": [],
    }


@pytest.mark.parametrize("case", sorted(_fleet_cases()))
def test_diagnose_fleet_gives_the_same_verdicts(case):
    entries = _fleet_cases()[case]
    pv = [v.to_dict() for v in pdoctor.diagnose_fleet(entries)]
    jv = [v.to_dict() for v in jdoctor.diagnose_fleet(entries)]
    assert pv == jv
    assert bool(pv) == (case not in ("healthy", "empty"))


def test_jax_fleet_reader_renders_the_ports_live_plane():
    """Port publishers on the port's store server; the JAX package's
    ``collect_fleet`` (through its own store client and the scan command)
    reads the same entries, and both tables agree."""
    server = pdist.TCPStore("127.0.0.1", 0, is_server=True)
    reporters = [pwire.FleetReporter(server, role, i, interval_s=0) for i, role in enumerate(["publisher", "subscriber"])]
    jclient = jdist.TCPStore("127.0.0.1", server.port, is_server=False, connect_timeout=SOCKET_TIMEOUT_S)
    try:
        for r in reporters:
            assert r.publish(force=True)
        now = time.time()
        pentries = pwire.collect_fleet(server)
        jentries = jwire.collect_fleet(jclient)
        assert [(e["role"], e["id"]) for e in pentries] == [("publisher", "0"), ("subscriber", "1")]
        strip = [{k: v for k, v in e.items() if k != "age_s"} for e in pentries]
        assert strip == [{k: v for k, v in e.items() if k != "age_s"} for e in jentries]
        for e in pentries + jentries:
            e["age_s"] = round(now - e["t"], 0)
        assert pwire.render_fleet_table(pentries) == jwire.render_fleet_table(jentries)
        for r in reporters:
            r.close()
        assert jclient.scan(pwire.OBS_PREFIX + "/") == []
    finally:
        jclient.close()
        server.close()


def test_endpoint_resolution_counts_alike():
    """The JAX tests' pinned counts: one batched resolve is one
    ``multi_get``, the per-key baseline pays world requests."""
    counts = {}
    for pkg, dist, scale in (("jax", jdist, jscale), ("port", pdist, pscale)):
        inner = dist.InProcessStore()
        for rank in range(64):
            dist.publish_endpoint(inner, "svc", rank, "host", 9000 + rank)
        batched = scale.CountingStore(inner)
        assert len(dist.lookup_endpoints(batched, "svc", range(64))) == 64
        per_key = scale.CountingStore(inner)
        assert len(dist.lookup_endpoints(scale.PerKeyStore(per_key), "svc", range(64))) == 64
        counts[pkg] = (batched.counts, per_key.total_requests)
    assert counts["port"] == counts["jax"] == ({"multi_get": 1}, 64)


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "per-key"])
def test_one_rank_storm_counts_the_same_requests(batched):
    """A world-1 storm never polls, so its store traffic is exact: both
    harnesses issue the same requests, op by op."""
    results = {}
    for pkg, scale in (("jax", jscale), ("port", pscale)):
        r = scale.run_storm(scale.StormConfig(world_size=1, steps=2, batched=batched, timeout_s=30.0))
        assert r.errors == {} and r.verified_ranks == 1
        results[pkg] = (r.store_request_ops, r.hot_key_touches, r.hot_data_key)
    assert results["port"] == results["jax"]
