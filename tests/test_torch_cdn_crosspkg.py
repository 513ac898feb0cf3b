"""The CDN across the two packages, on numpy-seeded states, byte for byte:
an announce encoded by one package decodes the same in the other; a step
one package's manager publishes is synced, verified and assembled by the
other package's subscriber over one TCP store; a mixed fleet pulls chunks
from the other package's peer servers; and the same state saved by both
managers on chunk-store roots announces the same chunk set."""

import threading

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu.cdn as jcdn
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu.dist_store import TCPStore as JaxTCPStore
from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, TensorTreeState, knobs
from torchsnapshot_tpu_torch import cdn as pcdn
from torchsnapshot_tpu_torch.cas import key_of_location
from torchsnapshot_tpu_torch.dist_store import TCPStore

PKGS = {"jax": jcdn, "port": pcdn}


def _leaves(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((64, 48)).astype(np.float32),
        "b": rng.integers(-(2**31), 2**31 - 1, size=(300,), dtype=np.int64).astype(np.int32),
        "s": rng.standard_normal((5,)).astype(np.float64),
    }


def _app_state(pkg: str, leaves: dict) -> dict:
    if pkg == "jax":
        return {"m": jts.PyTreeState({k: v.copy() for k, v in leaves.items()})}
    return {"m": TensorTreeState({k: torch.from_numpy(v.copy()) for k, v in leaves.items()})}


def _manager(pkg: str, root: str, store, **kw):
    cls = jts.CheckpointManager if pkg == "jax" else CheckpointManager
    return cls(root, cdn_topic="run", cdn_store=store, **kw)


def _stores(server_pkg: str):
    """A TCP store server of one package and a client of each package."""
    server = (JaxTCPStore if server_pkg == "jax" else TCPStore)("127.0.0.1", 0, is_server=True)
    return server, {
        "jax": JaxTCPStore("127.0.0.1", server.port, is_server=False),
        "port": TCPStore("127.0.0.1", server.port, is_server=False),
    }


def _manifest_assembler(pkg: str, step_path: str, names):
    """The serving side's assembler: each leaf cut out of its chunk by the
    manifest entry's location and byte range, read with the subscriber's
    own package. Host arrays: numpy for the JAX swapper, torch for the
    port's."""
    snap = (jts.Snapshot if pkg == "jax" else Snapshot)(step_path)
    manifest = snap.metadata.manifest

    def assemble(ann, chunk_bytes):
        out = {}
        for name in names:
            entry = manifest[f"0/m/{name}"]
            key = key_of_location(entry.location)
            assert key in ann.chunks, (name, entry.location)
            data = chunk_bytes[key]
            if entry.byte_range is not None:
                data = data[entry.byte_range[0] : entry.byte_range[1]]
            arr = np.frombuffer(data, dtype=np.dtype(entry.dtype)).reshape(entry.shape).copy()
            out[name] = arr if pkg == "jax" else torch.from_numpy(arr)
        return out

    return assemble


@pytest.mark.parametrize("encoder", ["jax", "port"])
def test_announce_decodes_the_same_in_both_packages(encoder):
    decoder = "port" if encoder == "jax" else "jax"
    enc, dec = PKGS[encoder], PKGS[decoder]
    chunks = {"cas-crc32c-200-0badf00d": 512, "cas-crc32c-10-12345678-p0000abcd": 16}
    assert enc.manifest_digest(7, chunks) == dec.manifest_digest(7, chunks)
    fields = dict(
        topic="run", seq=3, step=7, digest=enc.manifest_digest(7, chunks), chunks=chunks,
        published_ts=1700000000.25, publisher="rank0@/ckpt",
    )
    raw = enc.Announce(**fields).encode()
    assert raw == dec.Announce(**fields).encode()
    got = dec.Announce.decode(raw)
    assert got is not None and got.encode() == raw and got.bytes_in_step == 528
    damaged = raw.replace(b'"seq": 3', b'"seq": 4').replace(b'"step": 7', b'"step": 8')
    assert enc.Announce.decode(damaged) is None and dec.Announce.decode(damaged) is None


@pytest.mark.parametrize("publisher", ["jax", "port"])
def test_published_step_is_synced_and_assembled_by_the_other_package(tmp_path, publisher):
    """One package's manager publishes two committed steps over a TCP
    store of its own package; the other package's subscriber, on a client
    of its own, syncs each (durable reads verified against the keys),
    assembles it from the manifest and swaps it in, byte for byte."""
    subscriber = "port" if publisher == "jax" else "jax"
    root = str(tmp_path / "ckpt")
    server, clients = _stores(publisher)
    steps = {1: _leaves(1), 2: _leaves(1)}
    steps[2]["w"] = steps[2]["w"] + 1.0  # step 2 changes one leaf
    with knobs.enable_cas(), knobs.enable_cdn():
        mgr = _manager(publisher, root, clients[publisher])
        sub_mod = PKGS[subscriber]
        template = {k: np.zeros_like(v) for k, v in _leaves(99).items()}
        if subscriber == "port":
            template = {k: torch.from_numpy(v) for k, v in template.items()}
        sub = sub_mod.CdnSubscriber(clients[subscriber], "run", 0, 1, durable_fetch=sub_mod.durable_chunk_reader(root))
        try:
            for step, leaves in steps.items():
                mgr.save(step, _app_state(publisher, leaves))
                ann = sub.wait_for_update(timeout=10.0)
                assert ann is not None and ann.step == step and ann.seq == step
                step_path = f"{root}/step_{step:010d}"
                swapper = sub_mod.WeightSwapper(template, assemble=_manifest_assembler(subscriber, step_path, sorted(leaves)))
                sub.apply(ann, swapper)
                for name, want in leaves.items():
                    got = swapper.weights[name]
                    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
                    assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (step, name)
            # Step 2 pulled only the changed leaf's chunk.
            assert sub.stats.chunks_held >= 1
        finally:
            sub.close()


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_mixed_fleet_pulls_from_the_other_packages_peer_server(server_pkg):
    """A fleet of two, one subscriber of each package, over one TCP store:
    each chunk leaves durable storage once (its owner), and each member
    pulls the other's chunks from the other package's peer server."""
    from torchsnapshot_tpu_torch.cas import digest_key
    from torchsnapshot_tpu_torch.integrity import compute_checksum_entry

    rng = np.random.default_rng(5)
    blobs = {}
    for _ in range(6):
        data = rng.integers(0, 256, size=int(rng.integers(100, 5000)), dtype=np.uint8).tobytes()
        blobs[digest_key(compute_checksum_entry(memoryview(data)))] = data
    reads = []
    lock = threading.Lock()

    def durable_fetch(key):
        with lock:
            reads.append(key)
        return blobs[key]

    server, clients = _stores(server_pkg)
    with knobs.override_cdn_pull_timeout_seconds(20), jknobs.override_cdn_pull_timeout_seconds(20):
        subs = [
            pcdn.CdnSubscriber(clients["port"], "mix", 0, 2, durable_fetch=durable_fetch),
            jcdn.CdnSubscriber(clients["jax"], "mix", 1, 2, durable_fetch=durable_fetch),
        ]
        try:
            pcdn.CdnPublisher(clients["port"], "mix").publish(1, {k: len(v) for k, v in blobs.items()})
            results = {}

            def run(i, sub):
                results[i] = sub.sync(sub.wait_for_update(timeout=10.0))

            threads = [threading.Thread(target=run, args=(i, s)) for i, s in enumerate(subs)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60.0)
            assert not any(t.is_alive() for t in threads)
            assert sorted(reads) == sorted(blobs)  # each chunk read once
            for i, sub in enumerate(subs):
                assert results[i] == blobs
                assert sub.stats.chunks_from_peer > 0 and sub.stats.peer_fallbacks == 0
                assert sub.stats.chunks_from_peer + sub.stats.chunks_from_durable == len(blobs)
        finally:
            for s in subs:
                s.close()


def test_same_state_announces_the_same_chunk_set_from_both_managers(tmp_path):
    """The same numpy-seeded state, saved by each package's manager on a
    chunk-store root of its own, is announced with the same chunk set."""
    leaves = _leaves(7)
    announced = {}
    with knobs.enable_cas(), knobs.enable_cdn():
        for pkg in ("jax", "port"):
            store = jts.dist_store.InProcessStore() if pkg == "jax" else _port_store()
            mgr = _manager(pkg, str(tmp_path / pkg), store)
            mgr.save(3, _app_state(pkg, leaves))
            ann = PKGS[pkg].read_announce(store, "run", 1)
            assert ann is not None and ann.step == 3
            announced[pkg] = ann
    assert announced["jax"].chunks == announced["port"].chunks
    assert len(announced["port"].chunks) >= len(leaves)
    assert announced["jax"].digest == announced["port"].digest


def _port_store():
    from torchsnapshot_tpu_torch.dist_store import InProcessStore

    return InProcessStore()


def test_port_cdn_posts_no_run_ledger_events(tmp_path):
    """Parity of the CDN's ledger events (the name dates from before the
    port had a run ledger): under a root whose run a manager opened, each
    package's publisher posts ``cdn-published`` and its subscriber
    ``cdn-swapped`` (``torchsnapshot_tpu/cdn/publisher.py:156``,
    ``subscriber.py:366``), with the same fields; under a root with no
    ledger neither writes anything."""
    from torchsnapshot_tpu.cas import digest_key as jax_digest_key
    from torchsnapshot_tpu.integrity import compute_checksum_entry as jax_checksum
    from torchsnapshot_tpu.telemetry import ledger as jax_ledger
    from torchsnapshot_tpu_torch.telemetry import ledger as port_ledger

    data = b"\x01" * 64
    key = jax_digest_key(jax_checksum(memoryview(data)))
    seen = {}
    for pkg in ("jax", "port"):
        cdn, ledger_mod = (jcdn, jax_ledger) if pkg == "jax" else (pcdn, port_ledger)
        store = jts.dist_store.InProcessStore() if pkg == "jax" else _port_store()
        root = tmp_path / pkg
        bare = tmp_path / f"{pkg}-bare"
        root.mkdir()
        bare.mkdir()
        with knobs.enable_ledger():
            assert ledger_mod.open_run(str(root)) is not None
            for where, topic in ((root, "t"), (bare, "u")):
                pub = cdn.CdnPublisher(store, topic, root=str(where))
                sub = cdn.CdnSubscriber(
                    store, topic, 0, 1, durable_fetch={key: data}.__getitem__, root=str(where)
                )
                try:
                    assert pub.publish(1, {key: len(data)}) is not None
                    assert sub.track_once(timeout=5.0) is not None
                finally:
                    sub.close()
            records = ledger_mod.load_ledger(str(root / ".ledger.jsonl"))
        ledger_mod.reset_owned_roots()
        assert list(bare.iterdir()) == []
        seen[pkg] = [
            (r["event"], sorted(r)) for r in records if r["event"] != "run-start"
        ], {r["event"]: r for r in records}
    assert seen["port"][0] == seen["jax"][0]
    assert [e for e, _ in seen["port"][0]] == ["cdn-published", "cdn-swapped"]
    for event, fields in (("cdn-published", ("topic", "seq", "step", "chunks", "bytes_in_step")),
                          ("cdn-swapped", ("topic", "seq", "step", "subscriber", "bytes_on_wire"))):
        for f in fields:
            assert seen["port"][1][event][f] == seen["jax"][1][event][f], (event, f)