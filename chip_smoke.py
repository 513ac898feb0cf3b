#!/usr/bin/env python3
"""Smoke run of torchsnapshot_tpu_torch on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card; without one it exits non-zero and prints no result. Phases,
each of which raises on failure (nothing is caught):

1. **kernels**: build every CUDA kernel under
   ``torchsnapshot_tpu_torch/csrc`` and hold each against its plain PyTorch
   version on the card. Flash: at the training shape and a long-sequence
   shape, in bf16 and f32, and at the tensor-core kernels' edges (a half
   tile, a chunk with s_k = 2 s_q, the fused-qkv layout; bf16 and f32 at
   d = 64 and 128; f32's split pre-pass is held bit for bit against its
   plain version). Digest: bit for
   bit against the plain version and the host digest, over every dtype the
   port serializes, odd lengths, row ranges, an unaligned tail, an empty
   tensor and a non-contiguous view; then on the train state's own chunk
   table (one launch) and on the bulk state's. Time kernel, plain version
   and the library call (none for the digest) back to back (the record's
   ms), and each kernel again behind a spin kernel: the card's time alone
   and the host's cost per wrapper call. The digest's card time is also
   split by the profiler into its main kernel and the rest (memset, table
   copy, finalize), logged with the SM clock and power while it ran, the
   host's time to build the kernel's table, and the design's reckoned
   integer instructions per lane. Pack (``csrc/device_pack.cu``): bit for
   bit against its plain version, through plain specs and through a
   ``PackLayout``, over 15 dtypes, row slices, 1-byte, odd-sized and empty
   members, a non-contiguous view (copied by the wrapper and counted), 1
   and 10,000 members, members at odd distances from alignment, a member
   over several tiles, empty members on a tile boundary and 10,000 members
   of 4,093 bytes; then timed as the others (its library call
   ``torch.cat`` of the members' uint8 views), plain specs and with a
   layout, at rank 0's largest slab of the sharded phase's batched take,
   at 10,000 members of 4 KiB and at 10,000 of 4,093 bytes. The record's
   ``ms`` is the call the batcher makes, with the slab's layout.
   The host I/O runtime (``native/ts_io.cpp``) is built here too, so the
   timed takes and restores below hold no compile.
2. **main**: the port's main path. Train the widest in-repo transformer
   (d_model 1024, 8 layers, flash attention, bf16) for a few AdamW steps,
   ``Snapshot.take`` the train state, ``Snapshot.restore`` it into a fresh
   model and optimizer built from another seed, and check that every
   tensor, the step and the RNG state came back bit for bit, that the
   evaluation logits of both agree bit for bit, and that one more training
   step gives the same loss on both. The last training step runs under
   ``torch.profiler``: the device operations that took the most time, the
   flash kernels' share of the step and the device's idle share. Then
   (a) ``async_take(record_digests=True)`` with a training step run while
   it drains, restored bit-identical to the state at the call; (b) with
   the embedding and the first half of the layers frozen, an incremental
   take against a digest-recording base: the bytes copied to the host and
   written equal the bytes of the leaves that changed, and the restore is
   bit-identical and continues with the same loss; (c) ``async_restore``
   with a forward pass before ``wait()``: the live leaves are untouched
   until then and bit-identical after. The kernels' launch counters are set
   to 0 just before the phase and read just after: the path must have
   launched every kernel.
3. **bulk**: take and restore a bulk bf16 state of (16384, 8192) blocks
   (8 GiB by default, ``--bulk-gib 20`` for the reference's 20 GB figure)
   with a bitwise check; then a digest-recording take and an incremental
   take of the unchanged state, which writes no data blob.
4. **manager**: a training job's checkpoint loop on the main configuration
   through ``CheckpointManager(keep_last_n=2, incremental=True)`` and a
   ``PreemptionSaver`` on SIGTERM: a full save at step 1; the embedding
   and layers 0-3 frozen; an ``async_save`` at step 2 with step 3's
   update run beside its drain; a sync save at step 3; SIGTERM sent to
   itself after step 4's update and the save that ``should_save(4)``
   calls for. Each incremental save copies to the host exactly the bytes
   of the chunks that changed and writes them; retention leaves steps 3
   and 4 visible, pins each dropped step that a retained step's refs
   name and deletes the other, commit marker first; a deep fsck passes
   every retained step through its refs and catches one flipped byte in
   a copy; ``restore_latest`` into a fresh state from another seed gives
   bit-identical tensors, logits and next-step loss. The loop runs with
   every record on: the run ledger, heartbeats and history at their
   defaults, ``TORCHSNAPSHOT_TPU_TELEMETRY`` and ``TORCHSNAPSHOT_TPU_TRACE``
   set, and the saver's ``ledger_root``. The ledger holds one run-start, a
   step-committed per save but the deleted step's (pruned), its
   gc-reclaimed, a visible-stall per take and the async take's
   staged-drain with the bytes each take wrote, the preemption at step 4
   and a restore-served with the bytes of step 4's blobs; the goodput
   buckets sum to the ledger's wall, which is the measured wall within 5%;
   the history holds a row per save and one for the restore; each take's
   report moved the bytes it wrote (the card's bytes plus at most 1 MiB of
   host-side leaves); every heartbeat ended done and was removed; the
   step-3 take's Chrome trace holds the take's envelope; each take's
   report carries a critical path whose segments partition its wall
   (coverage >= 0.95), logged with its dominant segment. The first loop
   also runs with diagnosis on (the stall watchdog at 60 s, the SLO engine
   and bundle capture at their defaults). The same loop then runs on new
   roots with every record and diagnosis off and both on again, and each
   save's seconds, the step beside the drain and the turn's ``slo-breach``
   events are logged in the three turns. Then the diagnosis legs, each on
   a new root: (w) one managed take whose storage write the chaos engine
   delays 3 s past a 1 s watchdog deadline: one stall, one
   ``watchdog:stall`` instant in the take's trace, one bundle, and the
   step restores bit-identical; (s) three saves with the async-visible
   budget below what the card measures: exactly one ``slo-breach``
   event, one bundle, and the doctor names ``slo-burning``; (d) ``python
   -m torchsnapshot_tpu_torch.telemetry doctor`` on that root and
   ``stats`` on a step's report log, their output logged; (t) six saves
   with ``TORCHSNAPSHOT_TPU_AUTOTUNE=1`` and staging threads pinned in the
   environment: each decision (action, tunable, from, to) and each save's
   seconds logged, every value within its tunable's bounds, the pinned
   knob never moved, ``restore_latest`` bit-identical under the last
   vector. The phase
   keeps its own launch counts, set to 0 just before its first loop: it
   must launch every kernel of the path.
5. **cas**: the main configuration's loop on the content-addressed chunk
   store (``TORCHSNAPSHOT_TPU_CAS=1``, grace window 0) through
   ``CheckpointManager(keep_last_n=2)``: step 1 a full save recording
   digests (before it, legacy and CAS takes of the same state into new
   roots, in turns, timed); the embedding
   and layers 0-3 frozen; a step and step 2, a full save recording
   digests; a step and step 3, incremental; a step and step 4, an
   ``async_save`` with ``ENABLE_BATCHING`` and ``DEVICE_PACK`` and a step
   beside its drain. Each save copies to the host what it must (all of the
   card's bytes; at step 3 the changed chunks' bytes) and writes to the
   store exactly its blobs that the store lacked, computed from the state
   itself (every blob's chunk key from its bytes); the rest is deduped;
   step 3 names only ``../chunks/`` locations; at step 4 each slab is one
   chunk, and there is one pack launch per slab of two or more card
   members. Retention reclaims the chunks only steps 1-2 named, to the
   byte, and keeps those of steps 3-4; a deep ``fsck --cas`` passes and
   catches one flipped byte in a copy of the root; a fresh manager over a
   lost journal rebuilds the pins, and ``restore_latest`` into another
   seed's state is bit-identical: tensors, logits and the loss of the step
   run beside step 4's drain. Logs each save's seconds and the store's
   bytes against the retained steps' dense bytes. Its digest and pack
   launches, counted from 0, add to the record's.
6. **ranks**: two processes on the card (rank r on card r % count),
   spawned by the package's ``run_multiprocess`` over its TCP store, each
   training the main configuration from ``--seed`` on the same tokens
   (data-parallel replicas) with per-rank state beside it (its global RNG
   and a 64 MiB tensor from ``--seed + rank``). The ranks first compare
   the digests of every train-state leaf through the store: replicas that
   differ fail the phase. Then (a) ``Snapshot.take(pg=, replicated=)``:
   each rank copies to the host and writes half the replicated bytes
   within 10%, plus its own; replicated entries sit under rank 0 and there
   is one commit marker; (b) restore on both ranks into another seed's
   state: bit-identical, and the next loss too; the world-1 snapshot that
   the parent took of the same state restores on both ranks; (c)
   ``async_take`` with a training step beside its drain, one commit,
   restored bit-identical; (d) the parent, at world size 1, restores the
   two-rank snapshot and reads rank 1's tensor with ``read_object``; (e)
   ``CheckpointManager(keep_last_n=2, incremental=True, pg=)`` and a
   ``PreemptionSaver(pg=)``: a full save, an ``async_save``, an
   incremental save with half the model frozen, then SIGTERM on rank 1
   only and one save at the agreed step on both; retention, a deep fsck
   and ``restore_latest`` on both ranks, bit-identical, and the root's run
   ledger written by rank 0 alone; (f) rank 1's writes fail: rank 0 raises
   within 30 s and no commit marker is left; (g) two managed saves with
   the autotuner on leave both ranks with the same applied vector. Take
   (a) runs with the report sink on: each rank's report is in the log
   with its critical path, and rank 0's carries the gathered spread and
   straggler of every metric, each rank's critical-path segments folded
   in; its store requests include the gather's; each rank's report
   carries a non-empty wire split (store frames, bytes and RPCs), logged
   with its store RPC seconds by op id beside the critical path's
   ``coordination`` and ``other``. Each rank must launch every kernel of
   the path. Then the storm leg, host only, in the parent:
   ``scalemodel.run_storm`` at 256 simulated ranks (threads) over the
   package's barriers, store and fan-out exchange: at step 0 every rank's
   exchanged bytes verify; at step 1 three ranks are preempted mid-round
   and every survivor abandons with ``BarrierError`` / ``FanoutError``
   within half the 60 s round timeout. Logs each structure's straggler
   seconds and the store requests by op.
7. **sharded**: two processes on the card, spawned as in the ranks phase,
   with a gloo default group (no tensor collective runs on the checkpoint
   path) and a ``cuda`` device mesh of 2. Each trains the main
   configuration from ``--seed`` and expresses the train state FSDP-style:
   every CUDA leaf a ``Shard(0)`` ``DTensor`` built by ``from_local`` of its
   rank's chunk, plus a (1001, 4096) bf16 leaf (uneven rows) and a (1,
   4096) one (rank 1's box is empty). (a) ``Snapshot.take`` with digests
   recorded and the report sink on (rank 0's report gathers both
   ranks', critical paths folded): each rank copies to the host and writes 50% +- 1% of the
   sharded bytes, the saved boxes tile every array with no hole and no
   overlap, one commit marker; (b) restore into ``DTensor``s from ``--seed
   + 1``: bit-identical local shards, in place; (c1) restore into
   ``Shard(1)`` (the tensor-parallel layout): each local shard is its
   column slice of the replica, ranged and whole shard reads counted;
   (c2) the parent, at world size 1, restores the two-rank snapshot into
   plain CUDA tensors, bit-identical to its own run of the same training,
   and one more step gives that run's loss bit for bit; (c3)
   ``read_object(path, sharding=(mesh, [Shard(1)]))`` of the uneven leaf;
   (d) the embedding and layers 0-3 frozen, one step, an incremental take:
   each rank launches the digest kernel once and copies and writes exactly
   its changed pieces' bytes, the restore is bit-identical; (e) batched
   takes with ``ENABLE_BATCHING`` and ``DEVICE_PACK`` (one pack launch per
   slab) and member by member, each through the zero-pack vectorized
   write and with ``TORCHSNAPSHOT_TPU_WRITE_VECTORIZED=0`` (staged into one
   slab buffer), in turns, each restored bit for bit: every blob and CRC
   table of the rank the same both ways, ``batcher_pack_bytes_avoided_total``
   the rank's slab bytes with the vectorized write and 0 without; (f) a
   deep fsck of (a) passes and catches one flipped byte in a copy of a
   shard blob; (g) (a)'s snapshot restored into ``Shard(1)`` with
   single-reader fan-out at its default (on), sync and async, then with
   ``TORCHSNAPSHOT_TPU_FANOUT_RESTORE=0``: each restore bit-identical; with
   fan-out every sharded blob is read from storage once across the two
   ranks (a counting plugin), without it every rank reads its own; each
   rank's seconds, coordination-store requests and seconds, and bytes
   fetched, received and published are logged. The other multi-rank
   restores of the phase run with fan-out at its default too. Each rank
   must launch ``flash_fwd``, ``flash_chunk``, ``device_digest`` and
   ``device_pack``; the record's ``device_pack`` launches are the cas
   phase's, this phase's (both ranks') and the leaves phase's.
8. **leaves**: a stress case of the state the device pack is meant for
   (states of 10^4 small leaves): 10,000 CUDA leaves from ``--seed``
   (sizes log-uniform from 256 B to 64 KiB; float32, bfloat16, int64,
   uint8 and bool in turn, the last three at odd element counts, so that
   at least a quarter of the slab's members sit at an odd distance from
   alignment). The mix is made up, not a published configuration's. Batched takes with ``ENABLE_BATCHING`` and
   ``DEVICE_PACK`` and member by member, through the zero-pack vectorized
   write and staged into one slab buffer, in turns (``LEAVES_TURNS``); the
   first four restored bit-identical into fresh leaves and three leaves
   read back with ``read_object``; pack launches equal the slabs of card
   members; every blob and CRC table the same in all six takes, and
   ``batcher_pack_bytes_avoided_total`` the slab bytes with the vectorized
   write and 0 without. Logs each take's seconds, its slabs, and the pack's share of
   it: the wrapper's host time, and its kernel's card time (CUDA events
   behind a spin kernel that holds the stream while the host queues the
   launch).
9. **tiered**: the main configuration's loop on a ``tiered://`` root whose
   fast and durable tiers are two local directories of this machine (the
   mirror's seconds are a local disk's, not an object store's), through
   ``CheckpointManager(keep_last_n=3, keep_fast_last_n=1,
   incremental=True)``: (a) a sync save, an ``async_save`` beside a
   training step, an incremental save with half the model frozen (on a
   tiered root it records digests and writes in full, in both packages),
   a batched save with ``DEVICE_PACK``, each followed by ``wait_durable``:
   every durable blob byte-identical to its fast copy, the journal
   complete with the commit marker landed last, the settled job's
   ``kind: "mirror"`` report and its ``mirror-settled`` ledger event each
   with the bytes the job shipped (the report and trace sinks on), the
   take's and the job's reports each with a critical path, and after the eviction
   pass only the newest step on the fast tier; the step's time alone,
   beside the async drain and beside the mirror; (b) the restore of an
   evicted step from the durable tier alone: bit-identical state, logits
   and next-step loss; (c) one byte flipped in each of 3 fast blobs of
   the newest step: the restore heals each from the durable tier (the
   degraded-read counter moves by 3) and is bit-identical, and the same
   flip on a plain root raises ``ChecksumError``; (d) a chaos plan fails
   the durable writes after 4 blobs; after a mirror reset a new manager's
   ``resume_mirrors()`` ships exactly the blobs the journal lacks, commit
   marker last, and the durable tier alone restores the step; (e) a chunk
   store on a tiered root: the mirror ships step 2's novel chunks, their
   bytes equal to its ``cas_bytes_written_total``; (f) the crash matrix's
   eight smoke points on tiered + CAS with CUDA states. Each leg prints
   one JSON line. Its digest and pack launches, counted from 0, add to the
   record's.
10. **peer**: the peer-RAM tier (``tiered/peer.py``) on the sharded
   phase's state: two processes on the card, a gloo default group, a
   ``cuda`` mesh of 2, the main configuration as ``Shard(0)`` DTensors
   (about 0.507 GB a rank), through ``CheckpointManager(root, pg=,
   keep_peer_last_n=1)`` on a plain root with the tier on (the default 1
   GiB cache a rank, a 5 s transfer timeout) and fan-out off (it would
   pick by a content hash which rank pulls a blob). (a) A step and a sync
   save (digests recorded), a step beside its push, a step and an
   ``async_save`` beside a step, the drain: each rank's neighbour holds
   exactly this rank's blobs of step 2, the same paths, entries and bytes
   as its checksum table, step 1 evicted; ``fsck --tier peer`` passes.
   (b) Rank 1 is preempted (its tier reset, a new manager): both ranks
   ``restore_latest`` into zeroed DTensors, rank 1 behind a plugin that
   counts data reads: it reads none from storage and takes at least 95%
   of its bytes from peer RAM; every local shard bit-identical, and the
   full state gathered from both ranks gives the evaluation logits and
   the next step's loss of the saved state, bit for bit. (c) Both caches
   wiped: the same restore from storage alone, no ``peer`` in the split.
   (d) Rank 0's server stops; both save step 3: rank 1's push degrades
   (``peer_push_failures_total`` >= 1, ``peer_tier_degraded`` 1) without
   holding its save, the drain settles within 60 s, rank 1 restores from
   storage bit-identical (rank 0 from peer RAM), and ``fsck --tier peer``
   names each of rank 1's blobs as unplaced. Each leg's ``wire:*`` spans
   of both ranks, exported per rank and merged with
   ``trace.merge_traces``, stitch at least one client -> handler pair per
   push job (a) and per restore that took bytes from peer RAM (b, d).
   Logs each rank's push seconds
   and bytes, the step alone and beside the push, restore seconds from
   peer RAM and from storage, store requests per leg, and per leg the RPC
   seconds by op id (``peer-push``, ``peer-pull``, ``store-*``) and the
   frame bytes by endpoint and direction; first, the host's microseconds
   to put the 50-byte trace header on a frame and take it off. Its digest
   launches (both ranks') add to the record's.
11. **cdn**: the checkpoint CDN (``cdn/``) on the main configuration,
   with the fleet metrics plane on (``TORCHSNAPSHOT_TPU_FLEET_OBS=1``). The
   trainer (this process) hosts the package's ``TCPStore`` and saves
   through ``CheckpointManager(root, keep_last_n=1, incremental=True,
   cdn_topic="run", cdn_store=<client>)`` with ``TORCHSNAPSHOT_TPU_CAS=1``,
   ``TORCHSNAPSHOT_TPU_CDN=1`` and the chunk GC's grace at 0: step 1 full,
   step 2 after a step with the embedding and layers 0-3 frozen, step 3
   batched with ``ENABLE_BATCHING`` and ``DEVICE_PACK``; after each save it
   writes its parameters and the evaluation logits of a fixed 1 x 1024
   token batch for the fleet. The fleet: 4 subscribers in 2 spawned
   processes on the card, each with ``durable_chunk_reader(root)`` behind a
   shim that counts reads, ``CASStore(root)`` for its lease, a 60 s pull
   timeout and a ``WeightSwapper`` over its own serving ``Transformer``'s
   CUDA parameters (the module itself moved to ``meta``). The assembler,
   the serving binary's knowledge, lives here: it cuts each parameter out
   of its chunk by the committed step's manifest entry (whole chunks, the
   dim-0 pieces of chunked entries, byte ranges of slab chunks). After each
   swap the subscriber serves ``functional_call(model, swapper.weights,
   tokens)`` through the fused flash kernel. Hard checks: at every step, on
   every subscriber, the served weights and the logits bit-identical to the
   trainer's; the fleet's durable reads equal the step's novel chunks, with
   no peer fallback; at steps 2 and 3 each subscriber's wire bytes equal
   the bytes of the chunks the previous step did not announce; subscriber
   0, armed at ``cdn-swap-staged`` at step 2, raises ``SimulatedCrash``,
   still serves step 1 bit for bit, and its next ``track_once`` applies step
   2; the publisher, armed at ``cdn-publish-announced`` at step 3, leaves
   the head unmoved (no subscriber applies the torn record), and a restarted
   publisher announces the step; after each save every chunk a live lease
   names is on disk, and a deep ``fsck --cas`` is clean with the leases
   outstanding; after the fleet closes (releasing its leases) save 4's GC
   leaves exactly step 4's chunks; during each swap the allocated memory
   rises by at most the new set's bytes plus 5%, and after it is back where
   it was; the trainer's run ledger holds a ``cdn-published`` event per
   announced step and a ``cdn-swapped`` event per subscriber per applied
   step (the subscribers post to the trainer's root). The wire
   observatory, hard checks: while the fleet serves, ``wire.collect_fleet``
   on the trainer's store returns one fresh ``__obs/`` entry for the
   publisher and one for each subscriber, each within 4096 bytes; ``python
   -m torchsnapshot_tpu_torch.telemetry fleet <host:port> --once`` (a
   subprocess) exits 0 with one row per member, and ``doctor --fleet``
   runs; after the fleet and the publisher close no ``__obs/`` key is
   left; the fleet processes' wire spans, merged, stitch every served peer
   pull to its client span, some across the two processes. Logs publish
   ms, per subscriber and step the sync s, bytes from
   peers and from durable storage, stage and swap s, staleness (publish to
   swap) and the serving forward's ms, the fleet's staleness median and
   maximum, each fleet process's wire split (frames, bytes, dials, RPC
   seconds by op id), the fleet table and the doctor's verdicts, and the
   phase's launches, which add to the record's.
12. **bridge**: the migration bridge (``tricks/``, ``lowp.py``) on the
   main configuration, trained ``STEPS`` steps from ``--seed``. (a)
   ``write_reference_snapshot`` of its model and optimizer state (the
   reference TorchSnapshot 0.0.3 format, JSON metadata) and
   ``read_reference_snapshot`` back onto the card: every leaf
   bit-identical, and the evaluation logits of a fresh model loaded from
   it equal the live model's bit for bit. (b) The same state as a
   four-rank reference snapshot (``test_utils.write_sharded_reference_snapshot``:
   2-D leaves ``ShardedTensor`` shards on dim 0, small leaves in batched
   slabs with ``byte_range``), placed by two spawned processes (a gloo
   default group, a ``cuda`` mesh of 2) with ``read_sharded`` as
   ``Shard(0)``, ``Shard(1)`` and ``Replicate()`` DTensors: each local
   bit-identical to its slice of the trained leaf; each rank's ranged and
   whole-blob reads and its peak host bytes against the state's are
   logged. (c) ``convert`` of (a)'s snapshot (read onto the card, taken
   with digests by the card), restored into a fresh state bit for bit;
   with the embedding and layers 0-3 frozen one more step gives the live
   run's loss bit for bit; an incremental take on the converted base
   copies to the host exactly the changed chunks' bytes and writes them
   (plus at most 1 MiB of CPU leaves), and a deep fsck passes; the
   convert's read and take seconds and the digest launches are logged.
   (d) Every float leaf encoded per tensor and every 2-D leaf per channel
   on axis 0 (``lowp``), on the card and on the CPU: equal bytes, and the
   card's decode equals the CPU's; each codec's encode GB/s on the card is
   logged. Its launches, counted from 0, add to the record's.
13. **moe**: the MoE configuration at full width (``benchmarks/pod/main.py
   --experts 4``: the main configuration with every second block a
   soft-routed MoE block of 4 experts; 268.5 M parameters, a 1.611 GB
   train state, half of it expert-stacked). (a) One process: ``STEPS``
   steps from ``--seed``; ``Snapshot.take`` and a restore into another
   seed's state, bit-identical, with equal evaluation logits and the next
   step's loss bit for bit; the same state taken again as a tree of
   tensors and as pp = 1 stage stacks (for legs b and c); then main's
   legs (a)-(c) (an async take beside a step, an incremental take with
   half the layers frozen that copies and writes exactly the changed
   chunks' bytes, an async restore; one digest launch each take); a
   batched take with ``ENABLE_BATCHING`` and ``DEVICE_PACK``: one pack
   launch per slab of card members, restored bit for bit, equal logits.
   (b) Expert parallel, two spawned processes on the card (a gloo default
   group, a ``cuda`` mesh of 2), each training the same replica: the take
   of the state with every expert-stacked leaf and its moments ``Shard(0)``
   over the experts (JAX's ep layout, 2 experts a rank) and the rest
   declared replicated; the saved boxes tile every expert leaf, and each
   rank writes 50% +- 1% of the expert bytes; restored under the same
   layout bit for bit; (a)'s world-1 tree restored into the layout bit for
   bit. (c) The pipeline, the same processes: the 8 blocks as 2 stages of
   4 (``parallel/pipeline.py``; embedding, final norm and unembedding on
   every rank), the stage leaves and their moments ``Shard(0)`` over
   ``pp``; (a)'s pp = 1 stacks restored into pp = 2 bit for bit; 2 AdamW
   steps through ``pipelined_apply`` with 4 microbatches (the hops'
   transport named: gloo moves a CUDA activation through the host), the
   first step's loss within ``PP_LOSS_RTOL`` of the unpipelined step's;
   a pp = 2 take (each rank 50% +- 1% of the stage bytes) restored bit for
   bit, the next pipelined step's loss equal bit for bit. Then this
   process, at world 1: the expert-parallel snapshot into plain tensors,
   bit-identical to (a)'s state, and one more step gives (a)'s next loss
   bit for bit; the pp = 2 snapshot into full stacks (each stage
   bit-identical to its rank's, by digest) and the unpipelined model built
   from them, its loss within ``PP_LOSS_RTOL`` of the pipelined one. Logs
   take and restore s and GB/s per leg, each rank's bytes, ms per step
   pipelined and not, the hops' transport, count, bytes and ms, and the
   phase's launches (its workers' included), which add to the record's.
14. **ring**: ring attention over a sequence-parallel group
   (``ops/ring_attention.py``), the main configuration at ``attn_impl=
   "ring_flash"``, two spawned processes on the card (a gloo default group,
   a ``cuda`` mesh with an ``sp`` dimension of 2: each rank 512 of the 1024
   positions; its ring hops go through the host). (a) Attention alone,
   bf16 (8, 1024, 16, 64) in the fused-qkv layout: each rank's ``ring``
   and ``ring_flash`` output block within ``FUSED_TOL`` of its block of
   the world-1 ``flash_causal_forward``, and its q, k, v gradients (a
   random cotangent) within 2^-6 relative L2 of ``_FlashCausal``'s; the
   chunk kernel on this rank's queries against every key block at or
   behind them, causal and unmasked, held against its plain version
   (``compare_with_plain``). (b) ``STEPS`` AdamW steps at sp = 2 from the
   same initial state as a world-1 ``flash`` step on a replica: the first
   step's loss within 2^-13 and every leaf's gradient within 2^-6
   (relative L2; the moe phase's limits), the parameters within 2^-3 of
   the update (``RING_FIRST_UPDATE_RTOL``: AdamW's first update is the
   sign of the gradient); beside it a control, the world-1 step with its
   gradient summed over two halves of the batch; then both ranks' states
   equal by every leaf's ``mlh64`` digest. (c) ``Snapshot.take(pg=, replicated=["train/**"])``: each rank
   writes 50% +- 10% of the replicated bytes; restored at world 2 into
   another seed's state bit for bit, and the next step's loss equals the
   live run's bit for bit. (c2) This process restores the snapshot at
   world 1 into a ``flash`` model's state: every leaf's digest equal to
   the saved state's; its next flash step is within the moe phase's
   limits (the parameters 2^-5 of the update) of the sp run's next step. The workers meet at gates between legs; a rank whose
   check fails posts its error under a key every rank polls, and the
   others stop at once (e). Logs each rank's step ms, its ring hops and
   gradient sums through the host (calls, MB, ms), the chunk kernel's
   launches by mode, the world-1 flash step's ms, and the unmasked chunk
   at a ring step's shape, bf16 (8, 512, 16, 64): ms, card ms, host us,
   plain ms, SDPA ``is_causal=False`` ms and the bound. The counts are
   set to 0 after (a) and the world-1 reference step and read at the
   workers' end: the path must launch the chunk kernel in both modes and
   the digest; its launches add to the record's, and the record's
   ``flash_chunk_unmasked`` entry carries the unmasked ones with that
   timing.
15. **dcp**: interop with ``torch.distributed.checkpoint`` (DCP;
   ``tricks/dcp.py``, ``tricks/train_state.py``) on the main
   configuration, trained ``STEPS`` steps. (a) Migration: ``dcp.save``
   with DCP's own ``FileSystemWriter``, ``migrate_dcp_to_snapshot`` (raw),
   ``Snapshot.restore`` into a fresh state: bit-identical; then
   ``migrate_snapshot_to_dcp`` into a fresh state's tensors and
   ``dcp.load`` with ``FileSystemReader`` into another: bit-identical.
   (b) Interception: ``dcp.save`` through ``SnapshotStorageWriter``
   restored by ``Snapshot.restore`` (bit-identical, a deep fsck passes);
   ``Snapshot.take`` loaded by ``dcp.load`` through
   ``SnapshotStorageReader`` (bit-identical, equal evaluation logits);
   ``dcp.async_save`` through the writer, committed and bit-identical;
   then, in turns, ``Snapshot.take``, the writer and ``FileSystemWriter``,
   and ``Snapshot.restore``, the reader and ``FileSystemReader``, each
   into a state zeroed before it and checked, their seconds logged. (c)
   Two processes on the card, set up as in the sharded phase, the train
   state's ``Shard(0)`` ``DTensor``s saved by ``dcp.save`` through the
   writer at world 2: each rank writes 50% +- 1% of the sharded bytes;
   loaded through the reader into ``Shard(1)``: every local shard its
   slice of the saved value; a failed check on one rank ends both (its
   error posted in the store, as in the ring phase). The parent restores
   that snapshot at world 1 with ``Snapshot.restore``: every leaf's digest
   equals its own run's. (d) ``TrainStateStateful(model, AdamW)`` taken
   and restored into a fresh model and optimizer. The next training step
   of the live state, of (a)'s and of (d)'s restores: the same loss and
   parameters, bit for bit. The counts are set to 0 at the phase's start:
   it must launch ``flash_fwd``, ``flash_chunk`` and ``device_digest``,
   and its launches add to the record's.

Every phase runs with the record knobs at their defaults (the run ledger,
heartbeats and history on; the report and trace sinks off) and the stall
watchdog at its default 60 s, except where a phase says otherwise. The
SLO engine, incident bundles and the autotuner are pinned off
(``TORCHSNAPSHOT_TPU_SLO``, ``..._BUNDLE_MAX_BYTES`` and ``..._AUTOTUNE``
at 0 unless set): the phases hold byte counts, ledger events and file
sets of a fixed knob geometry, and the manager and ranks phases turn each
on where they measure it. The ranks and sharded phases pin
``TORCHSNAPSHOT_TPU_PEER_TIER=0`` in their workers: their checks are of the paths without the tier (each
rank's bytes written, the file sets, which plugin reads a blob). Before
the result lines, one ``summary <phase>:`` line per phase gives its
seconds, its headline numbers and PASS (or FAIL with the error, before
the script raises), then the card's name and power limit. The
second-to-last line of stdout is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_TF32_FLOPS = 494.7e12

# The slice's configuration: the widest transformer the repo runs
# (benchmarks/pod/main.py), all 8 layers, trained for 3 steps.
N_LAYERS = 8
STEPS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


# Each phase's headline numbers, printed as one compact line per phase
# just before the result lines (the per-leg lines above them can be long).
HEADLINES: dict = {}


def _headline(phase: str, **numbers) -> None:
    HEADLINES[phase] = numbers


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    if isinstance(v, (list, tuple)):
        return "/".join(_fmt(x) for x in v)
    return str(v)


def print_summary(done: list, failed=None) -> None:
    """One line per phase run: its seconds, its headline numbers, and
    PASS, or FAIL with the error for the phase that raised."""
    for phase, seconds in done:
        nums = ", ".join(f"{k} {_fmt(v)}" for k, v in HEADLINES.get(phase, {}).items())
        log(f"summary {phase}: PASS in {seconds:.1f} s" + (f"; {nums}" if nums else ""))
    if failed is not None:
        phase, err = failed
        log(f"summary {phase}: FAIL: {err!r}"[:400])


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, from CUDA
    events around them: the card's time, or the host's where the host issues
    the calls more slowly than the card runs them. The ``ms`` the kernels'
    record reports."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ~5 ms of spin on the card: longer than the host takes to queue a timed
# run of flash wrapper calls.
HOLD_CYCLES = 10_000_000
# ~50 ms: the digest wrapper's host cost was up to 2.4 ms a call, so ten
# calls outlasted the 5 ms spin and the card's time took in the host's gaps.
DIGEST_HOLD_CYCLES = 100_000_000
# ~300 ms: the pack wrapper's host cost grows with its members (10,000).
PACK_HOLD_CYCLES = 600_000_000


def held_times(fn, iters: int = 10, warmup: int = 2, hold_cycles: int = HOLD_CYCLES) -> tuple:
    """``(device ms, host us)`` per call of ``fn``. A spin kernel holds the
    stream while the calls queue up behind it, so the events time the card's
    work alone and the host's clock times what each call costs the host
    (argument checks, allocations, the launch itself). The spin must outlast
    the host's ``iters`` calls, or the card's time includes the host's."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(hold_cycles)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_s / iters * 1e6


# ----------------------------------------------------------------------
# Phase 1: kernels against their plain versions
# ----------------------------------------------------------------------


def _qkv(shape, dtype, seed: int, fused_qkv: bool, s_k=None):
    """q, k, v on the card from a seed. With ``fused_qkv`` they are the
    strided slices of one (b, s, 3, h, d) tensor, as the model makes them;
    ``s_k`` gives k and v another length than q."""
    import torch

    b, s, h, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    if fused_qkv:
        qkv = torch.randn((b, s, 3, h, d), generator=g, device="cuda").to(dtype)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    kv_shape = (b, s if s_k is None else s_k, h, d)
    return tuple(
        torch.randn(sh, generator=g, device="cuda").to(dtype)
        for sh in (shape, kv_shape, kv_shape)
    )


def kernel_phase(seed: int) -> dict:
    """Hold both kernels against their plain versions and time them; returns
    the per-kernel record at the main path's shape (bf16, (8, 1024, 16, 64))."""
    import torch
    import torch.nn.functional as F

    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    # (q shape (b, s, h, d), s_k, dtype, fused-qkv layout, timed)
    cases = [
        ((8, 1024, 16, 64), 1024, torch.bfloat16, True, True),  # the main path's call
        ((8, 1024, 16, 64), 1024, torch.float32, False, True),
        ((2, 4096, 16, 128), 4096, torch.bfloat16, False, True),
        ((2, 4096, 16, 128), 4096, torch.float32, False, True),
        # The tensor-core kernels' edges, checked only: the fused-qkv layout
        # (bf16 d = 128, f32 d = 64 and 128), a sequence of 64 but not 128 (a
        # half tile), and a chunk whose keys outnumber its queries.
        ((2, 1024, 16, 128), 1024, torch.bfloat16, True, False),
        ((2, 192, 4, 64), 192, torch.bfloat16, False, False),
        ((2, 128, 4, 64), 256, torch.bfloat16, False, False),
        ((2, 1024, 16, 64), 1024, torch.float32, True, False),
        ((2, 192, 4, 64), 192, torch.float32, False, False),
        ((2, 128, 4, 64), 256, torch.float32, False, False),
        ((2, 1024, 16, 128), 1024, torch.float32, True, False),
        ((2, 192, 4, 128), 192, torch.float32, False, False),
        ((2, 128, 4, 128), 256, torch.float32, False, False),
    ]
    records = {}
    for shape, s_k, dtype, fused_qkv, timed in cases:
        b, s, h, d = shape
        dt = str(dtype).split(".")[1]
        q, k, v = _qkv(shape, dtype, seed, fused_qkv, s_k)
        block = 128 if s % 128 == 0 and s_k % 128 == 0 else 64
        label = f"{tuple(shape)} s_k={s_k} {dt}{' fused-qkv' if fused_qkv else ''}"
        split = dtype == torch.float32
        if split:
            _require(
                all(same_bits(a, b) for a, b in zip(fa.flash_split(q, k, v), fa.flash_split_plain(q, k, v))),
                f"the split pre-pass differs from its plain version at {label}",
            )
        errs = fa.compare_with_plain(q, k, v, block)
        tols = (
            f"(fused rtol {fa.FUSED_TOL[dtype][0]} atol {fa.FUSED_TOL[dtype][1]}; chunk o/l "
            f"atol {errs['chunk_atol']:.3e}, m and l {fa.F32_TOL})"
        )
        if not timed:
            log(
                f"kernel check {label}: max |err| "
                + ", ".join(f"{n} {e:.3e}" for n, e in errs.items() if n != "chunk_atol")
                + f" {tols}"
            )
            continue
        itemsize = q.element_size()
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

        def fwd():
            return fa.flash_causal_forward(q, k, v)

        def chunk():
            return fa.flash_attention_chunk(q, k, v, causal=True)

        library_ms = cuda_ms(sdpa)
        sdpa_device_ms, _ = held_times(sdpa)
        flops = fa.attention_flops(b, h, s, s, d, causal=True)
        op_ms = flops / PEAK_FLOPS[dt] * 1e3
        nbytes = 4 * b * s * h * d * itemsize
        nbytes_c = 3 * b * s * h * d * itemsize + 4 * b * h * s * (d + 2)
        recs = {}
        bounds = ""
        entry_bytes = {"flash_fwd": nbytes, "flash_chunk": nbytes_c}
        if split:
            # The f32 entries' bound is the function's own bytes (q, k, v
            # in, the outputs out) against three tf32 products for each f32
            # one. Logged beside it: the f32-FMA bound, and the bytes the
            # design moves (the pre-pass reads q, k, v and writes hi and lo
            # of each, 9 tensors; the main kernel reads those 6 and writes
            # its outputs).
            split_bytes = 9 * b * s * h * d * 4
            design_bytes = {
                name: split_bytes + 3 * b * s * h * d * 4 + n for name, n in entry_bytes.items()
            }
            fma_ms, op_ms = op_ms, 3 * flops / PEAK_TF32_FLOPS * 1e3
            bounds = (
                f"; f32-FMA bound {fma_ms:.4f} ms, 3xTF32 operation bound {op_ms:.4f} ms, "
                f"the function's own bytes {entry_bytes['flash_chunk'] / HBM_BYTES_PER_S * 1e3:.4f} ms "
                f"(chunk), {entry_bytes['flash_fwd'] / HBM_BYTES_PER_S * 1e3:.4f} ms (fused), "
                f"bytes of pre-pass + main kernel "
                f"{design_bytes['flash_chunk'] / HBM_BYTES_PER_S * 1e3:.4f} ms (chunk), "
                f"{design_bytes['flash_fwd'] / HBM_BYTES_PER_S * 1e3:.4f} ms (fused)"
            )

            def split_fn():
                return fa.flash_split(q, k, v)

            rec = recs["flash_split"] = {
                "ms": cuda_ms(split_fn),
                "plain_ms": cuda_ms(lambda: fa.flash_split_plain(q, k, v), iters=3),
                "library_ms": None,
                "bound_ms": split_bytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
                "max_abs_err": 0.0,  # bit for bit, checked above
            }
            device_ms, host_us = held_times(split_fn)
            log(
                f"kernel flash_split {label}: {rec['ms']:.4f} ms back to back, "
                f"{split_bytes / rec['ms'] / 1e9:.1f} TB/s; device {device_ms:.4f} ms, host "
                f"{host_us:.1f} us per call (plain {rec['plain_ms']:.4f} ms; no library call; "
                f"bound {rec['bound_ms']:.4f} ms by bytes); bit-identical to the plain version"
            )
        for name, fn, plain, err in (
            ("flash_fwd", fwd, lambda: fa.flash_causal_forward_plain(q, k, v), errs["flash_fwd"]),
            ("flash_chunk", chunk, lambda: fa.flash_attention_chunk_plain(q, k, v, causal=True),
             errs["flash_chunk_causal"]),
        ):
            bytes_ms = entry_bytes[name] / HBM_BYTES_PER_S * 1e3
            rec = recs[name] = {
                "ms": cuda_ms(fn),
                "plain_ms": cuda_ms(plain, iters=3),
                "library_ms": library_ms,
                "bound_ms": max(bytes_ms, op_ms),
                "bound_by": "bytes" if bytes_ms > op_ms else "operations",
                "max_abs_err": err,
            }
            device_ms, host_us = held_times(fn)
            log(
                f"kernel {name} {label}: {rec['ms']:.4f} ms back to back, "
                f"{flops / rec['ms'] / 1e9:.1f} TFLOP/s; device {device_ms:.4f} ms, host "
                f"{host_us:.1f} us per call (plain {rec['plain_ms']:.4f} ms, SDPA "
                f"{rec['library_ms']:.4f} ms, device {sdpa_device_ms:.4f} ms; bound "
                f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}), max |err| "
                f"{rec['max_abs_err']:.3e} {tols}{bounds}"
            )
        if (shape, dtype) == ((8, 1024, 16, 64), torch.bfloat16):
            records.update(recs)
        elif "flash_split" in recs:  # the record keeps the first, at d = 64
            records.setdefault("flash_split", recs["flash_split"])
        del qh, kh, vh
    del q, k, v
    torch.cuda.empty_cache()

    # Gradients through the autograd Function against the dense op, f32,
    # small: the backward is plain torch, the forward the chunk kernel.
    q, k, v = (t.detach().requires_grad_() for t in _qkv((2, 256, 4, 64), torch.float32, seed, False))
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fa.flash_causal_attention(q, k, v).square().sum().backward()
    from torchsnapshot_tpu_torch.ops import causal_attention

    causal_attention(q2, k2, v2).square().sum().backward()
    for a, bb in ((q, q2), (k, k2), (v, v2)):
        torch.testing.assert_close(a.grad, bb.grad, rtol=1e-4, atol=1e-4)
    log("kernel flash_chunk: autograd gradients match the dense op (tol 1e-4)")
    return records


def _digest_case_specs(seed: int) -> list:
    """(label, specs) of the digest kernel's checks: every dtype the port
    serializes and the digest takes; odd row counts and row bytes, row
    ranges at unaligned starts, a tail shorter than one 16-byte load, an
    empty tensor, a non-contiguous view."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dtypes = [
        torch.float32, torch.bfloat16, torch.float16, torch.float64, torch.int64,
        torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool,
        torch.float8_e4m3fn,
    ]
    cases = []
    for dtype in dtypes:
        def make(*shape, dtype=dtype):
            if dtype == torch.bool:
                return torch.rand(shape, generator=g, device="cuda") > 0.5
            if dtype.is_floating_point:
                return (100 * torch.randn(shape, generator=g, device="cuda")).to(dtype)
            return torch.randint(-100, 100, shape, generator=g, device="cuda").to(dtype)

        big = make(1031, 77)
        cases.append((str(dtype).split(".")[1], [
            (big, None),
            (big, ((0, 1), (3, 517), (517, 1031), (9, 9))),
            (make(3, 5), None),
            (make(0), None),
            (make(64, 33)[:, 1::2], None),
            (make(200_003), ((7, 199_999),)),
        ]))
    return cases


def _train_state_digest_specs(seed: int):
    """The train state and its chunk table as an incremental take digests
    it (one launch)."""
    import torch

    from torchsnapshot_tpu_torch.flatten import flatten
    from torchsnapshot_tpu_torch.incremental import IncrementalTakeContext
    from torchsnapshot_tpu_torch.models.transformer import init_train_state

    state = init_train_state(main_config(), seed=seed)  # AdamW moments included
    _, flat = flatten(state.state_dict(), prefix="train")
    batches = IncrementalTakeContext(None, None, None, 0).collect(flat)
    return state, batches[torch.device("cuda", torch.cuda.current_device())].specs


def digest_phase(seed: int, bulk_gib: float) -> dict:
    """Hold the digest kernel against its plain version and the host digest
    bit for bit, then time it on the train state's chunk table and the bulk
    state's; returns the record at the train state (the main path's call)."""
    import torch

    from torchsnapshot_tpu_torch.ops import device_digest as dd

    cases = _digest_case_specs(seed)
    for label, specs in cases:
        kernel = dd.materialize_many(dd.digest_many_async(specs))
        plain = dd.materialize_many(dd.digest_many_plain(specs))
        host = []
        for t, ranges in specs:
            t = t.cpu()
            host += [dd.digest_host(t)] if ranges is None else [dd.digest_host(t[a:b]) for a, b in ranges]
        _require((kernel == plain).all(), f"digest {label} differs from the plain version")
        _require(
            [(int(d1), int(d2)) for d1, d2 in kernel] == host, f"digest {label} differs from the host digest"
        )
    del cases
    log("kernel device_digest: 11 dtypes x 6 layouts (odd lengths, row ranges, an unaligned "
        "tail, an empty tensor, a non-contiguous view) bit-identical to the plain version and "
        "the host digest")

    state, specs = _train_state_digest_specs(seed)
    record = _time_digest("train state", specs)
    del state, specs
    torch.cuda.empty_cache()
    bulk = bulk_state(seed, bulk_gib)
    from torchsnapshot_tpu_torch.flatten import flatten
    from torchsnapshot_tpu_torch.incremental import IncrementalTakeContext

    _, flat = flatten(bulk, prefix="bulk")
    batches = IncrementalTakeContext(None, None, None, 0).collect(flat)
    _time_digest("bulk state", batches[torch.device("cuda", torch.cuda.current_device())].specs)
    del bulk, flat, batches
    torch.cuda.empty_cache()
    return record


def _time_digest(label: str, specs) -> dict:
    from torchsnapshot_tpu_torch.ops import device_digest as dd

    nbytes = dd.digest_bytes(specs)
    kernel = dd.materialize_many(dd.digest_many_async(specs))
    plain = dd.materialize_many(dd.digest_many_plain(specs))
    mismatched = int((kernel != plain).any(axis=1).sum())
    _require(mismatched == 0, f"digest of the {label} differs from the plain version in {mismatched} rows")
    # The host digest too, on 8 rows spread over the table (the whole state
    # would take the host minutes).
    pieces = []
    for t, ranges in specs:
        pieces += [t] if ranges is None else [t[a:b] for a, b in ranges]
    picked = sorted({round(i * (len(pieces) - 1) / 7) for i in range(8)})
    host = [dd.digest_host(pieces[i].cpu()) for i in picked]
    _require([tuple(int(x) for x in kernel[i]) for i in picked] == host,
             f"digest of the {label} differs from the host digest")

    def fn():
        return dd.digest_many_async(specs)

    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    t = digest_timings(fn)
    rec = {
        "ms": t["ms"],
        "plain_ms": cuda_ms(lambda: dd.digest_many_plain(specs), iters=1, warmup=0),
        "library_ms": None,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "max_abs_err": float(abs(kernel.astype("int64") - plain.astype("int64")).max()),
    }
    table = dd.build_table(specs)
    table_us = []
    for _ in range(50):
        t0 = time.perf_counter()
        dd.build_table(specs)
        table_us.append((time.perf_counter() - t0) * 1e6)
    log(
        f"kernel device_digest {label}: {len(kernel)} rows, {nbytes / 1e9:.3f} GB in one launch "
        f"({table.n_items} items): {rec['ms']:.4f} ms back to back, "
        f"{nbytes / rec['ms'] / 1e6:.1f} GB/s; device {t['device_ms']:.4f} ms "
        f"({nbytes / t['device_ms'] / 1e6:.1f} GB/s, {bound_ms / t['device_ms']:.1%} of the bound), "
        f"of which the main kernel {t['main_ms']:.4f} ms and the rest (memset, table copy, "
        f"finalize) {t['rest_ms']:.4f} ms by the profiler; host {t['host_us']:.1f} us per call, "
        f"of which the table {statistics.median(table_us):.1f} us (median of 50) (plain {rec['plain_ms']:.2f} ms; no library call computes it; bound {bound_ms:.4f} ms by "
        f"bytes at 3.35 TB/s; the design's reckoned integer instructions per lane "
        f"{reckoned_int_ops_per_lane(table):.2f}); SM clock / power while timed: {t['clocks']}; "
        f"bit-identical to the plain version, and on {len(picked)} rows to the host digest"
    )
    return rec


def digest_timings(fn) -> dict:
    """The digest wrapper ``fn`` timed as every tree's digest is: ms back to
    back, card ms and host us per call behind a spin kernel, the card's time
    split by the profiler into the main kernel and the rest, and the SM
    clock and power sampled while it runs."""
    device_ms, host_us = held_times(fn, hold_cycles=DIGEST_HOLD_CYCLES)
    ops = device_ops_ms(fn)
    main_ms = sum(ms for name, ms in ops.items() if "digest" in name and "finalize" not in name)
    return {
        "ms": cuda_ms(fn, iters=10), "device_ms": device_ms, "host_us": host_us,
        "main_ms": main_ms, "rest_ms": sum(ops.values()) - main_ms, "ops": ops,
        "clocks": clocks_during(fn),
    }


def device_ops_ms(fn, iters: int = 10) -> dict:
    """Device time per call of ``fn`` by operation name (kernels, copies,
    memsets), from torch.profiler over ``iters`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ops = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = (e.time_range.end - e.time_range.start) / 1e3 / iters
            ops[e.name] = ops.get(e.name, 0.0) + ms
    return ops


def clocks_during(fn, seconds: float = 0.5) -> str:
    """The SM clock and power draw that nvidia-smi reads every 50 ms while
    ``fn`` runs back to back for ``seconds``: 'clock min-max MHz, power
    max W (limit)'."""
    import torch

    smi = subprocess.Popen(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, text=True,
    )
    try:
        time.sleep(0.2)  # its first reading
        t0 = time.monotonic()
        while time.monotonic() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate()
    rows = [[float(x) for x in line.split(",")] for line in out.splitlines()[1:] if line.count(",") == 2]
    if not rows:
        return "not read"
    clocks = [r[0] for r in rows]
    return (f"clock {min(clocks):.0f}-{max(clocks):.0f} MHz, power max "
            f"{max(r[1] for r in rows):.1f} W (limit {rows[0][2]:.0f} W)")


# The digest design's integer instructions (csrc/device_digest.cu), as
# reckoned from its code: per lane, its extraction (none for 4-byte lanes)
# and two multiply-adds; per weight pair, 19 (the index step, two seed adds,
# two mix32s of 8), one pair per lane of every (item, sub-window) reached;
# per (segment, sub-window), 3 a thread (two warp sums and the slot's add).
DIGEST_SUB_LANES = 4096  # lanes of a sub-window: 256 threads x 16


def reckoned_int_ops_per_lane(table) -> float:
    import numpy as np

    from torchsnapshot_tpu_torch.ops import device_digest as dd

    seg, win = table.segments, table.windows
    lane = seg["lane_bytes"].astype(np.int64)
    nb = seg["nbytes"]
    sub_bytes = DIGEST_SUB_LANES * lane
    lanes = nb // lane
    if not lanes.sum():
        return 0.0
    data = (lanes * np.where(lane == 4, 2, 3)).sum()
    reduce = 3 * 256 * (-(-nb // sub_bytes)).sum()
    n = win["n_reach"].astype(np.int64)
    k = dd.items_per_window(n)
    w = np.repeat(np.arange(len(win)), k)
    i = np.arange(k.sum()) - np.repeat(np.cumsum(k) - k, k)
    first = win["seg_begin"][w] + i * n[w] // k[w]  # each item's longest segment
    reach = np.minimum(nb[first] - win["index"][w].astype(np.int64) * dd.WINDOW_BYTES, dd.WINDOW_BYTES)
    weights = 19 * DIGEST_SUB_LANES * (-(-reach // sub_bytes[first])).sum()
    return float((data + reduce + weights) / lanes.sum())


# ----------------------------------------------------------------------
# The device pack kernel
# ----------------------------------------------------------------------


def _pack_case_specs(seed: int) -> list:
    """(label, specs) of the pack kernel's checks: every dtype the port
    serializes and packs, row slices (unaligned starts included), 1-byte,
    odd-sized and empty members, a non-contiguous view, 1 and 10,000
    members; members at odd distances from their slab offset's alignment,
    one member longer than several tiles, empty members on a tile boundary
    and 10,000 members of 4,093 bytes."""
    import torch

    from torchsnapshot_tpu_torch.ops.device_pack import TILE_BYTES

    g = torch.Generator(device="cuda").manual_seed(seed)
    dtypes = [
        torch.float32, torch.bfloat16, torch.float16, torch.float64, torch.int64,
        torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool,
        torch.float8_e4m3fn, torch.float8_e5m2, torch.uint16, torch.uint32, torch.uint64,
    ]

    def make(shape, dtype):
        """Random bytes viewed as ``dtype`` (a byte copy carries any bits)."""
        if dtype == torch.bool:
            return torch.rand(shape, generator=g, device="cuda") > 0.5
        raw = torch.randint(0, 256, (*shape, dtype.itemsize), generator=g, device="cuda", dtype=torch.uint8)
        return raw.view(dtype).reshape(shape)

    big = make((1031, 77), torch.uint8)
    odd = zip((1, 3, 17, 4093, 255, 16, 31, 1000, 7, 2049),
              (torch.uint8, torch.bool, torch.bfloat16, torch.uint8, torch.int8, torch.float32,
               torch.bfloat16, torch.bool, torch.uint8, torch.float16))
    return [
        ("dtypes", [(make((33, 7), d), None) for d in dtypes]),
        ("row slices", [(big, (0, 1)), (big, (3, 517)), (big, (9, 9)),
                        (make((200, 3), torch.bfloat16), (7, 199))]),
        ("1-byte, odd and empty", [(make((1,), torch.uint8), None), (make((0,), torch.float32), None),
                                   (make((3, 5), torch.bfloat16), None), (make((17,), torch.int8), None),
                                   (make((5,), torch.float64), None)]),
        ("non-contiguous", [(make((64, 33), torch.float32)[:, 1::2], None), (big, None)]),
        ("1 member", [(make((4096,), torch.float32), None)]),
        ("10,000 members", [(make((1024,), torch.float32), None) for _ in range(10_000)]),
        ("odd distances", [(make((n,), d), None) for n, d in odd] + [(big, (5, 333)), (big, (333, 1030))]),
        ("a member over several tiles", [(make((3,), torch.uint8), None),
                                         (make((5 * TILE_BYTES + 7,), torch.uint8), None),
                                         (make((9,), torch.bool), None)]),
        ("empty members on a tile boundary", [(make((TILE_BYTES - 3,), torch.uint8), None),
                                              (make((3,), torch.uint8), None),
                                              (make((0,), torch.float32), None),
                                              (make((0, 4), torch.bfloat16), None)]
         + [(make((1024,), torch.float32), None) for _ in range(5)]),
        ("10,000 members of 4,093 bytes", [(make((4093,), torch.uint8), None) for _ in range(10_000)]),
    ]


def _train_state_slab_specs(seed: int):
    """Rank 0's largest slab of the sharded phase's batched take: each
    CUDA leaf of the train state cut Shard(0) over two ranks (rank 0's
    rows, a row range of the leaf), packed greedily in plan order into
    slabs of the 128 MiB threshold, as the batcher plans them."""
    from torchsnapshot_tpu_torch import knobs
    from torchsnapshot_tpu_torch.models.transformer import init_train_state

    state = init_train_state(main_config(), seed=seed)
    threshold = knobs.get_slab_size_threshold_bytes()
    slabs, current, size = [], [], 0
    for t in _state_tensors(state).values():
        if not t.is_cuda or t.dim() == 0:
            continue
        rows = -(-t.shape[0] // RANKS)
        nbytes = rows * t[0].numel() * t.element_size()
        if current and size + nbytes > threshold:
            slabs.append(current)
            current, size = [], 0
        current.append((t, (0, rows)))
        size += nbytes
    slabs.append(current)
    return state, max(slabs, key=lambda specs: sum(t[a:b].numel() * t.element_size() for t, (a, b) in specs)), len(slabs)


def pack_layouts(seed: int):
    """The pack's three timed layouts, made on the card from ``seed``:
    (label, specs) of the train state's largest slab, 10,000 members of
    4 KiB and 10,000 uint8 members of 4,093 bytes (every member after the
    first at an odd distance from its slab offset's alignment)."""
    import torch

    state, specs, n_slabs = _train_state_slab_specs(seed)
    yield f"train state slab (largest of {n_slabs} of rank 0's half)", specs
    del state, specs
    g = torch.Generator(device="cuda").manual_seed(seed)
    for label, nbytes in (("10,000 members of 4 KiB", 4096), ("10,000 members of 4,093 bytes", 4093)):
        tiny = [(torch.randint(0, 255, (nbytes,), generator=g, device="cuda", dtype=torch.uint8), None)
                for _ in range(10_000)]
        yield label, tiny
        del tiny
    torch.cuda.empty_cache()


def pack_phase(seed: int) -> dict:
    """Hold the pack kernel against its plain version bit for bit on every
    case, through plain specs and through a ``PackLayout``, then time it at
    the three layouts of :func:`pack_layouts`; returns the record at the
    train state's slab."""
    import numpy as np
    import torch

    from torchsnapshot_tpu_torch.ops import device_pack as dp

    cases = _pack_case_specs(seed)
    for label, specs in cases:
        plain = dp.pack_plain(specs)
        # As the batcher makes it: sizes and row offsets, and the members
        # that are not contiguous named for a copy at launch.
        planned, _ = dp.PackLayout.from_specs(specs)
        copies = [i for i, (t, _) in enumerate(specs) if not t.is_contiguous()]
        layout = dp.PackLayout(planned.device, np.diff(planned.table[: planned.n + 1]), planned.src_offsets, copies)
        for how, packed_fn in (
            ("plain specs", lambda: dp.pack_async(specs)),
            ("a layout", lambda: dp.pack_async(specs, layout=layout)),
        ):
            before = dp.launch_counts["device_pack"]
            packed = packed_fn()
            torch.cuda.synchronize()
            _require(dp.launch_counts["device_pack"] == before + 1, f"pack {label} ({how}): not one launch")
            _require(packed.numel() == plain.numel() and torch.equal(packed, plain),
                     f"pack {label} ({how}) differs from the plain version")
    log(f"kernel device_pack: {len(cases)} layouts ({', '.join(label for label, _ in cases)}; copies of "
        f"non-contiguous members counted: {dp.copy_counts['device_pack_contiguous']}) bit-identical to the "
        f"plain version, through plain specs and through a layout, one launch each")
    del cases
    record = None
    for label, specs in pack_layouts(seed):
        rec = _time_pack(label, specs)
        record = record or rec
    return record


def pack_timings(specs) -> dict:
    """The pack wrapper timed on ``specs`` as every tree's pack is: ms back
    to back, card ms and host us a call behind a spin kernel, and the
    host's us to build the table (median of 20), for the plain-specs call;
    the plain version's and ``torch.cat``'s ms; and, where this tree has
    ``PackLayout``, the same for a call given the slab's layout (the
    batcher's), whose table work is the members' addresses alone."""
    import torch

    from torchsnapshot_tpu_torch.ops import device_pack as dp

    nbytes = dp.pack_bytes(specs)
    packed = dp.pack_async(specs)
    plain = dp.pack_plain(specs)
    _require(torch.equal(packed, plain), "the pack differs from the plain version")
    del packed, plain
    views = [(t if r is None else t[r[0]:r[1]]).contiguous().reshape(-1).view(torch.uint8) for t, r in specs]

    def median_us(fn) -> float:
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        return statistics.median(times)

    def fn():
        return dp.pack_async(specs)

    rec = {"bytes": nbytes, "members": len(specs), "ms": cuda_ms(fn)}
    # Once unmeasured first: the calls queued behind the spin each hold a
    # pinned table buffer (this tree's pool or torch's caching host
    # allocator), and the first such run allocates them.
    held_times(fn, hold_cycles=PACK_HOLD_CYCLES)
    rec["device_ms"], rec["host_us"] = held_times(fn, hold_cycles=PACK_HOLD_CYCLES)
    rec["table_us"] = median_us(lambda: dp.build_table(specs))
    rec["plain_ms"] = cuda_ms(lambda: dp.pack_plain(specs), iters=3)
    rec["library_ms"] = cuda_ms(lambda: torch.cat(views))
    if hasattr(dp, "PackLayout"):
        layout, members = dp.PackLayout.from_specs(specs)
        lspecs = list(zip(members, (r for _, r in specs)))
        _require(torch.equal(dp.pack_async(lspecs, layout=layout), dp.pack_plain(specs)),
                 "the pack through a layout differs from the plain version")

        def lfn():
            return dp.pack_async(lspecs, layout=layout)

        rec["layout"] = {"ms": cuda_ms(lfn)}
        rec["layout"]["device_ms"], rec["layout"]["host_us"] = held_times(lfn, hold_cycles=PACK_HOLD_CYCLES)
        rec["layout"]["table_us"] = median_us(lambda: layout.addresses(members))
    return rec


def _odd_members(specs) -> int:
    """Members of ``specs`` with bytes whose source sits at an odd
    distance from their slab offset's 16-byte alignment: the ones the
    kernel shifts into place."""
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    table, _, members = dp.build_table(specs)
    n = len(members)
    offsets, srcs = table[:n], table[n + 1 : 2 * n + 1]
    return int((((srcs - offsets) % 16 != 0) & (table[1 : n + 1] > offsets)).sum())


def _time_pack(label: str, specs) -> dict:
    """Time the pack at one layout; the record's ``ms`` is the call the
    batcher makes, given the slab's ``PackLayout``, and ``plain_specs_ms``
    the call with plain specs, which builds the layout each time."""
    t = pack_timings(specs)
    nbytes, lt = t["bytes"], t["layout"]
    bound_ms = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    log(
        f"kernel device_pack {label}: {len(specs)} members ({_odd_members(specs)} at an odd distance from "
        f"16-byte alignment), {nbytes / 1e6:.3f} MB in one launch: with the slab's layout (the batcher's "
        f"call) {lt['ms']:.4f} ms back to back, device {lt['device_ms']:.4f} ms "
        f"({2 * nbytes / lt['device_ms'] / 1e9:.3f} TB/s read + written, {bound_ms / lt['device_ms']:.1%} of "
        f"the bound), host {lt['host_us']:.1f} us per call, of which the addresses {lt['table_us']:.1f} us; "
        f"plain specs {t['ms']:.4f} ms back to back, device {t['device_ms']:.4f} ms, host "
        f"{t['host_us']:.1f} us per call, of which the table {t['table_us']:.1f} us (median of 20) "
        f"(plain {t['plain_ms']:.4f} ms; torch.cat of the uint8 views {t['library_ms']:.4f} ms; "
        f"bound {bound_ms:.4f} ms by bytes, 2 x {nbytes / 1e6:.3f} MB at 3.35 TB/s); bit-identical to "
        f"the plain version"
    )
    return {
        "ms": lt["ms"], "plain_ms": t["plain_ms"], "library_ms": t["library_ms"], "bound_ms": bound_ms,
        "bound_by": "bytes", "max_abs_err": 0.0,  # bit for bit, checked above
        "path": "PackLayout", "plain_specs_ms": t["ms"],
    }


# ----------------------------------------------------------------------
# Phase 7: a state of 10^4 small leaves, batched and packed
# ----------------------------------------------------------------------

LEAVES = 10_000
LEAF_DTYPES = ("float32", "bfloat16", "int64", "uint8", "bool")
# Of these, leaves at odd element counts: whatever follows them in a slab
# sits at an odd distance from 16-byte alignment.
ODD_LEAF_DTYPES = ("bfloat16", "uint8", "bool")


def leaves_state(seed: int) -> dict:
    """A stress case of the many-small-leaves state the device pack is
    meant for (torchrec-style states, as the JAX package's pack names
    them): 10,000 CUDA leaves from ``seed``, their sizes log-uniform from
    256 B to 64 KiB, dtypes cycling float32, bfloat16, int64, uint8 and
    bool, the bfloat16, uint8 and bool leaves at odd element counts, so
    that most members sit at an odd distance from their slab offset's
    alignment. The mix is made up to drive the kernel's odd-distance path,
    not taken from a published configuration: its times say what this
    mix costs, not what a recommender's state would. Their bits come from
    one random buffer made on the card, cut and cloned."""
    import torch

    g = torch.Generator().manual_seed(seed)
    sizes = torch.exp(torch.empty(LEAVES, dtype=torch.float64).uniform_(math.log(256), math.log(65536), generator=g))
    shapes = []
    for i, nbytes in enumerate(sizes.tolist()):
        dtype = getattr(torch, LEAF_DTYPES[i % len(LEAF_DTYPES)])
        numel = max(1, int(nbytes) // dtype.itemsize)
        if LEAF_DTYPES[i % len(LEAF_DTYPES)] in ODD_LEAF_DTYPES:
            numel |= 1
        shapes.append((dtype, numel))
    total = sum(dtype.itemsize * numel for dtype, numel in shapes)
    gd = torch.Generator(device="cuda").manual_seed(seed)
    raw = torch.randint(0, 256, (total,), generator=gd, device="cuda", dtype=torch.uint8)
    leaves, at = {}, 0
    for i, (dtype, numel) in enumerate(shapes):
        nbytes = dtype.itemsize * numel
        piece = raw[at : at + nbytes]
        at += nbytes
        leaves[f"leaf_{i:05d}"] = (piece & 1).bool() if dtype == torch.bool else piece.clone().view(dtype)
    del raw
    torch.cuda.synchronize()
    return leaves


# ~2 ms of spin on the card ahead of each timed pack inside a take: the
# host queues the table copy and the launch behind it, so the events after
# it time the card's work alone.
PACK_SPIN_CYCLES = 4_000_000


@contextlib.contextmanager
def timed_packs(record: dict):
    """Time the packs of the takes inside: each ``pack_async`` call's host
    seconds, and its kernel's card ms. A spin kernel holds the pack's
    stream while the host queues the launch (the table copy on its side
    stream, the stream's wait for it, the kernel), and CUDA events after
    the spin and after the launch bound the card's work, the table copy
    having run during the spin. ``queue_us`` is the host's time from the
    spin's launch to the pack's: the events hold none of the host's time
    while it is under the spin's ~2 ms, which ``record["spin_covered"]``
    says."""
    import torch

    from torchsnapshot_tpu_torch.ops import device_pack as dp

    orig_pack, orig_library = dp.pack_async, dp._library
    events = []

    class TimedLibrary:
        def __init__(self, lib) -> None:
            self._lib = lib

        def __getattr__(self, name):
            return getattr(self._lib, name)

        def ts_pack(self, *args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            torch.cuda._sleep(PACK_SPIN_CYCLES)
            start.record()
            err = self._lib.ts_pack(*args)
            queue_us = (time.perf_counter() - t0) * 1e6
            end.record()
            events.append((start, end))
            record["queue_us"] = max(record.get("queue_us", 0.0), queue_us)
            return err

    def timed(specs, layout=None):
        t0 = time.perf_counter()
        out = orig_pack(specs, layout=layout)
        record["host_s"] = record.get("host_s", 0.0) + time.perf_counter() - t0
        record["calls"] = record.get("calls", 0) + 1
        return out

    dp.pack_async = timed
    dp._library = lambda: TimedLibrary(orig_library())
    try:
        yield
    finally:
        dp.pack_async, dp._library = orig_pack, orig_library
        torch.cuda.synchronize()
        record["card_ms"] = sum(a.elapsed_time(b) for a, b in events)
        record["spin_covered"] = record.setdefault("queue_us", 0.0) < 1000.0


def take_leaves(path: str, leaves: dict, pack: bool, record=None, vectorized: bool = True) -> float:
    """One batched take of ``leaves``, with the device pack or member by
    member, through the zero-pack vectorized write or staged into one slab
    buffer; returns its seconds, the pack's times added to ``record``
    where one is given (:func:`timed_packs`)."""
    import torch

    from torchsnapshot_tpu_torch import Snapshot, TensorTreeState, knobs

    with contextlib.ExitStack() as stack:
        stack.enter_context(knobs.enable_batching())
        stack.enter_context(knobs.enable_write_vectorized() if vectorized else knobs.disable_write_vectorized())
        if pack:
            stack.enter_context(knobs.enable_device_pack())
            if record is not None:
                stack.enter_context(timed_packs(record))
        torch.cuda.synchronize()
        t0 = time.monotonic()
        Snapshot.take(path, {"leaves": TensorTreeState(leaves)})
        return time.monotonic() - t0


# The leaves phase's turns: (label, device pack, vectorized write,
# restored). "slab" turns run with TORCHSNAPSHOT_TPU_WRITE_VECTORIZED=0.
LEAVES_TURNS = (
    ("pack", True, True, True), ("pack_slab", True, False, True),
    ("per_member", False, True, True), ("per_member_slab", False, False, True),
    ("pack", True, True, False), ("pack_slab", True, False, False),
)


def _blob_signature(path: str, rank: int = 0) -> dict:
    """The blobs ``rank`` wrote, by what they hold: for each manifest
    entry of the rank (a sharded entry by shard offsets), its blob's sha1
    and checksum-table entry. Slab names are random; the leaves a slab
    holds, at their byte ranges, are not."""
    from torchsnapshot_tpu_torch import Snapshot

    with open(os.path.join(path, "checksums", str(rank))) as f:
        table = json.load(f)
    digests: dict = {}

    def blob(loc: str) -> tuple:
        if loc not in digests:
            with open(os.path.join(path, loc), "rb") as f:
                digests[loc] = (hashlib.sha1(f.read()).hexdigest(), table[loc])
        return digests[loc]

    out = {}
    for key, entry in Snapshot(path).metadata.manifest.items():
        arrays = [(tuple(s.offsets), s.array) for s in getattr(entry, "shards", None) or getattr(entry, "chunks", None) or []]
        if hasattr(entry, "byte_range"):
            arrays.append(((), entry))
        for offsets, array in arrays:
            if array.location in table:
                out[(key, offsets)] = (blob(array.location), array.byte_range)
    return out


def _require_vectorized_pair(vec: dict, slab: dict, what: str) -> None:
    """A vectorized take against a slab-staged one: the same blobs, bytes
    and CRC tables."""
    _require(vec["signature"] == slab["signature"],
             f"{what}: blobs or CRC tables differ between the vectorized and the slab-staged takes")
    _require(vec["avoided_bytes"] == vec["slab_bytes"] > 0 and slab["avoided_bytes"] == 0,
             f"{what}: pack bytes avoided {vec['avoided_bytes']} (vectorized) and {slab['avoided_bytes']} (slab) "
             f"for {vec['slab_bytes']} slab bytes")


def leaves_phase(args, work_dir: str, card: str) -> dict:
    """Batched takes of the 10,000-leaf stress state, with the device pack and
    member by member, through the zero-pack vectorized write and staged
    into one slab buffer, in turns (``LEAVES_TURNS``): the first four
    restored bit-identical into fresh leaves, three leaves read back with
    ``read_object``, one pack launch per slab of card members; every blob
    and CRC table the same in all six; ``batcher_pack_bytes_avoided_total``
    the slab bytes with the vectorized write and 0 without. Returns the
    pack's launches in the phase (counts set to 0 just before it)."""
    import torch

    from torchsnapshot_tpu_torch import Snapshot, TensorTreeState
    from torchsnapshot_tpu_torch.ops import device_pack as dp
    from torchsnapshot_tpu_torch.telemetry import names as metric_names

    leaves = leaves_state(args.seed)
    nbytes = sum(t.numel() * t.element_size() for t in leaves.values())
    names = sorted(leaves)
    live = dp.pack_plain([(leaves[k], None) for k in names])
    odd = None
    signature = None
    dp.reset_launch_counts()
    runs = {label: [] for label, _, _, _ in LEAVES_TURNS}
    for turn, (label, pack, vectorized, restore) in enumerate(LEAVES_TURNS):
        path = os.path.join(work_dir, f"leaves_{turn}")
        before = dp.launch_counts["device_pack"]
        avoided = _counter(metric_names.BATCHER_PACK_BYTES_AVOIDED_TOTAL)
        packs: dict = {}
        take_s = take_leaves(path, leaves, pack, packs, vectorized=vectorized)
        avoided = _counter(metric_names.BATCHER_PACK_BYTES_AVOIDED_TOTAL) - avoided
        launched = dp.launch_counts["device_pack"] - before
        slabs: dict = {}
        offsets = []
        for entry in Snapshot(path).metadata.manifest.values():
            loc = getattr(entry, "location", "")
            if loc.startswith("batched/"):
                slabs[loc] = slabs.get(loc, 0) + 1
                offsets.append(entry.byte_range[0])
        if odd is None:
            # Members whose slab offset is not 16-byte aligned: their sources
            # (aligned allocations) sit at an odd distance from it.
            odd = sum(1 for o in offsets if o % 16)
            _require(odd >= LEAVES // 4, f"leaves: only {odd} members at an odd distance")
        want = sum(1 for n in slabs.values() if n > 1) if pack else 0
        _require(launched == want and (want > 0 or not pack),
                 f"leaves {label}: {launched} pack launches for {want} slabs of card members")
        slab_bytes = sum(os.path.getsize(os.path.join(path, loc)) for loc in slabs)
        sig = _blob_signature(path)
        signature = sig if signature is None else signature
        _require(sig == signature, f"leaves {label}: blobs or CRC tables differ from the first take's")
        _require(avoided == (slab_bytes if vectorized else 0) and slab_bytes > 0,
                 f"leaves {label}: pack bytes avoided {avoided} for {slab_bytes} slab bytes")
        r = {"take_s": take_s, "slabs": len(slabs), "slab_bytes": slab_bytes, "avoided_bytes": avoided,
             "pack_launches": launched, **packs}
        if restore:
            dest = {k: torch.zeros_like(v) for k, v in leaves.items()}
            t0 = time.monotonic()
            Snapshot(path).restore({"leaves": TensorTreeState(dest)})
            torch.cuda.synchronize()
            r["restore_s"] = time.monotonic() - t0
            _require(all(dest[k].dtype == leaves[k].dtype and dest[k].shape == leaves[k].shape for k in names),
                     f"leaves {label}: a restored leaf changed dtype or shape")
            _require(torch.equal(dp.pack_plain([(dest[k], None) for k in names]), live),
                     f"leaves {label}: the restore is not bit-identical")
            for k in (names[0], names[LEAVES // 2 + 1], names[-1]):
                got = Snapshot(path).read_object(f"0/leaves/{k}")
                _require(same_bits(got, leaves[k]), f"leaves {label}: read_object of {k} differs")
            del dest
        runs[label].append(r)
        shutil.rmtree(path, ignore_errors=True)
    launches = dp.launch_counts["device_pack"]
    for label, rs in runs.items():
        for i, r in enumerate(rs):
            share = ""
            if "host_s" in r:
                covered = "" if r["spin_covered"] else ", the host queued slower than the spin: host time inside"
                share = (f"; the pack inside it: wrapper host {r['host_s'] * 1e3:.3f} ms over {r['calls']} "
                         f"calls, kernel on the card {r['card_ms']:.4f} ms (events behind a spin; the host "
                         f"queued the launch in {r['queue_us']:.1f} us{covered})")
            restored = f"restore {r['restore_s']:.3f} s, bit-identical" if "restore_s" in r else "not restored"
            log(f"leaves: {label} take {i + 1}: {r['take_s']:.3f} s, {r['slabs']} slabs of {r['slab_bytes']} B, "
                f"{r['avoided_bytes']:.0f} pack bytes avoided, {r['pack_launches']} pack launches{share}; {restored}")
    log(f"leaves (a stress case, not a published mix): {LEAVES} leaves, {nbytes / 1e6:.3f} MB, {odd} of them "
        f"at an odd distance from 16-byte alignment in their slab; pack launches {launches} in the phase; three "
        f"read_objects bit-identical; every blob and CRC table the same in the vectorized and slab-staged takes; "
        f"on {card}")
    _headline("leaves", take_pack_s=[r["take_s"] for r in runs["pack"]],
              take_pack_slab_s=[r["take_s"] for r in runs["pack_slab"]],
              take_member_s=[r["take_s"] for r in runs["per_member"]],
              take_member_slab_s=[r["take_s"] for r in runs["per_member_slab"]], pack_launches=launches)
    print(json.dumps({"leaves": {"bytes": nbytes, "odd_members": odd, "runs": runs}}), flush=True)
    del leaves, live
    torch.cuda.empty_cache()
    return {"device_pack": launches}


# ----------------------------------------------------------------------
# Entry
# ----------------------------------------------------------------------


KERNEL_SOURCES = {
    "device_pack": (
        "torchsnapshot_tpu_torch/csrc/device_pack.cu",
        "torchsnapshot_tpu/ops/device_pack.py:52",
    ),
    "flash_fwd": (
        "torchsnapshot_tpu_torch/csrc/flash_attention.cu",
        "torchsnapshot_tpu/ops/flash_attention.py:395",
    ),
    "flash_chunk": (
        "torchsnapshot_tpu_torch/csrc/flash_attention.cu",
        "torchsnapshot_tpu/ops/flash_attention.py:223",
    ),
    "device_digest": (
        "torchsnapshot_tpu_torch/csrc/device_digest.cu",
        "torchsnapshot_tpu/ops/device_digest.py:237",
    ),
    # The f32 entries' pre-pass: a part of both flash kernels'
    # f32 port (the fused entry's pallas_call named here, the chunk's at :223).
    "flash_split": (
        "torchsnapshot_tpu_torch/csrc/flash_attention.cu",
        "torchsnapshot_tpu/ops/flash_attention.py:395",
    ),
    # The chunk kernel's unmasked mode (a ring step's block behind the
    # queries), timed at a ring step's shape; its launches are the ring
    # phase's unmasked ones (flash_chunk counts both modes).
    "flash_chunk_unmasked": (
        "torchsnapshot_tpu_torch/csrc/flash_attention.cu",
        "torchsnapshot_tpu/ops/flash_attention.py:223",
    ),
}
# The kernels the main path must launch (it trains in bf16: no f32 entry,
# so no split pre-pass).
MAIN_PATH_KERNELS = ("flash_fwd", "flash_chunk", "device_digest")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument(
        "--phases", default="kernels,main,bulk,manager,cas,ranks,sharded,leaves,tiered,peer,cdn,bridge,moe,ring,dcp"
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bulk-gib", type=float, default=8.0)
    args = p.parse_args()
    phases = set(args.phases.split(","))
    # The phases hold byte counts, ledger events and file sets of a fixed
    # knob geometry: the SLO engine, incident bundles and the autotuner (on
    # by default, as in the JAX package) are pinned off, as in the test
    # suite, and the manager and ranks phases turn each on where they
    # measure it. The stall watchdog and the critical path run everywhere.
    for name in ("TORCHSNAPSHOT_TPU_SLO", "TORCHSNAPSHOT_TPU_BUNDLE_MAX_BYTES", "TORCHSNAPSHOT_TPU_AUTOTUNE"):
        os.environ.setdefault(name, "0")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; nothing run", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "torchsnapshot_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from torchsnapshot_tpu_torch.ops import device_digest as dd
    from torchsnapshot_tpu_torch.ops import device_pack as dp
    from torchsnapshot_tpu_torch.ops import flash_attention as fa
    from torchsnapshot_tpu_torch.ops import kernels

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    t0 = time.monotonic()
    built = kernels.build()
    log(f"kernel build: {time.monotonic() - t0:.1f} s wall, per source {built}")
    for name, text in kernels.build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma", "setmaxnreg")):
                log(f"ptxas {name}: {line.strip()}")
    # The host I/O runtime (pwritev, CRC32-C) also compiles at first use;
    # build it here so that the timed take and restore hold no compile.
    from torchsnapshot_tpu_torch import _native

    t0 = time.monotonic()
    _require(_native.lib() is not None, "the native I/O runtime did not build")
    log(f"native I/O runtime: {time.monotonic() - t0:.1f} s to build and load")

    records = {}
    # Launches are counted only in the main path's run, plus the paths of
    # later slices, each counted from 0 (the digest's: the main, cas,
    # tiered, peer, cdn, bridge, moe, ring and dcp phases'; the pack's: the
    # cas phase's, both ranks' in the sharded phase, the leaves, tiered, cdn
    # and moe phases'; the flash kernels': the main, cdn, bridge, moe, ring
    # and dcp phases', the unmasked chunk's the ring phase's); without them they
    # were not measured and the record says null.
    launches = dict.fromkeys(
        list(fa.launch_counts) + list(dd.launch_counts) + list(dp.launch_counts) + ["flash_chunk_unmasked"]
    )

    def add(name: str, n: int) -> None:
        launches[name] = (launches[name] or 0) + n

    def kernels_phase() -> None:
        records.update(kernel_phase(args.seed))
        records["device_digest"] = digest_phase(args.seed, args.bulk_gib)
        records["device_pack"] = pack_phase(args.seed)
        _headline("kernels", **{
            f"{name}_ms": [r["ms"], r["plain_ms"]] for name, r in records.items() if "ms" in r
        })

    def cas() -> None:
        got = cas_phase(args, work_dir, card)
        for name in ("device_digest", "device_pack"):
            add(name, got[name])

    def sharded() -> None:
        add("device_pack", sum(r["launches"]["device_pack"] for r in sharded_phase(args, work_dir, card)["ranks"]))

    def tiered() -> None:
        got = tiered_phase(args, work_dir, card)
        for name in ("device_digest", "device_pack"):
            add(name, got[name])

    def peer() -> None:
        add("device_digest", sum(r["launches"]["device_digest"] for r in peer_phase(args, work_dir, card)["ranks"]))

    def cdn() -> None:
        got = cdn_phase(args, work_dir, card)
        for name in CDN_PATH_KERNELS:
            add(name, got[name])

    def bridge() -> None:
        got = bridge_phase(args, work_dir, card)
        for name in BRIDGE_PATH_KERNELS:
            add(name, got[name])

    def moe() -> None:
        got = moe_phase(args, work_dir, card)
        for name in MOE_PATH_KERNELS:
            add(name, got[name])

    def ring() -> None:
        got = ring_phase(args, work_dir, card)
        for name in RING_PATH_KERNELS + ("flash_chunk_unmasked",):
            add(name, got[name])
        records["flash_chunk_unmasked"] = got["record"]

    def dcp_run() -> None:
        got = dcp_phase(args, work_dir, card)
        for name in DCP_PATH_KERNELS:
            add(name, got[name])

    sequence = [
        ("kernels", kernels_phase),
        ("main", lambda: launches.update(main_phase(args, work_dir, card))),
        ("bulk", lambda: bulk_phase(args, work_dir, card)),
        ("manager", lambda: manager_phase(args, work_dir, card)),
        ("cas", cas),
        ("ranks", lambda: ranks_phase(args, work_dir, card)),
        ("sharded", sharded),
        ("leaves", lambda: add("device_pack", leaves_phase(args, work_dir, card)["device_pack"])),
        ("tiered", tiered),
        ("peer", peer),
        ("cdn", cdn),
        ("bridge", bridge),
        ("moe", moe),
        ("ring", ring),
        ("dcp", dcp_run),
    ]
    done: list = []
    work_dir = tempfile.mkdtemp(prefix="ts_chip_smoke_")
    try:
        for name, run in sequence:
            if name not in phases:
                continue
            t0 = time.monotonic()
            try:
                run()
            except BaseException as e:
                print_summary(done, failed=(name, e))
                raise
            done.append((name, time.monotonic() - t0))
            log(f"phase {name}: {done[-1][1]:.1f} s")
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)

    # The tail: one line per phase, the card, then the result lines.
    print_summary(done)
    log(card)
    if records:
        kernels_line = []
        for name, (source, replaces) in KERNEL_SOURCES.items():
            if name not in records:  # a kernel whose phase did not run
                continue
            kernels_line.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], **records[name],
            })
        print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def same_bits(a, b) -> bool:
    """Bitwise equality of two tensors (``torch.equal`` calls -0 == 0 and
    NaN != NaN; the bytes are what a restore must reproduce)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a = a.detach().contiguous().reshape(-1).view(torch.uint8)
    b = b.detach().contiguous().reshape(-1).view(torch.uint8)
    return torch.equal(a, b.to(a.device))


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main_config():
    """The widest transformer the repo runs (benchmarks/pod/main.py)."""
    import torch

    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        vocab_size=32768, d_model=1024, n_heads=16, n_layers=N_LAYERS,
        d_ff=4096, dtype=torch.bfloat16, attn_impl="flash",
    )


def main_phase(args, work_dir: str, card: str) -> dict:
    """Train, take, restore into a fresh state, and check the restored
    run continues bit for bit; then the async and incremental legs.
    Returns the kernels' launch counts of the run."""
    import torch

    from torchsnapshot_tpu_torch import RngState, Snapshot
    from torchsnapshot_tpu_torch.models.transformer import (
        init_train_state,
        make_train_step,
        random_tokens,
    )
    from torchsnapshot_tpu_torch.ops import device_digest as dd
    from torchsnapshot_tpu_torch.ops import flash_attention as fa
    from torchsnapshot_tpu_torch.scheduler import last_phase_timings, reset_phase_timings

    cfg = main_config()
    tokens = torch.from_numpy(random_tokens(cfg, 8, 1024, args.seed)).cuda()
    torch.manual_seed(args.seed)  # the global generators RngState holds
    state = init_train_state(cfg, seed=args.seed)
    train_step = make_train_step(cfg)

    fa.reset_launch_counts()
    dd.reset_launch_counts()
    t0 = time.monotonic()
    losses = []
    for _ in range(STEPS):
        state, loss = train_step(state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.monotonic() - t0) / STEPS
    losses = [float(x) for x in losses]
    _require(all(x == x and abs(x) < 1e4 for x in losses), f"losses not finite: {losses}")
    _require(
        fa.launch_counts["flash_chunk"] == cfg.n_layers * STEPS,
        f"training launched the chunk kernel {fa.launch_counts['flash_chunk']} times",
    )
    n_params = sum(p.numel() for p in state.model.parameters())
    state_bytes = sum(
        t.numel() * t.element_size()
        for t in list(state.model.parameters())
        + [v for s in state.optimizer.state.values() for v in s.values()]
    )
    log(
        f"main: {n_params / 1e6:.1f} M params, train state {state_bytes / 1e9:.3f} GB; "
        f"{STEPS} steps, {step_s * 1e3:.1f} ms/step (first step included), "
        f"losses {losses}"
    )

    torch.rand(3)
    torch.rand(3, device="cuda")  # nontrivial global RNG states
    rng_at_take = (torch.get_rng_state(), torch.cuda.get_rng_state())
    path = os.path.join(work_dir, "main")
    torch.cuda.synchronize()
    reset_phase_timings()
    t0 = time.monotonic()
    Snapshot.take(path, {"train": state, "rng": RngState()})
    take_s = time.monotonic() - t0
    # Seconds from the write pipeline's start to the end of each phase.
    take_phases = last_phase_timings()
    # A training job takes again and again: the second take finds the
    # pinned host buffers of the first in torch's caching host allocator.
    t0 = time.monotonic()
    Snapshot.take(path + "_again", {"train": state})
    take_again_s = time.monotonic() - t0
    shutil.rmtree(path + "_again", ignore_errors=True)

    fresh = init_train_state(cfg, seed=args.seed + 1)
    torch.rand(5)
    torch.rand(5, device="cuda")
    _require(not same_bits(fresh.model.embed, state.model.embed), "fresh model equals the trained one")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot(path).restore({"train": fresh, "rng": RngState()})
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0

    for (name, a), (_, b) in zip(state.model.named_parameters(), fresh.model.named_parameters()):
        _require(same_bits(a, b), f"parameter {name} differs after restore")
    sa, sb = state.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
    _require(sorted(sa) == sorted(sb), "optimizer state keys differ")
    for i in sa:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            _require(same_bits(sa[i][key], sb[i][key]), f"optimizer state {i}/{key} differs")
            _require(sb[i][key].device == sa[i][key].device, f"optimizer {i}/{key} moved device")
    _require(fresh.step == state.step, "step differs")
    _require(same_bits(fresh.rng.get_state(), state.rng.get_state()), "train RNG differs")
    _require(
        same_bits(torch.get_rng_state(), rng_at_take[0])
        and same_bits(torch.cuda.get_rng_state(), rng_at_take[1]),
        "global RNG state differs",
    )

    fwd_before = fa.launch_counts["flash_fwd"]
    with torch.no_grad():
        logits_a = state.model(tokens)
        logits_b = fresh.model(tokens)
    torch.cuda.synchronize()
    _require(bool(torch.isfinite(logits_a).all()), "evaluation logits not finite")
    _require(logits_a.shape == (8, 1024, cfg.vocab_size), "evaluation logits shape")
    _require(same_bits(logits_a, logits_b), "evaluation logits differ after restore")
    _require(
        fa.launch_counts["flash_fwd"] - fwd_before == 2 * cfg.n_layers,
        "the evaluation forward did not launch the fused kernel once per layer",
    )
    del logits_a, logits_b

    _, loss_a = train_step(state, tokens)
    (_, loss_b), profile = profile_step(lambda: train_step(fresh, tokens))
    torch.cuda.synchronize()
    _require(same_bits(loss_a, loss_b), f"next-step losses differ: {loss_a} vs {loss_b}")
    for (name, a), (_, b) in zip(state.model.named_parameters(), fresh.model.named_parameters()):
        _require(same_bits(a, b), f"parameter {name} differs after the next step")
    snap_bytes = sum(
        os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs
    )
    del fresh
    torch.cuda.empty_cache()
    shutil.rmtree(path, ignore_errors=True)

    async_record = async_and_incremental(args, work_dir, card, cfg, state, tokens, train_step, take_s)
    launches = {**fa.launch_counts, **dd.launch_counts}
    _require(
        all(launches[name] for name in MAIN_PATH_KERNELS),
        f"a kernel of the path never launched: {launches}",
    )
    record = {
        "card": card, "params": n_params, "train_state_bytes": state_bytes,
        "snapshot_bytes": snap_bytes, "take_s": take_s, "restore_s": restore_s,
        "take_gb_s": state_bytes / take_s / 1e9, "restore_gb_s": state_bytes / restore_s / 1e9,
        "take_again_s": take_again_s, "take_again_gb_s": state_bytes / take_again_s / 1e9,
        "take_phases_s": take_phases, "step_ms": step_s * 1e3, "losses": losses,
        "next_loss": float(loss_a), "launches": launches, "profile": profile,
        **async_record,
    }
    log(
        f"main: take {take_s:.3f} s ({record['take_gb_s']:.2f} GB/s; again "
        f"{take_again_s:.3f} s, {record['take_again_gb_s']:.2f} GB/s), restore "
        f"{restore_s:.3f} s ({record['restore_gb_s']:.2f} GB/s) of {state_bytes / 1e9:.3f} GB "
        f"on {card}; restored state, logits and next-step loss {float(loss_a)!r} bit-identical; "
        f"launches {launches}"
    )
    _headline("main", take_s=take_s, restore_s=restore_s, step_ms=step_s * 1e3, next_loss=float(loss_a))
    print(json.dumps({"main": record}), flush=True)
    del state
    torch.cuda.empty_cache()
    return launches


def _state_tensors(state) -> dict:
    """Every tensor of a train state by name: parameters, AdamW moments and
    step counters, and the training RNG's state."""
    out = {f"param/{n}": p for n, p in state.model.named_parameters()}
    for i, s in state.optimizer.state_dict()["state"].items():
        for k, v in s.items():
            out[f"opt/{i}/{k}"] = v
    out["rng"] = state.rng.get_state()
    return out


def _require_same_state(a: dict, b, what: str) -> None:
    """``a`` (a dict of tensors) against train state ``b``, bit for bit."""
    tb = _state_tensors(b)
    _require(sorted(a) == sorted(tb), f"{what}: the states hold other tensors")
    for k in a:
        _require(same_bits(a[k], tb[k]), f"{what}: {k} differs")


def _changed_bytes(before: dict, after: dict) -> int:
    """Bytes of the CUDA leaves' chunks (as a digest-enabled take cuts
    them) whose bits differ between two captures of a train state."""
    from torchsnapshot_tpu_torch.io_preparer import (
        ChunkedArrayIOPreparer,
        chunk_shapes,
        effective_max_chunk_size_bytes,
    )

    total = 0
    for k, a in before.items():
        if not a.is_cuda:
            continue
        b = after[k]
        if ChunkedArrayIOPreparer.should_chunk(a, incremental=True):
            pieces = [
                (a[s:e], b[s:e])
                for s, e in chunk_shapes(list(a.shape), a.element_size(), effective_max_chunk_size_bytes(True))
            ]
        else:
            pieces = [(a, b)]
        total += sum(x.numel() * x.element_size() for x, y in pieces if not same_bits(x, y))
    return total


def _written_data_bytes(path: str) -> int:
    """Bytes of the data blobs under a snapshot (commit marker, checksum
    tables and telemetry records excluded)."""
    total = 0
    for d, _, files in os.walk(path):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), path)
            if not rel.startswith((".snapshot_metadata", "checksums")) and not _is_side_file(rel):
                total += os.path.getsize(os.path.join(d, f))
    return total


def _counter(name: str) -> float:
    from torchsnapshot_tpu_torch import telemetry

    return sum(
        v for k, v in telemetry.metrics().counters_snapshot().items() if k.split("{")[0] == name
    )


def async_and_incremental(args, work_dir, card, cfg, state, tokens, train_step, sync_take_s, label="main") -> dict:
    """Main phase legs (a) async take, (b) incremental take, (c) async
    restore, on the trained state (the moe phase runs them too; ``label``
    names the phase in the log)."""
    import torch

    from torchsnapshot_tpu_torch import Snapshot
    from torchsnapshot_tpu_torch.models.transformer import init_train_state
    from torchsnapshot_tpu_torch.telemetry import names

    # (a) async_take with digests; a training step mutates every parameter
    # and moment in place while the snapshot drains. A step alone first, as
    # the yardstick of the one that overlaps the drain.
    torch.cuda.synchronize()
    t0 = time.monotonic()
    train_step(state, tokens)
    torch.cuda.current_stream().synchronize()
    step_alone_s = time.monotonic() - t0
    at_call = {k: v.clone() for k, v in _state_tensors(state).items()}
    path_a = os.path.join(work_dir, "async")
    t0 = time.monotonic()
    pending = Snapshot.async_take(path_a, {"train": state}, record_digests=True)
    visible_s = time.monotonic() - t0
    train_step(state, tokens)
    # The training stream's end; a device-wide synchronize would also wait
    # for the drain's copies.
    torch.cuda.current_stream().synchronize()
    step_during_drain_s = time.monotonic() - t0 - visible_s
    pending.wait(phase="staged")
    pending.wait()
    fresh = init_train_state(cfg, seed=args.seed + 2)
    Snapshot(path_a).restore({"train": fresh})
    torch.cuda.synchronize()
    _require_same_state(at_call, fresh, "async take")
    del at_call, fresh
    shutil.rmtree(path_a, ignore_errors=True)
    log(
        f"{label} (a): async_take visible {pending.visible_s:.4f} s (call {visible_s:.4f} s), "
        f"staged {pending.staged_s:.3f} s, committed {pending.committed_s:.3f} s after the call "
        f"(sync take {sync_take_s:.3f} s); a training step of {step_during_drain_s:.3f} s ran while "
        f"it drained (alone {step_alone_s:.3f} s); restored state bit-identical to the state at the call, on {card}"
    )

    # (b) Freeze the embedding and the first half of the layers (AdamW then
    # leaves their moments and step counters alone), take a digest base,
    # run a step, take incrementally: only what changed is copied and written.
    frozen = [state.model.embed] + [
        p for blk in state.model.layers[: cfg.n_layers // 2] for p in blk.parameters()
    ]
    for p in frozen:
        p.requires_grad_(False)
    path_b0, path_b1 = os.path.join(work_dir, "base"), os.path.join(work_dir, "incr")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot.take(path_b0, {"train": state}, record_digests=True)
    base_take_s = time.monotonic() - t0
    before_step = {k: v.clone() for k, v in _state_tensors(state).items()}
    train_step(state, tokens)
    trainable_bytes = sum(3 * p.numel() * p.element_size() for p in state.model.parameters() if p.requires_grad)
    changed_bytes = _changed_bytes(before_step, _state_tensors(state))
    del before_step
    d2h0, written0 = _counter(names.DEVICE_TO_HOST_BYTES_TOTAL), _counter(names.STORAGE_WRITE_BYTES_TOTAL)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot.take(path_b1, {"train": state}, incremental_base=path_b0)
    incr_take_s = time.monotonic() - t0
    d2h = _counter(names.DEVICE_TO_HOST_BYTES_TOTAL) - d2h0
    written_all = _counter(names.STORAGE_WRITE_BYTES_TOTAL) - written0
    written = _written_data_bytes(path_b1)
    _require(d2h == changed_bytes, f"incremental take copied {d2h} bytes to the host, {changed_bytes} changed")
    # Beyond the changed leaves only small CPU leaves (step counters, the
    # RNG state, pickled param groups) are written.
    _require(
        changed_bytes <= written <= changed_bytes + (1 << 20),
        f"incremental take wrote {written} data bytes, {changed_bytes} changed",
    )
    fresh_b = init_train_state(cfg, seed=args.seed + 3)
    Snapshot(path_b1).restore({"train": fresh_b})
    torch.cuda.synchronize()
    now = {k: v.clone() for k, v in _state_tensors(state).items()}
    _require_same_state(now, fresh_b, "incremental take")
    log(
        f"{label} (b): {len(frozen)} of {len(list(state.model.parameters()))} parameters frozen; "
        f"base take {base_take_s:.3f} s, incremental take {incr_take_s:.3f} s: {d2h / 1e6:.3f} MB "
        f"copied to the host and {written / 1e6:.3f} MB of data written ({written_all / 1e6:.3f} MB "
        f"with checksum table and commit marker) for {changed_bytes / 1e6:.3f} MB of chunks that "
        f"changed (trainable parameters and their moments {trainable_bytes / 1e6:.3f} MB; state {sum(v.numel() * v.element_size() for v in now.values()) / 1e9:.3f} GB); "
        f"restore bit-identical, on {card}"
    )

    # (c) async_restore into a fresh state; a forward pass runs before wait().
    fresh_c = init_train_state(cfg, seed=args.seed + 4)
    before = {k: v.clone() for k, v in _state_tensors(fresh_c).items()}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    pending_r = Snapshot(path_b1).async_restore({"train": fresh_c})
    restore_visible_s = time.monotonic() - t0
    with torch.no_grad():
        logits = fresh_c.model(tokens)
    torch.cuda.synchronize()
    _require(bool(torch.isfinite(logits).all()), "forward pass during async_restore not finite")
    while not pending_r.done():
        time.sleep(0.005)
    reads_s = time.monotonic() - t0
    _require_same_state(before, fresh_c, "live leaves before wait()")
    pending_r.wait()
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    _require_same_state(now, fresh_c, "async restore")
    log(
        f"{label} (c): async_restore visible {restore_visible_s:.4f} s, reads and placement done "
        f"{reads_s:.3f} s, applied {restore_s:.3f} s; live leaves untouched until wait() and "
        f"bit-identical after, on {card}"
    )

    _, loss_a = train_step(state, tokens)
    for p in fresh_b.model.parameters():
        p.requires_grad_(True)
    for p in [fresh_b.model.embed] + [
        p for blk in fresh_b.model.layers[: cfg.n_layers // 2] for p in blk.parameters()
    ]:
        p.requires_grad_(False)
    _, loss_b = train_step(fresh_b, tokens)
    torch.cuda.synchronize()
    _require(same_bits(loss_a, loss_b), f"next-step losses differ after the incremental restore: {loss_a} vs {loss_b}")
    for path in (path_b0, path_b1):
        shutil.rmtree(path, ignore_errors=True)
    return {
        "async_visible_s": pending.visible_s, "async_staged_s": pending.staged_s,
        "async_committed_s": pending.committed_s, "step_alone_s": step_alone_s,
        "step_during_drain_s": step_during_drain_s,
        "incremental_base_take_s": base_take_s, "incremental_take_s": incr_take_s,
        "incremental_changed_bytes": changed_bytes, "incremental_trainable_bytes": trainable_bytes,
        "incremental_d2h_bytes": d2h,
        "incremental_written_bytes": written, "async_restore_visible_s": restore_visible_s,
        "async_restore_reads_s": reads_s, "async_restore_s": restore_s,
    }


def profile_step(run):
    """Run ``run()`` once under torch.profiler (CPU and CUDA activities) and
    break the card's time down: the ten device operations that took the
    most time, the flash kernels' share, and the card's idle share of the
    profiled window (the host's span of the step, through its final
    synchronize). Returns ``run()``'s result and the breakdown, or None
    when the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    events = list(prof.events())
    # Work on the card: kernels, copies, sets; not the annotations that
    # span them (e.g. Optimizer.step), which would count their kernels twice.
    dev = [
        e for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
        and "annotation" not in str(getattr(e, "activity_type", "") or "")
    ]
    if not dev:
        log("profile: torch.profiler recorded no device time on this card; "
            "the step's breakdown is not measured")
        return out, None
    t0 = min(e.time_range.start for e in events)
    t1 = max(e.time_range.end for e in events)
    busy, covered_to = 0.0, float("-inf")  # length of the union of device spans
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        busy += max(0.0, b - max(a, covered_to))
        covered_to = max(covered_to, b)
    by_name = {}
    for e in dev:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.end - e.time_range.start, n + 1)
    device_us = sum(us for us, _ in by_name.values())
    flash_us = sum(us for name, (us, _) in by_name.items() if "flash_" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    record = {
        "window_ms": (t1 - t0) / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1 - busy / (t1 - t0),
        "device_op_ms": device_us / 1e3,
        "flash_ms": flash_us / 1e3,
        "flash_share_of_device_time": flash_us / device_us,
        "top10": [{"name": n[:160], "ms": us / 1e3, "calls": c} for n, (us, c) in top],
    }
    log(
        f"profile of one training step: window {record['window_ms']:.3f} ms, device busy "
        f"{record['device_busy_ms']:.3f} ms (idle share {record['device_idle_share']:.4f}); "
        f"flash kernels {record['flash_ms']:.3f} ms = "
        f"{record['flash_share_of_device_time']:.4f} of device op time"
    )
    for i, row in enumerate(record["top10"], 1):
        log(f"profile top{i}: {row['ms']:.3f} ms in {row['calls']} calls: {row['name']}")
    return out, record


BULK_BLOCK = (16384, 8192)
BULK_BLOCK_BYTES = BULK_BLOCK[0] * BULK_BLOCK[1] * 2


def bulk_state(seed: int, gib: float) -> dict:
    """bf16 blocks of (16384, 8192), ``gib`` GiB of them, plus a 64 Ki f32
    bias, shaped like bench.py's make_state, on the card from a seed."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    state = {
        f"w{i}": torch.randn(BULK_BLOCK, generator=g, device="cuda", dtype=torch.bfloat16)
        for i in range(max(1, int(gib * 2**30) // BULK_BLOCK_BYTES))
    }
    state["bias"] = torch.ones(65536, device="cuda")
    return state


def bulk_phase(args, work_dir: str, card: str) -> None:
    """Take and restore bf16 (16384, 8192) blocks shaped like bench.py's
    make_state, with a bitwise check."""
    import torch

    from torchsnapshot_tpu_torch import Snapshot, TensorTreeState
    from torchsnapshot_tpu_torch.scheduler import last_phase_timings, reset_phase_timings

    state = bulk_state(args.seed, args.bulk_gib)
    n_blocks = len(state) - 1
    free = shutil.disk_usage(work_dir).free
    _require(
        free > BULK_BLOCK_BYTES * n_blocks * 1.1,
        f"{work_dir} has {free / 2**30:.1f} GiB free; the bulk phase needs "
        f"{n_blocks * BULK_BLOCK_BYTES / 2**30:.1f} GiB",
    )
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    path = os.path.join(work_dir, "bulk")
    torch.cuda.synchronize()
    reset_phase_timings()
    t0 = time.monotonic()
    Snapshot.take(path, {"bulk": TensorTreeState(state)})
    take_s = time.monotonic() - t0
    phases = last_phase_timings()

    target = {k: torch.zeros_like(v) for k, v in state.items()}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot(path).restore({"bulk": TensorTreeState(target)})
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    phases.update(last_phase_timings())
    for k in state:
        _require(same_bits(state[k], target[k]), f"bulk block {k} differs after restore")
    del target
    shutil.rmtree(path, ignore_errors=True)

    # A digest-recording take, then an incremental take of the unchanged
    # state: every chunk is a ref, no data blob is written.
    path_d, path_i = os.path.join(work_dir, "bulk_digests"), os.path.join(work_dir, "bulk_incr")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot.take(path_d, {"bulk": TensorTreeState(state)}, record_digests=True)
    digest_take_s = time.monotonic() - t0
    t0 = time.monotonic()
    Snapshot.take(path_i, {"bulk": TensorTreeState(state)}, incremental_base=path_d)
    incr_take_s = time.monotonic() - t0
    _require(_written_data_bytes(path_i) == 0, "the incremental take of the unchanged bulk state wrote data")
    record = {
        "card": card, "bytes": nbytes, "blocks": n_blocks, "take_s": take_s,
        "restore_s": restore_s, "take_gb_s": nbytes / take_s / 1e9,
        "restore_gb_s": nbytes / restore_s / 1e9, "phases_s": phases,
        "digest_take_s": digest_take_s, "incremental_take_s": incr_take_s,
    }
    log(
        f"bulk: {nbytes / 2**30:.2f} GiB in {n_blocks} blocks: take {take_s:.3f} s "
        f"({record['take_gb_s']:.2f} GB/s), restore {restore_s:.3f} s "
        f"({record['restore_gb_s']:.2f} GB/s); digest-recording take {digest_take_s:.3f} s, "
        f"incremental take of the unchanged state {incr_take_s:.3f} s (no data written) on "
        f"{card}; bitwise equal"
    )
    _headline("bulk", gib=nbytes / 2**30, take_gb_s=record["take_gb_s"], restore_gb_s=record["restore_gb_s"],
              incremental_take_s=incr_take_s)
    print(json.dumps({"bulk": record}), flush=True)
    for p in (path_d, path_i):
        shutil.rmtree(p, ignore_errors=True)


def _data_locations(manifest) -> list:
    """A step's own data blobs (not refs into another step), by manifest
    location."""
    from torchsnapshot_tpu_torch.manifest import entry_locations

    return sorted({
        loc for entry in manifest.values() for loc in entry_locations(entry)
        if not loc.startswith("../") and type(entry).__name__ != "ObjectEntry"
    })


def _flipped_copy(step_dir: str, location: str, dest: str) -> None:
    """A copy of a committed step at ``dest`` (a sibling, so its ``../``
    refs resolve as the original's do): every file a symlink to the
    original except ``location``, a real copy with one byte flipped."""
    for d, _, files in os.walk(step_dir):
        rel_dir = os.path.relpath(d, step_dir)
        os.makedirs(os.path.join(dest, rel_dir), exist_ok=True)
        for f in files:
            rel = os.path.normpath(os.path.join(rel_dir, f))
            src, dst = os.path.join(step_dir, rel), os.path.join(dest, rel)
            if rel == os.path.normpath(location):
                shutil.copyfile(src, dst)
                with open(dst, "r+b") as fh:
                    fh.seek(os.path.getsize(dst) // 2)
                    byte = fh.read(1)
                    fh.seek(-1, os.SEEK_CUR)
                    fh.write(bytes([byte[0] ^ 0x01]))
            else:
                os.symlink(src, dst)


def _require_critical_paths(reports: list, what: str) -> list:
    """Each report's ``critical_path`` partitions its op's wall: the
    segments sum to the wall and cover at least ``MIN_COVERAGE`` of it.
    Returns ``(kind, rank, dominant, wall_s, segments)`` per report."""
    from torchsnapshot_tpu_torch.telemetry.critpath import MIN_COVERAGE

    out = []
    for r in reports:
        cp = r.get("critical_path")
        _require(cp is not None, f"{what}: the {r['kind']} report of rank {r.get('rank')} has no critical_path")
        total = sum(cp["segments"].values())
        _require(
            cp["coverage"] >= MIN_COVERAGE and abs(total - cp["wall_s"]) <= 1e-4 * max(1.0, cp["wall_s"])
            and cp["dominant"] in cp["segments"],
            f"{what}: the {r['kind']} report's critical path {cp}",
        )
        out.append((r["kind"], r.get("rank"), cp["dominant"], cp["wall_s"], cp["segments"]))
    return out


def _critpath_line(paths: list) -> str:
    return "; ".join(
        f"{kind}@rank{rank} {wall:.3f} s, dominant {dom}: "
        + ", ".join(f"{seg} {sec:.3f}" for seg, sec in segs.items())
        for kind, rank, dom, wall, segs in paths
    )


def _is_side_file(rel: str) -> bool:
    """A telemetry record that both packages write beside a snapshot or a
    manager root, not data: the report log, trace exports, progress
    heartbeats, the step history and the run ledger."""
    from torchsnapshot_tpu_torch.telemetry.history import HISTORY_BASENAME
    from torchsnapshot_tpu_torch.telemetry.ledger import LEDGER_BASENAME
    from torchsnapshot_tpu_torch.telemetry.progress import SNAPSHOT_PROGRESS_PREFIX
    from torchsnapshot_tpu_torch.telemetry.sink import SNAPSHOT_EVENTS_BASENAME
    from torchsnapshot_tpu_torch.telemetry.trace import SNAPSHOT_TRACE_PREFIX

    base = os.path.basename(rel)
    return base in (SNAPSHOT_EVENTS_BASENAME, HISTORY_BASENAME, LEDGER_BASENAME) or base.startswith(
        (SNAPSHOT_TRACE_PREFIX, SNAPSHOT_PROGRESS_PREFIX)
    )


# The record knobs at their defaults with the report and trace sinks on
# (set), and every record off (the second pass of the manager phase).
RECORDS_ON = ({"TORCHSNAPSHOT_TPU_TELEMETRY": "1", "TORCHSNAPSHOT_TPU_TRACE": "1"},
              ("TORCHSNAPSHOT_TPU_LEDGER", "TORCHSNAPSHOT_TPU_PROGRESS_SECONDS",
               "TORCHSNAPSHOT_TPU_HISTORY_MAX_RECORDS"))
RECORDS_OFF = ({"TORCHSNAPSHOT_TPU_LEDGER": "0", "TORCHSNAPSHOT_TPU_PROGRESS_SECONDS": "0",
                "TORCHSNAPSHOT_TPU_HISTORY_MAX_RECORDS": "0"},
               ("TORCHSNAPSHOT_TPU_TELEMETRY", "TORCHSNAPSHOT_TPU_TRACE"))
# Diagnosis at the JAX package's defaults (the stall watchdog at 60 s, the
# SLO engine on, bundle capture at 64 MiB), and off: the manager phase's
# loop runs with records and diagnosis on, off, and on again. The critical
# path has no switch (in either package): every report carries one.
DIAGNOSIS_ON = ({"TORCHSNAPSHOT_TPU_WATCHDOG_SECONDS": "60", "TORCHSNAPSHOT_TPU_SLO": "1",
                 "TORCHSNAPSHOT_TPU_BUNDLE_MAX_BYTES": str(64 << 20)}, ())
DIAGNOSIS_OFF = ({"TORCHSNAPSHOT_TPU_WATCHDOG_SECONDS": "0", "TORCHSNAPSHOT_TPU_SLO": "0",
                  "TORCHSNAPSHOT_TPU_BUNDLE_MAX_BYTES": "0"}, ())
# test_goodput.py's tolerance of the ledger's wall against a measured one.
GOODPUT_WALL_REL = 0.05


@contextlib.contextmanager
def _env(knobs_set: tuple):
    """The environment with ``knobs_set`` = (values to set, names to
    remove), restored after the block."""
    values, removed = knobs_set
    names = list(values) + list(removed)
    before = {k: os.environ.get(k) for k in names}
    os.environ.update(values)
    for k in removed:
        os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def manager_phase(args, work_dir: str, card: str) -> dict:
    """A training job's checkpoint loop on the main configuration, through
    ``CheckpointManager(keep_last_n=2, incremental=True)`` and a
    ``PreemptionSaver(ledger_root=)`` on SIGTERM, with every record on (the
    run ledger, progress heartbeats and the step history at their
    defaults, the report and trace sinks set): step 1 saved in full
    (recording digests); the embedding and layers 0-3 frozen; step 2 saved
    with ``async_save`` while step 3's update runs beside its drain; step 3
    saved in sync; SIGTERM sent after step 4's update, and step 4 saved on
    ``should_save``. Then the retained, pinned and deleted steps against
    the steps' refs, a deep fsck of every retained step and of a copy with
    one flipped byte, and ``restore_latest`` into a fresh state from
    another seed: bit-identical state, logits and next-step loss. Then the
    records: the ledger's events and their bytes against the bytes each
    take wrote, the dropped step's pruned record, the goodput attribution
    against the measured wall, the history's rows, each take's report, the
    heartbeats and a trace. The loop then runs on new roots with every
    record off and on again, for its seconds. Returns the first loop's
    launch counts."""
    import signal

    import torch

    from torchsnapshot_tpu_torch import CheckpointManager, PreemptionSaver, Snapshot
    from torchsnapshot_tpu_torch.fsck import blob_requirements, verify_snapshot
    from torchsnapshot_tpu_torch.manager import INDEX_BLOB, referenced_steps
    from torchsnapshot_tpu_torch.models.transformer import (
        init_train_state,
        make_train_step,
        random_tokens,
    )
    from torchsnapshot_tpu_torch.ops import device_digest as dd
    from torchsnapshot_tpu_torch.ops import flash_attention as fa
    from torchsnapshot_tpu_torch.snapshot import SNAPSHOT_METADATA_FNAME
    from torchsnapshot_tpu_torch.telemetry import goodput, history, ledger, names, progress
    from torchsnapshot_tpu_torch.telemetry.sink import load_events
    from torchsnapshot_tpu_torch.telemetry.trace import spans_from_chrome

    cfg = main_config()
    tokens = torch.from_numpy(random_tokens(cfg, 8, 1024, args.seed)).cuda()
    train_step = make_train_step(cfg)
    n_frozen = cfg.n_layers // 2

    def freeze(model) -> None:
        for p in [model.embed] + [p for blk in model.layers[:n_frozen] for p in blk.parameters()]:
            p.requires_grad_(False)

    def counters() -> tuple:
        return _counter(names.DEVICE_TO_HOST_BYTES_TOTAL), _counter(names.STORAGE_WRITE_BYTES_TOTAL)

    def run_loop(root: str, records: bool) -> dict:
        """The four saves on a fresh state; returns the manager, the state,
        each save's record, the step's seconds alone and beside the drain,
        the state saved at step 4 and the moment the manager was built. With ``records``, each take's report
        is held against the bytes it wrote."""
        state = init_train_state(cfg, seed=args.seed)
        app_state = {"train": state}
        opened = time.monotonic()  # the ledger's run starts here
        mgr = CheckpointManager(root, keep_last_n=2, incremental=True)
        captured, saves = {}, {}

        def record_save(step: int, seconds: float, before: tuple, at=None, **extra) -> None:
            """Bytes of the save of ``step``: copied to the host, written as
            data blobs, and the bytes of the chunks that changed since the
            previous save (``at``: the state saved, by default the state
            now); with records, the take's report (read before retention
            can drop the step) against them."""
            torch.cuda.synchronize()
            if at is None:
                at = {k: v.clone() for k, v in _state_tensors(state).items()}
            captured[step] = at
            d2h, written_all = (a - b for a, b in zip(counters(), before))
            rec = {
                "s": seconds, "d2h_bytes": d2h, "written_bytes": _written_data_bytes(mgr.step_path(step)),
                "written_all_bytes": written_all, **extra,
            }
            if step - 1 in captured:
                rec["changed_bytes"] = changed = _changed_bytes(captured.pop(step - 1), at)
                _require(d2h == changed, f"save {step} copied {d2h} bytes to the host, {changed} changed")
                _require(
                    changed <= rec["written_bytes"] <= changed + (1 << 20),
                    f"save {step} wrote {rec['written_bytes']} data bytes, {changed} changed",
                )
            if records:
                reports = [
                    e for e in load_events(os.path.join(mgr.step_path(step), ".telemetry.jsonl"))
                    if e["kind"] in ("take", "async_take")
                ]
                _require(len(reports) == 1, f"save {step}: {len(reports)} take reports")
                rec["critical_path"] = _require_critical_paths(reports, f"save {step}")[0]
                moved = rec["report_bytes_moved"] = reports[0]["bytes_moved"]
                # The report counts every blob the take wrote: the card's
                # bytes and the small host-side leaves beside them.
                _require(
                    moved == rec["written_bytes"] and d2h <= moved <= d2h + (1 << 20),
                    f"save {step}: the report moved {moved} bytes; {rec['written_bytes']} data bytes "
                    f"written, {d2h} copied to the host",
                )
            saves[step] = rec

        saver = PreemptionSaver(signals=(signal.SIGTERM,), ledger_root=root if records else None)
        try:
            state, _ = train_step(state, tokens)
            _require(not saver.should_save(1), "should_save(1) before any signal")
            before = counters()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            mgr.save(1, app_state)
            record_save(1, time.monotonic() - t0, before)
            freeze(state.model)

            state, _ = train_step(state, tokens)
            _require(not saver.should_save(2), "should_save(2) before any signal")
            torch.cuda.synchronize()
            at_2 = {k: v.clone() for k, v in _state_tensors(state).items()}
            before = counters()
            t0 = time.monotonic()
            pending = mgr.async_save(2, app_state)
            visible_s = time.monotonic() - t0
            # Step 3's update runs while step 2 drains; it ends at its own
            # stream's end (a device-wide synchronize would wait for the
            # drain).
            t1 = time.monotonic()
            state, _ = train_step(state, tokens)
            torch.cuda.current_stream().synchronize()
            step_beside_drain_s = time.monotonic() - t1
            pending.wait()
            # To wait()'s return: the commit, then the index update and GC.
            waited_s = time.monotonic() - t0
            record_save(
                2, waited_s, before, at=at_2, visible_s=visible_s, staged_s=pending.staged_s,
                committed_s=pending.committed_s,
            )
            del at_2

            _require(not saver.should_save(3), "should_save(3) before any signal")
            before = counters()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            mgr.save(3, app_state)
            record_save(3, time.monotonic() - t0, before)

            torch.cuda.synchronize()
            t0 = time.monotonic()
            state, _ = train_step(state, tokens)
            torch.cuda.current_stream().synchronize()
            step_alone_s = time.monotonic() - t0
            os.kill(os.getpid(), signal.SIGTERM)
            _require(saver.preempted and saver.should_save(4), "SIGTERM after step 4 did not make should_save(4) true")
            before = counters()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            mgr.save(4, app_state)
            record_save(4, time.monotonic() - t0, before)
            _require(saver.exit_after_save and not saver.should_save(5), "the saver asked for a second save")
        finally:
            saver.close()
        return {"mgr": mgr, "state": state, "saves": saves, "at_4": captured.pop(4), "opened": opened,
                "step_alone_s": step_alone_s, "step_beside_drain_s": step_beside_drain_s}

    # The first loop, every record on; the heartbeats' trackers are kept.
    root = os.path.join(work_dir, "managed")
    trackers = []
    real_track = progress.track

    def tracking(kind: str, path: str, rank: int):
        trackers.append(real_track(kind, path, rank))
        return trackers[-1]

    fa.reset_launch_counts()
    dd.reset_launch_counts()
    progress.track = tracking
    try:
        with _env(RECORDS_ON), _env(DIAGNOSIS_ON):
            loop = run_loop(root, records=True)
            mgr, state, saves, at_4 = loop["mgr"], loop["state"], loop["saves"], loop["at_4"]

            # Retention: the newest two steps are visible; a dropped step is
            # pinned exactly when a retained step's manifest references it,
            # and deleted (commit marker and every blob) otherwise.
            retained = mgr.all_steps()
            _require(retained == [3, 4], f"retained steps {retained}, expected [3, 4]")
            refs = {s: sorted(referenced_steps(Snapshot(mgr.step_path(s)).metadata.manifest)) for s in retained}
            pinned = sorted({r for rs in refs.values() for r in rs} - set(retained))
            deleted = sorted({1, 2} - set(pinned))
            with open(os.path.join(root, INDEX_BLOB)) as f:
                index_pins = json.load(f).get("pinned", [])
            _require(index_pins == pinned, f"the index pins {index_pins}; the refs {refs} need {pinned}")
            for s in pinned:
                _require(
                    os.path.exists(os.path.join(mgr.step_path(s), SNAPSHOT_METADATA_FNAME)),
                    f"pinned step {s} lost its commit marker",
                )
            for s in deleted:
                # Neither package's GC removes a step's trace exports.
                left = [f for _, _, fs in os.walk(mgr.step_path(s)) for f in fs if not _is_side_file(f)]
                _require(not left, f"deleted step {s} left files behind: {left[:5]}")

            # Deep fsck of every retained step, through the refs into pinned
            # steps; then of a copy of step 4 with one byte of one of its own
            # blobs flipped.
            fsck_records = {}
            for s in retained:
                t0 = time.monotonic()
                report = verify_snapshot(mgr.step_path(s), deep=True)
                seconds = time.monotonic() - t0
                _require(report.ok, f"deep fsck of step {s}: {report.problems[:5]}")
                _require(report.crcs_verified == report.blobs_checked,
                         f"deep fsck of step {s} verified a blob by length only")
                fsck_records[s] = {
                    "s": seconds, "bytes": report.bytes_verified, "blobs": report.blobs_checked,
                    "gb_s": report.bytes_verified / seconds / 1e9,
                }
            manifest_4 = Snapshot(mgr.step_path(4)).metadata.manifest
            own = _data_locations(manifest_4)
            target = min(own, key=lambda loc: (os.path.getsize(os.path.join(mgr.step_path(4), loc)) < 4096, loc))
            flipped = os.path.join(root, "step_flipped")
            _flipped_copy(mgr.step_path(4), target, flipped)
            problems = [(p.kind, p.location) for p in verify_snapshot(flipped, deep=True).problems]
            _require(problems == [("checksum", target)], f"deep fsck of the flipped copy reported {problems}")
            shutil.rmtree(flipped)

            # restore_latest into a fresh state from another seed.
            fresh = init_train_state(cfg, seed=args.seed + 1)
            _require(not same_bits(fresh.model.embed, state.model.embed), "fresh model equals the trained one")
            state_bytes = sum(v.numel() * v.element_size() for v in at_4.values())
            torch.cuda.synchronize()
            t0 = time.monotonic()
            step = mgr.restore_latest({"train": fresh})
            torch.cuda.synchronize()
            restore_s = time.monotonic() - t0
            measured_wall_s = time.monotonic() - loop["opened"]
    finally:
        progress.track = real_track
    _require(step == 4, f"restore_latest returned {step}")
    _require_same_state(at_4, fresh, "restore_latest")
    del at_4
    with torch.no_grad():
        logits_a = state.model(tokens)
        logits_b = fresh.model(tokens)
    torch.cuda.synchronize()
    _require(bool(torch.isfinite(logits_a).all()), "evaluation logits not finite")
    _require(same_bits(logits_a, logits_b), "evaluation logits differ after restore_latest")
    del logits_a, logits_b
    freeze(fresh.model)
    _, loss_a = train_step(state, tokens)
    _, loss_b = train_step(fresh, tokens)
    torch.cuda.synchronize()
    _require(same_bits(loss_a, loss_b), f"next-step losses differ after restore_latest: {loss_a} vs {loss_b}")
    launches = {**fa.launch_counts, **dd.launch_counts}
    _require(
        all(launches[name] for name in MAIN_PATH_KERNELS),
        f"a kernel of the path never launched in the manager phase: {launches}",
    )

    # The records of the first loop. The ledger: one run, a committed
    # record per save but the deleted step's (pruned), its GC, a stall per
    # take and the drain of the async one, each with the bytes the take
    # wrote, the preemption at step 4, and the restore with the bytes of
    # step 4's blobs.
    events = ledger.load_ledger(os.path.join(root, ledger.LEDGER_BASENAME))

    def of(event: str) -> list:
        return [r for r in events if r["event"] == event]

    _require(len(of(names.EVENT_RUN_START)) == 1, f"{len(of(names.EVENT_RUN_START))} run-start events")
    committed = [r["step"] for r in of(names.EVENT_STEP_COMMITTED)]
    _require(committed == sorted({1, 2, 3, 4} - set(deleted)),
             f"step-committed for steps {committed}; GC deleted {deleted}")
    _require([r["step"] for r in of(names.EVENT_GC_RECLAIMED)] == deleted,
             f"gc-reclaimed for {[r['step'] for r in of(names.EVENT_GC_RECLAIMED)]}, deleted {deleted}")
    stalls = {r["step"]: r["nbytes"] for r in of(names.EVENT_VISIBLE_STALL)}
    _require(stalls == {s: rec["written_bytes"] for s, rec in saves.items()},
             f"visible-stall bytes {stalls}; the takes wrote {[rec['written_bytes'] for rec in saves.values()]}")
    drains = [(r["step"], r["nbytes"]) for r in of(names.EVENT_STAGED_DRAIN)]
    _require(drains == [(2, saves[2]["written_bytes"])], f"staged-drain events {drains}")
    preempt = [(r["step"], r["target_step"]) for r in of(names.EVENT_PREEMPTION)]
    _require(preempt == [(4, 4)], f"preemption events {preempt}")
    restore_bytes = sum(
        os.path.getsize(os.path.normpath(os.path.join(mgr.step_path(4), loc))) for loc in blob_requirements(manifest_4)
    )
    served = [(r["step"], r["nbytes"]) for r in of(names.EVENT_RESTORE_SERVED)]
    _require(served == [(4, restore_bytes)] and restore_bytes >= state_bytes,
             f"restore-served {served}; step 4's blobs hold {restore_bytes} bytes")
    # Goodput: the buckets sum to the ledger's wall, and that wall is the
    # measured one (the tolerance of test_goodput.py).
    run = goodput.latest_run(goodput.analyze_root(root))
    buckets = run["train_s"] + run["visible_stall_s"] + run["restore_s"] + run["lost_work_s"]
    _require(abs(buckets - run["wall_s"]) <= max(1e-3, 1e-6 * run["wall_s"]),
             f"goodput buckets sum to {buckets} s, the ledger's wall is {run['wall_s']} s")
    _require(abs(run["wall_s"] - measured_wall_s) <= GOODPUT_WALL_REL * measured_wall_s,
             f"the ledger's wall {run['wall_s']} s, measured {measured_wall_s} s")
    # The history: a row per save and one for the restore.
    rows = [(r["kind"], r["step"]) for r in history.load_history(os.path.join(root, history.HISTORY_BASENAME))]
    _require(rows == [("take", 1), ("async_take", 2), ("take", 3), ("take", 4), ("restore", 4)],
             f"history rows {rows}")
    # Heartbeats: every op wrote one, ended done in its last phase, and
    # removed it; the deleted step's went with it.
    beats = [(t.kind, t.snapshot()["terminal"], t.snapshot()["phase"], t._file) for t in trackers]
    _require(len(beats) == 5 and all(
        f is not None and term == "done" and ph in ("committing", "applying") and not os.path.exists(f)
        for _, term, ph, f in beats
    ), f"heartbeats {beats}")
    # The step-3 take's trace parses and holds the take's envelope.
    with open(os.path.join(mgr.step_path(3), ".trace-take-rank0.json")) as f:
        spans = {s["name"] for s in spans_from_chrome(json.load(f))}
    _require(names.SPAN_TAKE in spans, f"the step-3 trace holds {sorted(spans)}")
    records_on = {s: rec["s"] for s, rec in saves.items()}
    del state, fresh
    torch.cuda.empty_cache()

    def slo_breaches(turn_root: str) -> list:
        """The turn's slo-breach events (with diagnosis on, the SLO engine
        judges every commit at the default budgets)."""
        return [(r["objective"], r["step"]) for r in events_of(turn_root) if r["event"] == names.EVENT_SLO_BREACH]

    def events_of(turn_root: str) -> list:
        path = os.path.join(turn_root, ledger.LEDGER_BASENAME)
        return ledger.load_ledger(path) if os.path.exists(path) else []

    # The same loop with every record off, then on again, for their
    # seconds: the turns on, off, on keep a warm-up from passing as the
    # records' cost.
    turns = {"on": {"saves_s": records_on, "step_alone_s": loop["step_alone_s"],
                    "step_beside_drain_s": loop["step_beside_drain_s"], "slo_breaches": slo_breaches(root)}}
    for name, knobs_set, diagnosis, records in (
        ("off", RECORDS_OFF, DIAGNOSIS_OFF, False), ("on_again", RECORDS_ON, DIAGNOSIS_ON, True),
    ):
        turn_root = os.path.join(work_dir, f"managed_{name}")
        with _env(knobs_set), _env(diagnosis):
            again = run_loop(turn_root, records=records)
        if not records:
            side = [os.path.relpath(os.path.join(d, f), turn_root) for d, _, fs in os.walk(turn_root) for f in fs
                    if _is_side_file(f)]
            _require(not side, f"the loop with every record off wrote {side[:5]}")
        turns[name] = {"saves_s": {s: rec["s"] for s, rec in again["saves"].items()},
                       "step_alone_s": again["step_alone_s"], "step_beside_drain_s": again["step_beside_drain_s"],
                       "slo_breaches": slo_breaches(turn_root)}
        del again
        torch.cuda.empty_cache()
    _require(not turns["off"]["slo_breaches"], f"the SLO engine judged with diagnosis off: {turns['off']}")

    diagnosis = diagnosis_legs(args, work_dir, card, cfg, tokens, train_step)

    record = {
        "card": card, "saves": saves, "step_alone_s": loop["step_alone_s"],
        "step_beside_drain_s": loop["step_beside_drain_s"], "restore_latest_s": restore_s,
        "restore_latest_gb_s": state_bytes / restore_s / 1e9, "state_bytes": state_bytes,
        "fsck_deep": fsck_records, "flipped": target, "retained": retained, "refs": refs,
        "pinned": pinned, "deleted": deleted, "next_loss": float(loss_a), "launches": launches,
        "ledger_events": len(events), "goodput": {k: run[k] for k in (
            "wall_s", "train_s", "visible_stall_s", "restore_s", "lost_work_s", "overhead_fraction",
            "staged_drain_s")},
        "measured_wall_s": measured_wall_s, "turns": turns, "diagnosis": diagnosis,
    }
    for s, rec in saves.items():
        log(
            f"manager: save {s} {rec['s']:.3f} s"
            + (
                f" to wait()'s return (call {rec['visible_s']:.4f} s, staged {rec['staged_s']:.3f} s, "
                f"committed {rec['committed_s']:.3f} s)" if "visible_s" in rec else ""
            )
            + f": {rec['d2h_bytes'] / 1e6:.3f} MB copied to the host, {rec['written_bytes'] / 1e6:.3f} MB "
            f"of data written (the report: {rec['report_bytes_moved'] / 1e6:.3f} MB)"
            + (f", {rec['changed_bytes'] / 1e6:.3f} MB of chunks changed" if "changed_bytes" in rec else "")
        )
    log(
        f"manager: step alone {loop['step_alone_s']:.3f} s, beside the async drain "
        f"{loop['step_beside_drain_s']:.3f} s; retained {retained}, refs {refs}, pinned {pinned}, "
        f"deleted {deleted}; deep fsck "
        + ", ".join(f"step {s} {r['s']:.3f} s ({r['gb_s']:.2f} GB/s)" for s, r in fsck_records.items())
        + f", flip in {target} caught; restore_latest {restore_s:.3f} s "
        f"({record['restore_latest_gb_s']:.2f} GB/s) bit-identical, logits and next-step loss "
        f"{float(loss_a)!r} too; launches {launches}; on {card}"
    )
    log(
        f"manager records: {len(events)} ledger events; goodput wall {run['wall_s']:.3f} s (measured "
        f"{measured_wall_s:.3f} s): train {run['train_s']:.3f}, visible stall {run['visible_stall_s']:.3f}, "
        f"restore {run['restore_s']:.3f}, lost {run['lost_work_s']:.3f}, overhead "
        f"{run['overhead_fraction']:.4f}; {len(rows)} history rows, {len(beats)} heartbeats settled"
    )
    log("manager critical paths: " + _critpath_line([rec["critical_path"] for rec in saves.values()]))
    order = ("on", "off", "on_again")
    log("manager slo-breach events with diagnosis on / off / on: "
        + " / ".join(str(turns[t]["slo_breaches"]) for t in order))
    log(
        "manager records and diagnosis on / off / on: saves "
        + ", ".join(f"{s}: " + " / ".join(f"{turns[t]['saves_s'][s]:.3f}" for t in order) + " s" for s in records_on)
        + "; step alone " + " / ".join(f"{turns[t]['step_alone_s']:.3f}" for t in order)
        + " s, beside the drain " + " / ".join(f"{turns[t]['step_beside_drain_s']:.3f}" for t in order) + " s"
    )
    _headline("manager", step_alone_s=loop["step_alone_s"], step_beside_drain_s=loop["step_beside_drain_s"],
              restore_latest_s=restore_s, retained=retained, ledger_events=len(events),
              drain_step_on_off_on_s=[turns[t]["step_beside_drain_s"] for t in ("on", "off", "on_again")])
    print(json.dumps({"manager": record}), flush=True)
    return launches


# The watchdog leg's deadline and the storage write the chaos engine
# delays past it.
WATCHDOG_DEADLINE_S = 1.0
WATCHDOG_DELAY_S = 3.0
# The autotuner leg's saves, and the knob it must leave alone (pinned in
# the environment at its default).
TUNER_SAVES = 6
TUNER_PINNED = ("TORCHSNAPSHOT_TPU_STAGING_THREADS", "staging_threads", "4")


def diagnosis_legs(args, work_dir: str, card: str, cfg, tokens, train_step) -> dict:
    """The manager phase's diagnosis and control legs, each on a new root
    with the run ledger on and a fresh state of the main configuration:
    (w) a managed take whose one storage write the chaos engine delays
    3 s past a 1 s watchdog deadline: ``watchdog_stalls_total`` rises by
    exactly 1, the take's trace holds one ``watchdog:stall`` instant, one
    ``watchdog-stall`` bundle is captured, and the step restores
    bit-identical; (s) three saves with the async-visible budget below
    what the card measures (and the overhead objective off): exactly one
    ``slo-breach`` event and one ``slo-breach`` bundle, and the doctor on
    the root names ``slo-burning``; (t) six saves with the autotuner on
    and staging threads pinned in the environment: each decision logged,
    every value within its tunable's bounds, the pinned knob never moved,
    and ``restore_latest`` bit-identical under the last vector; (d) the
    ``doctor`` and ``stats`` CLIs on (s)'s root. Returns the legs' record."""
    import subprocess

    import torch

    from torchsnapshot_tpu_torch import CheckpointManager, knobs
    from torchsnapshot_tpu_torch.chaos import ChaosEngine, FaultPlan, FaultSpec, chaotic_plugin_type
    from torchsnapshot_tpu_torch.models.transformer import init_train_state
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
    from torchsnapshot_tpu_torch.telemetry import bundle, doctor, ledger, names, slo
    from torchsnapshot_tpu_torch.test_utils import patch_storage_plugin
    from torchsnapshot_tpu_torch.tuner import TUNABLES, load_state

    def trained(seed_shift: int = 0):
        st = init_train_state(cfg, seed=args.seed + seed_shift)
        st, _ = train_step(st, tokens)
        torch.cuda.synchronize()
        return st

    def capture(st) -> dict:
        torch.cuda.synchronize()
        return {k: v.clone() for k, v in _state_tensors(st).items()}

    def events(root: str, event: str) -> list:
        return [r for r in ledger.load_ledger(ledger.ledger_path_for(root)) if r["event"] == event]

    record = {}
    bundle_on = {"TORCHSNAPSHOT_TPU_BUNDLE_MAX_BYTES": str(64 << 20)}

    # (w) The stall watchdog. The watchdog captures its bundle at the
    # first root this process opened a ledger at: this one.
    root_w = os.path.join(work_dir, "diag_watchdog")
    ledger.reset_owned_roots()
    state = trained()
    at = capture(state)
    engine = ChaosEngine(FaultPlan(seed=args.seed, faults=[
        FaultSpec(point="storage-write", mode="delay", match="0/train/", times=1, delay_s=WATCHDOG_DELAY_S),
    ]))
    stalls_before = _counter(names.WATCHDOG_STALLS_TOTAL)
    with _env(({"TORCHSNAPSHOT_TPU_WATCHDOG_SECONDS": str(WATCHDOG_DEADLINE_S), "TORCHSNAPSHOT_TPU_TRACE": "1",
                **bundle_on}, ())):
        mgr = CheckpointManager(root_w, keep_last_n=2)
        with patch_storage_plugin(chaotic_plugin_type(FSStoragePlugin, engine)):
            t0 = time.monotonic()
            mgr.save(1, {"train": state})
            take_s = time.monotonic() - t0
        time.sleep(WATCHDOG_DEADLINE_S)  # four more scans, which must stay quiet
    stalls = _counter(names.WATCHDOG_STALLS_TOTAL) - stalls_before
    _require(engine.fired and engine.fired[0][2] == "delay", f"the chaos engine fired {engine.fired}")
    _require(stalls == 1, f"watchdog_stalls_total rose by {stalls} over one stalled take")
    with open(os.path.join(mgr.step_path(1), ".trace-take-rank0.json")) as f:
        instants = [e for e in json.load(f)["traceEvents"]
                    if e["ph"] == "i" and e["name"] == names.INSTANT_WATCHDOG_STALL]
    _require(len(instants) == 1, f"the take's trace holds {len(instants)} watchdog:stall instants")
    bundles_w = bundle.list_bundles(root_w)
    _require([b["trigger"] for b in bundles_w] == ["watchdog-stall"]
             and instants[0]["args"]["bundle"] == bundles_w[0]["path"], f"watchdog bundles {bundles_w}")
    fresh = init_train_state(cfg, seed=args.seed + 1)
    _require(mgr.restore_latest({"train": fresh}) == 1, "restore_latest of the stalled take")
    _require_same_state(at, fresh, "the stalled take's restore")
    stall = instants[0]["args"]
    record["watchdog"] = {
        "take_s": take_s, "stalls": stalls, "span": stall["span"], "age_s": stall["age_s"],
        "idle_s": stall["idle_s"], "gating_segment": stall["gating_segment"], "bundle_files": bundles_w[0]["files"],
        "bundle_bytes": bundles_w[0]["bytes"],
    }
    log(f"manager diagnosis (w): one write delayed {WATCHDOG_DELAY_S} s past a {WATCHDOG_DEADLINE_S} s deadline; "
        f"the take {take_s:.3f} s, {stalls:.0f} stall on span {stall['span']} open {stall['age_s']} s (idle "
        f"{stall['idle_s']} s, segment {stall['gating_segment']}), bundle of {bundles_w[0]['files']} files "
        f"{bundles_w[0]['bytes']} bytes; restored bit-identical")
    del state, fresh, at
    torch.cuda.empty_cache()

    # (s) The SLO engine: every take's visible span is a bad sample of
    # take-visible-stall; the overhead objective is off, so that exactly
    # one objective burns.
    root_s = os.path.join(work_dir, "diag_slo")
    slo_env = ({"TORCHSNAPSHOT_TPU_SLO": "1", "TORCHSNAPSHOT_TPU_TELEMETRY": "1",
                "TORCHSNAPSHOT_TPU_ASYNC_VISIBLE_BUDGET_SECONDS": "0.0001",
                "TORCHSNAPSHOT_TPU_SLO_OVERHEAD_FRACTION": "0", **bundle_on}, ())
    state = trained()
    saves_s = []
    with _env(slo_env):
        mgr = CheckpointManager(root_s, keep_last_n=2)
        for step in (1, 2, 3):
            state, _ = train_step(state, tokens)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            if step == 2:
                mgr.async_save(step, {"train": state}).wait()
            else:
                mgr.save(step, {"train": state})
            saves_s.append(time.monotonic() - t0)
        breaches = [(r["objective"], r["step"]) for r in events(root_s, names.EVENT_SLO_BREACH)]
        judged = slo.evaluate_root(root_s)
        verdicts = doctor.diagnose_snapshot(root_s)
    _require(breaches == [(names.SLO_TAKE_VISIBLE_STALL, 1)], f"slo-breach events {breaches}")
    _require(judged["breaching"] == [names.SLO_TAKE_VISIBLE_STALL], f"the SLO judgment {judged['breaching']}")
    bundles_s = bundle.list_bundles(root_s)
    _require([b["trigger"] for b in bundles_s] == ["slo-breach"], f"SLO bundles {bundles_s}")
    _require(names.RULE_SLO_BURNING in {v.rule for v in verdicts},
             f"the doctor on the root: {[v.rule for v in verdicts]}")
    burn = next(o for o in judged["objectives"] if o["objective"] == names.SLO_TAKE_VISIBLE_STALL)
    record["slo"] = {"saves_s": saves_s, "breaches": breaches, "burn_rate": burn["burn_rate"],
                     "last_visible_s": burn["last_value"], "verdicts": sorted({v.rule for v in verdicts})}
    log(f"manager diagnosis (s): saves {', '.join(f'{x:.3f}' for x in saves_s)} s; breaches {breaches}; "
        f"take-visible-stall burn {burn['burn_rate']} (last visible {burn['last_value']} s against 0.0001 s); "
        f"one bundle; doctor verdicts {record['slo']['verdicts']}")
    del state
    torch.cuda.empty_cache()

    # (d) The telemetry CLI on (s)'s root, as an operator runs it; the two
    # processes run side by side (each spends seconds importing torch).
    cli = {}
    env = dict(os.environ, **slo_env[0])
    t0 = time.monotonic()
    procs = {
        argv[0]: subprocess.Popen([sys.executable, "-m", "torchsnapshot_tpu_torch.telemetry", *argv], cwd=HERE,
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for argv in (["doctor", root_s], ["stats", os.path.join(root_s, "step_0000000003", ".telemetry.jsonl")])
    }
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=120)
        cli[name] = {"rc": proc.returncode, "s": time.monotonic() - t0}
        for line in out.splitlines():
            log(f"telemetry {name}: {line}")
        _require(proc.returncode == (2 if name == "doctor" else 0),
                 f"telemetry {name} exited {proc.returncode}: {err[-2000:]}")
        _require(name != "doctor" or names.RULE_SLO_BURNING in out, "the doctor CLI did not name slo-burning")
    record["cli"] = cli

    # (t) The autotuner, with staging threads pinned in the environment.
    root_t = os.path.join(work_dir, "diag_tuner")
    env_name, pinned, pinned_value = TUNER_PINNED
    state = trained()
    tuner_saves = []
    with _env(({env_name: pinned_value}, ())), knobs.enable_autotune():
        mgr = CheckpointManager(root_t, keep_last_n=2)
        for step in range(1, TUNER_SAVES + 1):
            state, _ = train_step(state, tokens)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            mgr.save(step, {"train": state})
            seconds = time.monotonic() - t0
            d = load_state(root_t).decisions[-1]
            tuner_saves.append({"step": step, "s": seconds, **{
                k: d["decision"].get(k) for k in ("action", "tunable", "from_value", "to_value", "reason")}})
            for name, value in d["vector"].items():
                t = TUNABLES[name]
                _require(t.lo <= value <= t.hi, f"step {step}: {name} = {value} outside [{t.lo}, {t.hi}]")
            _require(knobs.tunable_snapshot()[pinned] == int(pinned_value) and env_name not in
                     knobs.get_tuner_overrides(), f"step {step}: the pinned {pinned} moved")
        at = capture(state)
        vector = dict(load_state(root_t).vector)
        fresh = init_train_state(cfg, seed=args.seed + 1)
        t0 = time.monotonic()
        _require(mgr.restore_latest({"train": fresh}) == TUNER_SAVES, "restore_latest under the tuned vector")
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        _require_same_state(at, fresh, "restore_latest under the tuned vector")
    _require(all(s["tunable"] != pinned for s in tuner_saves), f"a decision moved the pinned {pinned}")
    _require(not knobs.get_tuner_overrides(), "tuner overrides outlived the leg")
    record["tuner"] = {"saves": tuner_saves, "vector": vector, "restore_latest_s": restore_s}
    for s_ in tuner_saves:
        log(f"manager diagnosis (t): save {s_['step']} {s_['s']:.3f} s, then {s_['action']} {s_['tunable'] or ''} "
            f"{s_['from_value']} -> {s_['to_value']} ({s_['reason']})")
    log(f"manager diagnosis (t): last vector {vector}; restore_latest {restore_s:.3f} s bit-identical; "
        f"{pinned} held at {pinned_value}; on {card}")
    del state, fresh, at
    torch.cuda.empty_cache()
    return record


# ---------------------------------------------------------------------------
# cas: the managed loop over the content-addressed chunk store
# ---------------------------------------------------------------------------


def _tensor_blob_keys(tensors: dict, record_digests: bool) -> list:
    """The chunk key and size of every tensor blob a take of ``tensors``
    writes, cut as the take cuts them (digest-recording takes chunk at the
    incremental chunk size): the state's own bytes, hashed on the host."""
    import torch

    from torchsnapshot_tpu_torch.cas import digest_key
    from torchsnapshot_tpu_torch.integrity import compute_checksum_entry
    from torchsnapshot_tpu_torch.io_preparer import (
        ChunkedArrayIOPreparer,
        chunk_shapes,
        effective_max_chunk_size_bytes,
    )

    out = []
    incremental = True if record_digests else None
    for t in tensors.values():
        if ChunkedArrayIOPreparer.should_chunk(t, incremental):
            size = effective_max_chunk_size_bytes(incremental)
            pieces = [t[s:e] for s, e in chunk_shapes(list(t.shape), t.element_size(), size)]
        else:
            pieces = [t]
        for p in pieces:
            host = p.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
            out.append((digest_key(compute_checksum_entry(memoryview(host))), host.nbytes))
    return out


def _object_blob_keys(manifest) -> list:
    """Chunk key and size of each pickled-object blob of a CAS manifest."""
    from torchsnapshot_tpu_torch.cas import key_of_location, nbytes_of_key

    return [
        (key_of_location(e.location), nbytes_of_key(key_of_location(e.location)))
        for e in manifest.values()
        if type(e).__name__ == "ObjectEntry"
    ]


def _store_bytes(root: str) -> dict:
    from torchsnapshot_tpu_torch.cas import CASStore

    return CASStore(root).list_chunks()


def cas_phase(args, work_dir: str, card: str) -> dict:
    """The main configuration's checkpoint loop on a chunk store
    (``TORCHSNAPSHOT_TPU_CAS=1``, grace window 0) through
    ``CheckpointManager(keep_last_n=2)``: step 1 a full save recording
    digests; the embedding and layers 0-3 frozen; a step, then step 2 a
    full save recording digests; a step, then step 3 incremental; step 4 an
    ``async_save`` with the batcher and the device pack, a step beside its
    drain. Checks each save's bytes against the state (copied to the host,
    written to and deduped by the store), the slabs as chunks, the chunks
    retention reclaims, a deep ``fsck --cas`` (and a flipped byte in a
    copy), and a fresh manager's reconcile and ``restore_latest``:
    bit-identical tensors, logits and next-step loss. Returns the phase's
    launch counts."""
    import torch

    from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, knobs
    from torchsnapshot_tpu_torch.cas import CASStore, chunk_refs, is_chunk_location
    from torchsnapshot_tpu_torch.flatten import flatten
    from torchsnapshot_tpu_torch.fsck import verify_cas_store
    from torchsnapshot_tpu_torch.manager import referenced_steps
    from torchsnapshot_tpu_torch.manifest import entry_locations
    from torchsnapshot_tpu_torch.models.transformer import (
        init_train_state,
        make_train_step,
        random_tokens,
    )
    from torchsnapshot_tpu_torch.ops import device_digest as dd
    from torchsnapshot_tpu_torch.ops import device_pack as dp
    from torchsnapshot_tpu_torch.ops import flash_attention as fa
    from torchsnapshot_tpu_torch.telemetry import names

    cfg = main_config()
    tokens = torch.from_numpy(random_tokens(cfg, 8, 1024, args.seed)).cuda()
    state = init_train_state(cfg, seed=args.seed)
    train_step = make_train_step(cfg)
    app_state = {"train": state}
    root = os.path.join(work_dir, "cas")
    n_frozen = cfg.n_layers // 2

    def freeze(model) -> None:
        for p in [model.embed] + [p for blk in model.layers[:n_frozen] for p in blk.parameters()]:
            p.requires_grad_(False)

    counter_names = (
        names.DEVICE_TO_HOST_BYTES_TOTAL, names.CAS_BYTES_WRITTEN_TOTAL, names.CAS_BYTES_DEDUPED_TOTAL,
        names.CAS_BYTES_RECLAIMED_TOTAL,
    )

    def counters() -> dict:
        return {n: _counter(n) for n in counter_names}

    def delta(before: dict) -> dict:
        now = counters()
        return {n: now[n] - before[n] for n in counter_names}

    def capture() -> dict:
        torch.cuda.synchronize()
        return {k: v.clone() for k, v in _state_tensors(state).items()}

    saves, refs, dense = {}, {}, {}

    def after_save(step: int, seconds: float, before: dict, blobs=None, **extra) -> dict:
        """Record a save: its counters, its chunk refs, the store's bytes
        against the dense bytes of the retained steps; with ``blobs`` (the
        take's blob keys from the state) the bytes it had to write are the
        blobs new to the store before it."""
        d = delta(before)
        manifest = Snapshot(mgr.step_path(step)).metadata.manifest
        refs[step] = chunk_refs(manifest)
        rec = {
            "s": seconds, "d2h_bytes": d[names.DEVICE_TO_HOST_BYTES_TOTAL],
            "written_bytes": d[names.CAS_BYTES_WRITTEN_TOTAL], "deduped_bytes": d[names.CAS_BYTES_DEDUPED_TOTAL],
            "reclaimed_bytes": d[names.CAS_BYTES_RECLAIMED_TOTAL], **extra,
        }
        if blobs is not None:
            blobs = blobs + _object_blob_keys(manifest)
            dense[step] = sum(n for _, n in blobs)
            new = {k: n for k, n in blobs if k not in stored_before}
            rec["expected_written_bytes"] = sum(new.values())
            _require(set(refs[step]) == {k for k, _ in blobs}, f"save {step}: the manifest's chunks are not the state's blobs")
            _require(
                rec["written_bytes"] == rec["expected_written_bytes"],
                f"save {step} wrote {rec['written_bytes']} bytes to the store; its blobs new to the store hold "
                f"{rec['expected_written_bytes']}",
            )
        else:
            dense[step] = sum(refs[step].values())
        store = _store_bytes(root)
        rec["store_bytes"] = sum(store.values())
        rec["dense_retained_bytes"] = sum(dense[s] for s in mgr.all_steps())
        saves[step] = rec
        return rec

    for counts in (fa.launch_counts, dd.launch_counts, dp.launch_counts):
        for k in counts:
            counts[k] = 0
    state, _ = train_step(state, tokens)
    at = capture()
    # Legacy and CAS takes of the same state, each into a new root, in
    # turns: the cost of addressing every byte by its digest before it is
    # written, where a legacy take fuses the CRC with the write.
    turns = {"legacy": [], "cas": []}
    for i, label in enumerate(("legacy", "cas", "cas", "legacy")):
        turn_root = os.path.join(work_dir, f"cas_turn_{i}")
        with knobs.enable_cas() if label == "cas" else contextlib.nullcontext():
            t0 = time.monotonic()
            Snapshot.take(os.path.join(turn_root, "step_0000000000"), app_state, record_digests=True)
            turns[label].append(time.monotonic() - t0)
        shutil.rmtree(turn_root)
    with knobs.enable_cas(), knobs.override_cas_gc_grace_seconds(0):
        mgr = CheckpointManager(root, keep_last_n=2)
        # Step 1: full save; the store holds each distinct blob once.
        blobs = _tensor_blob_keys(at, record_digests=True)
        stored_before = _store_bytes(root)
        before = counters()
        t0 = time.monotonic()
        mgr.save(1, app_state, record_digests=True)
        rec = after_save(1, time.monotonic() - t0, before, blobs)
        _require(rec["store_bytes"] == sum(refs[1].values()), "step 1: the store holds other bytes than its chunks")
        _require(rec["d2h_bytes"] == sum(t.numel() * t.element_size() for t in at.values() if t.is_cuda),
                 "step 1 did not copy every CUDA byte to the host")
        freeze(state.model)

        # Step 2: full save after one step with half the model frozen.
        state, _ = train_step(state, tokens)
        at_2 = capture()
        blobs = _tensor_blob_keys(at_2, record_digests=True)
        stored_before = _store_bytes(root)
        before = counters()
        t0 = time.monotonic()
        mgr.save(2, app_state, record_digests=True)
        rec = after_save(2, time.monotonic() - t0, before, blobs)
        all_cuda = sum(t.numel() * t.element_size() for t in at_2.values() if t.is_cuda)
        _require(rec["d2h_bytes"] == all_cuda, f"step 2 copied {rec['d2h_bytes']} bytes to the host, not all {all_cuda}")
        _require(rec["deduped_bytes"] == dense[2] - rec["written_bytes"],
                 f"step 2 deduped {rec['deduped_bytes']} bytes, its blobs hold {dense[2]}, it wrote {rec['written_bytes']}")

        # Step 3: incremental; only the changed chunks leave the card.
        state, _ = train_step(state, tokens)
        at_3 = capture()
        changed = _changed_bytes(at_2, at_3)
        del at_2
        blobs = _tensor_blob_keys(at_3, record_digests=True)
        stored_before = _store_bytes(root)
        digests_before = dd.launch_counts["device_digest"]
        before = counters()
        t0 = time.monotonic()
        mgr.save(3, app_state, incremental=True)
        rec = after_save(3, time.monotonic() - t0, before, blobs, changed_bytes=changed)
        _require(dd.launch_counts["device_digest"] > digests_before, "the incremental save launched no digest")
        _require(rec["d2h_bytes"] == changed, f"step 3 copied {rec['d2h_bytes']} bytes to the host, {changed} changed")
        manifest_3 = Snapshot(mgr.step_path(3)).metadata.manifest
        locations = [loc for e in manifest_3.values() for loc in entry_locations(e)]
        _require(referenced_steps(manifest_3) == set() and all(is_chunk_location(loc) for loc in locations),
                 "step 3 names a location outside the chunk store")
        del at_3

        # Step 4: async, batched and packed, a step beside the drain. That
        # step's loss, and the logits before it, are what the restored
        # state must give.
        state, _ = train_step(state, tokens)
        at_4 = capture()
        with torch.no_grad():
            logits_4 = state.model(tokens)
        _, leaves = flatten(app_state["train"].state_dict(), prefix="train")
        packs_before = dp.launch_counts["device_pack"]
        before = counters()
        with knobs.enable_batching(), knobs.enable_device_pack():
            t0 = time.monotonic()
            pending = mgr.async_save(4, app_state)
            visible_s = time.monotonic() - t0
            t1 = time.monotonic()
            state, loss_5 = train_step(state, tokens)
            torch.cuda.current_stream().synchronize()
            step_beside_drain_s = time.monotonic() - t1
            pending.wait()
            waited_s = time.monotonic() - t0
        packs = dp.launch_counts["device_pack"] - packs_before
        rec = after_save(4, waited_s, before, visible_s=visible_s, step_beside_drain_s=step_beside_drain_s,
                         pack_launches=packs)
        manifest_4 = Snapshot(mgr.step_path(4)).metadata.manifest
        with open(os.path.join(mgr.step_path(4), "cas", "0")) as f:
            slab_keys = [r["k"] for p, r in json.load(f)["paths"].items() if p.startswith("batched/")]
        members: dict = {}
        for path, e in manifest_4.items():
            if getattr(e, "byte_range", None) is not None:
                leaf = leaves[path.partition("/")[2]]
                members.setdefault(e.location, []).append(getattr(leaf, "is_cuda", False))
        _require(len(slab_keys) == len(set(slab_keys)) == len(members) > 0
                 and {f"../chunks/{k}" for k in slab_keys} == set(members),
                 f"step 4: {len(slab_keys)} slabs, {len(members)} chunks hold batched members")
        want = sum(1 for cuda in members.values() if sum(cuda) > 1)
        _require(packs == want, f"step 4: {packs} pack launches for {want} slabs of two or more card members")

    # Retention: the chunks only steps 1-2 named are reclaimed.
    live = set(refs[3]) | set(refs[4])
    gone = {k: n for s in (1, 2) for k, n in refs[s].items() if k not in live}
    reclaimed = saves[3]["reclaimed_bytes"] + saves[4]["reclaimed_bytes"]
    _require(mgr.all_steps() == [3, 4], f"retained {mgr.all_steps()}")
    _require(reclaimed == sum(gone.values()), f"reclaimed {reclaimed} bytes; steps 1-2 alone named {sum(gone.values())}")
    store = _store_bytes(root)
    _require(set(store) == live, "the store does not hold exactly the chunks steps 3 and 4 name")
    pins, orphans = CASStore(root).load()
    _require(pins == {3: refs[3], 4: refs[4]} and not orphans, f"journal pins {sorted(pins)}, orphans {len(orphans)}")

    # fsck --cas --deep, and a flipped byte in a copy of the root.
    t0 = time.monotonic()
    report = verify_cas_store(root, deep=True)
    fsck_s = time.monotonic() - t0
    _require(report.ok and report.crcs_verified == report.chunks_referenced == len(live),
             f"deep fsck --cas: {report.problems[:5]}")
    victim = max(live, key=lambda k: (refs[4].get(k, 0), k))
    flipped = os.path.join(work_dir, "cas_flipped")
    _flipped_copy(root, f"chunks/{victim}", flipped)
    problems = [(p.kind, p.location) for p in verify_cas_store(flipped, deep=True).problems]
    _require(problems == [("checksum", f"chunks/{victim}")], f"deep fsck --cas of the flipped copy: {problems}")
    shutil.rmtree(flipped)

    # A fresh manager over a lost journal reconciles, and restore_latest
    # into another seed's state is bit-identical.
    os.remove(os.path.join(root, "chunks", ".refcounts.jsonl"))
    fresh_mgr = CheckpointManager(root, keep_last_n=2)
    pins, _ = CASStore(root).load()
    _require(pins == {3: refs[3], 4: refs[4]}, f"reconcile rebuilt pins {sorted(pins)}")
    fresh = init_train_state(cfg, seed=args.seed + 1)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    step = fresh_mgr.restore_latest({"train": fresh})
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    _require(step == 4, f"restore_latest returned {step}")
    _require_same_state(at_4, fresh, "cas restore_latest")
    del at_4
    with torch.no_grad():
        logits_b = fresh.model(tokens)
    torch.cuda.synchronize()
    _require(bool(torch.isfinite(logits_4).all()) and same_bits(logits_4, logits_b),
             "evaluation logits differ after the cas restore_latest")
    del logits_4, logits_b
    freeze(fresh.model)
    _, loss_b = train_step(fresh, tokens)
    torch.cuda.synchronize()
    _require(same_bits(loss_5, loss_b), f"next-step losses differ after the cas restore_latest: {loss_5} vs {loss_b}")
    launches = {**fa.launch_counts, **dd.launch_counts, **dp.launch_counts}
    _require(all(launches[k] for k in CAS_PATH_KERNELS), f"a kernel of the cas path never launched: {launches}")

    record = {
        "card": card, "saves": saves, "take_turns_s": turns, "fsck_cas_deep_s": fsck_s,
        "fsck_bytes": report.stored_bytes, "flipped": victim, "reclaimed_bytes": reclaimed,
        "restore_latest_s": restore_s, "next_loss": float(loss_5), "launches": launches,
    }
    for s, rec in saves.items():
        log(
            f"cas: save {s} {rec['s']:.3f} s: {rec['d2h_bytes'] / 1e6:.3f} MB to the host, "
            f"{rec['written_bytes'] / 1e6:.3f} MB written to the store, {rec['deduped_bytes'] / 1e6:.3f} MB deduped, "
            f"{rec['reclaimed_bytes'] / 1e6:.3f} MB reclaimed; store {rec['store_bytes'] / 1e6:.3f} MB against "
            f"{rec['dense_retained_bytes'] / 1e6:.3f} MB of the retained steps' dense blobs"
            + (f" (pack launches {rec['pack_launches']}, step beside the drain {rec['step_beside_drain_s']:.3f} s)"
               if "pack_launches" in rec else "")
        )
    log(
        f"cas: takes of step 1's state in turns, legacy {turns['legacy'][0]:.3f} s, CAS "
        f"{turns['cas'][0]:.3f}, {turns['cas'][1]:.3f} s, legacy {turns['legacy'][1]:.3f} s; "
        f"deep fsck --cas {fsck_s:.3f} s over {report.stored_bytes / 1e6:.3f} MB, flip in {victim} caught; "
        f"reconcile and restore_latest {restore_s:.3f} s bit-identical, logits and next loss {float(loss_5)!r} too; "
        f"launches {launches}; on {card}"
    )
    _headline("cas", take_legacy_cas_s=[turns["legacy"][0], turns["cas"][0]], fsck_s=fsck_s,
              restore_latest_s=restore_s)
    print(json.dumps({"cas": record}), flush=True)
    del state, fresh
    torch.cuda.empty_cache()
    return launches


# The kernels the cas phase must launch.
CAS_PATH_KERNELS = ("flash_fwd", "flash_chunk", "device_digest", "device_pack")


# ---------------------------------------------------------------------------
# tiered: a fast tier, a durable tier and the mirror between them
# ---------------------------------------------------------------------------

# The crash matrix's tier-1 smoke points (the JAX package's
# tests/test_chaos_matrix.py SMOKE_POINTS).
MATRIX_SMOKE_POINTS = (
    "take-writes-done", "checksum-table-written", "cas-chunk-written", "cas-map-written",
    "pre-commit-marker", "commit-marker", "index-backup-written", "refcount-pinned",
)
# The kernels the tiered phase must launch.
TIERED_PATH_KERNELS = ("flash_fwd", "flash_chunk", "device_digest", "device_pack")


def _files(top: str) -> dict:
    """``relative path -> size`` of every file under ``top`` but the
    telemetry records."""
    out = {}
    for d, _, names in os.walk(top):
        for n in names:
            full = os.path.join(d, n)
            if not _is_side_file(n):
                out[os.path.relpath(full, top)] = os.path.getsize(full)
    return out


def _flip_middle_byte(path: str) -> None:
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0x01]))


def tiered_phase(args, work_dir: str, card: str) -> dict:
    """The main configuration's loop on ``tiered://<work>/tiered_fast|
    <work>/tiered_durable`` (both local directories of this machine: the
    mirror's seconds are a local disk's, not an object store's) through
    ``CheckpointManager(keep_last_n=3, keep_fast_last_n=1,
    incremental=True)``. (a) Four saves with training between them: sync;
    ``async_save`` beside a step; incremental after freezing half the
    model; batched with ``DEVICE_PACK``. Each save's seconds, its
    ``wait_durable`` seconds and what the mirror shipped; the step alone,
    beside the async drain and beside the mirror; every durable blob
    byte-identical to its fast copy, the journal complete with the commit
    marker landed last; after the eviction pass only the newest step on
    the fast tier. (b) The restore of an evicted step, wholly from the
    durable tier: bit-identical state, logits and next-step loss. (c) One
    byte flipped in each of k fast blobs of the newest step: the restore
    heals each from the durable tier (``storage_degraded_reads_total
    {tier="durable"}`` moves by k) and is bit-identical; the same flip on
    a plain root raises ``ChecksumError``. (d) A chaos plan fails the
    durable writes after n blobs; a new manager's ``resume_mirrors()``
    after a mirror reset ships exactly the blobs the journal lacks, the
    commit marker last, byte for byte. (e) A chunk store on a tiered root:
    the mirror ships a step's novel chunks and nothing of what the durable
    tier holds. (f) The crash matrix's eight smoke points on tiered + CAS
    with CUDA states: every point fires and every invariant holds.
    Returns the phase's launch counts."""
    from unittest import mock

    import torch

    from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, knobs
    from torchsnapshot_tpu_torch.chaos.harness import FULL_CONFIG, run_crash_case
    from torchsnapshot_tpu_torch.integrity import ChecksumError
    from torchsnapshot_tpu_torch.manager import INDEX_BACKUP_BLOB, INDEX_BLOB
    from torchsnapshot_tpu_torch.models.transformer import (
        init_train_state,
        make_train_step,
        random_tokens,
    )
    from torchsnapshot_tpu_torch.ops import device_digest as dd
    from torchsnapshot_tpu_torch.ops import device_pack as dp
    from torchsnapshot_tpu_torch.ops import flash_attention as fa
    from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
    from torchsnapshot_tpu_torch.telemetry import names
    from torchsnapshot_tpu_torch.test_utils import faulty_fs_plugin
    from torchsnapshot_tpu_torch.telemetry import ledger
    from torchsnapshot_tpu_torch.telemetry.sink import load_events
    from torchsnapshot_tpu_torch.tiered import get_mirror, reset_mirror
    from torchsnapshot_tpu_torch.tiered.journal import JOURNAL_BACKUP_BLOB, JOURNAL_BLOB

    cfg = main_config()
    tokens = torch.from_numpy(random_tokens(cfg, 8, 1024, args.seed)).cuda()
    state = init_train_state(cfg, seed=args.seed)
    train_step = make_train_step(cfg)
    app_state = {"train": state}
    fast, durable = os.path.join(work_dir, "tiered_fast"), os.path.join(work_dir, "tiered_durable")
    root = f"tiered://{fast}|{durable}"
    n_frozen = cfg.n_layers // 2
    journal_files = (JOURNAL_BLOB, JOURNAL_BACKUP_BLOB)

    def freeze(model) -> None:
        for p in [model.embed] + [p for blk in model.layers[:n_frozen] for p in blk.parameters()]:
            p.requires_grad_(False)

    def capture() -> dict:
        torch.cuda.synchronize()
        return {k: v.clone() for k, v in _state_tensors(state).items()}

    def mirrored() -> tuple:
        m = get_mirror().metrics()
        return m["bytes_mirrored"], m["blobs_done"]

    def step_dir(tier: str, step: int) -> str:
        return os.path.join(tier, f"step_{step:010d}")

    def step_step() -> float:
        """One training step, timed to its own stream's end."""
        nonlocal state
        t0 = time.monotonic()
        state, _ = train_step(state, tokens)
        torch.cuda.current_stream().synchronize()
        return time.monotonic() - t0

    saves = {}

    def finish_save(step: int, seconds: float, before: tuple, d2h_before: float, **extra) -> dict:
        """wait_durable, then the step's durable copy against its fast one
        (before the next commit's eviction pass drops the fast copy)."""
        t0 = time.monotonic()
        mgr.wait_durable(step, timeout=600)
        wait_s = time.monotonic() - t0
        shipped = [a - b for a, b in zip(mirrored(), before)]
        with open(os.path.join(step_dir(fast, step), JOURNAL_BLOB)) as f:
            journal = json.load(f)
        on_durable = _files(step_dir(durable, step))
        _require(set(on_durable) == set(journal["blobs"]), f"save {step}: the durable tier holds other blobs")
        _require(
            journal["durable_committed"] and journal["metadata"] == ".snapshot_metadata"
            and sorted(journal["done"]) == sorted(journal["blobs"]),
            f"save {step}: the journal is not complete",
        )
        for rel in journal["blobs"]:
            with open(os.path.join(step_dir(fast, step), rel), "rb") as a, open(
                os.path.join(step_dir(durable, step), rel), "rb"
            ) as b:
                _require(a.read() == b.read(), f"save {step}: durable {rel} differs from its fast copy")
        mtimes = {rel: os.stat(os.path.join(step_dir(durable, step), rel)).st_mtime_ns for rel in on_durable}
        marker = mtimes.pop(".snapshot_metadata")
        _require(marker >= max(mtimes.values()), f"save {step}: a durable blob landed after the commit marker")
        # The settled job's report beside the fast step and its ledger
        # event, each with the bytes the job shipped.
        step_bytes = sum(on_durable.values())
        reports = [
            (e["bytes_moved"], e["error"]) for e in load_events(os.path.join(step_dir(fast, step), ".telemetry.jsonl"))
            if e["kind"] == "mirror"
        ]
        settled = [
            (r["nbytes"], r["error"]) for r in ledger.load_ledger(os.path.join(fast, ledger.LEDGER_BASENAME))
            if r["event"] == names.EVENT_MIRROR_SETTLED and r.get("step") == step
        ]
        _require(reports == settled == [(step_bytes, None)],
                 f"save {step}: mirror reports {reports}, mirror-settled {settled}, {step_bytes} bytes mirrored")
        # The take's and the mirror job's reports carry critical paths.
        paths = _require_critical_paths(
            load_events(os.path.join(step_dir(fast, step), ".telemetry.jsonl")), f"tiered save {step}"
        )
        _require(sorted(k for k, *_ in paths) in (["mirror", "take"], ["async_take", "mirror"]),
                 f"tiered save {step}: reports {[k for k, *_ in paths]}")
        log(f"tiered save {step} critical paths: {_critpath_line(paths)}")
        rec = {
            "s": seconds, "wait_durable_s": wait_s, "mirrored_bytes": shipped[0], "mirrored_blobs": shipped[1],
            "step_blobs": len(on_durable), "step_bytes": sum(on_durable.values()),
            "d2h_bytes": _counter(names.DEVICE_TO_HOST_BYTES_TOTAL) - d2h_before,
            "critical_paths": {k: {"dominant": d, "wall_s": w, "segments": sg} for k, _, d, w, sg in paths}, **extra,
        }
        saves[step] = rec
        return rec

    reset_mirror()
    for counts in (fa.launch_counts, dd.launch_counts, dp.launch_counts):
        for k in counts:
            counts[k] = 0
    # (a) The managed loop, with the report and trace sinks on.
    records = contextlib.ExitStack()
    records.enter_context(_env(RECORDS_ON))
    mgr = CheckpointManager(root, keep_last_n=3, keep_fast_last_n=1, incremental=True)

    step_step()
    torch.cuda.synchronize()
    step_alone_s = step_step()
    d2h, before = _counter(names.DEVICE_TO_HOST_BYTES_TOTAL), mirrored()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    mgr.save(1, app_state)
    save_s = time.monotonic() - t0
    # A step while the mirror copies step 1.
    busy = get_mirror().metrics()["snapshots_pending"]
    step_beside_mirror_s = step_step()
    busy_after = get_mirror().metrics()["snapshots_pending"]
    finish_save(1, save_s, before, d2h, mirror_jobs_pending_around_step=[busy, busy_after])

    torch.cuda.synchronize()
    d2h, before = _counter(names.DEVICE_TO_HOST_BYTES_TOTAL), mirrored()
    t0 = time.monotonic()
    pending = mgr.async_save(2, app_state)
    visible_s = time.monotonic() - t0
    step_beside_drain_s = step_step()
    pending.wait()
    finish_save(2, time.monotonic() - t0, before, d2h, visible_s=visible_s)

    freeze(state.model)
    step_step()
    at_3 = capture()
    with torch.no_grad():
        logits_3 = state.model(tokens)
    digests = dd.launch_counts["device_digest"]
    d2h, before = _counter(names.DEVICE_TO_HOST_BYTES_TOTAL), mirrored()
    t0 = time.monotonic()
    mgr.save(3, app_state)
    finish_save(3, time.monotonic() - t0, before, d2h)
    # Neither package's incremental take references a base on a tiered
    # root (``incremental.relative_ref_prefix`` resolves fs, s3 and gs
    # only), so the save records digests and writes in full.
    _require(dd.launch_counts["device_digest"] > digests, "the incremental save launched no digest")
    state, loss_after_3 = train_step(state, tokens)

    at_4 = capture()
    with torch.no_grad():
        logits_4 = state.model(tokens)
    packs = dp.launch_counts["device_pack"]
    d2h, before = _counter(names.DEVICE_TO_HOST_BYTES_TOTAL), mirrored()
    with knobs.enable_batching(), knobs.enable_device_pack():
        t0 = time.monotonic()
        mgr.save(4, app_state)
        save_s = time.monotonic() - t0
    finish_save(4, save_s, before, d2h, pack_launches=dp.launch_counts["device_pack"] - packs)
    records.close()
    _require(saves[4]["pack_launches"] > 0, "the batched save launched no pack")

    # After step 4's eviction pass the fast tier holds the newest step only.
    retained = mgr.all_steps()
    with open(os.path.join(fast, INDEX_BLOB)) as f:
        index = json.load(f)
    _require(retained == [2, 3, 4], f"retained {retained}")
    left = {s: _files(step_dir(fast, s)) for s in (1, 2, 3)}
    _require(not any(left.values()), f"evicted steps left fast files: {[(s, sorted(v)[:3]) for s, v in left.items() if v]}")
    _require(
        index.get("evicted") == sorted(set(retained + index.get("pinned", [])) - {4}),
        f"the index records evicted {index.get('evicted')}",
    )
    fast_4 = {r for r in _files(step_dir(fast, 4)) if r not in journal_files}
    _require(fast_4 == set(_files(step_dir(durable, 4))), "step 4's fast copy is not whole")
    leg_a = {
        "card": card, "saves": saves, "step_alone_s": step_alone_s, "step_beside_drain_s": step_beside_drain_s,
        "step_beside_mirror_s": step_beside_mirror_s, "retained": retained, "evicted": index.get("evicted"),
        "pinned": index.get("pinned", []),
    }
    for s, rec in saves.items():
        log(
            f"tiered (a): save {s} {rec['s']:.3f} s, wait_durable {rec['wait_durable_s']:.3f} s; the mirror shipped "
            f"{rec['mirrored_bytes'] / 1e6:.3f} MB in {rec['mirrored_blobs']} blobs (the step's own "
            f"{rec['step_bytes'] / 1e6:.3f} MB in {rec['step_blobs']}, the rest the index); "
            f"{rec['d2h_bytes'] / 1e6:.3f} MB copied to the host"
            + (f"; {rec['pack_launches']} pack launches" if "pack_launches" in rec else "")
        )
    log(
        f"tiered (a): step alone {step_alone_s:.3f} s, beside the async drain {step_beside_drain_s:.3f} s, "
        f"beside the mirror {step_beside_mirror_s:.3f} s (mirror jobs pending at its start and end "
        f"{saves[1]['mirror_jobs_pending_around_step']}); retained {retained}, evicted from the fast tier "
        f"{index.get('evicted')}; both tiers local directories; on {card}"
    )
    print(json.dumps({"tiered_a": leg_a}), flush=True)

    # (b) Restore the evicted step 3 from the durable tier alone.
    fresh = init_train_state(cfg, seed=args.seed + 1)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    snapshot = Snapshot(mgr.step_path(3))
    snapshot.restore({"train": fresh})
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    _require_same_state(at_3, fresh, "restore of the evicted step 3")
    _require("degraded_reads" not in snapshot.restore_telemetry, "the durable restore healed a read")
    with torch.no_grad():
        logits_b = fresh.model(tokens)
    torch.cuda.synchronize()
    _require(bool(torch.isfinite(logits_3).all()) and same_bits(logits_3, logits_b),
             "evaluation logits differ after the restore of the evicted step")
    freeze(fresh.model)
    _, loss_b = train_step(fresh, tokens)
    torch.cuda.synchronize()
    _require(same_bits(loss_after_3, loss_b), f"next-step losses differ: {loss_after_3} vs {loss_b}")
    state_bytes = sum(v.numel() * v.element_size() for v in at_3.values())
    del at_3, logits_3, logits_b
    leg_b = {"restore_s": restore_s, "state_bytes": state_bytes, "restore_gb_s": state_bytes / restore_s / 1e9,
             "next_loss": float(loss_b)}
    log(
        f"tiered (b): restore of evicted step 3 from the durable tier {restore_s:.3f} s "
        f"({leg_b['restore_gb_s']:.2f} GB/s of {state_bytes / 1e6:.3f} MB) bit-identical, logits and next "
        f"loss {float(loss_b)!r} too; on {card}"
    )
    print(json.dumps({"tiered_b": leg_b}), flush=True)

    # (c) Self-healing: one byte flipped in each of k fast blobs of step 4.
    k = 3
    own = sorted(
        (n, r) for r, n in _files(step_dir(fast, 4)).items()
        if r not in journal_files and not r.startswith((".snapshot_metadata", "checksums"))
    )
    victims = [r for _, r in own[-k:]]
    _require(len(victims) == k, f"step 4 holds {len(own)} data blobs on the fast tier")
    for rel in victims:
        _flip_middle_byte(os.path.join(step_dir(fast, 4), rel))
    healed_before = _counter(names.STORAGE_DEGRADED_READS_TOTAL)
    fresh2 = init_train_state(cfg, seed=args.seed + 2)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    snapshot = Snapshot(mgr.step_path(4))
    with knobs.enable_batching():
        snapshot.restore({"train": fresh2})
    torch.cuda.synchronize()
    heal_restore_s = time.monotonic() - t0
    healed = _counter(names.STORAGE_DEGRADED_READS_TOTAL) - healed_before
    _require_same_state(at_4, fresh2, "restore of step 4 around corrupt fast blobs")
    with torch.no_grad():
        logits_c = fresh2.model(tokens)
    _require(same_bits(logits_4, logits_c), "evaluation logits differ after the healed restore")
    _require(healed == k and snapshot.restore_telemetry["tier_split"].keys() == {"durable"},
             f"{healed} reads healed for {k} corrupt blobs ({snapshot.restore_telemetry})")
    plain = os.path.join(work_dir, "tiered_plain")
    Snapshot.take(plain, app_state)
    plain_victim = max((n, r) for r, n in _files(plain).items() if not r.startswith((".snapshot", "checksums")))[1]
    _flip_middle_byte(os.path.join(plain, plain_victim))
    try:
        Snapshot(plain).restore({"train": fresh2})
        raised = None
    except ChecksumError as e:
        raised = str(e)
    _require(raised is not None, "the flipped byte on a plain root was served")
    shutil.rmtree(plain)
    del fresh, fresh2, logits_4, logits_c
    leg_c = {"corrupt_blobs": victims, "healed_reads": healed, "restore_s": heal_restore_s,
             "tier_split": snapshot.restore_telemetry["tier_split"], "plain_root": raised}
    log(
        f"tiered (c): {k} fast blobs of step 4 with a flipped byte ({victims}); restore {heal_restore_s:.3f} s "
        f"bit-identical, {healed:.0f} reads healed from the durable tier "
        f"({leg_c['tier_split']['durable'] / 1e6:.3f} MB); the plain root raised ChecksumError; on {card}"
    )
    print(json.dumps({"tiered_c": leg_c}), flush=True)

    # (d) An interrupted mirror: durable writes fail after n blobs.
    n = 4
    writes = {"n": 0}

    def after_n(_path: str) -> bool:
        writes["n"] += 1
        return writes["n"] > n

    faulty = faulty_fs_plugin(after_n, ops=("write",), exc_msg="durable outage")

    def faulty_factory(url: str):
        return faulty(root=url) if url.startswith(durable) else url_to_storage_plugin(url)

    step_step()
    at_5 = capture()
    with knobs.override_mirror_progress_window_seconds(0.5), mock.patch(
        "torchsnapshot_tpu_torch.tiered.mirror.url_to_storage_plugin", side_effect=faulty_factory
    ):
        t0 = time.monotonic()
        mgr.save(5, app_state)
        save_5_s = time.monotonic() - t0
        _require(get_mirror().drain(timeout=600), "the failing mirror did not settle")
        failed = [j for j in get_mirror().jobs_for(step_dir(fast, 5)) if j.error is not None]
    _require(failed, "the chaos plan did not fail step 5's mirror")
    with open(os.path.join(step_dir(fast, 5), JOURNAL_BLOB)) as f:
        journal = json.load(f)
    done = set(journal["done"])
    lacking = set(journal["blobs"]) - done
    _require(len(done) == n and not journal["durable_committed"], f"the journal holds {len(done)} done blobs")
    reset_mirror()
    shipped = []

    class Recording(FSStoragePlugin):
        async def write(self, write_io):
            shipped.append((self.root, write_io.path))
            await super().write(write_io)

    def recording_factory(url: str):
        return Recording(root=url) if url.startswith(durable) else url_to_storage_plugin(url)

    with mock.patch("torchsnapshot_tpu_torch.tiered.mirror.url_to_storage_plugin", side_effect=recording_factory):
        mgr2 = CheckpointManager(root, keep_last_n=3, keep_fast_last_n=1, incremental=True)
        t0 = time.monotonic()
        resumed = mgr2.resume_mirrors()
        mgr2.wait_durable(5, timeout=600)
        resume_s = time.monotonic() - t0
        _require(get_mirror().drain(timeout=600), "the resumed mirror did not settle")
    step_5 = [p for r, p in shipped if os.path.normpath(r) == os.path.normpath(step_dir(durable, 5))]
    _require(resumed == [5], f"resume_mirrors resumed {resumed}")
    _require(sorted(step_5) == sorted(lacking) and step_5[-1] == ".snapshot_metadata",
             f"the resumed mirror shipped {len(step_5)} blobs, the journal lacked {len(lacking)}")
    shipped_bytes = sum(os.path.getsize(os.path.join(step_dir(durable, 5), p)) for p in step_5)
    lacking_bytes = sum(os.path.getsize(os.path.join(step_dir(fast, 5), p)) for p in lacking)
    for rel in journal["blobs"]:
        with open(os.path.join(step_dir(fast, 5), rel), "rb") as a, open(
            os.path.join(step_dir(durable, 5), rel), "rb"
        ) as b:
            _require(a.read() == b.read(), f"durable {rel} of step 5 differs from its fast copy")
    fresh3 = init_train_state(cfg, seed=args.seed + 3)
    shutil.rmtree(fast)  # the durable tier alone now
    Snapshot(mgr2.step_path(5)).restore({"train": fresh3})
    torch.cuda.synchronize()
    _require_same_state(at_5, fresh3, "restore of step 5 from the durable tier after the resume")
    del at_5, fresh3
    leg_d = {"fail_after": n, "save_s": save_5_s, "journal_done": len(done), "journal_blobs": len(journal["blobs"]),
             "resumed": resumed, "shipped_blobs": len(step_5), "shipped_bytes": shipped_bytes,
             "lacking_bytes": lacking_bytes, "resume_s": resume_s}
    _require(shipped_bytes == lacking_bytes, f"shipped {shipped_bytes} bytes, the journal lacked {lacking_bytes}")
    log(
        f"tiered (d): durable writes failed after {n} blobs; the journal held {len(done)} of "
        f"{len(journal['blobs'])} done; a new manager's resume_mirrors() shipped {len(step_5)} blobs "
        f"({shipped_bytes / 1e6:.3f} MB), exactly those lacking, the commit marker last, in {resume_s:.3f} s "
        f"with wait_durable; the durable tier alone restores step 5 bit-identical; on {card}"
    )
    print(json.dumps({"tiered_d": leg_d}), flush=True)

    # (e) CAS on a tiered root: the mirror ships novel chunks only.
    cas_fast, cas_durable = os.path.join(work_dir, "tiered_cas_fast"), os.path.join(work_dir, "tiered_cas_durable")
    reset_mirror()
    with knobs.enable_cas():
        cmgr = CheckpointManager(f"tiered://{cas_fast}|{cas_durable}", keep_last_n=2)
        cmgr.save(1, app_state)
        cmgr.wait_durable(1, timeout=600)
        step_step()
        written, skipped, before = (
            _counter(names.CAS_BYTES_WRITTEN_TOTAL), _counter(names.MIRROR_CHUNKS_SKIPPED_TOTAL), mirrored(),
        )
        t0 = time.monotonic()
        cmgr.save(2, app_state)
        cas_save_s = time.monotonic() - t0
        t0 = time.monotonic()
        cmgr.wait_durable(2, timeout=600)
        cas_wait_s = time.monotonic() - t0
        _require(get_mirror().drain(timeout=600), "the mirror did not settle")
        written = _counter(names.CAS_BYTES_WRITTEN_TOTAL) - written
        skipped = _counter(names.MIRROR_CHUNKS_SKIPPED_TOTAL) - skipped
        shipped_bytes = mirrored()[0] - before[0]
    control = sum(n for r, n in _files(step_dir(cas_fast, 2)).items() if r not in journal_files)
    index_bytes = sum(os.path.getsize(os.path.join(cas_fast, b)) for b in (INDEX_BLOB, INDEX_BACKUP_BLOB))
    chunk_bytes = shipped_bytes - control - index_bytes
    _require(chunk_bytes == written, f"the mirror shipped {chunk_bytes} chunk bytes; step 2 wrote {written} to the store")
    _require(skipped > 0, "the mirror probed no deduped chunk")
    fast_chunks, durable_chunks = (_files(os.path.join(t, "chunks")) for t in (cas_fast, cas_durable))
    fast_chunks.pop(".refcounts.jsonl", None)
    _require(fast_chunks == durable_chunks, "the tiers hold other chunks")
    leg_e = {"save_s": cas_save_s, "wait_durable_s": cas_wait_s, "cas_bytes_written": written,
             "mirrored_chunk_bytes": chunk_bytes, "mirrored_bytes": shipped_bytes, "chunks_skipped": skipped}
    log(
        f"tiered (e): CAS step 2 saved in {cas_save_s:.3f} s, durable {cas_wait_s:.3f} s later; the mirror shipped "
        f"{chunk_bytes / 1e6:.3f} MB of chunks = cas_bytes_written_total {written / 1e6:.3f} MB, skipped "
        f"{skipped:.0f} chunks the durable tier held; on {card}"
    )
    print(json.dumps({"tiered_e": leg_e}), flush=True)
    shutil.rmtree(cas_fast)
    shutil.rmtree(cas_durable)

    # (f) The crash matrix's smoke points, tiered + CAS, CUDA states.
    matrix = {}
    for point in MATRIX_SMOKE_POINTS:
        t0 = time.monotonic()
        result = run_crash_case(os.path.join(work_dir, "matrix"), point, FULL_CONFIG, seed=args.seed, device="cuda")
        reset_mirror()
        _require(result.fired and result.ok, result.describe())
        matrix[point] = {"s": time.monotonic() - t0, "latest_step": result.latest_step}
    shutil.rmtree(os.path.join(work_dir, "matrix"))
    log(
        "tiered (f): crash matrix on tiered + CAS with CUDA states, every point fired and held: "
        + ", ".join(f"{p} {r['s']:.2f} s (latest {r['latest_step']})" for p, r in matrix.items())
        + f"; on {card}"
    )
    print(json.dumps({"tiered_f": matrix}), flush=True)
    _headline("tiered", durable_restore_s=leg_b["restore_s"], healed_reads=leg_c["healed_reads"],
              resumed_blobs=leg_d["shipped_blobs"], crash_points=len(matrix))

    launches = {**fa.launch_counts, **dd.launch_counts, **dp.launch_counts}
    _require(all(launches[k] for k in TIERED_PATH_KERNELS), f"a kernel of the tiered path never launched: {launches}")
    log(f"tiered: launches {launches}")
    shutil.rmtree(durable, ignore_errors=True)
    del state
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# ranks: two processes on the card
# ---------------------------------------------------------------------------

# The whole train state is data-parallel replicated (parameters, AdamW
# moments and step counters, the training RNG, the step): every rank holds
# the same bits. The global RNG state and the "own" tensor are per rank.
REPLICATED = ["train/**"]
RANKS = 2
OWN_NUMEL = 16 * 1024 * 1024  # a 64 MiB float32 per-rank tensor


def _own_tensor(seed: int, rank: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed + rank)
    return torch.randn(OWN_NUMEL, generator=gen, device="cuda")


def _coordination_counters() -> tuple:
    from torchsnapshot_tpu_torch.telemetry import names

    return (
        _counter(names.DEVICE_TO_HOST_BYTES_TOTAL),
        _counter(names.COORD_STORE_REQUESTS_TOTAL),
        _counter(names.COORD_STORE_SECONDS_TOTAL),
    )


def _rank_blob_bytes(path: str, rank: int) -> tuple:
    """``(replicated, per-rank)`` bytes of the blobs ``rank`` wrote under
    ``path``: its checksum table lists each blob it wrote, sized on disk."""
    with open(os.path.join(path, "checksums", str(rank))) as f:
        table = json.load(f)
    rep = own = 0
    for location in table:
        size = os.path.getsize(os.path.join(path, location))
        if location.startswith("replicated/"):
            rep += size
        else:
            own += size
    return rep, own


def _replicated_bytes(path: str) -> int:
    root = os.path.join(path, "replicated")
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)


def _leaf_digests(state) -> dict:
    """The ``mlh64`` digest of every leaf of a train state by path: the CUDA
    leaves in one launch of the digest kernel, the host ones on the host,
    other values by ``repr``."""
    import torch

    from torchsnapshot_tpu_torch.flatten import flatten
    from torchsnapshot_tpu_torch.ops import device_digest as dd

    _, leaves = flatten(state.state_dict(), prefix="train")
    cuda = [(p, t) for p, t in leaves.items() if isinstance(t, torch.Tensor) and t.is_cuda]
    rows = dd.materialize_many(dd.digest_many_async([(t, None) for _, t in cuda]))
    mine = {p: (int(r[0]), int(r[1])) for (p, _), r in zip(cuda, rows)}
    for p, leaf in leaves.items():
        if p not in mine:
            mine[p] = dd.digest_host(leaf) if isinstance(leaf, torch.Tensor) else repr(leaf)
    return mine


def _require_replicas_equal(pg, state) -> int:
    """Digest every leaf of the (declared replicated) train state on the
    card and compare the digests of all ranks through the store: the
    replicas must be bitwise equal, or declaring them replicated would
    save one rank's bits for all. Returns the leaves compared."""
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    mine = _leaf_digests(state)
    gathered = PGWrapper(pg).all_gather_object(mine)
    for p in sorted(mine):
        values = {repr(g.get(p)) for g in gathered}
        _require(len(values) == 1, f"replicated leaf {p} differs across ranks: {sorted(values)}")
    return len(mine)


def _require_gathered_reports(path: str, kind: str) -> int:
    """Each rank's report of a take at ``path`` is in its log, and rank 0's
    alone carries the gathered spread: min, median, max and the straggler
    rank of every metric. Returns the number of metrics."""
    from torchsnapshot_tpu_torch.telemetry.sink import load_events

    reports = {e["rank"]: e for e in load_events(os.path.join(path, ".telemetry.jsonl")) if e["kind"] == kind}
    _require(sorted(reports) == list(range(RANKS)), f"{kind} reports of ranks {sorted(reports)}")
    agg = reports[0]["aggregated"] or {}
    _require(
        "bytes_moved" in agg and all(
            set(v) == {"min", "median", "max", "straggler"} and v["straggler"] in range(RANKS) for v in agg.values()
        ),
        f"rank 0's {kind} report aggregated {agg}",
    )
    _require(all(reports[r]["aggregated"] is None for r in range(1, RANKS)), "a report of rank > 0 aggregated")
    _require(len(reports[0]["clock_offsets_s"] or []) == RANKS, "rank 0's report has no clock offsets")
    # Every rank's report carries its critical path, and rank 0's
    # aggregate folds each segment over both ranks.
    paths = _require_critical_paths([reports[r] for r in range(RANKS)], f"{kind} at {path}")
    folded = {k for k in agg if k.startswith("critpath_")}
    segments = {seg for *_, segs in paths for seg in segs}
    _require(folded == {f"critpath_{seg}_s" for seg in segments},
             f"rank 0's aggregate folds {sorted(folded)}, the ranks' segments are {sorted(segments)}")
    log(f"{kind} critical paths at {os.path.basename(path)}: {_critpath_line(paths)}")
    return len(agg)


def _require_wire_split(path: str, kind: str, rank: int) -> dict:
    """``rank``'s ``kind`` report at ``path`` carries a non-empty wire split
    (``report.wire``): frames, bytes and RPCs over the coordination store,
    with the RPC seconds by op id. Returns the split beside the report's
    critical-path ``coordination`` and ``other`` seconds."""
    from torchsnapshot_tpu_torch.telemetry.sink import load_events

    reports = [e for e in load_events(os.path.join(path, ".telemetry.jsonl")) if (e["kind"], e["rank"]) == (kind, rank)]
    _require(len(reports) == 1, f"rank {rank}: {len(reports)} {kind} reports at {path}")
    wire = reports[0].get("wire") or {}
    store = {op: t for op, t in (wire.get("ops") or {}).items() if op.startswith("store-")}
    _require(min(wire.get("frames", 0), wire.get("bytes", 0), wire.get("rpcs", 0)) > 0 and store,
             f"rank {rank}'s {kind} report at {path} has no wire split over the store: {wire}")
    segments = reports[0]["critical_path"]["segments"]
    return {
        "frames": wire["frames"], "bytes": wire["bytes"], "rpcs": wire["rpcs"], "rpc_s": wire["rpc_s"],
        "store_ops": {op: [t["rpcs"], t["rpc_s"]] for op, t in sorted(store.items())},
        "coordination_s": segments.get("coordination", 0.0), "other_s": segments.get("other", 0.0),
    }


def _wire_line(w: dict) -> str:
    return (
        f"{w['frames']:.0f} frames, {w['bytes'] / 1e6:.4f} MB, {w['rpcs']:.0f} store RPCs in {w['rpc_s']:.4f} s ("
        + ", ".join(f"{op} {n:.0f} in {sec:.4f} s" for op, (n, sec) in w["store_ops"].items())
        + f"); critical path coordination {w['coordination_s']:.4f} s, other {w['other_s']:.4f} s"
    )


def _ledger_events(root: str) -> list:
    from torchsnapshot_tpu_torch.telemetry.ledger import LEDGER_BASENAME, load_ledger

    return load_ledger(os.path.join(root, LEDGER_BASENAME))


def ranks_worker(pg, seed: int, work_dir: str) -> dict:
    """One rank of the ranks phase (spawned by ``run_multiprocess``; the
    parent built every kernel and the native runtime). Legs (a) sync take
    with ``replicated=``, (b) restore into another seed's state, (c)
    ``async_take`` beside a training step, the world-1 snapshot's restore,
    (e) the managed loop with a SIGTERM on rank 1 only, (f) a failing
    rank. Returns the rank's record."""
    import signal

    import torch

    from torchsnapshot_tpu_torch import (
        CheckpointManager,
        PreemptionSaver,
        RngState,
        Snapshot,
        TensorTreeState,
    )
    from torchsnapshot_tpu_torch.fsck import verify_snapshot
    from torchsnapshot_tpu_torch.manager import referenced_steps
    from torchsnapshot_tpu_torch.manifest import is_container_entry
    from torchsnapshot_tpu_torch.models.transformer import (
        init_train_state,
        make_train_step,
        random_tokens,
    )
    from torchsnapshot_tpu_torch.ops import device_digest as dd
    from torchsnapshot_tpu_torch.ops import flash_attention as fa
    from torchsnapshot_tpu_torch.ops import kernels
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper
    from torchsnapshot_tpu_torch.snapshot import SNAPSHOT_METADATA_FNAME
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
    from torchsnapshot_tpu_torch.test_utils import faulty_fs_plugin, patch_storage_plugin

    t_start = time.monotonic()
    # The peer tier off: this phase's checks are of the write and read
    # paths without it (each rank's bytes written, the file sets, which
    # plugin reads a blob); the peer phase drives the tier.
    os.environ["TORCHSNAPSHOT_TPU_PEER_TIER"] = "0"
    rank = pg.rank
    wrapper = PGWrapper(pg)
    torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    missing = [n for n in kernels.kernel_names() if not os.path.exists(kernels._library_path(n))]
    _require(not missing, f"rank {rank}: kernels {missing} not built by the parent")

    cfg = main_config()
    tokens = torch.from_numpy(random_tokens(cfg, 8, 1024, seed)).cuda()
    torch.manual_seed(seed + rank)  # the per-rank global generators RngState holds
    state = init_train_state(cfg, seed=seed)
    train_step = make_train_step(cfg)
    own = TensorTreeState({"x": _own_tensor(seed, rank)})
    app = {"train": state, "rng": RngState(), "own": own}
    fa.reset_launch_counts()
    dd.reset_launch_counts()
    for _ in range(STEPS):
        state, _ = train_step(state, tokens)
    torch.cuda.synchronize()
    n_leaves = _require_replicas_equal(pg, state)
    record = {"rank": rank, "device": torch.cuda.current_device(), "replica_leaves": n_leaves}

    def fresh_app(seed_shift: int) -> dict:
        return {
            "train": init_train_state(cfg, seed=seed + seed_shift),
            "rng": RngState(),
            "own": TensorTreeState({"x": torch.zeros(OWN_NUMEL, device="cuda")}),
        }

    def check_restored(restored: dict, at: dict, own_at, rng_at, what: str) -> None:
        _require_same_state(at, restored["train"], what)
        _require(same_bits(restored["own"].tree["x"], own_at), f"{what}: the per-rank tensor differs")
        _require(
            same_bits(torch.get_rng_state(), rng_at[0]) and same_bits(torch.cuda.get_rng_state(), rng_at[1]),
            f"{what}: the per-rank RNG state differs",
        )

    # (a) Sync take with replicated= globs.
    path_a = os.path.join(work_dir, "a")
    torch.rand(3)
    torch.rand(3, device="cuda")  # nontrivial per-rank global RNG states
    rng_at = (torch.get_rng_state(), torch.cuda.get_rng_state())
    at_a = {k: v.clone() for k, v in _state_tensors(state).items()}
    own_at = own.tree["x"].clone()
    before = _coordination_counters()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with _env(RECORDS_ON):
        Snapshot.take(path_a, app, pg=pg, replicated=REPLICATED)
    take_s = time.monotonic() - t0
    d2h, requests, store_s = (a - b for a, b in zip(_coordination_counters(), before))
    wrapper.barrier()  # both ranks' reports are in the log
    aggregated = _require_gathered_reports(path_a, "take") if rank == 0 else None
    wire_a = _require_wire_split(path_a, "take", rank)
    manifest = Snapshot(path_a).metadata.manifest
    _require(
        all(k.startswith("0/") for k, e in manifest.items() if getattr(e, "replicated", False)),
        "a replicated entry sits under a rank other than 0",
    )
    _require(
        not any(k.startswith("1/train/") and not is_container_entry(e) for k, e in manifest.items()),
        "rank 1 holds train leaves",
    )
    _require(f"{rank}/own/x" in manifest, f"rank {rank}'s per-rank tensor is not in the manifest")
    markers = [d for d, _, fs in os.walk(path_a) if SNAPSHOT_METADATA_FNAME in fs]
    _require(markers == [path_a], f"commit markers: {markers}")
    rep_total = _replicated_bytes(path_a)
    rep_written, own_written = _rank_blob_bytes(path_a, rank)
    own_bytes = OWN_NUMEL * 4
    half = rep_total / RANKS
    _require(
        abs(rep_written - half) <= 0.1 * half,
        f"rank {rank} wrote {rep_written} of {rep_total} replicated bytes, not half within 10%",
    )
    _require(
        abs(d2h - own_bytes - half) <= 0.1 * half,
        f"rank {rank} copied {d2h} bytes to the host: {d2h - own_bytes} replicated, not half of "
        f"{rep_total} within 10%",
    )
    _require(own_written >= own_bytes, f"rank {rank} wrote {own_written} per-rank bytes")
    # For the parent's leg (d); popped before the record is printed.
    record["rng_at_take"] = tuple(t.numpy().tobytes() for t in rng_at)
    record["a"] = {
        "take_s": take_s, "d2h_bytes": d2h, "replicated_bytes": rep_total,
        "replicated_written_bytes": rep_written, "replicated_share": rep_written / rep_total,
        "own_written_bytes": own_written, "store_requests": requests, "store_s": store_s,
        "aggregated_metrics": aggregated, "wire": wire_a,
    }

    # (b) Restore into another seed's state; the next step continues bit for bit.
    fresh = fresh_app(1)
    torch.rand(5)
    torch.rand(5, device="cuda")
    _require(not same_bits(fresh["train"].model.embed, state.model.embed), "fresh model equals the trained one")
    torch.cuda.synchronize()
    before = _coordination_counters()
    t0 = time.monotonic()
    Snapshot(path_a, pg=pg).restore(fresh)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    requests, store_s = (a - b for a, b in list(zip(_coordination_counters(), before))[1:])
    check_restored(fresh, at_a, own_at, rng_at, f"rank {rank} restore")
    with torch.no_grad():
        logits_a = state.model(tokens)
        logits_b = fresh["train"].model(tokens)
    torch.cuda.synchronize()
    _require(bool(torch.isfinite(logits_a).all()), "evaluation logits not finite")
    _require(same_bits(logits_a, logits_b), "evaluation logits differ after restore")
    del logits_a, logits_b
    _, loss_a = train_step(state, tokens)
    _, loss_b = train_step(fresh["train"], tokens)
    torch.cuda.synchronize()
    _require(same_bits(loss_a, loss_b), f"next-step losses differ: {loss_a} vs {loss_b}")
    record["b"] = {"restore_s": restore_s, "store_requests": requests, "store_s": store_s, "next_loss": float(loss_a)}
    del fresh
    torch.cuda.empty_cache()

    # The world-1 snapshot (taken by the parent of the same state, with the
    # same globs) restores on both ranks.
    fresh = {"train": init_train_state(cfg, seed=seed + 1)}
    t0 = time.monotonic()
    Snapshot(os.path.join(work_dir, "world1"), pg=pg).restore(fresh)
    torch.cuda.synchronize()
    record["world1_restore_s"] = time.monotonic() - t0
    _require_same_state(at_a, fresh["train"], f"rank {rank} restore of the world-1 snapshot")
    del fresh, at_a
    torch.cuda.empty_cache()

    # (c) async_take with the process group, a training step beside its drain.
    path_c = os.path.join(work_dir, "c")
    torch.cuda.synchronize()
    at_c = {k: v.clone() for k, v in _state_tensors(state).items()}
    rng_at = (torch.get_rng_state(), torch.cuda.get_rng_state())
    before = _coordination_counters()
    t0 = time.monotonic()
    pending = Snapshot.async_take(path_c, app, pg=pg, replicated=REPLICATED)
    call_s = time.monotonic() - t0
    t1 = time.monotonic()
    state, _ = train_step(state, tokens)
    torch.cuda.current_stream().synchronize()
    step_beside_drain_s = time.monotonic() - t1
    pending.wait()
    d2h, requests, store_s = (a - b for a, b in zip(_coordination_counters(), before))
    markers = [d for d, _, fs in os.walk(path_c) if SNAPSHOT_METADATA_FNAME in fs]
    _require(markers == [path_c], f"async take commit markers: {markers}")
    fresh = fresh_app(2)
    Snapshot(path_c, pg=pg).restore(fresh)
    torch.cuda.synchronize()
    check_restored(fresh, at_c, own_at, rng_at, f"rank {rank} restore of the async take")
    record["c"] = {
        "call_s": call_s, "visible_s": pending.visible_s, "staged_s": pending.staged_s,
        "committed_s": pending.committed_s, "step_beside_drain_s": step_beside_drain_s,
        "d2h_bytes": d2h, "store_requests": requests, "store_s": store_s,
    }
    del fresh, at_c
    torch.cuda.empty_cache()

    # (e) The managed loop: full save 1, async save 2, incremental save 3
    # with the embedding and layers 0-3 frozen, then SIGTERM on rank 1 only
    # and one agreed save on both ranks.
    root = os.path.join(work_dir, "managed")
    mgr = CheckpointManager(root, keep_last_n=2, incremental=True, pg=pg)
    n_frozen = cfg.n_layers // 2

    def freeze(model) -> None:
        for p in [model.embed] + [p for blk in model.layers[:n_frozen] for p in blk.parameters()]:
            p.requires_grad_(False)

    saves = {}
    saver = PreemptionSaver(pg=pg, signals=(signal.SIGTERM,), poll_interval=0.05, session="ranks")
    try:
        state, _ = train_step(state, tokens)
        _require(not saver.should_save(1), "should_save(1) before any signal")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        mgr.save(1, app, replicated=REPLICATED)
        saves[1] = {"s": time.monotonic() - t0}
        freeze(state.model)
        state, _ = train_step(state, tokens)
        _require(not saver.should_save(2), "should_save(2) before any signal")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        pending = mgr.async_save(2, app, replicated=REPLICATED)
        visible_s = time.monotonic() - t0
        state, _ = train_step(state, tokens)  # step 3's update beside the drain
        torch.cuda.current_stream().synchronize()
        pending.wait()
        saves[2] = {"s": time.monotonic() - t0, "visible_s": visible_s, "committed_s": pending.committed_s}
        _require(not saver.should_save(3), "should_save(3) before any signal")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        mgr.save(3, app, replicated=REPLICATED)
        saves[3] = {"s": time.monotonic() - t0}
        agreed = None
        for step in range(4, 40):
            state, _ = train_step(state, tokens)
            torch.cuda.synchronize()
            if rank == 1 and step == 4:
                os.kill(os.getpid(), signal.SIGTERM)
            if saver.should_save(step):
                agreed = step
                at_t = {k: v.clone() for k, v in _state_tensors(state).items()}
                rng_at = (torch.get_rng_state(), torch.cuda.get_rng_state())
                t0 = time.monotonic()
                mgr.save(step, app, replicated=REPLICATED)
                saves[step] = {"s": time.monotonic() - t0, "preemption": True}
                break
        _require(agreed is not None, f"rank {rank}: the ranks never agreed on a preemption save")
    finally:
        saver.close()
    agreed_all = wrapper.all_gather_object(agreed)
    _require(len(set(agreed_all)) == 1, f"the ranks saved at different steps: {agreed_all}")
    wrapper.barrier()  # rank 0's index write and retention are done
    if rank == 0:
        # Rank 0 alone appends to the root's run ledger: one run, one
        # stall and one committed record per take, none twice.
        events = [r["event"] for r in _ledger_events(root)]
        committed = [r["step"] for r in _ledger_events(root) if r["event"] == "step-committed"]
        _require(
            events.count("run-start") == 1 and _ledger_events(root)[0].get("world_size") == RANKS
            and events.count("visible-stall") == len(saves) and len(committed) == len(set(committed)),
            f"the two-rank run's ledger: {events}",
        )
        record["ledger_events"] = len(events)
    retained = mgr.all_steps()
    _require(retained == [3, agreed], f"retained steps {retained}, expected [3, {agreed}]")
    refs = {s: sorted(referenced_steps(Snapshot(mgr.step_path(s)).metadata.manifest)) for s in retained}
    fsck = {}
    for s in retained:
        t0 = time.monotonic()
        report = verify_snapshot(mgr.step_path(s), deep=True)
        fsck[s] = time.monotonic() - t0
        _require(report.ok, f"rank {rank}: deep fsck of step {s}: {report.problems[:5]}")
    fresh = fresh_app(3)
    t0 = time.monotonic()
    step = mgr.restore_latest(fresh)
    torch.cuda.synchronize()
    restore_latest_s = time.monotonic() - t0
    _require(step == agreed, f"restore_latest returned {step}, the agreed step was {agreed}")
    check_restored(fresh, at_t, own_at, rng_at, f"rank {rank} restore_latest")
    freeze(fresh["train"].model)
    _, loss_a = train_step(state, tokens)
    _, loss_b = train_step(fresh["train"], tokens)
    torch.cuda.synchronize()
    _require(same_bits(loss_a, loss_b), f"next-step losses differ after restore_latest: {loss_a} vs {loss_b}")
    record["e"] = {
        "saves": saves, "agreed_step": agreed, "retained": retained, "refs": refs,
        "fsck_deep_s": fsck, "restore_latest_s": restore_latest_s,
    }
    del fresh, at_t
    torch.cuda.empty_cache()

    # (g) Two managed saves with the autotuner on: rank 0 decides after
    # each commit and both ranks apply the vector it broadcasts.
    from torchsnapshot_tpu_torch import knobs
    from torchsnapshot_tpu_torch.tuner import current_vector

    with knobs.enable_autotune():
        mgr_t = CheckpointManager(os.path.join(work_dir, "tuned"), keep_last_n=2, pg=pg)
        tuned_s = []
        for step in (1, 2):
            state, _ = train_step(state, tokens)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            mgr_t.save(step, app, replicated=REPLICATED)
            tuned_s.append(time.monotonic() - t0)
        vectors = wrapper.all_gather_object(current_vector())
    _require(vectors[0] == vectors[1], f"the ranks applied different vectors: {vectors}")
    record["g"] = {"saves_s": tuned_s, "vector": vectors[rank]}

    # (f) A failing rank: rank 1's data writes fail.
    path_f = os.path.join(work_dir, "f")
    faulty = faulty_fs_plugin(lambda p: p.startswith(("replicated/", f"{rank}/")), exc_msg="injected write failure")
    failed = None
    t0 = time.monotonic()
    try:
        with patch_storage_plugin(faulty if rank == 1 else FSStoragePlugin):
            Snapshot.take(path_f, app, pg=pg, replicated=REPLICATED)
    except Exception as e:  # noqa: BLE001 - the leg expects it
        failed = repr(e)
    fail_s = time.monotonic() - t0
    _require(failed is not None, f"rank {rank}: the take with a failing rank 1 did not raise")
    _require(fail_s < 30.0, f"rank {rank} raised after {fail_s:.1f} s")
    wrapper.barrier()
    _require(
        not os.path.exists(os.path.join(path_f, SNAPSHOT_METADATA_FNAME)),
        "a commit marker was left by the failed take",
    )
    record["f"] = {"raised_s": fail_s, "error": failed[:200]}

    launches = {**fa.launch_counts, **dd.launch_counts}
    _require(
        all(launches[name] for name in MAIN_PATH_KERNELS),
        f"rank {rank}: a kernel of the path never launched in the ranks phase: {launches}",
    )
    record["launches"] = launches
    record["worker_s"] = time.monotonic() - t_start
    return record


# The ranks phase's storm leg: the scale model's simulated ranks (threads of
# this process) over the package's barriers, store and fan-out exchange.
STORM_WORLD = 256
STORM_KILLED = frozenset({7, 41, 200})
STORM_TIMEOUT_S = 60.0


def storm_leg() -> dict:
    """``scalemodel.run_storm`` at world 256, host only: at step 0 the save
    and restore storms run to the end and every rank's exchanged bytes
    verify; at step 1 three ranks are preempted mid-round, and every
    survivor must abandon with ``BarrierError`` / ``FanoutError`` well
    inside the round timeout."""
    import collections

    from torchsnapshot_tpu_torch.scalemodel import StormConfig, run_storm

    t0 = time.monotonic()
    r = run_storm(StormConfig(
        world_size=STORM_WORLD, steps=2, kill_ranks=STORM_KILLED, kill_step=1, timeout_s=STORM_TIMEOUT_S,
    ))
    wall_s = time.monotonic() - t0
    survivors = sorted(set(range(STORM_WORLD)) - STORM_KILLED)
    _require(r.survivors_aborted_cleanly(), f"storm: {r.hung_ranks} ranks hung, errors of {len(r.errors)} ranks")
    _require(all("SimulatedPreemption" in r.errors[k] for k in STORM_KILLED), "storm: a victim was not preempted")
    abandoned = [k for k in survivors if r.errors[k].startswith(("BarrierError", "FanoutError"))]
    _require(len(abandoned) == len(survivors),
             f"storm: survivors {sorted(set(survivors) - set(abandoned))[:5]} raised otherwise: "
             f"{[r.errors[k] for k in survivors if k not in abandoned][:2]}")
    _require(r.verified_ranks == STORM_WORLD, f"storm: {r.verified_ranks} of {STORM_WORLD} exchanges verified")
    _require(wall_s < STORM_TIMEOUT_S / 2, f"storm: the survivors took {wall_s:.1f} s to abandon")
    return {
        "world": STORM_WORLD, "killed": sorted(STORM_KILLED), "wall_s": wall_s, "straggler_s": r.max_s,
        "mean_s": r.mean_s, "store_requests": r.store_requests, "store_request_ops": r.store_request_ops,
        "hot_data_key": r.hot_data_key, "hot_data_key_touches": r.hot_data_key_touches,
        "errors": dict(sorted(collections.Counter(e.split("(")[0] for e in r.errors.values()).items())),
    }


def ranks_phase(args, work_dir: str, card: str) -> dict:
    """Two processes on the card (rank r on card r % count), each training
    the main configuration and checkpointing it through a process group of
    the package's TCP store (only metadata moves between them). The parent
    first takes a world-1 snapshot of the same state with the same globs,
    and afterwards restores the two-rank snapshot at world 1 (leg d)."""
    import torch

    from torchsnapshot_tpu_torch import RngState, Snapshot, TensorTreeState
    from torchsnapshot_tpu_torch.models.transformer import (
        init_train_state,
        make_train_step,
        random_tokens,
    )
    from torchsnapshot_tpu_torch.test_utils import run_multiprocess

    t_phase = time.monotonic()
    ranks_dir = os.path.join(work_dir, "ranks")
    os.makedirs(ranks_dir, exist_ok=True)
    cfg = main_config()
    tokens = torch.from_numpy(random_tokens(cfg, 8, 1024, args.seed)).cuda()
    state = init_train_state(cfg, seed=args.seed)
    train_step = make_train_step(cfg)
    for _ in range(STEPS):
        state, _ = train_step(state, tokens)
    torch.cuda.synchronize()
    Snapshot.take(os.path.join(ranks_dir, "world1"), {"train": state}, replicated=REPLICATED)

    t0 = time.monotonic()
    records = run_multiprocess(ranks_worker, RANKS, args=(args.seed, ranks_dir), timeout=600.0)
    workers_s = time.monotonic() - t0

    # (d) Elastic restore: this process, at world size 1, restores the
    # two-rank snapshot of leg (a): the replicated state and rank 0's
    # per-rank leaves; rank 1's tensor through read_object("1/own/x").
    fresh = {
        "train": init_train_state(cfg, seed=args.seed + 1),
        "rng": RngState(),
        "own": TensorTreeState({"x": torch.zeros(OWN_NUMEL, device="cuda")}),
    }
    path_a = os.path.join(ranks_dir, "a")
    t0 = time.monotonic()
    Snapshot(path_a).restore(fresh)
    torch.cuda.synchronize()
    elastic_s = time.monotonic() - t0
    _require_same_state(_state_tensors(state), fresh["train"], "world-1 restore of the two-rank snapshot")
    _require(same_bits(fresh["own"].tree["x"], _own_tensor(args.seed, 0)), "rank 0's per-rank tensor differs")
    rng_0 = records[0].pop("rng_at_take")
    records[1].pop("rng_at_take")
    _require(
        (torch.get_rng_state().numpy().tobytes(), torch.cuda.get_rng_state().numpy().tobytes()) == rng_0,
        "rank 0's per-rank RNG state differs after the world-1 restore",
    )
    t0 = time.monotonic()
    own_1 = Snapshot(path_a).read_object("1/own/x", obj_out=torch.zeros(OWN_NUMEL, device="cuda"))
    torch.cuda.synchronize()
    read_object_s = time.monotonic() - t0
    _require(same_bits(own_1, _own_tensor(args.seed, 1)), "rank 1's per-rank tensor differs (read_object)")
    del fresh, state, own_1
    torch.cuda.empty_cache()
    storm = storm_leg()

    wall_s = time.monotonic() - t_phase
    record = {
        "card": card, "ranks": records, "workers_s": workers_s,
        "d": {"restore_s": elastic_s, "read_object_s": read_object_s}, "storm": storm, "wall_s": wall_s,
    }
    for r in records:
        a, c = r["a"], r["c"]
        log(
            f"ranks: rank {r['rank']} on card {r['device']}: take {a['take_s']:.3f} s, "
            f"{a['replicated_written_bytes'] / 1e9:.3f} of {a['replicated_bytes'] / 1e9:.3f} GB replicated "
            f"written ({a['replicated_share']:.3f}), {a['d2h_bytes'] / 1e9:.3f} GB to the host, "
            f"{a['store_requests']:.0f} store requests in {a['store_s']:.4f} s (the report gather's included"
            + (f"; rank 0's report aggregates {a['aggregated_metrics']} metrics" if r["rank"] == 0 else "")
            + f"); restore {r['b']['restore_s']:.3f} s; async_take call {c['call_s']:.4f} s, committed "
            f"{c['committed_s']:.3f} s; managed saves "
            + ", ".join(f"{s}: {v['s']:.3f} s" for s, v in r["e"]["saves"].items())
            + "; tuned saves " + ", ".join(f"{x:.3f}" for x in r["g"]["saves_s"])
            + f" s, applied vector {r['g']['vector']}"
            + f"; failing peer raised in {r['f']['raised_s']:.2f} s; launches {r['launches']}"
        )
        log(f"ranks: rank {r['rank']} take (a) wire: {_wire_line(a['wire'])}")
    log(
        f"ranks: storm of {storm['world']} simulated ranks, {len(storm['killed'])} preempted at step 1: "
        f"abandoned in {storm['wall_s']:.3f} s ({storm['errors']}); straggler s "
        + ", ".join(f"{k} {v:.4f}" for k, v in storm["straggler_s"].items())
        + f"; {storm['store_requests']} store requests {storm['store_request_ops']}; hottest data key "
        f"{storm['hot_data_key']!r} touched {storm['hot_data_key_touches']} times"
    )
    log(
        f"ranks: world-1 restore of the two-rank snapshot {elastic_s:.3f} s, read_object(1/own/x) "
        f"{read_object_s:.3f} s, bit-identical; workers {workers_s:.1f} s, phase {wall_s:.1f} s on {card}"
    )
    _headline("ranks", take_s=[r["a"]["take_s"] for r in records], restore_s=[r["b"]["restore_s"] for r in records],
              world1_restore_s=elastic_s, take_store_rpc_s=[r["a"]["wire"]["rpc_s"] for r in records],
              storm_abandon_s=storm["wall_s"])
    print(json.dumps({"ranks": record}), flush=True)
    return record


# ----------------------------------------------------------------------
# Phase 6: sharded (DTensor) state across two ranks on the card
# ----------------------------------------------------------------------

# Two extra leaves for the uneven cases: rows that do not divide over the
# ranks, and one row (rank 1's box is empty).
UNEVEN_SHAPES = {"extra/uneven": (1001, 4096), "extra/one": (1, 4096)}


def _tp_dim(t) -> int:
    """The tensor-parallel layout of leg (c1): columns (rows for 1-d
    leaves)."""
    return 1 if t.dim() > 1 else 0


def _extra_leaves(seed: int) -> dict:
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    return {k: torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16) for k, shape in UNEVEN_SHAPES.items()}


def _replica_leaves(state, seed: int) -> dict:
    """The train state's tensors by name (``_state_tensors``) plus the two
    extra leaves: the global values every rank holds."""
    return {**_state_tensors(state), **_extra_leaves(seed)}


def _dtensor_tree(leaves: dict, mesh, dim_of=lambda t: 0) -> dict:
    """FSDP style: every CUDA leaf of at least one dimension becomes a
    DTensor ``Shard(dim_of(t))`` built by ``from_local`` of this rank's
    chunk (torch's layout, ``compute_local_shape_and_global_offset``); the
    0-d step counters and the RNG state stay per-rank plain tensors."""
    from torch.distributed.tensor import DTensor, Shard

    out = {}
    for name, t in leaves.items():
        if not t.is_cuda or t.dim() == 0:
            out[name] = t.clone()
            continue
        placements = [Shard(dim_of(t))]
        out[name] = DTensor.from_local(
            _expected_local(t, mesh, placements).clone(), mesh, placements,
            run_check=False, shape=t.shape, stride=t.stride(),
        )
    return out


def _expected_local(full, mesh, placements):
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(full.shape, mesh, placements)
    return full[tuple(slice(o, o + n) for o, n in zip(offset, shape))]


def _require_shards(tree: dict, leaves: dict, what: str) -> None:
    """Each DTensor's local shard is bit for bit its rank's chunk of the
    global value; each plain leaf equals it whole."""
    for name, x in tree.items():
        want = leaves[name]
        if hasattr(x, "device_mesh"):
            got, want = x.to_local(), _expected_local(want, x.device_mesh, x.placements)
        else:
            got = x
        _require(same_bits(got, want), f"{what}: {name} differs")


def _require_tiling(path: str) -> int:
    """Every sharded entry's saved boxes tile its array: no hole, no
    overlap. Returns the entries checked."""
    from torchsnapshot_tpu_torch import Snapshot
    from torchsnapshot_tpu_torch.manifest import ShardedArrayEntry, get_manifest_for_rank

    n = 0
    for name, entry in get_manifest_for_rank(Snapshot(path).metadata, 0).items():
        if not isinstance(entry, ShardedArrayEntry):
            continue
        boxes = [(s.offsets, s.sizes) for s in entry.shards]
        vol = sum(math.prod(sz) for _, sz in boxes)
        total = math.prod(entry.shape)
        _require(vol == total, f"{name}: the saved boxes hold {vol} of {total} elements")
        for i, (oa, sa) in enumerate(boxes):
            for ob, sb in boxes[i + 1:]:
                disjoint = any(a0 + an <= b0 or b0 + bn <= a0 for a0, an, b0, bn in zip(oa, sa, ob, sb))
                _require(disjoint, f"{name}: saved boxes {oa}+{sa} and {ob}+{sb} overlap")
        n += 1
    return n


def _rank_blobs(path: str, rank: int, prefix: str) -> tuple:
    """``(count, bytes)`` of the blobs under ``prefix`` that ``rank`` wrote
    (its checksum table lists each blob it wrote; refs are not written)."""
    with open(os.path.join(path, "checksums", str(rank))) as f:
        table = json.load(f)
    blobs = [loc for loc in table if loc.startswith(prefix)]
    return len(blobs), sum(os.path.getsize(os.path.join(path, loc)) for loc in blobs)


def _changed_piece_bytes(before: dict, after: dict, chunk: int) -> int:
    """Bytes of this rank's local pieces (its DTensors' boxes cut as a
    digest-enabled take cuts them) whose bits differ."""
    total = 0
    for name, a in before.items():
        if not hasattr(a, "device_mesh"):
            continue
        la, lb = a.to_local(), after[name].to_local()
        if la.numel() == 0:
            continue
        row = la[0].numel() * la.element_size()
        rows = max(1, chunk // max(1, row)) if la.numel() * la.element_size() > chunk else la.shape[0]
        for r in range(0, la.shape[0], rows):
            x, y = la[r:r + rows], lb[r:r + rows]
            if not same_bits(x, y):
                total += x.numel() * x.element_size()
    return total


def sharded_worker(pg, seed: int, work_dir: str) -> dict:
    """One rank of the sharded phase (spawned by ``run_multiprocess``; the
    parent built every kernel): a gloo default group, a ``cuda`` device
    mesh of 2, the main configuration trained from ``--seed`` and expressed
    FSDP-style as ``Shard(0)`` DTensors; legs (a), (b), (c1), (c3), (d),
    (e), (f) of the module docstring. Returns the rank's record."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard

    from torchsnapshot_tpu_torch import Snapshot, TensorTreeState, knobs
    from torchsnapshot_tpu_torch.flatten import _encode
    from torchsnapshot_tpu_torch.fsck import verify_snapshot
    from torchsnapshot_tpu_torch.models.transformer import (
        init_train_state,
        make_train_step,
        random_tokens,
    )
    from torchsnapshot_tpu_torch.ops import device_digest as dd
    from torchsnapshot_tpu_torch.ops import device_pack as dp
    from torchsnapshot_tpu_torch.ops import flash_attention as fa
    from torchsnapshot_tpu_torch.ops import kernels
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper
    from torchsnapshot_tpu_torch.snapshot import SNAPSHOT_METADATA_FNAME
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
    from torchsnapshot_tpu_torch.telemetry import names
    from torchsnapshot_tpu_torch.test_utils import init_torch_group, patch_storage_plugin

    t_start = time.monotonic()
    # The peer tier off: this phase's checks are of the write and read
    # paths without it (each rank's bytes written, the file sets, which
    # plugin reads a blob); the peer phase drives the tier.
    os.environ["TORCHSNAPSHOT_TPU_PEER_TIER"] = "0"
    rank = pg.rank
    wrapper = PGWrapper(pg)
    torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    missing = [n for n in kernels.kernel_names() if not os.path.exists(kernels._library_path(n))]
    _require(not missing, f"rank {rank}: kernels {missing} not built by the parent")
    init_torch_group(pg)  # gloo: no tensor collective on the checkpoint path
    try:
        mesh = init_device_mesh("cuda", (pg.world_size,))
        cfg = main_config()
        tokens = torch.from_numpy(random_tokens(cfg, 8, 1024, seed)).cuda()
        state = init_train_state(cfg, seed=seed)
        train_step = make_train_step(cfg)
        for counts in (fa.launch_counts, dd.launch_counts, dp.launch_counts):
            for k in counts:
                counts[k] = 0
        for _ in range(STEPS):
            state, _ = train_step(state, tokens)
        torch.cuda.synchronize()
        n_leaves = _require_replicas_equal(pg, state)
        with torch.no_grad():
            logits = state.model(tokens)  # the evaluation forward: the fused kernel
        _require(bool(torch.isfinite(logits).all()), "evaluation logits not finite")
        del logits
        record = {"rank": rank, "device": torch.cuda.current_device(), "replica_leaves": n_leaves}

        def d2h() -> float:
            return _counter(names.DEVICE_TO_HOST_BYTES_TOTAL)

        def fresh_tree(shift: int, dim_of=lambda t: 0) -> dict:
            other = _replica_leaves(init_train_state(cfg, seed=seed + shift), seed + shift)
            return _dtensor_tree(other, mesh, dim_of)

        # (a) Take of the FSDP-style state (digests recorded: the base of d).
        leaves_a = _replica_leaves(state, seed)
        tree_a = _dtensor_tree(leaves_a, mesh)
        path_a = os.path.join(work_dir, "a")
        before = d2h()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with _env(RECORDS_ON):
            Snapshot.take(path_a, {"train": TensorTreeState(tree_a)}, pg=pg, record_digests=True)
        take_s = time.monotonic() - t0
        copied = d2h() - before
        wrapper.barrier()  # both ranks' reports are in the log
        aggregated = _require_gathered_reports(path_a, "take") if rank == 0 else None
        markers = [d for d, _, fs in os.walk(path_a) if SNAPSHOT_METADATA_FNAME in fs]
        _require(markers == [path_a], f"commit markers: {markers}")
        tiled = _require_tiling(path_a)
        n_blobs, written = _rank_blobs(path_a, rank, "sharded/")
        sharded_total = sum(
            os.path.getsize(os.path.join(d, f))
            for d, _, fs in os.walk(os.path.join(path_a, "sharded")) for f in fs
        )
        _require(sharded_total == sum(
            t.numel() * t.element_size() for t in leaves_a.values() if t.is_cuda and t.dim() > 0
        ), "the sharded blobs do not hold the sharded leaves' bytes")
        share = written / sharded_total
        _require(abs(share - 0.5) <= 0.01, f"rank {rank} wrote {share:.4f} of the sharded bytes")
        _require(abs(copied / sharded_total - 0.5) <= 0.01,
                 f"rank {rank} copied {copied} bytes to the host, not half of {sharded_total} within 1%")
        record["a"] = {
            "take_s": take_s, "d2h_bytes": copied, "written_bytes": written, "blobs": n_blobs,
            "sharded_bytes": sharded_total, "share": share, "entries_tiled": tiled,
            "aggregated_metrics": aggregated,
        }

        # (b) Restore, same layout, into DTensors from --seed + 1.
        tree_b = fresh_tree(1)
        _require(not same_bits(tree_b["param/embed"].to_local(), tree_a["param/embed"].to_local()),
                 "the fresh state equals the trained one")
        storage_b = tree_b["param/embed"].to_local().data_ptr()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        app_b = {"train": TensorTreeState(tree_b)}
        Snapshot(path_a, pg=pg).restore(app_b)
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        _require_shards(app_b["train"].tree, leaves_a, f"rank {rank} restore (b)")
        _require(app_b["train"].tree["param/embed"].to_local().data_ptr() == storage_b,
                 "restore (b) did not land in place in the DTensor's local tensor")
        record["b"] = {"restore_s": restore_s}
        del tree_b, app_b

        # (c1) Elastic: into the tensor-parallel layout (Shard(1)).
        class CountingFS(FSStoragePlugin):
            ranged = whole = 0

            async def read(self, read_io):
                self._count(read_io)
                return await super().read(read_io)

            async def read_with_checksum(self, read_io):
                self._count(read_io)
                return await super().read_with_checksum(read_io)

            def _count(self, read_io):
                if read_io.path.startswith("sharded/"):
                    if read_io.byte_range is None:
                        type(self).whole += 1
                    else:
                        type(self).ranged += 1

        tree_c = fresh_tree(1, _tp_dim)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with patch_storage_plugin(CountingFS):
            Snapshot(path_a, pg=pg).restore({"train": TensorTreeState(tree_c)})
        torch.cuda.synchronize()
        c1_s = time.monotonic() - t0
        _require_shards(tree_c, leaves_a, f"rank {rank} restore into Shard(1) (c1)")
        record["c1"] = {"restore_s": c1_s, "ranged_reads": CountingFS.ranged, "whole_reads": CountingFS.whole}
        del tree_c

        # (c3) read_object under a layout of one leaf, the uneven one.
        t0 = time.monotonic()
        one = Snapshot(path_a).read_object(f"0/train/{_encode('extra/uneven')}", sharding=(mesh, [Shard(1)]))
        torch.cuda.synchronize()
        record["c3"] = {"read_object_s": time.monotonic() - t0}
        _require(one.placements == (Shard(1),) and one.to_local().is_cuda, "read_object: not a Shard(1) DTensor on the card")
        _require(same_bits(one.to_local(), _expected_local(leaves_a["extra/uneven"], mesh, [Shard(1)])),
                 "read_object(sharding=) differs")
        del one

        # (g) Fan-out restore: (a)'s snapshot into Shard(1), sync and async,
        # with the knob at its default (on), then off. With it on, each
        # sharded blob is read from storage once across the ranks.
        record["g"] = _fanout_leg(pg, wrapper, path_a, leaves_a, lambda: fresh_tree(1, _tp_dim))

        # (d) Incremental take: embedding and layers 0-3 frozen, one step.
        n_frozen = cfg.n_layers // 2
        for prm in [state.model.embed] + [prm for blk in state.model.layers[:n_frozen] for prm in blk.parameters()]:
            prm.requires_grad_(False)
        state, _ = train_step(state, tokens)
        torch.cuda.synchronize()
        leaves_d = _replica_leaves(state, seed)
        tree_d = _dtensor_tree(leaves_d, mesh)
        changed = _changed_piece_bytes(tree_a, tree_d, knobs.get_incremental_chunk_size_bytes())
        digests_before = dd.launch_counts["device_digest"]
        path_d = os.path.join(work_dir, "d")
        before = d2h()
        t0 = time.monotonic()
        Snapshot.take(path_d, {"train": TensorTreeState(tree_d)}, pg=pg, incremental_base=path_a)
        incr_s = time.monotonic() - t0
        copied = d2h() - before
        _, written = _rank_blobs(path_d, rank, "sharded/")
        _require(dd.launch_counts["device_digest"] == digests_before + 1,
                 "the incremental take did not launch the digest kernel once")
        _require(written == changed, f"rank {rank} wrote {written} sharded bytes, its changed pieces hold {changed}")
        _require(copied == changed, f"rank {rank} copied {copied} bytes to the host, changed {changed}")
        tree_r = fresh_tree(2)
        Snapshot(path_d, pg=pg).restore({"train": TensorTreeState(tree_r)})
        torch.cuda.synchronize()
        _require_shards(tree_r, leaves_d, f"rank {rank} restore of the incremental take (d)")
        record["d"] = {"take_s": incr_s, "changed_bytes": changed, "written_bytes": written, "d2h_bytes": copied}
        del tree_r, tree_a

        # (e) Batched takes of the sharded state, with the device pack and
        # member by member, through the zero-pack vectorized write and
        # staged into one slab buffer, in turns (the first of each
        # allocates its pinned buffers cold); each turn's restore is
        # bit-identical, and each slab-staged take writes the blobs and CRC
        # table of the vectorized take before it.
        e = {label: {"take_s": []} for label in ("pack", "pack_slab", "per_member", "per_member_slab")}
        turns = (("pack", True, True), ("pack_slab", True, False),
                 ("per_member", False, True), ("per_member_slab", False, False)) * 2
        for turn, (label, pack, vectorized) in enumerate(turns):
            path_e = os.path.join(work_dir, f"e_{turn}")
            packs_before = dp.launch_counts["device_pack"]
            before = d2h()
            avoided = _counter(names.BATCHER_PACK_BYTES_AVOIDED_TOTAL)
            with contextlib.ExitStack() as stack:
                stack.enter_context(knobs.enable_batching())
                stack.enter_context(knobs.enable_write_vectorized() if vectorized else knobs.disable_write_vectorized())
                if pack:
                    stack.enter_context(knobs.enable_device_pack())
                torch.cuda.synchronize()
                t0 = time.monotonic()
                Snapshot.take(path_e, {"train": TensorTreeState(tree_d)}, pg=pg)
                e[label]["take_s"].append(time.monotonic() - t0)
                copied = d2h() - before
                slabs, slab_bytes = _rank_blobs(path_e, rank, "batched/")
                e[label]["avoided_bytes"] = _counter(names.BATCHER_PACK_BYTES_AVOIDED_TOTAL) - avoided
                e[label]["signature"] = _blob_signature(path_e, rank)
                packs = dp.launch_counts["device_pack"] - packs_before
                if pack:
                    # One launch per slab that holds two or more members on the card.
                    cuda_members = {}
                    for key, entry in Snapshot(path_e).metadata.manifest.items():
                        if key.startswith(f"{rank}/") and type(entry).__name__ == "ShardedArrayEntry":
                            for shard in entry.shards:
                                loc = shard.array.location
                                cuda_members[loc] = cuda_members.get(loc, 0) + 1
                    want = sum(1 for loc, n in cuda_members.items() if loc.startswith("batched/") and n > 1)
                    _require(packs == want and want > 0,
                             f"rank {rank}: {packs} pack launches for {want} slabs of card members")
                else:
                    _require(packs == 0, "the pack ran with DEVICE_PACK unset")
                tree_r = fresh_tree(3)
                t0 = time.monotonic()
                Snapshot(path_e, pg=pg).restore({"train": TensorTreeState(tree_r)})
                torch.cuda.synchronize()
                e[label].setdefault("restore_s", []).append(time.monotonic() - t0)
            _require_shards(tree_r, leaves_d, f"rank {rank} restore of the batched take (e, {label})")
            e[label].update({"slabs": slabs, "slab_bytes": slab_bytes, "d2h_bytes": copied})
            e[label]["pack_launches"] = e[label].get("pack_launches", 0) + packs
            if not vectorized:
                vec = e[label.removesuffix("_slab")]
                _require_vectorized_pair(vec, e[label], f"rank {rank} (e, {label})")
            del tree_r
            shutil.rmtree(path_e, ignore_errors=True)
        _require(e["pack"]["signature"] == e["per_member"]["signature"],
                 f"rank {rank} (e): the device pack and member-by-member staging wrote other blobs")
        for r in e.values():
            del r["signature"]
        record["e"] = e

        # (f) Deep fsck of (a), and of a copy with one flipped byte.
        wrapper.barrier()
        if rank == 0:
            t0 = time.monotonic()
            report = verify_snapshot(path_a, deep=True)
            fsck_s = time.monotonic() - t0
            _require(report.ok, f"deep fsck of (a): {report.problems[:5]}")
            with open(os.path.join(path_a, "checksums", "1")) as f:
                victim = sorted(loc for loc in json.load(f) if loc.startswith("sharded/"))[0]
            bad = os.path.join(work_dir, "a_flipped")
            _flipped_copy(path_a, victim, bad)
            bad_report = verify_snapshot(bad, deep=True)
            _require(not bad_report.ok, "deep fsck missed a flipped byte in a shard blob")
            record["f"] = {"fsck_deep_s": fsck_s, "flipped": victim, "caught": [str(x) for x in bad_report.problems[:1]]}
        wrapper.barrier()

        launches = {**fa.launch_counts, **dd.launch_counts, **dp.launch_counts}
        _require(all(launches[k] for k in SHARDED_PATH_KERNELS),
                 f"rank {rank}: a kernel of the path never launched in the sharded phase: {launches}")
        record["launches"] = launches
        record["worker_s"] = time.monotonic() - t_start
        return record
    finally:
        dist.destroy_process_group()


def _fanout_leg(pg, wrapper, path: str, leaves: dict, make_tree) -> dict:
    """Leg (g) of the sharded phase on one rank: four restores of the
    snapshot at ``path`` into ``make_tree()`` (Shard(1) DTensors), fan-out
    on and off, sync and async, each bit-identical, with the sharded blobs
    read from storage counted across the ranks, the rank's seconds, its
    coordination-store requests and seconds, and its fan-out bytes."""
    import collections

    import torch

    from torchsnapshot_tpu_torch import Snapshot, TensorTreeState
    from torchsnapshot_tpu_torch.manifest import sharded_blob_windows
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
    from torchsnapshot_tpu_torch.telemetry import names
    from torchsnapshot_tpu_torch.test_utils import patch_storage_plugin

    class BlobReads(FSStoragePlugin):
        paths: list = []

        async def read(self, read_io):
            self._count(read_io)
            return await super().read(read_io)

        async def read_with_checksum(self, read_io):
            self._count(read_io)
            return await super().read_with_checksum(read_io)

        def _count(self, read_io):
            if read_io.path.startswith("sharded/"):
                BlobReads.paths.append(read_io.path)

    eligible = sorted(sharded_blob_windows(Snapshot(path).metadata.manifest))
    out = {}
    try:
        for fanout in (True, False):
            if not fanout:
                os.environ["TORCHSNAPSHOT_TPU_FANOUT_RESTORE"] = "0"
            for use_async in (False, True):
                label = ("on" if fanout else "off") + ("_async" if use_async else "")
                tree = make_tree()
                app = {"train": TensorTreeState(tree)}
                BlobReads.paths = []
                requests, store_s = _counter(names.COORD_STORE_REQUESTS_TOTAL), _counter(names.COORD_STORE_SECONDS_TOTAL)
                wrapper.barrier()
                torch.cuda.synchronize()
                t0 = time.monotonic()
                with patch_storage_plugin(BlobReads):
                    snapshot = Snapshot(path, pg=pg)
                    if use_async:
                        pending = snapshot.async_restore(app)
                        pending.wait()
                        io = pending.restore_telemetry
                    else:
                        snapshot.restore(app)
                        io = snapshot.restore_telemetry
                torch.cuda.synchronize()
                seconds = time.monotonic() - t0
                requests = _counter(names.COORD_STORE_REQUESTS_TOTAL) - requests
                store_s = _counter(names.COORD_STORE_SECONDS_TOTAL) - store_s
                _require_shards(tree, leaves, f"rank {pg.rank} fan-out restore (g, {label})")
                counts = collections.Counter(p for r in wrapper.all_gather_object(BlobReads.paths) for p in r)
                if fanout:
                    _require(sorted(counts) == eligible and set(counts.values()) == {1},
                             f"(g, {label}): sharded blobs read {dict(collections.Counter(counts.values()))} "
                             f"times across the ranks, {len(eligible)} blobs")
                else:
                    _require(sorted(counts) == eligible and sum(counts.values()) > len(eligible),
                             f"(g, {label}): every-rank-reads read {sum(counts.values())} times")
                out[label] = {
                    "restore_s": seconds, "blob_reads": len(BlobReads.paths),
                    "blob_reads_all_ranks": sum(counts.values()), "blobs": len(eligible),
                    "store_requests": requests, "store_s": store_s, **io,
                }
                del tree, app
    finally:
        os.environ.pop("TORCHSNAPSHOT_TPU_FANOUT_RESTORE", None)
    return out


# The kernels the sharded phase must launch on every rank.
SHARDED_PATH_KERNELS = ("flash_fwd", "flash_chunk", "device_digest", "device_pack")


def sharded_phase(args, work_dir: str, card: str) -> dict:
    """Two processes on the card train the main configuration and take,
    restore and reshard it as Shard(0) DTensors (legs a-f); then this
    process, at world size 1, restores the two-rank snapshot into plain
    CUDA tensors (c2): bit-identical to its own run of the same training,
    and one more step gives that run's loss bit for bit."""
    import torch

    from torchsnapshot_tpu_torch import Snapshot, TensorTreeState
    from torchsnapshot_tpu_torch.models.transformer import (
        init_train_state,
        make_train_step,
        random_tokens,
    )
    from torchsnapshot_tpu_torch.test_utils import run_multiprocess

    t_phase = time.monotonic()
    sharded_dir = os.path.join(work_dir, "sharded")
    os.makedirs(sharded_dir, exist_ok=True)
    t0 = time.monotonic()
    records = run_multiprocess(sharded_worker, RANKS, args=(args.seed, sharded_dir), timeout=600.0)
    workers_s = time.monotonic() - t0

    # (c2) World 1: the two-rank snapshot into plain CUDA tensors.
    cfg = main_config()
    tokens = torch.from_numpy(random_tokens(cfg, 8, 1024, args.seed)).cuda()
    replica = init_train_state(cfg, seed=args.seed)
    train_step = make_train_step(cfg)
    for _ in range(STEPS):
        replica, _ = train_step(replica, tokens)
    torch.cuda.synchronize()
    want = _replica_leaves(replica, args.seed)
    fresh = init_train_state(cfg, seed=args.seed + 1)
    dest = {k: torch.zeros_like(v) for k, v in want.items()}
    t0 = time.monotonic()
    Snapshot(os.path.join(sharded_dir, "a")).restore({"train": TensorTreeState(dest)})
    torch.cuda.synchronize()
    c2_s = time.monotonic() - t0
    for k, v in want.items():
        _require(same_bits(dest[k], v), f"world-1 restore of the two-rank snapshot: {k} differs")
    live = _state_tensors(fresh)
    with torch.no_grad():
        for k, t in live.items():
            if k != "rng":
                t.copy_(dest[k])
    fresh.rng.set_state(dest["rng"])
    fresh.step = replica.step
    _, loss_a = train_step(replica, tokens)
    _, loss_b = train_step(fresh, tokens)
    torch.cuda.synchronize()
    _require(same_bits(loss_a, loss_b), f"next-step losses differ after the world-1 restore: {loss_a} vs {loss_b}")
    del replica, fresh, dest, want
    torch.cuda.empty_cache()

    wall_s = time.monotonic() - t_phase
    record = {"card": card, "ranks": records, "workers_s": workers_s,
              "c2": {"restore_s": c2_s, "next_loss": float(loss_a)}, "wall_s": wall_s}
    for r in records:
        a, d, e = r["a"], r["d"], r["e"]
        log(
            f"sharded: rank {r['rank']} on card {r['device']}: (a) take {a['take_s']:.3f} s, wrote "
            f"{a['written_bytes'] / 1e9:.4f} of {a['sharded_bytes'] / 1e9:.4f} GB sharded ({a['share']:.6f}), "
            f"{a['d2h_bytes'] / 1e9:.4f} GB to the host, {a['entries_tiled']} entries tiled"
            + (f", the report aggregates {a['aggregated_metrics']} metrics" if r["rank"] == 0 else "")
            + f"; (b) restore "
            f"{r['b']['restore_s']:.3f} s; (c1) Shard(1) restore {r['c1']['restore_s']:.3f} s, "
            f"{r['c1']['ranged_reads']} ranged and {r['c1']['whole_reads']} whole shard reads; (c3) read_object "
            f"{r['c3']['read_object_s']:.4f} s; (d) incremental take {d['take_s']:.3f} s, "
            f"{d['written_bytes'] / 1e6:.3f} MB written = changed pieces; (e) batched takes, in turns, "
            + "; ".join(
                f"{label} {', '.join(f'{x:.3f}' for x in e[label]['take_s'])} s (restores "
                f"{', '.join(f'{x:.3f}' for x in e[label]['restore_s'])} s)"
                for label in ("pack", "pack_slab", "per_member", "per_member_slab")
            )
            + f" ({e['pack']['slabs']} slabs of {e['pack']['slab_bytes']} B, "
            f"{e['pack']['pack_launches'] + e['pack_slab']['pack_launches']} pack launches in all, "
            f"{e['pack']['avoided_bytes']:.0f} pack bytes avoided by a vectorized take, 0 by a slab-staged one; "
            f"blobs and CRC tables the same both ways); launches {r['launches']}"
        )
    for r in records:
        log(
            f"sharded: rank {r['rank']} (g) Shard(1) restores of (a): "
            + "; ".join(
                f"{label} {g['restore_s']:.3f} s, {g['blob_reads']} blob reads here "
                f"({g['blob_reads_all_ranks']} for {g['blobs']} blobs across the ranks), "
                f"{g['store_requests']:.0f} store requests in {g['store_s']:.3f} s, "
                f"{g['bytes_fetched'] / 1e9:.4f} GB from storage, {g['bytes_received'] / 1e9:.4f} GB received, "
                f"{g['bytes_published'] / 1e9:.4f} GB published"
                for label, g in r["g"].items()
            )
        )
    f = records[0]["f"]
    log(
        f"sharded: (f) deep fsck {f['fsck_deep_s']:.3f} s, caught the flipped byte in {f['flipped']}; (c2) "
        f"world-1 restore of the two-rank snapshot {c2_s:.3f} s, bit-identical, next loss "
        f"{float(loss_a)!r} bit for bit; workers {workers_s:.1f} s, phase {wall_s:.1f} s on {card}"
    )
    _headline("sharded", take_s=[r["a"]["take_s"] for r in records],
              restore_s=[r["b"]["restore_s"] for r in records], world1_restore_s=c2_s,
              e_vectorized_s=[x for r in records for x in r["e"]["pack"]["take_s"] + r["e"]["per_member"]["take_s"]],
              e_slab_s=[x for r in records for x in r["e"]["pack_slab"]["take_s"] + r["e"]["per_member_slab"]["take_s"]])
    print(json.dumps({"sharded": record}), flush=True)
    return record


# ----------------------------------------------------------------------
# The peer phase: the peer-RAM tier on the sharded state
# ----------------------------------------------------------------------


# The kernels the peer phase must launch on every rank: the training step
# and the evaluation forward (flash), the saves' digests.
PEER_PATH_KERNELS = ("flash_fwd", "flash_chunk", "device_digest")
# A dead-neighbour push gives up after this many seconds without progress;
# the default (30 s) would only lengthen leg (d).
PEER_TIMEOUT_S = 5.0


def _gather_train_state(tree: dict, world: int) -> dict:
    """The full train tensors of a Shard(0) DTensor tree (its ``param/``
    and ``opt/`` leaves and the RNG state), each gathered from every
    rank's restored local shard over the gloo group as CPU copies (the
    train state's shards are equal-sized), back on the card."""
    import torch
    import torch.distributed as dist

    out = {}
    for name in sorted(tree):
        if not name.startswith(("param/", "opt/")) and name != "rng":
            continue
        x = tree[name]
        if not hasattr(x, "device_mesh"):
            out[name] = x
            continue
        local = x.to_local().cpu().contiguous()
        parts = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(parts, local)
        out[name] = torch.cat(parts, dim=0).to("cuda")
    return out


def _next_loss(cfg, tensors: dict, step: int, tokens, train_step):
    """One training step from a train state loaded with ``tensors`` (as
    ``_state_tensors`` names them): its loss, and the evaluation logits'
    finiteness before it (the fused flash kernel)."""
    import torch

    from torchsnapshot_tpu_torch.models.transformer import init_train_state

    fresh = init_train_state(cfg, seed=12345)
    live = _state_tensors(fresh)
    _require(sorted(live) == sorted(tensors), "the restored tensors are not a train state's")
    with torch.no_grad():
        for k, t in live.items():
            if k != "rng":
                t.copy_(tensors[k])
        logits = fresh.model(tokens)
    _require(bool(torch.isfinite(logits).all()), "evaluation logits of the restored state not finite")
    del logits
    fresh.rng.set_state(tensors["rng"])
    fresh.step = step
    _, loss = train_step(fresh, tokens)
    torch.cuda.synchronize()
    del fresh, live
    return loss


class WireWindow:
    """One leg's wire record on one rank of a two-rank phase: the wire
    counters' deltas (RPCs and their seconds by op id, frame bytes by
    endpoint and direction) and the leg's ``wire:*`` spans, which every
    rank exports and then merges with both ranks' files
    (``trace.merge_traces``) to count the stitched client -> handler
    pairs in which it is the client."""

    def __init__(self, wrapper, rank: int, world: int, work_dir: str, leg: str) -> None:
        from torchsnapshot_tpu_torch import telemetry
        from torchsnapshot_tpu_torch.telemetry.trace import get_recorder

        self.wrapper, self.rank = wrapper, rank
        self.paths = [os.path.join(work_dir, f"wire-{leg}-rank{r}.json") for r in range(world)]
        self.mark = get_recorder().mark()
        self.counters = telemetry.metrics().counters_snapshot()

    def close(self) -> dict:
        """Export, wait for the other rank's file, merge; every rank calls it."""
        from torchsnapshot_tpu_torch import telemetry
        from torchsnapshot_tpu_torch.telemetry import names
        from torchsnapshot_tpu_torch.telemetry.registry import parse_series_key
        from torchsnapshot_tpu_torch.telemetry.trace import (
            chrome_trace,
            get_recorder,
            merge_traces,
            stitched_wire_pairs,
            write_trace_file,
        )

        rpcs: dict = {}
        frame_bytes: dict = {}
        for key, v in telemetry.metrics().counters_delta_since(self.counters).items():
            name, labels = parse_series_key(key)
            if name in (names.WIRE_RPCS_TOTAL, names.WIRE_RPC_SECONDS_TOTAL):
                rpcs.setdefault(labels["op"], [0.0, 0.0])[name == names.WIRE_RPC_SECONDS_TOTAL] += v
            elif name == names.WIRE_BYTES_TOTAL:
                key = f"{labels['endpoint']}/{labels['dir']}"
                frame_bytes[key] = frame_bytes.get(key, 0.0) + v
        rec = get_recorder()
        spans = [e for e in rec.events_since(self.mark) if e["name"] in (names.SPAN_WIRE_RPC, names.SPAN_WIRE_HANDLER)]
        write_trace_file(self.paths[self.rank], chrome_trace(
            spans, rec.tid_names(), rank=self.rank, dropped=rec.dropped - self.mark.dropped))
        self.wrapper.barrier()
        merged = merge_traces(self.paths)
        stitched: dict = {}
        for client, handler in stitched_wire_pairs(merged):
            if client["pid"] == self.rank and handler["pid"] != self.rank:
                op = client["args"]["op"]
                stitched[op] = stitched.get(op, 0) + 1
        clients: dict = {}
        for e in spans:
            if e["name"] == names.SPAN_WIRE_RPC:
                clients[e["args"]["op"]] = clients.get(e["args"]["op"], 0) + 1
        return {
            "rpcs": dict(sorted(rpcs.items())), "frame_bytes": dict(sorted(frame_bytes.items())),
            "stitched": dict(sorted(stitched.items())), "client_rpcs": dict(sorted(clients.items())),
            "stitched_total": merged["otherData"]["wire_stitched"],
            "dropped_events": merged["otherData"]["dropped_events"],
        }


def _peer_wire_line(leg: str, w: dict) -> str:
    return (
        f"{leg} RPCs " + ", ".join(f"{op} {n:.0f} in {sec:.4f} s" for op, (n, sec) in w["rpcs"].items())
        + "; frame MB " + ", ".join(f"{k} {v / 1e6:.3f}" for k, v in w["frame_bytes"].items())
        + "; stitched as the client " + ", ".join(
            f"{op} {w['stitched'].get(op, 0)} of {n}" for op, n in w["client_rpcs"].items())
    )


def wire_header_cost(frames: int = 20000) -> dict:
    """Host microseconds to put the trace header on a 256-byte frame and
    to take it off (``wire.encode_frame`` / ``decode_frame``)."""
    from torchsnapshot_tpu_torch.telemetry import names, wire

    ctx = wire.WireContext(wire.new_id(), wire.new_id(), names.RPC_PEER_PULL)
    body = bytes(256)
    t0 = time.perf_counter()
    for _ in range(frames):
        framed = wire.encode_frame(ctx, body)
    encode_us = (time.perf_counter() - t0) / frames * 1e6
    t0 = time.perf_counter()
    for _ in range(frames):
        got, _ = wire.decode_frame(framed)
    decode_us = (time.perf_counter() - t0) / frames * 1e6
    _require(got == ctx, "the header did not round-trip")
    return {"header_bytes": wire.HEADER_LEN, "encode_us": encode_us, "decode_us": decode_us}


def peer_worker(pg, seed: int, work_dir: str) -> dict:
    """One rank of the peer phase (spawned by ``run_multiprocess``; the
    parent built every kernel): the sharded phase's state (the main
    configuration as ``Shard(0)`` DTensors on a ``cuda`` mesh of 2 over a
    gloo default group) through ``CheckpointManager(root, pg=,
    keep_peer_last_n=1)`` with the peer tier on; legs (a)-(d) of the
    module docstring. Returns the rank's record."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    # The tier on (its default, pinned against the caller's environment),
    # a short transfer timeout for the dead neighbour of (d), and fan-out
    # off: with fan-out an owner chosen by a content hash would pull the
    # replacement's blobs and ship them on, and (b) holds the
    # replacement's own ladder.
    os.environ["TORCHSNAPSHOT_TPU_PEER_TIER"] = "1"
    os.environ["TORCHSNAPSHOT_TPU_PEER_TRANSFER_TIMEOUT_SECONDS"] = str(PEER_TIMEOUT_S)
    os.environ["TORCHSNAPSHOT_TPU_FANOUT_RESTORE"] = "0"

    from torchsnapshot_tpu_torch import CheckpointManager, TensorTreeState, telemetry
    from torchsnapshot_tpu_torch.fsck import verify_snapshot
    from torchsnapshot_tpu_torch.models.transformer import init_train_state, make_train_step, random_tokens
    from torchsnapshot_tpu_torch.ops import device_digest as dd
    from torchsnapshot_tpu_torch.ops import device_pack as dp
    from torchsnapshot_tpu_torch.ops import flash_attention as fa
    from torchsnapshot_tpu_torch.ops import kernels
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
    from torchsnapshot_tpu_torch.telemetry import names
    from torchsnapshot_tpu_torch.test_utils import init_torch_group, patch_storage_plugin
    from torchsnapshot_tpu_torch.tiered import peer

    t_start = time.monotonic()
    rank, world = pg.rank, pg.world_size
    wrapper = PGWrapper(pg)
    torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    missing = [n for n in kernels.kernel_names() if not os.path.exists(kernels._library_path(n))]
    _require(not missing, f"rank {rank}: kernels {missing} not built by the parent")
    init_torch_group(pg)
    root = os.path.join(work_dir, "root")
    try:
        mesh = init_device_mesh("cuda", (world,))
        cfg = main_config()
        tokens = torch.from_numpy(random_tokens(cfg, 8, 1024, seed)).cuda()
        state = init_train_state(cfg, seed=seed)
        train_step = make_train_step(cfg)
        for counts in (fa.launch_counts, dd.launch_counts, dp.launch_counts):
            for k in counts:
                counts[k] = 0
        for _ in range(STEPS):
            state, _ = train_step(state, tokens)
        torch.cuda.synchronize()
        _require_replicas_equal(pg, state)
        record = {"rank": rank, "device": torch.cuda.current_device()}

        def timed_step() -> float:
            nonlocal state
            torch.cuda.current_stream().synchronize()
            t0 = time.monotonic()
            state, _ = train_step(state, tokens)
            torch.cuda.current_stream().synchronize()
            return time.monotonic() - t0

        def zero_tree() -> dict:
            return _dtensor_tree({k: torch.zeros_like(v) for k, v in _replica_leaves(state, seed).items()}, mesh)

        def requests() -> float:
            return _counter(names.COORD_STORE_REQUESTS_TOTAL)

        def data_locations(step_path: str, r: int) -> dict:
            with open(os.path.join(step_path, "checksums", str(r))) as f:
                return json.load(f)

        neighbour = (rank + 1) % world
        mgr = CheckpointManager(root, pg=pg, keep_peer_last_n=1)
        rep = peer.get_replicator()
        _require(rep.configured and rep.cache.keep_last_n == 1, f"rank {rank}: the peer tier is not configured")

        # (a) A sync save, then an async save beside a training step; each
        # rank's neighbour then holds exactly the newer step's blobs of
        # this rank, and the older step is evicted from its cache.
        window = WireWindow(wrapper, rank, world, work_dir, "a")
        timed_step()
        alone_s = statistics.median(timed_step() for _ in range(3))
        tree = _dtensor_tree(_replica_leaves(state, seed), mesh)
        r0 = requests()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        mgr.save(1, {"train": TensorTreeState(tree)}, record_digests=True)
        save1_s = time.monotonic() - t0
        job1 = rep.last_job()
        # The step right after the save, beside the push worker: whether
        # the push still ran when the step began and when it ended.
        push1_busy = [not job1.done_evt.is_set()]
        beside_s = timed_step()
        push1_busy.append(not job1.done_evt.is_set())
        _require(peer.maybe_drain(timeout=120), f"rank {rank}: the push of step 1 did not settle")
        _require(job1.error is None and job1.blobs_failed == 0, f"rank {rank}: push of step 1: {job1.error!r}")
        del tree
        # Copies: the step run beside the async save updates the live leaves.
        leaves2 = {k: v.clone() for k, v in _replica_leaves(state, seed).items()}
        saved2 = {k: leaves2[k] for k in _state_tensors(state)}
        step2 = state.step
        tree = _dtensor_tree(leaves2, mesh)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        pending = mgr.async_save(2, {"train": TensorTreeState(tree)}, record_digests=True)
        async_visible_s = time.monotonic() - t0
        beside_async_s = timed_step()
        pending.wait()
        async_s = time.monotonic() - t0
        t0 = time.monotonic()
        _require(peer.maybe_drain(timeout=120), f"rank {rank}: the push of step 2 did not settle")
        drain2_s = time.monotonic() - t0
        job2 = rep.last_job()
        _require(job2.error is None and job2.blobs_failed == 0 and job2.blobs_refused == 0,
                 f"rank {rank}: push of step 2: {job2.error!r}, {job2.blobs_failed} failed, "
                 f"{job2.blobs_refused} refused")
        a_requests = requests() - r0
        del tree
        wrapper.barrier()  # every push settled: each cache is final
        wire_a = window.close()
        _require(wire_a["stitched"].get(names.RPC_PEER_PUSH, 0) >= 1,
                 f"rank {rank} (a): no push of its job stitched to the neighbour's handler: {wire_a}")
        step2_path = mgr.step_path(2)
        table = data_locations(step2_path, rank)
        endpoint = rep.endpoint_for(neighbour)
        client = peer.PeerClient(*endpoint, timeout=60)
        try:
            inventory = client.list_step(peer.peer_step_key(step2_path))
            _require(sorted(inventory) == sorted(table),
                     f"rank {rank}: the neighbour holds {len(inventory)} blobs of step 2, its table {len(table)}")
            for loc in sorted(table):
                _require(list(inventory[loc][:3]) == list(table[loc][:3]), f"rank {rank}: {loc}: other entry")
                got = client.pull(peer.peer_step_key(step2_path), loc)
                with open(os.path.join(step2_path, loc), "rb") as f:
                    _require(got is not None and bytes(got[1]) == f.read(), f"rank {rank}: {loc}: other bytes")
            _require(client.list_step(peer.peer_step_key(mgr.step_path(1))) == {},
                     f"rank {rank}: step 1 not evicted from the neighbour (keep_peer_last_n=1)")
            neighbour_stats = client.stats()
        finally:
            client.close()
        if rank == 0:
            report = verify_snapshot(step2_path, tier="peer")
            _require(report.ok, f"fsck --tier peer of step 2: {[str(p) for p in report.problems[:5]]}")
        record["a"] = {
            "save_s": save1_s, "async_visible_s": async_visible_s, "async_s": async_s,
            "push_s": [job1.seconds, job2.seconds], "push_bytes": [job1.bytes_pushed, job2.bytes_pushed],
            "push_blobs": [job1.blobs_pushed, job2.blobs_pushed], "drain_after_async_s": drain2_s,
            "step_alone_s": alone_s, "step_beside_push_s": beside_s, "push_busy_at_step": push1_busy,
            "step_beside_async_s": beside_async_s, "store_requests": a_requests,
            "neighbour_cache_bytes": neighbour_stats["bytes"], "neighbour_cache_steps": neighbour_stats["steps"],
            "wire": wire_a,
        }
        wrapper.barrier()

        # (b) Rank 1 is preempted: its process state and its cache go; the
        # replacement re-announces under rank 1 and restores from rank 0's
        # RAM, zero data blobs read from storage.
        class DataReads(FSStoragePlugin):
            paths: list = []

            async def read(self, read_io):
                self._count(read_io)
                return await super().read(read_io)

            async def read_with_checksum(self, read_io):
                self._count(read_io)
                return await super().read_with_checksum(read_io)

            def _count(self, read_io):
                if not read_io.path.startswith((".", "checksums", "cas/")):
                    DataReads.paths.append(read_io.path)

        def restore_leg(what: str, count: bool) -> dict:
            dest = zero_tree()
            DataReads.paths = []
            r = requests()
            wrapper.barrier()
            window = WireWindow(wrapper, rank, world, work_dir, what.split("(")[-1].rstrip(")"))
            torch.cuda.synchronize()
            t0 = time.monotonic()
            with patch_storage_plugin(DataReads) if count else contextlib.nullcontext():
                _require(mgr.restore_latest({"train": TensorTreeState(dest)}) == restored_step,
                         f"rank {rank} {what}: restore_latest restored another step")
            torch.cuda.synchronize()
            seconds = time.monotonic() - t0
            _require_shards(dest, want_leaves, f"rank {rank} {what}")
            full = _gather_train_state(dest, world)
            loss = _next_loss(cfg, full, want_step, tokens, train_step)
            _require(same_bits(loss, want_loss), f"rank {rank} {what}: next-step loss {loss} vs {want_loss}")
            del dest, full
            tele = dict(mgr.restore_telemetry)
            reads = len(DataReads.paths) if count else None  # None: not counted on this rank
            wire_leg = window.close()
            # Every pull job (a restore that took bytes from peer RAM) shows
            # in the merged trace as stitched client -> handler pairs.
            if tele.get("tier_split", {}).get("peer", 0) > 0:
                _require(wire_leg["stitched"].get(names.RPC_PEER_PULL, 0) >= 1,
                         f"rank {rank} {what}: no peer pull stitched to the serving handler: {wire_leg}")
            return {"restore_s": seconds, "data_reads": reads, "store_requests": requests() - r,
                    "telemetry": tele, "next_loss": float(loss), "wire": wire_leg}

        restored_step, want_leaves, want_step = 2, leaves2, step2
        want_loss = _next_loss(cfg, saved2, step2, tokens, train_step)
        del saved2, leaves2
        if rank == 1:
            del mgr
            peer.reset_peer_tier()
            mgr = CheckpointManager(root, pg=pg, keep_peer_last_n=1)
            _require(peer.get_replicator().configured, "the replacement's peer tier is not configured")
        b = restore_leg("peer-RAM restore (b)", count=(rank == 1))
        split = b["telemetry"].get("tier_split", {})
        if rank == 1:
            _require(b["data_reads"] == 0, f"the replacement read {b['data_reads']} data blobs from storage")
            share = split.get("peer", 0) / max(1, sum(split.values()))
            _require(share >= 0.95, f"the replacement took {share:.4f} of its bytes from peer RAM: {split}")
            _require(b["telemetry"]["bytes_fetched"] == 0 and b["telemetry"]["peer"]["failures"] == 0,
                     f"the replacement's telemetry: {b['telemetry']}")
            b["peer_share"] = share
        record["b"] = b

        # (c) Both caches wiped (a double preemption): storage alone.
        wrapper.barrier()
        del mgr
        peer.reset_peer_tier()
        mgr = CheckpointManager(root, pg=pg, keep_peer_last_n=1)
        wrapper.barrier()
        c = restore_leg("storage restore (c)", count=True)
        _require("peer" not in c["telemetry"].get("tier_split", {}), f"rank {rank} (c): {c['telemetry']}")
        _require(c["data_reads"] > 0, f"rank {rank} (c): no data blob read from storage")
        record["c"] = c

        # (d) Rank 0's server stops (a dead neighbour for rank 1). Both
        # ranks save step 3; rank 1's save does not wait on its push, which
        # degrades the tier; the restore falls through to storage.
        timed_step()
        tree = _dtensor_tree(_replica_leaves(state, seed), mesh)
        want_leaves, want_step = _replica_leaves(state, seed), state.step
        want_loss = _next_loss(cfg, _state_tensors(state), state.step, tokens, train_step)
        restored_step = 3
        failures = _counter(names.PEER_PUSH_FAILURES_TOTAL)
        wrapper.barrier()
        if rank == 0:
            peer.get_replicator().stop_server()
        wrapper.barrier()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        mgr.save(3, {"train": TensorTreeState(tree)}, record_digests=True)
        save3_s = time.monotonic() - t0
        del tree
        t0 = time.monotonic()
        drained = peer.maybe_drain(timeout=60)
        drain3_s = time.monotonic() - t0
        _require(drained, f"rank {rank}: the drain of step 3 did not settle within 60 s")
        job3 = peer.get_replicator().last_job()
        gauges = telemetry.metrics().collect()["gauges"]
        d = {"save_s": save3_s, "drain_s": drain3_s, "push_error": repr(job3.error),
             "push_failures": _counter(names.PEER_PUSH_FAILURES_TOTAL) - failures,
             "degraded_gauge": gauges.get(names.PEER_TIER_DEGRADED_STATE)}
        if rank == 1:
            _require(d["push_failures"] >= 1 and d["degraded_gauge"] == 1 and job3.error is not None,
                     f"rank 1 with a dead neighbour: {d}")
        else:
            _require(job3.error is None and d["push_failures"] == 0, f"rank 0's push of step 3: {d}")
        wrapper.barrier()
        d.update(restore_leg("restore after a dead neighbour (d)", count=True))
        split = d["telemetry"].get("tier_split", {})
        if rank == 1:
            _require(split.get("peer", 0) == 0 and d["data_reads"] > 0,
                     f"rank 1 (d): its blobs must come from storage: {d['telemetry']}")
            report = verify_snapshot(mgr.step_path(3), tier="peer")
            mine = sorted(data_locations(mgr.step_path(3), 1))
            missing = sorted(p.location for p in report.problems if p.kind == "missing")
            _require(not report.ok and missing == mine,
                     f"fsck --tier peer of step 3 names {len(missing)} unplaced blobs, rank 1 wrote {len(mine)}")
            d["fsck_unplaced"] = len(missing)
        else:
            _require(split.get("peer", 0) > 0, f"rank 0 (d): its blobs sit in rank 1's cache: {d['telemetry']}")
        record["d"] = d
        wrapper.barrier()

        launches = {**fa.launch_counts, **dd.launch_counts, **dp.launch_counts}
        _require(all(launches[k] for k in PEER_PATH_KERNELS),
                 f"rank {rank}: a kernel of the path never launched in the peer phase: {launches}")
        record["launches"] = launches
        record["worker_s"] = time.monotonic() - t_start
        peer.reset_peer_tier()
        return record
    finally:
        dist.destroy_process_group()


def peer_phase(args, work_dir: str, card: str) -> dict:
    """Two processes on the card run legs (a)-(d) of the peer tier on the
    sharded state (``peer_worker``). Prints one JSON line for the phase."""
    from torchsnapshot_tpu_torch.test_utils import run_multiprocess

    t_phase = time.monotonic()
    peer_dir = os.path.join(work_dir, "peer")
    os.makedirs(peer_dir, exist_ok=True)
    header = wire_header_cost()
    log(f"peer: the wire header, {header['header_bytes']} bytes: {header['encode_us']:.3f} us to put on a "
        f"256-byte frame, {header['decode_us']:.3f} us to take off (host)")
    records = run_multiprocess(peer_worker, RANKS, args=(args.seed, peer_dir), timeout=900.0)
    wall_s = time.monotonic() - t_phase
    for r in records:
        a, b, c, d = r["a"], r["b"], r["c"], r["d"]
        busy = a["push_busy_at_step"]
        beside = f"{a['step_beside_push_s']:.4f} s (the push running at its start {busy[0]}, at its end {busy[1]})"
        log(
            f"peer: rank {r['rank']} (a) save {a['save_s']:.3f} s, async save {a['async_s']:.3f} s "
            f"({a['async_visible_s']:.3f} s visible); pushes {a['push_s'][0]:.3f} and {a['push_s'][1]:.3f} s for "
            f"{a['push_bytes'][0] / 1e9:.4f} and {a['push_bytes'][1] / 1e9:.4f} GB ({a['push_blobs'][1]} blobs), "
            f"drain after the async save {a['drain_after_async_s']:.3f} s; step alone {a['step_alone_s']:.4f} s, "
            f"beside the push {beside}, beside the async save {a['step_beside_async_s']:.4f} s; "
            f"{a['store_requests']:.0f} store requests; the neighbour's cache {a['neighbour_cache_bytes'] / 1e9:.4f} "
            f"GB in {a['neighbour_cache_steps']} step"
        )
        log(
            f"peer: rank {r['rank']} (b) restore {b['restore_s']:.3f} s, tier split {b['telemetry'].get('tier_split')}, "
            f"{b['data_reads'] if b['data_reads'] is not None else 'uncounted'} data reads from storage; (c) from storage {c['restore_s']:.3f} s, "
            f"{c['data_reads']} data reads; (d) save {d['save_s']:.3f} s with a dead neighbour, drain "
            f"{d['drain_s']:.3f} s, {d['push_failures']:.0f} push failures, degraded {d['degraded_gauge']}, restore "
            f"{d['restore_s']:.3f} s, tier split {d['telemetry'].get('tier_split')}; store requests (b) "
            f"{b['store_requests']:.0f}, (c) {c['store_requests']:.0f}, (d) {d['store_requests']:.0f}; "
            f"launches {r['launches']}"
        )
        for leg, w in (("(a)", a["wire"]), ("(b)", b["wire"]), ("(c)", c["wire"]), ("(d)", d["wire"])):
            log(f"peer: rank {r['rank']} wire {_peer_wire_line(leg, w)}")
    record = {"card": card, "ranks": records, "wire_header": header, "wall_s": wall_s}
    log(f"peer: phase {wall_s:.1f} s on {card}")
    r1 = records[1]
    _headline("peer", push_s=r1["a"]["push_s"], push_gb=[x / 1e9 for x in r1["a"]["push_bytes"]],
              replacement_peer_share=r1["b"]["peer_share"], restore_peer_s=r1["b"]["restore_s"],
              restore_storage_s=r1["c"]["restore_s"], dead_neighbour_save_s=r1["d"]["save_s"],
              dead_neighbour_drain_s=r1["d"]["drain_s"],
              pull_rpc_s=r1["b"]["wire"]["rpcs"].get("peer-pull", [0, 0])[1],
              header_us=header["encode_us"] + header["decode_us"])
    print(json.dumps({"peer": record}), flush=True)
    return record


# ---------------------------------------------------------------------------
# cdn: a trainer publishes, a fleet of subscribers swaps onto the card
# ---------------------------------------------------------------------------

# The kernels of the cdn phase: the trainer's steps (flash_chunk), its
# evaluations and every serving forward (flash_fwd), its incremental saves
# (device_digest) and its batched save (device_pack).
CDN_PATH_KERNELS = ("flash_fwd", "flash_chunk", "device_digest", "device_pack")
CDN_TOPIC = "run"
CDN_FLEET_PROCS = 2
CDN_SUBS_PER_PROC = 2
CDN_FLEET = CDN_FLEET_PROCS * CDN_SUBS_PER_PROC
CDN_PULL_TIMEOUT_S = 60.0
# Each subscriber's peer cache: room for two steps of the 1.007 GB state.
CDN_CACHE_BUDGET_BYTES = 3 << 30
# One serving request: a batch of 1 x 1024 tokens.
CDN_SERVE_SHAPE = (1, 1024)
CDN_STEPS = (1, 2, 3)
# The subscriber killed between stage and swap, and at which step.
CDN_CRASH_SUB, CDN_CRASH_STEP = 0, 2
# The step whose publisher is killed between the announce and the head.
CDN_PUBLISH_CRASH_STEP = 3
CDN_WAIT_S = 300.0
# The fleet processes' flight-recorder ring (completed events).
CDN_TRACE_EVENTS = 1 << 20


def _cdn_key(*parts) -> str:
    return "cdn_smoke/" + "/".join(str(p) for p in parts)


def _cdn_param_path(name: str) -> str:
    """The manifest path of a ``Transformer`` parameter in the train
    state's snapshot (``layers.0.wqkv`` -> ``0/train/params/layers/0/wqkv``)."""
    return "0/train/params/" + name.replace(".", "/")


class _CdnManifestAssembler:
    """The serving binary's assembler: each parameter is cut out of the
    announced chunks by its manifest entry in the committed step (read
    through ``Snapshot(...).metadata``): a whole chunk, a byte range of a
    slab chunk, or the dim-0 pieces of a chunked entry. Host tensors."""

    def __init__(self, root: str, names) -> None:
        self.root = root
        self.names = list(names)

    def __call__(self, ann, chunk_bytes: dict) -> dict:
        import torch

        from torchsnapshot_tpu_torch import Snapshot
        from torchsnapshot_tpu_torch.cas import key_of_location
        from torchsnapshot_tpu_torch.serialization import string_to_dtype

        manifest = Snapshot(os.path.join(self.root, f"step_{ann.step:010d}")).metadata.manifest

        def piece(entry, shape):
            _require(entry.serializer == "buffer_protocol", f"{entry.location}: serializer {entry.serializer}")
            key = key_of_location(entry.location)
            _require(key in ann.chunks, f"{entry.location} is not in announce {ann.seq}")
            data = chunk_bytes[key]
            lo, hi = entry.byte_range if entry.byte_range is not None else (0, len(data))
            dtype = string_to_dtype(entry.dtype)
            raw = torch.frombuffer(bytearray(data[lo:hi]), dtype=torch.uint8)
            return raw.view(dtype).reshape(shape)

        out = {}
        for name in self.names:
            entry = manifest[_cdn_param_path(name)]
            if type(entry).__name__ == "ChunkedArrayEntry":
                full = torch.empty(entry.shape, dtype=string_to_dtype(entry.dtype))
                for chunk in entry.chunks:
                    index = tuple(slice(o, o + s) for o, s in zip(chunk.offsets, chunk.sizes))
                    full[index] = piece(chunk.array, chunk.sizes)
                out[name] = full
            else:
                out[name] = piece(entry, entry.shape)
        return out


def cdn_fleet_worker(pg, seed: int, work_dir: str, store_port: int, root: str) -> dict:
    """One serving process of the cdn phase (spawned by
    ``run_multiprocess``; the parent built every kernel): two subscribers,
    each in its own thread with its own serving ``Transformer`` whose CUDA
    parameters a ``WeightSwapper`` holds, tracking the trainer's topic on
    its ``TCPStore``. Each step: track until the step is applied (the
    armed subscriber first crashes between stage and swap and serves the
    previous step), check the served weights and one serving forward's
    logits against the trainer's, bit for bit, then tell the trainer.
    Returns the process's records."""
    import threading

    import torch
    from torch.func import functional_call

    os.environ["TORCHSNAPSHOT_TPU_CDN_PULL_TIMEOUT_SECONDS"] = str(CDN_PULL_TIMEOUT_S)
    # A flight-recorder ring that holds every wire span of the phase.
    os.environ["TORCHSNAPSHOT_TPU_TRACE_BUFFER_EVENTS"] = str(CDN_TRACE_EVENTS)

    from torchsnapshot_tpu_torch import telemetry
    from torchsnapshot_tpu_torch.cas import CASStore
    from torchsnapshot_tpu_torch.cdn import CdnSubscriber, WeightSwapper, durable_chunk_reader
    from torchsnapshot_tpu_torch.chaos import SimulatedCrash, arm, disarm
    from torchsnapshot_tpu_torch.dist_store import TCPStore
    from torchsnapshot_tpu_torch.models.transformer import Transformer, random_tokens
    from torchsnapshot_tpu_torch.ops import device_digest as dd
    from torchsnapshot_tpu_torch.ops import device_pack as dp
    from torchsnapshot_tpu_torch.ops import flash_attention as fa
    from torchsnapshot_tpu_torch.ops import kernels
    from torchsnapshot_tpu_torch.telemetry import names
    from torchsnapshot_tpu_torch.telemetry.report import wire_from_deltas
    from torchsnapshot_tpu_torch.telemetry.trace import chrome_trace, get_recorder, write_trace_file

    proc = pg.rank
    telemetry.reset_trace()
    mark = get_recorder().mark()
    counters = telemetry.metrics().counters_snapshot()
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    missing = [n for n in kernels.kernel_names() if not os.path.exists(kernels._library_path(n))]
    _require(not missing, f"fleet process {proc}: kernels {missing} not built by the parent")
    cfg = main_config()
    eval_tokens = torch.from_numpy(random_tokens(cfg, *CDN_SERVE_SHAPE, seed + 1)).cuda()
    # Swaps, and the checks and forwards that read the card's memory
    # counters, hold this lock: both subscribers of the process share the
    # allocator's statistics. It is taken at the end of a stage and let go
    # at the end of the swap, so that the armed subscriber alone reaches
    # the crash point while it is armed.
    device_lock = threading.Lock()
    refs: dict = {}
    refs_lock = threading.Lock()
    abort = TCPStore("127.0.0.1", store_port, is_server=False)

    def reference(step: int) -> dict:
        with refs_lock:
            if step not in refs:
                deadline = time.monotonic() + CDN_WAIT_S
                while abort.try_get(_cdn_key("ref", step)) is None:
                    _require(abort.try_get(_cdn_key("abort")) is None, "the trainer aborted")
                    _require(time.monotonic() < deadline, f"no reference for step {step}")
                    time.sleep(0.05)
                # The load allocates on the card: under the lock, so that it
                # never falls inside another subscriber's swap.
                with device_lock:
                    refs.pop(step - 1, None)
                    refs[step] = torch.load(os.path.join(work_dir, f"ref_{step}.pt"), map_location="cuda")
            return refs[step]

    class ServingSwapper(WeightSwapper):
        """Times the swap to the serving stream's end and reads the card's
        allocated memory around it."""

        crash_next = False

        def __init__(self, *a, **kw) -> None:
            super().__init__(*a, **kw)
            self.swaps: list = []

        def stage(self, ann, chunk_bytes):
            t0 = time.monotonic()
            staged = super().stage(ann, chunk_bytes)
            self.stage_s = time.monotonic() - t0
            device_lock.acquire()
            if self.crash_next:
                self.crash_next = False
                arm(names.CRASH_CDN_SWAP_STAGED)
            return staged

        def swap(self, staged) -> None:
            try:
                new_bytes = sum(t.numel() * t.element_size() for t in staged.host_arrays.values())
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.monotonic()
                super().swap(staged)
                torch.cuda.current_stream().synchronize()
                swap_s = time.monotonic() - t0
                peak = torch.cuda.max_memory_allocated()
                after = torch.cuda.memory_allocated()
                self.swaps.append({
                    "step": staged.announce.step, "swap_s": swap_s, "stage_s": self.stage_s,
                    "new_bytes": new_bytes, "peak_rise": peak - before, "after_minus_before": after - before,
                })
                _require(peak - before <= new_bytes * 1.05,
                         f"swap of step {staged.announce.step}: allocated memory rose by {peak - before} bytes, "
                         f"the new set is {new_bytes}")
                _require(after - before <= new_bytes * 0.01,
                         f"after the swap of step {staged.announce.step} {after - before} more bytes are allocated")
            finally:
                device_lock.release()

    class TimedSubscriber(CdnSubscriber):
        """Adds up the seconds of its syncs (both of a killed step's)."""

        sync_s = 0.0

        def sync(self, ann):
            t0 = time.monotonic()
            out = super().sync(ann)
            self.sync_s += time.monotonic() - t0
            return out

    members = []
    for j in range(CDN_SUBS_PER_PROC):
        sid = proc * CDN_SUBS_PER_PROC + j
        model = Transformer(cfg, seed=seed + 100 + sid)
        weights = {n: p.detach() for n, p in model.named_parameters()}
        # The module keeps no storage: the swapper's dict is the only owner
        # of the served tensors, so a swap frees the old set.
        model.to("meta")
        swapper = ServingSwapper(weights, assemble=_CdnManifestAssembler(root, weights))
        del weights
        reads = {"n": 0}
        fetch = durable_chunk_reader(root)

        def counting_fetch(key, _fetch=fetch, _reads=reads):
            _reads["n"] += 1
            return _fetch(key)

        sub = TimedSubscriber(
            TCPStore("127.0.0.1", store_port, is_server=False), CDN_TOPIC, sid, CDN_FLEET,
            durable_fetch=counting_fetch, cache_budget_bytes=CDN_CACHE_BUDGET_BYTES,
            cas_store=CASStore(root), root=root,
        )
        members.append({"sid": sid, "model": model, "swapper": swapper, "sub": sub, "reads": reads, "steps": []})

    def serve(m) -> tuple:
        """One serving forward through the fused flash kernel; the logits
        and its ms (CUDA events around 3 more)."""
        with torch.no_grad():
            logits = functional_call(m["model"], m["swapper"].weights, (eval_tokens,))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                functional_call(m["model"], m["swapper"].weights, (eval_tokens,))
            end.record()
            end.synchronize()
        return logits, start.elapsed_time(end) / 3

    def check_served(m, step: int, what: str) -> float:
        ref = reference(step)
        with device_lock:
            served = m["swapper"].weights
            _require(sorted(served) == sorted(k for k in ref if k != "logits"), f"{what}: served leaves differ")
            for name, t in served.items():
                _require(t.is_cuda and same_bits(t, ref[name]), f"{what}: served {name} differs from the trainer's")
            logits, ms = serve(m)
            _require(same_bits(logits, ref["logits"]), f"{what}: serving logits differ from the trainer's")
            del logits
        return ms

    def member_main(m) -> None:
        sub, swapper, sid = m["sub"], m["swapper"], m["sid"]
        prev = None
        for step in CDN_STEPS:
            wire0, reads0, fallbacks0 = sub.stats.bytes_on_wire, m["reads"]["n"], sub.stats.peer_fallbacks
            peer0, durable0 = sub.stats.bytes_from_peer, sub.stats.bytes_from_durable
            crashed, sub.sync_s = False, 0.0
            if sid == CDN_CRASH_SUB and step == CDN_CRASH_STEP:
                swapper.crash_next = True
            deadline = time.monotonic() + CDN_WAIT_S
            ann = None
            while ann is None:
                _require(abort.try_get(_cdn_key("abort")) is None, "the trainer aborted")
                _require(time.monotonic() < deadline, f"subscriber {sid}: step {step} never arrived")
                try:
                    ann = sub.track_once(swapper, timeout=2.0)
                except SimulatedCrash:
                    disarm()
                    device_lock.release()
                    crashed = True
                    _require(sub.applied_seq == step - 1 and swapper.swapped_step == step - 1,
                             f"subscriber {sid} killed mid-swap applied seq {sub.applied_seq}")
                    # Still the previous step, bit for bit.
                    check_served(m, step - 1, f"subscriber {sid} killed at step {step}")
            _require(ann.step == step and swapper.swapped_step == step,
                     f"subscriber {sid} applied step {ann.step}, expected {step}")
            novel = {k: n for k, n in ann.chunks.items() if prev is None or k not in prev.chunks}
            wire = sub.stats.bytes_on_wire - wire0
            if prev is not None:
                _require(wire == sum(novel.values()),
                         f"subscriber {sid} step {step}: {wire} bytes on the wire, the chunks step {step - 1} "
                         f"did not announce hold {sum(novel.values())}")
            serve_ms = check_served(m, step, f"subscriber {sid} step {step}")
            rec = {
                "sid": sid, "step": step, "seq": ann.seq, "crashed": crashed, "sync_s": sub.sync_s,
                "wire_bytes": wire, "novel_bytes": sum(novel.values()), "novel_chunks": len(novel),
                "bytes_from_peer": sub.stats.bytes_from_peer - peer0,
                "bytes_from_durable": sub.stats.bytes_from_durable - durable0,
                "durable_reads": m["reads"]["n"] - reads0,
                "peer_fallbacks": sub.stats.peer_fallbacks - fallbacks0,
                "staleness_s": sub.stats.staleness_s[-1], "serve_ms": serve_ms, **swapper.swaps[-1],
            }
            m["steps"].append(rec)
            abort.set(_cdn_key("served", sid, step), json.dumps(rec).encode())
            prev = ann

    errors: dict = {}

    def run(m) -> None:
        try:
            member_main(m)
        except BaseException as e:  # noqa: BLE001 - reported to the trainer and raised below
            errors[m["sid"]] = repr(e)
            abort.set(_cdn_key("error", m["sid"]), repr(e).encode())

    try:
        for m in members:
            abort.set(_cdn_key("ready", m["sid"]), b"1")
        threads = [threading.Thread(target=run, args=(m,), daemon=True) for m in members]
        for t in threads:
            t.start()
        for t in threads:
            t.join(len(CDN_STEPS) * CDN_WAIT_S + 60)
        _require(not any(t.is_alive() for t in threads), f"fleet process {proc}: a subscriber thread hung")
        _require(not errors, f"fleet process {proc}: {errors}")
        # Serve until the trainer has run its retention and fsck checks
        # with the leases outstanding, then close (releasing the leases).
        deadline = time.monotonic() + CDN_WAIT_S
        while abort.try_get(_cdn_key("close")) is None:
            _require(abort.try_get(_cdn_key("abort")) is None, "the trainer aborted")
            _require(time.monotonic() < deadline, "the trainer never closed the fleet")
            time.sleep(0.05)
        # Every subscriber applied the last step: no pull is in flight. The
        # process's wire spans go where the trainer merges them.
        rec = get_recorder()
        spans = [e for e in rec.events_since(mark) if e["name"] in (names.SPAN_WIRE_RPC, names.SPAN_WIRE_HANDLER)]
        write_trace_file(os.path.join(work_dir, f"wire-fleet-proc{proc}.json"),
                         chrome_trace(spans, rec.tid_names(), rank=proc, dropped=rec.dropped - mark.dropped))
        wire = wire_from_deltas(telemetry.metrics().counters_delta_since(counters))
    finally:
        for m in members:
            m["sub"].close()
    launches = {**fa.launch_counts, **dd.launch_counts, **dp.launch_counts}
    _require(launches["flash_fwd"] > 0, f"fleet process {proc} never launched flash_fwd")
    return {"proc": proc, "steps": [r for m in members for r in m["steps"]], "launches": launches, "wire": wire}


def _log_cdn_step(step: int, save: dict, recs: list) -> None:
    log(
        f"cdn: step {step} save {save['save_s']:.3f} s, publish {save['publish_s'] * 1e3:.3f} ms; "
        f"{save['novel_chunks']} novel chunks ({save['novel_bytes'] / 1e6:.3f} of {save['step_bytes'] / 1e6:.3f} MB), "
        f"{save['leased_chunks']} leased chunks all on disk"
    )
    for r in recs:
        log(
            f"cdn: step {step} subscriber {r['sid']}: sync {r['sync_s']:.3f} s, {r['bytes_from_peer'] / 1e6:.3f} MB "
            f"from peers, {r['bytes_from_durable'] / 1e6:.3f} MB from durable ({r['durable_reads']} reads), "
            f"stage {r['stage_s']:.3f} s, swap {r['swap_s']:.4f} s (memory +{r['peak_rise'] / 1e6:.3f} MB at peak "
            f"for {r['new_bytes'] / 1e6:.3f} MB, {r['after_minus_before']} bytes after), staleness "
            f"{r['staleness_s']:.3f} s, serving forward {r['serve_ms']:.3f} ms"
            + (" (killed between stage and swap first)" if r["crashed"] else "")
        )


def fleet_plane_checks(store, port: int, publisher_id: str) -> dict:
    """The fleet metrics plane while the fleet serves: one fresh ``__obs/``
    entry for the publisher and one for each subscriber, each within the
    entry bound; ``telemetry fleet`` (a subprocess) renders one row per
    member; ``doctor --fleet`` runs."""
    from torchsnapshot_tpu_torch.telemetry import wire

    raw = store.multi_get(store.scan(wire.OBS_PREFIX + "/"))
    sizes = {k: len(v) - len(b"%08x:" % 0) for k, v in raw.items()}
    entries = wire.collect_fleet(store)
    members = sorted((e["role"], e["id"]) for e in entries)
    _require(members == [("publisher", publisher_id)] + [("subscriber", str(s)) for s in range(CDN_FLEET)],
             f"the fleet plane holds {members}")
    _require(len(sizes) == len(entries) and all(0 < n <= wire.SNAPSHOT_MAX_BYTES for n in sizes.values()),
             f"fleet entries of {sorted(sizes.values())} bytes, the bound is {wire.SNAPSHOT_MAX_BYTES}")
    # The two CLIs side by side: each spends most of its seconds importing torch.
    cli = [sys.executable, "-m", "torchsnapshot_tpu_torch.telemetry"]
    t0 = time.monotonic()
    procs = [
        subprocess.Popen(cli + args, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for args in (["fleet", f"127.0.0.1:{port}", "--once"], ["doctor", "--fleet", f"127.0.0.1:{port}"])
    ]
    (table, table_err), (doctor, doctor_err) = (p.communicate(timeout=180) for p in procs)
    clis_s = time.monotonic() - t0
    rows = [ln for ln in table.splitlines() if ln.split()[:1] in (["publisher"], ["subscriber"])]
    _require(procs[0].returncode == 0 and len(rows) == 1 + CDN_FLEET,
             f"telemetry fleet exited {procs[0].returncode} with {len(rows)} member rows: {table[-2000:]}"
             f"{table_err[-2000:]}")
    _require(procs[1].returncode in (0, 2) and "doctor fleet" in doctor,
             f"doctor --fleet exited {procs[1].returncode}: {doctor[-2000:]}{doctor_err[-2000:]}")
    return {"entry_bytes": sorted(sizes.values()), "ages_s": [round(e["age_s"], 3) for e in entries],
            "table": table, "doctor": doctor, "clis_s": clis_s}


def stitched_fleet_pulls(paths: list) -> dict:
    """Merge the fleet processes' wire spans: every peer pull that reached a
    server is stitched to its client span, and some cross processes."""
    from torchsnapshot_tpu_torch.telemetry import names
    from torchsnapshot_tpu_torch.telemetry.trace import merge_traces, spans_from_chrome, stitched_wire_pairs

    merged = merge_traces(paths)
    pulls = [(c, h) for c, h in stitched_wire_pairs(merged) if c["args"].get("op") == names.RPC_PEER_PULL]
    spans = spans_from_chrome(merged)
    handlers = [s for s in spans if s["name"] == names.SPAN_WIRE_HANDLER and s["args"].get("op") == names.RPC_PEER_PULL]
    clients = [s for s in spans if s["name"] == names.SPAN_WIRE_RPC and s["args"].get("op") == names.RPC_PEER_PULL]
    cross = sum(1 for c, h in pulls if c["pid"] != h["pid"])
    dropped = merged["otherData"]["dropped_events"]
    _require(dropped == 0 and len(pulls) == len(handlers) and cross > 0,
             f"the fleet's merged trace: {len(pulls)} stitched pulls, {len(handlers)} served, {cross} across "
             f"processes, {dropped} events dropped")
    return {"client_pulls": len(clients), "served_pulls": len(handlers), "stitched_pulls": len(pulls),
            "cross_process": cross}


def cdn_phase(args, work_dir: str, card: str) -> dict:
    """The checkpoint CDN on the card (module docstring, phase 11) with the
    fleet metrics plane on (``TORCHSNAPSHOT_TPU_FLEET_OBS=1``; the fleet's
    processes inherit it)."""
    from torchsnapshot_tpu_torch import knobs

    with knobs.enable_fleet_obs():
        return _cdn_phase(args, work_dir, card)


def _cdn_phase(args, work_dir: str, card: str) -> dict:
    """The trainer here, the fleet in two spawned processes. Returns the
    phase's launch counts."""
    import threading

    import torch

    from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, knobs
    from torchsnapshot_tpu_torch.cas import CASStore, chunk_refs
    from torchsnapshot_tpu_torch.cdn import CdnPublisher, read_announce, read_head
    from torchsnapshot_tpu_torch.chaos import SimulatedCrash, arm, disarm
    from torchsnapshot_tpu_torch.dist_store import TCPStore
    from torchsnapshot_tpu_torch.fsck import verify_cas_store
    from torchsnapshot_tpu_torch.models.transformer import init_train_state, make_train_step, random_tokens
    from torchsnapshot_tpu_torch.ops import device_digest as dd
    from torchsnapshot_tpu_torch.ops import device_pack as dp
    from torchsnapshot_tpu_torch.ops import flash_attention as fa
    from torchsnapshot_tpu_torch.telemetry import names
    from torchsnapshot_tpu_torch.telemetry.trace import get_recorder
    from torchsnapshot_tpu_torch.test_utils import run_multiprocess

    t_phase = time.monotonic()
    cdn_dir = os.path.join(work_dir, "cdn")
    root = os.path.join(cdn_dir, "root")
    os.makedirs(root)
    server = TCPStore("127.0.0.1", 0, is_server=True)
    client = TCPStore("127.0.0.1", server.port, is_server=False)
    cfg = main_config()
    tokens = torch.from_numpy(random_tokens(cfg, 8, 1024, args.seed)).cuda()
    eval_tokens = torch.from_numpy(random_tokens(cfg, *CDN_SERVE_SHAPE, args.seed + 1)).cuda()
    state = init_train_state(cfg, seed=args.seed)
    train_step = make_train_step(cfg)
    app_state = {"train": state}
    n_frozen = cfg.n_layers // 2

    def freeze(model) -> None:
        for p in [model.embed] + [p for blk in model.layers[:n_frozen] for p in blk.parameters()]:
            p.requires_grad_(False)

    def write_reference(step: int) -> None:
        """The trainer's parameters and its evaluation logits of the step,
        where the fleet reads them."""
        with torch.no_grad():
            logits = state.model(eval_tokens)
        ref = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
        ref["logits"] = logits.cpu()
        torch.save(ref, os.path.join(cdn_dir, f"ref_{step}.pt"))
        client.set(_cdn_key("ref", step), b"1")

    def wait_served(step: int) -> list:
        deadline = time.monotonic() + CDN_WAIT_S
        recs = {}
        while len(recs) < CDN_FLEET:
            for sid in range(CDN_FLEET):
                err = client.try_get(_cdn_key("error", sid))
                _require(err is None, f"subscriber {sid} failed: {err!r}")
                raw = client.try_get(_cdn_key("served", sid, step))
                if raw is not None:
                    recs[sid] = json.loads(raw)
            _require(fleet.get("error") is None, f"the fleet failed: {fleet.get('error')}")
            _require(time.monotonic() < deadline, f"step {step}: served by {sorted(recs)} of {CDN_FLEET}")
            time.sleep(0.02)
        return [recs[s] for s in range(CDN_FLEET)]

    def leased_chunks_on_disk(what: str) -> int:
        _, _, leases = CASStore(root).load_full()
        leased = {k for chunks in leases.values() for k in chunks}
        gone = [k for k in leased if not os.path.exists(os.path.join(root, "chunks", k))]
        _require(not gone, f"{what}: {len(gone)} chunks a live lease names were deleted")
        return len(leased)

    fleet: dict = {}

    def run_fleet() -> None:
        try:
            fleet["records"] = run_multiprocess(
                cdn_fleet_worker, CDN_FLEET_PROCS, args=(args.seed, cdn_dir, server.port, root),
                timeout=len(CDN_STEPS) * CDN_WAIT_S + 300,
            )
        except BaseException as e:  # noqa: BLE001 - raised by the trainer
            fleet["error"] = repr(e)

    for counts in (fa.launch_counts, dd.launch_counts, dp.launch_counts):
        for k in counts:
            counts[k] = 0
    fleet_thread = threading.Thread(target=run_fleet, daemon=True)
    fleet_thread.start()
    announces, saves, steps = {}, {}, {}
    restarted = None
    try:
        deadline = time.monotonic() + CDN_WAIT_S
        while any(client.try_get(_cdn_key("ready", s)) is None for s in range(CDN_FLEET)):
            _require(fleet.get("error") is None, f"the fleet failed: {fleet.get('error')}")
            _require(time.monotonic() < deadline, "the fleet never came up")
            time.sleep(0.05)
        fleet_up_s = time.monotonic() - t_phase
        with knobs.enable_cas(), knobs.enable_cdn(), knobs.override_cas_gc_grace_seconds(0):
            mgr = CheckpointManager(root, keep_last_n=1, incremental=True, cdn_topic=CDN_TOPIC, cdn_store=client)
            for step in CDN_STEPS:
                if step == 2:
                    freeze(state.model)
                state, _ = train_step(state, tokens)
                torch.cuda.synchronize()
                batched = knobs.enable_batching() if step == 3 else contextlib.nullcontext()
                pack = knobs.enable_device_pack() if step == 3 else contextlib.nullcontext()
                mark = get_recorder().mark()
                t0 = time.monotonic()
                if step == CDN_PUBLISH_CRASH_STEP:
                    # The publisher dies between the announce record and the
                    # head: the step is committed but not announced.
                    head = read_head(client, CDN_TOPIC)
                    arm(names.CRASH_CDN_PUBLISH_ANNOUNCED)
                    try:
                        with batched, pack, contextlib.suppress(SimulatedCrash):
                            mgr.save(step, app_state)
                            raise AssertionError(f"save {step}: the armed publisher was not killed")
                    finally:
                        disarm()
                    save_s = time.monotonic() - t0
                    _require(read_head(client, CDN_TOPIC) == head and mgr.latest_step() == step,
                             f"the killed publish moved the head to {read_head(client, CDN_TOPIC)}")
                    time.sleep(1.0)
                    _require(all(client.try_get(_cdn_key("served", s, step)) is None for s in range(CDN_FLEET)),
                             "a subscriber applied the torn announce")
                    write_reference(step)
                    # The restarted trainer's publisher announces the step.
                    refs = chunk_refs(Snapshot(mgr.step_path(step)).metadata.manifest)
                    t1 = time.monotonic()
                    restarted = CdnPublisher(client, CDN_TOPIC, publisher_id=f"rank0@{root}", root=root)
                    ann = restarted.publish(step, refs)
                    publish_s = time.monotonic() - t1
                    _require(ann is not None and ann.seq == head + 1 and read_head(client, CDN_TOPIC) == head + 1,
                             "the restarted publisher did not announce the step")
                    mgr = CheckpointManager(root, keep_last_n=1, incremental=True, cdn_topic=CDN_TOPIC,
                                            cdn_store=client)
                else:
                    with batched, pack:
                        mgr.save(step, app_state)
                    save_s = time.monotonic() - t0
                    spans = [e for e in get_recorder().events_since(mark) if e["name"] == names.SPAN_CDN_PUBLISH]
                    _require(len(spans) == 1, f"save {step}: {len(spans)} publish spans")
                    publish_s = spans[0]["dur"] / 1e6
                    write_reference(step)
                ann = read_announce(client, CDN_TOPIC, read_head(client, CDN_TOPIC))
                _require(ann is not None and ann.step == step, f"step {step} is not the topic's head")
                _require(ann.chunks == chunk_refs(Snapshot(mgr.step_path(step)).metadata.manifest),
                         f"announce {ann.seq} does not name step {step}'s chunks")
                announces[step] = ann
                saves[step] = {"save_s": save_s, "publish_s": publish_s, "published_ts": ann.published_ts}
                recs = wait_served(step)
                steps[step] = recs
                prev = announces.get(step - 1)
                novel = [k for k in ann.chunks if prev is None or k not in prev.chunks]
                reads = sum(r["durable_reads"] for r in recs)
                fallbacks = sum(r["peer_fallbacks"] for r in recs)
                _require(reads == len(novel) and fallbacks == 0,
                         f"step {step}: {reads} durable reads across the fleet for {len(novel)} novel chunks, "
                         f"{fallbacks} peer fallbacks")
                saves[step]["leased_chunks"] = leased_chunks_on_disk(f"after step {step}")
                saves[step]["novel_chunks"] = len(novel)
                saves[step]["novel_bytes"] = sum(ann.chunks[k] for k in novel)
                saves[step]["step_bytes"] = ann.bytes_in_step
                _log_cdn_step(step, saves[step], recs)
            _require(any(r["crashed"] for r in steps[CDN_CRASH_STEP] if r["sid"] == CDN_CRASH_SUB),
                     "the armed subscriber was never killed")
            plane = fleet_plane_checks(client, server.port, f"rank0@{root}")
            # Retention with the fleet's leases outstanding: fsck --cas clean.
            t0 = time.monotonic()
            report = verify_cas_store(root, deep=True)
            fsck_s = time.monotonic() - t0
            _require(report.ok, f"fsck --cas with leases outstanding: {[str(p) for p in report.problems[:5]]}")
            leased_unreferenced = len(report.unreferenced)
            client.set(_cdn_key("close"), b"1")
            fleet_thread.join(CDN_WAIT_S)
            _require(not fleet_thread.is_alive() and fleet.get("error") is None,
                     f"the fleet did not close: {fleet.get('error')}")
            _, _, leases = CASStore(root).load_full()
            _require(leases == {}, f"leases outstanding after the fleet closed: {sorted(leases)}")
            # The fleet and the trainer's publisher closed: the plane is reaped.
            restarted.close()
            left = client.scan("__obs/")
            _require(left == [], f"fleet-plane keys left after the fleet closed: {left}")
            stitched = stitched_fleet_pulls(
                [os.path.join(cdn_dir, f"wire-fleet-proc{p}.json") for p in range(CDN_FLEET_PROCS)])
            # The next save's GC reclaims every chunk no retained step names.
            state, _ = train_step(state, tokens)
            mgr.save(4, app_state)
        on_disk = set(CASStore(root).list_chunks())
        live = set(chunk_refs(Snapshot(mgr.step_path(4)).metadata.manifest))
        _require(mgr.all_steps() == [4] and on_disk == live,
                 f"after the fleet closed, save 4 left {len(on_disk - live)} chunks no retained step names")
        # The run ledger of the trainer's root: a cdn-published event per
        # announced step (the killed publish posted none, its restart one)
        # and a cdn-swapped event per subscriber per applied step.
        events = _ledger_events(root)
        published = [r["step"] for r in events if r["event"] == names.EVENT_CDN_PUBLISHED]
        swapped = sorted((r["subscriber"], r["step"]) for r in events if r["event"] == names.EVENT_CDN_SWAPPED)
        _require(published == [*CDN_STEPS, 4], f"cdn-published for steps {published}")
        _require(swapped == [(sid, s) for sid in range(CDN_FLEET) for s in CDN_STEPS],
                 f"cdn-swapped (subscriber, step) {swapped}")
    except BaseException:
        client.set(_cdn_key("abort"), b"1")
        fleet_thread.join(60)
        raise
    finally:
        client.close()
        server.close()

    launches = {**fa.launch_counts, **dd.launch_counts, **dp.launch_counts}
    for rec in fleet["records"]:
        for k, n in rec["launches"].items():
            launches[k] += n
    _require(all(launches[k] for k in CDN_PATH_KERNELS), f"a kernel of the cdn path never launched: {launches}")
    wall_s = time.monotonic() - t_phase
    all_recs = [r for s in CDN_STEPS for r in steps[s]]
    staleness = sorted(r["staleness_s"] for r in all_recs)
    median = statistics.median(staleness)
    for rec in fleet["records"]:
        w = rec["wire"] or {}
        log(
            f"cdn: fleet process {rec['proc']} wire: {w.get('frames', 0):.0f} frames, {w.get('bytes', 0) / 1e6:.3f} MB, "
            f"dials {w.get('dials', 0):.0f} in {w.get('dial_s', 0):.4f} s; RPCs "
            + ", ".join(f"{op} {t['rpcs']:.0f} in {t['rpc_s']:.4f} s" for op, t in (w.get("ops") or {}).items())
        )
    log(
        f"cdn: fleet plane: {len(plane['entry_bytes'])} entries of {plane['entry_bytes']} bytes, ages "
        f"{plane['ages_s']} s; telemetry fleet and doctor --fleet side by side {plane['clis_s']:.2f} s; "
        f"merged fleet trace: {stitched['stitched_pulls']} of {stitched['served_pulls']} served pulls stitched "
        f"({stitched['cross_process']} across processes; {stitched['client_pulls']} client pulls)"
    )
    for line in (plane["table"] + plane["doctor"]).splitlines():
        log(f"cdn: | {line}")
    log(
        f"cdn: fleet of {CDN_FLEET} in {CDN_FLEET_PROCS} processes up in {fleet_up_s:.1f} s; staleness median "
        f"{median:.3f} s, max {staleness[-1]:.3f} s; the ledger {len(published)} cdn-published and "
        f"{len(swapped)} cdn-swapped events; deep fsck --cas with leases {fsck_s:.3f} s "
        f"({leased_unreferenced} leased chunks unreferenced); launches {launches}; phase {wall_s:.1f} s on {card}"
    )
    record = {"card": card, "saves": saves, "steps": steps, "staleness_median_s": median,
              "staleness_max_s": staleness[-1], "fsck_s": fsck_s, "launches": launches, "wall_s": wall_s,
              "fleet_wire": [rec["wire"] for rec in fleet["records"]], "stitched": stitched,
              "fleet_entry_bytes": plane["entry_bytes"]}
    _headline(
        "cdn", publish_ms=[saves[s]["publish_s"] * 1e3 for s in CDN_STEPS],
        sync_s_max=[max(r["sync_s"] for r in steps[s]) for s in CDN_STEPS],
        swap_s_max=[max(r["swap_s"] for r in steps[s]) for s in CDN_STEPS],
        wire_mb=[sum(r["wire_bytes"] for r in steps[s]) / 1e6 for s in CDN_STEPS],
        serve_ms=statistics.median(r["serve_ms"] for r in all_recs),
        staleness_s=[median, staleness[-1]],
        launches="/".join(f"{k}:{launches[k]}" for k in CDN_PATH_KERNELS),
    )
    print(json.dumps({"cdn": record}), flush=True)
    del state
    torch.cuda.empty_cache()
    return launches



# ----------------------------------------------------------------------
# The bridge phase: reference-format checkpoints on the card
# ----------------------------------------------------------------------


# The kernels the bridge phase must launch: the training steps and the
# evaluation forwards (flash), the converted snapshot's and the
# incremental take's digests.
BRIDGE_PATH_KERNELS = ("flash_fwd", "flash_chunk", "device_digest")
# Leg (b): the reference snapshot's ranks, and the processes that place it.
BRIDGE_SAVED_RANKS = 4
BRIDGE_RANKS = 2


def _tree_leaves(tree, prefix: str) -> dict:
    """``{path: leaf}`` of a nested state, by the package's flatten."""
    from torchsnapshot_tpu_torch.flatten import flatten

    return flatten(tree, prefix=prefix)[1]


def _tensor_bytes(leaves: dict) -> int:
    import torch

    return sum(v.numel() * v.element_size() for v in leaves.values() if isinstance(v, torch.Tensor))


def bridge_worker(pg, ref_sharded: str, ref_dense: str) -> dict:
    """One rank of bridge leg (b) (spawned by ``run_multiprocess``): a gloo
    default group and a ``cuda`` device mesh of 2 place every tensor
    entry of the four-rank reference snapshot with ``read_sharded`` as
    ``Shard(0)``, ``Shard(1)`` and ``Replicate()`` DTensors (the layouts
    its rank admits). Each local must be bit-identical to its slice of
    the trained leaf, read densely from leg (a)'s snapshot."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    from torchsnapshot_tpu_torch.test_utils import init_torch_group
    from torchsnapshot_tpu_torch.tricks.torchsnapshot_reader import (
        ReferenceSnapshotReader,
        read_reference_snapshot,
    )

    rank = pg.rank
    torch.cuda.set_device(rank % torch.cuda.device_count())
    init_torch_group(pg)
    try:
        mesh = init_device_mesh("cuda", (pg.world_size,))
        truth = _tree_leaves(read_reference_snapshot(ref_dense)["train"], "train")
        reader = ReferenceSnapshotReader(ref_sharded)
        view = reader.manifest_for_rank(rank)
        # One untimed call first: the first DTensor of a process pays its
        # one-time set-up.
        t0 = time.monotonic()
        first = next(p for p, e in view.items() if e.get("type") == "Tensor")
        ReferenceSnapshotReader(ref_sharded).read_sharded(first, (mesh, [Replicate()]), rank=rank)
        torch.cuda.synchronize()
        warmup_s = time.monotonic() - t0
        # Seconds inside the storage reads, apart from assembly and copies.
        read_s = [0.0]
        reads = reader._read_blobs

        def timed_reads(*a):
            t0 = time.monotonic()
            try:
                return reads(*a)
            finally:
                read_s[0] += time.monotonic() - t0

        reader._read_blobs = timed_reads
        kinds = {}
        seconds = {"Shard(0)": 0.0, "Shard(1)": 0.0, "Replicate()": 0.0}
        placed = dict.fromkeys(seconds, 0)
        for path, entry in view.items():
            if entry.get("type") not in ("Tensor", "ShardedTensor", "ChunkedTensor"):
                continue
            kinds[entry["type"]] = kinds.get(entry["type"], 0) + 1
            full = truth[path]
            layouts = [[Replicate()]] + [[Shard(d)] for d in range(min(full.ndim, 2))]
            for placements in layouts:
                torch.cuda.synchronize()
                t0 = time.monotonic()
                dt = reader.read_sharded(path, (mesh, placements), rank=rank)
                torch.cuda.synchronize()
                label = "Replicate()" if isinstance(placements[0], Replicate) else f"Shard({placements[0].dim})"
                seconds[label] += time.monotonic() - t0
                placed[label] += 1
                local = dt.to_local()
                _require(local.is_cuda, f"rank {rank}: {path} {label} local not on the card")
                _require(
                    tuple(dt.shape) == tuple(full.shape) and same_bits(local, _expected_local(full, mesh, placements)),
                    f"rank {rank}: {path} placed as {label} differs from its slice of the trained leaf",
                )
                del dt, local
        stats = reader.stats
        reader.close()
        return {
            "rank": rank, "kinds": kinds, "placed": placed, "seconds": seconds,
            "ranged_reads": stats.ranged_reads, "direct_reads": stats.direct_reads,
            "whole_reads": stats.whole_reads, "read_s": read_s[0], "warmup_s": warmup_s,
            "bytes_read": stats.bytes_read, "peak_host_bytes": stats.peak_host_bytes,
            "state_bytes": _tensor_bytes(truth),
        }
    finally:
        dist.destroy_process_group()


def _codec_leg(leaves: dict) -> dict:
    """Bridge leg (d): every float leaf encoded per tensor, every 2-D leaf
    per channel on axis 0, on the card and on the CPU: the bytes must be
    equal, and the card's decode must equal the CPU's decode."""
    import torch

    from torchsnapshot_tpu_torch import lowp

    out = {}
    for codec, encode, decode, wanted in (
        ("per_tensor", lowp.encode_per_tensor, lowp.decode_per_tensor, lambda t: True),
        ("per_channel", lambda t: lowp.encode_per_channel(t, 0), lowp.decode_per_channel, lambda t: t.ndim == 2),
    ):
        card_s = host_s = 0.0
        nbytes = n = 0
        rates = []
        for path, t in leaves.items():
            if not (isinstance(t, torch.Tensor) and t.is_cuda and t.is_floating_point() and wanted(t)):
                continue
            torch.cuda.synchronize()
            t0 = time.monotonic()
            on_card = encode(t)
            dt = time.monotonic() - t0
            host = t.cpu()
            t0 = time.monotonic()
            on_host = encode(host)
            host_s += time.monotonic() - t0
            if on_card != on_host:
                a = torch.frombuffer(bytearray(on_card), dtype=torch.uint8)
                b = torch.frombuffer(bytearray(on_host), dtype=torch.uint8)
                flips = int((a != b).sum()) if a.numel() == b.numel() else -1
                raise AssertionError(f"bridge (d): {codec} bytes of {path} differ: {flips} bytes flipped")
            dec_card = decode(on_card, tuple(t.shape))
            dec_host = decode(on_host, tuple(t.shape), device="cpu")
            _require(dec_card.is_cuda and same_bits(dec_host, dec_card), f"bridge (d): {codec} decode of {path} differs")
            del dec_card, dec_host, host
            card_s += dt
            nbytes += t.numel() * t.element_size()
            n += 1
            rates.append(t.numel() * t.element_size() / dt / 1e9)
        out[codec] = {"leaves": n, "bytes": nbytes, "card_s": card_s, "card_gb_s": nbytes / card_s / 1e9,
                      "host_s": host_s, "leaf_gb_s_min": min(rates), "leaf_gb_s_max": max(rates)}
    return out


def bridge_phase(args, work_dir: str, card: str) -> dict:
    """The migration bridge on the main configuration: (a) write the
    trained state in the reference format and read it back onto the card,
    bit for bit, logits included; (b) a four-rank reference snapshot of
    it placed as DTensors by two processes; (c) convert (a) to the native
    format, restore, resume one step bit for bit and take incrementally on
    the converted base; (d) the int8 codecs on the card against the CPU.
    Returns the kernels' launches of the phase."""
    import torch

    from torchsnapshot_tpu_torch import Snapshot
    from torchsnapshot_tpu_torch.fsck import verify_snapshot
    from torchsnapshot_tpu_torch.models.transformer import (
        init_train_state,
        make_train_step,
        params_tree,
        random_tokens,
    )
    from torchsnapshot_tpu_torch.ops import device_digest as dd
    from torchsnapshot_tpu_torch.ops import flash_attention as fa
    from torchsnapshot_tpu_torch.state_dict import load_tree_into
    from torchsnapshot_tpu_torch.telemetry import names
    from torchsnapshot_tpu_torch.test_utils import run_multiprocess, write_sharded_reference_snapshot
    from torchsnapshot_tpu_torch.tricks.convert import convert
    from torchsnapshot_tpu_torch.tricks.torchsnapshot_reader import read_reference_snapshot
    from torchsnapshot_tpu_torch.tricks.torchsnapshot_writer import write_reference_snapshot

    t_phase = time.monotonic()
    root = os.path.join(work_dir, "bridge")
    os.makedirs(root, exist_ok=True)
    cfg = main_config()
    tokens = torch.from_numpy(random_tokens(cfg, 8, 1024, args.seed)).cuda()
    state = init_train_state(cfg, seed=args.seed)
    train_step = make_train_step(cfg)
    fa.reset_launch_counts()
    dd.reset_launch_counts()
    for _ in range(STEPS):
        state, _ = train_step(state, tokens)
    torch.cuda.synchronize()

    # (a) Write the reference format, read it back onto the card.
    legs = {}
    t_leg = time.monotonic()
    ref_a = os.path.join(root, "ref")
    live = _tree_leaves(state.state_dict(), "train")
    state_bytes = sum(v.numel() * v.element_size() for v in live.values() if isinstance(v, torch.Tensor) and v.is_cuda)
    t0 = time.monotonic()
    write_reference_snapshot(ref_a, {"train": state.state_dict()})
    write_s = time.monotonic() - t0
    t0 = time.monotonic()
    back_tree = read_reference_snapshot(ref_a)
    torch.cuda.synchronize()
    read_s = time.monotonic() - t0
    back = _tree_leaves(back_tree["train"], "train")
    _require(sorted(back) == sorted(live), "bridge (a): the read state holds other leaves")
    for k, v in live.items():
        if isinstance(v, torch.Tensor):
            _require(back[k].is_cuda and same_bits(v, back[k]), f"bridge (a): {k} differs after the round trip")
        else:
            _require(back[k] == v, f"bridge (a): {k} is {back[k]!r}, written {v!r}")
    fresh = init_train_state(cfg, seed=args.seed + 1)
    load_tree_into(params_tree(fresh.model), back_tree["train"]["params"])
    del back_tree, back
    fwd0 = fa.launch_counts["flash_fwd"]
    with torch.no_grad():
        logits_live = state.model(tokens)
        logits_read = fresh.model(tokens)
    torch.cuda.synchronize()
    _require(bool(torch.isfinite(logits_live).all()), "bridge (a): logits not finite")
    _require(same_bits(logits_live, logits_read), "bridge (a): logits of the model read back differ")
    _require(fa.launch_counts["flash_fwd"] - fwd0 == 2 * cfg.n_layers, "bridge (a): the forwards skipped the fused kernel")
    del logits_live, logits_read, fresh
    torch.cuda.empty_cache()
    ref_bytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(ref_a) for f in fs)
    log(
        f"bridge (a): reference-format write {write_s:.3f} s ({state_bytes / write_s / 1e9:.2f} GB/s of the "
        f"card's {state_bytes / 1e9:.4f} GB; {ref_bytes / 1e9:.4f} GB on disk), read onto the card {read_s:.3f} s "
        f"({state_bytes / read_s / 1e9:.2f} GB/s); {len(live)} leaves and the evaluation logits bit-identical, on {card}"
    )

    legs["a"] = time.monotonic() - t_leg

    # (b) A four-rank reference snapshot, placed as DTensors by two processes.
    t_leg = time.monotonic()
    ref_b = os.path.join(root, "ref4")
    t0 = time.monotonic()
    fixture = write_sharded_reference_snapshot(ref_b, {"train": state.state_dict()}, world_size=BRIDGE_SAVED_RANKS)
    fixture_s = time.monotonic() - t0
    t0 = time.monotonic()
    ranks = run_multiprocess(bridge_worker, BRIDGE_RANKS, args=(ref_b, ref_a), timeout=300.0)
    workers_s = time.monotonic() - t0
    for r in ranks:
        _require(r["ranged_reads"] > 0, f"bridge (b): rank {r['rank']} read no row window")
        log(
            f"bridge (b): rank {r['rank']}: {r['kinds']} entries placed "
            + ", ".join(f"{k} x{r['placed'][k]} in {r['seconds'][k]:.3f} s" for k in r["seconds"])
            + f" (storage reads {r['read_s']:.3f} s of the three; a first call {r['warmup_s']:.3f} s before); "
            f"{r['ranged_reads']} ranged reads (row windows and slab members; {r['direct_reads']} straight into "
            f"the local box) "
            f"and {r['whole_reads']} whole-blob reads, "
            f"{r['bytes_read'] / 1e9:.4f} GB read; peak host bytes {r['peak_host_bytes'] / 1e6:.3f} MB against "
            f"the state's {r['state_bytes'] / 1e9:.4f} GB"
        )
    log(f"bridge (b): fixture {fixture} written in {fixture_s:.3f} s; workers {workers_s:.1f} s; every local bit for bit")

    legs["b"] = time.monotonic() - t_leg

    # (c) Convert (a), restore, resume, take incrementally on the converted base.
    t_leg = time.monotonic()
    conv = os.path.join(root, "converted")
    digests0 = dd.launch_counts["device_digest"]
    conv_times = convert(ref_a, conv)
    convert_digests = dd.launch_counts["device_digest"] - digests0
    _require(convert_digests > 0, "bridge (c): the convert's take launched no digest kernel")
    resumed = init_train_state(cfg, seed=args.seed + 2)
    t0 = time.monotonic()
    Snapshot(conv).restore({"train": resumed})
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    _require_same_state({k: v for k, v in _state_tensors(state).items()}, resumed, "bridge (c) restore of the converted snapshot")
    for s in (state, resumed):
        for p in [s.model.embed] + [p for blk in s.model.layers[: cfg.n_layers // 2] for p in blk.parameters()]:
            p.requires_grad_(False)
    before = {k: v.clone() for k, v in _state_tensors(resumed).items()}
    _, loss_live = train_step(state, tokens)
    _, loss_resumed = train_step(resumed, tokens)
    torch.cuda.synchronize()
    _require(same_bits(loss_live, loss_resumed), f"bridge (c): resumed loss {loss_resumed} differs from {loss_live}")
    changed = _changed_bytes(before, _state_tensors(resumed))
    del before
    incr = os.path.join(root, "incr")
    d2h0 = _counter(names.DEVICE_TO_HOST_BYTES_TOTAL)
    digests0 = dd.launch_counts["device_digest"]
    t0 = time.monotonic()
    Snapshot.take(incr, {"train": resumed}, incremental_base=conv)
    incr_s = time.monotonic() - t0
    incr_digests = dd.launch_counts["device_digest"] - digests0
    d2h = _counter(names.DEVICE_TO_HOST_BYTES_TOTAL) - d2h0
    written = _written_data_bytes(incr)
    _require(d2h == changed, f"bridge (c): the incremental take copied {d2h} bytes to the host, {changed} changed")
    _require(changed <= written <= changed + (1 << 20), f"bridge (c): incremental take wrote {written} bytes, {changed} changed")
    t0 = time.monotonic()
    report = verify_snapshot(incr, deep=True)
    fsck_s = time.monotonic() - t0
    _require(not report.problems, f"bridge (c): deep fsck of the incremental take: {report.problems[:3]}")
    log(
        f"bridge (c): convert read {conv_times['read_s']:.3f} s, take {conv_times['take_s']:.3f} s "
        f"({convert_digests} digest launches); restore {restore_s:.3f} s bit-identical; resumed loss "
        f"{float(loss_resumed)!r} bit for bit; incremental take on the converted base {incr_s:.3f} s "
        f"({incr_digests} digest launches): {d2h / 1e6:.3f} MB to the host and {written / 1e6:.3f} MB written for "
        f"{changed / 1e6:.3f} MB changed; deep fsck {fsck_s:.3f} s clean"
    )
    del resumed
    torch.cuda.empty_cache()

    legs["c"] = time.monotonic() - t_leg

    # (d) The int8 codecs on the card against the CPU.
    t_leg = time.monotonic()
    codecs = _codec_leg(_tree_leaves(state.state_dict(), "train"))
    legs["d"] = time.monotonic() - t_leg
    for codec, c in codecs.items():
        log(
            f"bridge (d): {codec}: {c['leaves']} leaves, {c['bytes'] / 1e9:.4f} GB: encode on the card "
            f"{c['card_s']:.3f} s ({c['card_gb_s']:.2f} GB/s; a leaf {c['leaf_gb_s_min']:.2f}-{c['leaf_gb_s_max']:.2f} "
            f"GB/s), on the CPU {c['host_s']:.3f} s; bytes and decodes equal"
        )

    launches = {k: v for k, v in {**fa.launch_counts, **dd.launch_counts}.items() if k in BRIDGE_PATH_KERNELS}
    _require(all(launches[k] for k in BRIDGE_PATH_KERNELS), f"bridge: a kernel of the path never launched: {launches}")
    shutil.rmtree(root, ignore_errors=True)
    wall_s = time.monotonic() - t_phase
    record = {
        "card": card, "state_bytes": state_bytes, "write_s": write_s, "read_s": read_s,
        "fixture": fixture, "ranks": ranks, "convert": conv_times, "convert_digests": convert_digests,
        "restore_s": restore_s, "incremental_s": incr_s, "incremental_written": written,
        "changed": changed, "fsck_s": fsck_s, "codecs": codecs, "launches": launches, "legs_s": legs,
        "wall_s": wall_s,
    }
    log(
        f"bridge: launches {launches}; legs " + ", ".join(f"({k}) {v:.1f} s" for k, v in legs.items())
        + f"; phase {wall_s:.1f} s on {card}"
    )
    _headline(
        "bridge", write_s=write_s, read_s=read_s, convert_s=[conv_times["read_s"], conv_times["take_s"]],
        ranged_reads=[r["ranged_reads"] for r in ranks], incremental_s=incr_s,
        encode_gb_s=[codecs["per_tensor"]["card_gb_s"], codecs["per_channel"]["card_gb_s"]],
        launches="/".join(f"{k}:{launches[k]}" for k in BRIDGE_PATH_KERNELS),
    )
    print(json.dumps({"bridge": record}), flush=True)
    del state
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# The moe phase: MoE blocks, expert parallel, the GPipe pipeline
# ----------------------------------------------------------------------


# The kernels the moe phase must launch (its process and its workers
# together): the training steps' chunk kernel, the evaluation forwards'
# fused kernel, the digests of the digest-recording and incremental takes
# (and the workers' replica check), the batched take's pack.
MOE_PATH_KERNELS = ("flash_fwd", "flash_chunk", "device_digest", "device_pack")
# The expert count of examples/sharded_example.py:40 and tests/test_model.py.
MOE_EXPERTS = 4
MOE_RANKS = 2
# Leg (c): the 8 blocks as 2 stages of 4 (dense, MoE, dense, MoE), 4
# microbatches of 2 sequences, 2 AdamW steps.
PP_STAGES = 2
PP_MICROBATCHES = 4
PP_STEPS = 2
# The pipelined step against the unpipelined one from the same state.
# Microbatching gives every product other row counts (2 sequences a call,
# not 8), so cuBLAS may pick other kernels and split-K orders: bf16
# outputs that differ in their last bits, carried through 8 blocks, and a
# stage's gradient summed over 4 microbatches in bf16. Each limit is set
# from readings on an H100 (PERF.md, PR 20), between the largest sound one
# and the controls: the loss's relative gap (7.3e-6); the largest relative
# L2 gap of a leaf's gradient (3.9e-3; the unpipelined gradient summed
# over the same microbatches 3.6e-3; a doubled or a lost cotangent 1.0);
# the parameters' L2 gap after the step relative to the unpipelined
# update, over all of a rank's leaves (1.4e-2; a doubled or a lost
# cotangent 0.11-0.20).
PP_LOSS_RTOL = 2.0 ** -13
PP_GRAD_RTOL = 2.0 ** -6
PP_UPDATE_RTOL = 2.0 ** -5


def moe_config():
    """The repo's MoE configuration at full width: ``benchmarks/pod/main.py``
    with ``--experts 4``, every second block MoE."""
    return dataclasses.replace(main_config(), n_experts=MOE_EXPERTS, moe_every=2)


def _is_expert_leaf(t) -> bool:
    """The expert-stacked leaves of a train state: the MoE blocks' 3-D
    ``w_in`` / ``w_out`` and their moments (no other leaf has 3 dims)."""
    return t.is_cuda and t.dim() == 3


def _ep_tree(leaves: dict, mesh) -> dict:
    """JAX's ep layout for this rank: every expert-stacked leaf a
    ``Shard(0)`` DTensor over the experts, built from this rank's experts;
    every other leaf a plain copy (declared replicated by the take)."""
    from torch.distributed.tensor import DTensor, Shard

    out = {}
    for name, t in leaves.items():
        if not _is_expert_leaf(t):
            out[name] = t.clone()
            continue
        out[name] = DTensor.from_local(
            _expected_local(t, mesh, [Shard(0)]).clone(), mesh, [Shard(0)],
            run_check=False, shape=t.shape, stride=t.stride(),
        )
    return out


def _sharded_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(os.path.join(path, "sharded")) for f in fs)


def _tree_bytes(tree) -> int:
    import torch

    return sum(
        t.numel() * t.element_size() for t in _tree_leaves(tree, "x").values() if isinstance(t, torch.Tensor)
    )


class PipelineState:
    """The MoE model as pipeline training state: its blocks as
    ``PP_STAGES`` stage stacks (block ``s * per + j`` is slot ``j`` of stage
    ``s``; every second block being MoE, the slots of both stages match),
    the embedding, final norm and unembedding outside the pipeline on every
    rank, and AdamW over all of it.

    Its tensors are one tree (:meth:`tree`, the checkpointed state):
    ``params``, ``exp_avg`` and ``exp_avg_sq`` each hold the slots' stacked
    leaves under ``stages`` (as ``stack_stage_params`` gives them: with a
    ``pp`` mesh ``Shard(0)`` DTensors, one stage a rank; without one, full
    stacks) and the rest by name; ``step`` the step counts. The state
    adopts the tensors of the tree it is built from, and :meth:`tree`
    shares their storage, so a restore into it writes in place."""

    REST = ("embed", "ln_f_scale", "unembed")
    MOMENTS = ("exp_avg", "exp_avg_sq")

    def __init__(self, cfg, tree: dict, mesh=None) -> None:
        from torch.utils._pytree import tree_flatten

        from torchsnapshot_tpu_torch.models.transformer import make_adamw

        self.cfg, self.mesh = cfg, mesh
        self.per = cfg.n_layers // PP_STAGES
        self.lo = mesh.get_local_rank(0) if mesh is not None else 0
        self.stages = tree["params"]["stages"]
        self.rest = {n: tree["params"][n] for n in self.REST}
        stage_leaves, self._spec = tree_flatten(self.stages)
        for p in self.params():
            p.requires_grad_(True)
        # An AdamW's foreach step takes DTensors or plain tensors, not both.
        self.opts = (make_adamw(cfg, stage_leaves), make_adamw(cfg, self.rest.values()))
        self._states = [opt.state[p] for opt in self.opts for p in opt.param_groups[0]["params"]]
        for key in self.MOMENTS:
            for st, m in zip(self._states, self._flat(tree[key])):
                st[key] = m
        for st, step in zip(self._states, tree["step"]):
            st["step"] = step

    @classmethod
    def of(cls, cfg, state, mesh=None) -> "PipelineState":
        """From copies of a train state's parameters, moments and step
        counts, its blocks stacked by ``stack_stage_params`` (with a mesh,
        each rank stacks only its own stage)."""
        import torch

        from torchsnapshot_tpu_torch.parallel import stack_stage_params

        per = cfg.n_layers // PP_STAGES
        layers = [blk.tree() for blk in state.model.layers]
        moments = state.optimizer.state
        getters = {"params": lambda p: p.detach(), **{k: (lambda p, k=k: moments[p][k]) for k in cls.MOMENTS}}
        tree = {}
        with torch.no_grad():
            for key, get in getters.items():
                per_stage = [
                    [{n: get(t) for n, t in layers[s * per + j].items()} for j in range(per)]
                    for s in range(PP_STAGES)
                ]
                tree[key] = {
                    "stages": stack_stage_params(per_stage, mesh),
                    **{n: get(getattr(state.model, n)).clone() for n in cls.REST},
                }
        step = moments[state.model.embed]["step"]
        tree["step"] = [step.clone() for _ in cls._flat(tree["params"])]
        return cls(cfg, tree, mesh)

    @classmethod
    def _flat(cls, part: dict) -> list:
        from torch.utils._pytree import tree_leaves

        return tree_leaves(part["stages"]) + [part[n] for n in cls.REST]

    def params(self) -> list:
        return self._flat({"stages": self.stages, **self.rest})

    def tree(self) -> dict:
        """The checkpointed state, sharing storage with the live tensors."""
        from torch.utils._pytree import tree_unflatten

        k = self._spec.num_leaves
        out = {}
        for key, leaves in (
            ("params", [p.detach() for p in self.params()]),
            *((key, [st[key] for st in self._states]) for key in self.MOMENTS),
        ):
            out[key] = {"stages": tree_unflatten(leaves[:k], self._spec), **dict(zip(self.REST, leaves[k:]))}
        out["step"] = [st["step"] for st in self._states]
        return out

    def targets(self, mesh=None) -> dict:
        """Zeroed restore destinations of :meth:`tree`'s structure at pp =
        ``mesh``'s size: the stage leaves under ``pipeline_stage_shardings``
        (full stacks without a mesh), the rest and the step counts plain."""
        import torch
        from torch.distributed.tensor import zeros as dtensor_zeros
        from torch.utils._pytree import tree_map

        from torchsnapshot_tpu_torch.parallel import pipeline_stage_shardings

        def zeros(t, sharding=None):
            if sharding is None:
                return torch.zeros(t.shape, dtype=t.dtype, device=t.device)
            return dtensor_zeros(*t.shape, dtype=t.dtype, device_mesh=sharding[0], placements=sharding[1])

        out = {}
        for key, part in self.tree().items():
            if key == "step":
                out[key] = [zeros(t) for t in part]
                continue
            shardings = () if mesh is None else (pipeline_stage_shardings(part["stages"], mesh),)
            out[key] = {"stages": tree_map(zeros, part["stages"], *shardings), **{n: zeros(part[n]) for n in self.REST}}
        return out

    def digest(self, stage: int) -> str:
        """blake2b of stage ``stage``'s slice of every stacked leaf and of
        every other leaf, in path order."""
        import torch

        h = hashlib.blake2b(digest_size=16)
        for path, t in sorted(_pp_locals(self.tree()).items()):
            if "/stages/" in path:
                t = t[stage - self.lo]
            h.update(path.encode())
            h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()

    def step(self, tokens):
        """One pipelined AdamW step; its loss. The step's gradients stay
        in the leaves' ``.grad``."""
        import torch.nn.functional as F

        from torchsnapshot_tpu_torch.models.transformer import _rmsnorm, block_forward
        from torchsnapshot_tpu_torch.parallel import pipelined_apply

        cfg = self.cfg

        def stage_fn(blocks, x):
            for blk in blocks:
                x = block_forward(cfg, blk, x)
            return x

        for opt in self.opts:
            opt.zero_grad(set_to_none=True)
        x = F.embedding(tokens, self.rest["embed"])
        y = pipelined_apply(stage_fn, self.stages, x, mesh=self.mesh, n_microbatches=PP_MICROBATCHES)
        logits = (_rmsnorm(y, self.rest["ln_f_scale"]) @ self.rest["unembed"]).float()[:, :-1]
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))
        loss.backward()
        for opt in self.opts:
            opt.step()
        return loss.detach()

    def mine(self, model) -> list:
        """``(name, leaf, row, the model's parameter)`` of this rank's
        leaves: its stage's (row ``row`` of the local stack: stage ``lo``)
        and the rest (``row`` None), with their counterparts in ``model``."""
        out = []
        for j, blk in enumerate(self.stages):
            i = self.lo * self.per + j
            out += [(f"layers/{i}/{n}", t, 0, getattr(model.layers[i], n)) for n, t in blk.items()]
        return out + [(n, t, None, getattr(model, n)) for n, t in self.rest.items()]

    def to_model(self, seed: int):
        """The unpipelined model of the full stacks (no mesh only)."""
        import torch

        from torchsnapshot_tpu_torch.models.transformer import Transformer

        _require(self.mesh is None, "to_model needs the full stacks")
        model = Transformer(self.cfg, seed=seed)
        with torch.no_grad():
            for j, blk in enumerate(self.stages):
                for s in range(PP_STAGES):
                    for n, t in blk.items():
                        getattr(model.layers[s * self.per + j], n).copy_(t[s])
            for n, t in self.rest.items():
                getattr(model, n).copy_(t)
        return model


def _pp_locals(tree: dict) -> dict:
    """Every tensor of a pipeline state's tree by path, DTensors as their
    local shards."""
    return {k: (v.to_local() if hasattr(v, "device_mesh") else v) for k, v in _tree_leaves(tree, "pp").items()}


def _require_same_pp(a: dict, b: dict, what: str) -> None:
    la, lb = _pp_locals(a), _pp_locals(b)
    _require(sorted(la) == sorted(lb), f"{what}: the states hold other leaves")
    for k in la:
        _require(same_bits(la[k], lb[k]), f"{what}: {k} differs")


def _row(t, row):
    """A leaf's (or its gradient's) local tensor, or its row ``row``."""
    t = (t.to_local() if hasattr(t, "device_mesh") else t).detach()
    return t if row is None else t[row]


def _norm2(t) -> float:
    import torch

    return float(torch.linalg.vector_norm(t.float().reshape(-1))) ** 2


def _rel_gap(diff2: float, base2: float) -> float:
    """``sqrt(diff2 / base2)``: 0 where both are 0, infinite where only
    the difference is not."""
    return math.sqrt(diff2 / base2) if base2 else (0.0 if diff2 == 0 else math.inf)


def _unpipelined_reference(live: PipelineState, replica, tokens) -> dict:
    """The unpipelined step on the replica, from the state ``live`` was
    built from: by the names of ``live.mine``, the gradients of the full
    batch and (the control) accumulated over ``PP_MICROBATCHES``
    microbatches as the pipeline cuts the batch, the parameters before and
    after the full batch's AdamW step; and its loss."""
    from torchsnapshot_tpu_torch.models.transformer import loss_fn

    model, opt = replica.model, replica.optimizer
    mine = [(name, p) for name, _, _, p in live.mine(model)]
    opt.zero_grad(set_to_none=True)
    mb = tokens.shape[0] // PP_MICROBATCHES
    for i in range(PP_MICROBATCHES):
        (loss_fn(model, tokens[i * mb:(i + 1) * mb]) / PP_MICROBATCHES).backward()
    grad_mb = {name: p.grad.clone() for name, p in mine}
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model, tokens)
    loss.backward()
    ref = {
        "loss": float(loss), "grad": {name: p.grad.clone() for name, p in mine}, "grad_mb": grad_mb,
        "before": {name: p.detach().clone() for name, p in mine},
    }
    opt.step()
    ref["after"] = {name: p.detach().clone() for name, p in mine}
    opt.zero_grad(set_to_none=True)
    return ref


def _first_step_gaps(live: PipelineState, ref: dict, model) -> dict:
    """After the first pipelined step, per leaf of this rank: the relative
    L2 gap of its gradient to the unpipelined one (``grad``) and the
    control's, the microbatched unpipelined gradient's (``control``); the
    gap of its parameters to the unpipelined step's, relative to that
    step's update (``update``), and the same over all the rank's leaves
    together (``update_all``)."""
    out = {"grad": {}, "control": {}, "update": {}}
    diff_all = update_all = 0.0
    for name, p, row, _ in live.mine(model):
        want = ref["grad"][name]
        want2 = _norm2(want)
        out["grad"][name] = _rel_gap(_norm2(_row(p.grad, row).float() - want.float()), want2)
        out["control"][name] = _rel_gap(_norm2(ref["grad_mb"][name].float() - want.float()), want2)
        after = ref["after"][name].float()
        diff2 = _norm2(_row(p, row).float() - after)
        update2 = _norm2(after - ref["before"][name].float())
        out["update"][name] = _rel_gap(diff2, update2)
        diff_all, update_all = diff_all + diff2, update_all + update2
    out["update_all"] = _rel_gap(diff_all, update_all)
    return out


def _pipeline_moves(before: dict) -> dict:
    """The pipeline's moves since the registry snapshot ``before``: calls,
    bytes and seconds by kind (the pipeline's, and the ring's ``ring`` and
    ``sp_sum`` moves), and the device-copy bytes."""
    from torchsnapshot_tpu_torch import telemetry
    from torchsnapshot_tpu_torch.telemetry import names
    from torchsnapshot_tpu_torch.telemetry.registry import parse_series_key

    fields = {
        names.PIPELINE_TRANSFERS_TOTAL: "calls", names.PIPELINE_TRANSFER_BYTES_TOTAL: "bytes",
        names.PIPELINE_TRANSFER_SECONDS_TOTAL: "seconds",
    }
    copies = {names.DEVICE_TO_HOST_BYTES_TOTAL: "d2h_bytes", names.HOST_TO_DEVICE_BYTES_TOTAL: "h2d_bytes"}
    out = {kind: {"calls": 0, "bytes": 0, "seconds": 0.0} for kind in ("hop", "broadcast", "sum")}
    out.update({v: 0 for v in copies.values()})
    for key, v in telemetry.metrics().counters_delta_since(before).items():
        name, labels = parse_series_key(key)
        if name in fields:
            moves = out.setdefault(labels["kind"], {"calls": 0, "bytes": 0, "seconds": 0.0})
            moves[fields[name]] += v
        elif name in copies:
            out[copies[name]] += v
    return out


def _ep_leg(pg, mesh, cfg, replica, seed: int, work_dir: str, path_w1: str) -> dict:
    """Leg (b) on one rank: the expert-parallel take, its restore under the
    same layout, and the world-1 take's restore into the layout."""
    import torch

    from torchsnapshot_tpu_torch import Snapshot, TensorTreeState
    from torchsnapshot_tpu_torch.models.transformer import init_train_state
    from torchsnapshot_tpu_torch.telemetry import names

    rank = pg.rank
    leaves = _state_tensors(replica)
    tree = _ep_tree(leaves, mesh)
    expert_bytes = sum(t.numel() * t.element_size() for t in leaves.values() if _is_expert_leaf(t))
    path = os.path.join(work_dir, "ep")
    d2h0 = _counter(names.DEVICE_TO_HOST_BYTES_TOTAL)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot.take(path, {"train": TensorTreeState(tree)}, pg=pg, replicated=["train/**"])
    take_s = time.monotonic() - t0
    copied = _counter(names.DEVICE_TO_HOST_BYTES_TOTAL) - d2h0
    tiled = _require_tiling(path)
    n_expert = sum(1 for t in leaves.values() if _is_expert_leaf(t))
    _require(tiled == n_expert, f"{tiled} sharded entries tiled, {n_expert} expert-stacked leaves")
    _require(_sharded_bytes(path) == expert_bytes, "the sharded blobs do not hold the expert-stacked bytes")
    _, written = _rank_blobs(path, rank, "sharded/")
    _, replicated_written = _rank_blobs(path, rank, "replicated/")
    share = written / expert_bytes
    _require(abs(share - 0.5) <= 0.01, f"rank {rank} wrote {share:.4f} of the expert bytes")

    fresh = _ep_tree(_state_tensors(init_train_state(cfg, seed=seed + 1)), mesh)
    _require(not same_bits(fresh["param/embed"], leaves["param/embed"]), "the fresh state equals the trained one")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot(path, pg=pg).restore({"train": TensorTreeState(fresh)})
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    _require_shards(fresh, leaves, f"rank {rank} restore of the expert-parallel take")
    del fresh

    fresh = _ep_tree(_state_tensors(init_train_state(cfg, seed=seed + 2)), mesh)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot(path_w1, pg=pg).restore({"train": TensorTreeState(fresh)})
    torch.cuda.synchronize()
    from_w1_s = time.monotonic() - t0
    _require_shards(fresh, leaves, f"rank {rank} restore of the world-1 take into the expert-parallel layout")
    del fresh, tree
    torch.cuda.empty_cache()
    return {
        "take_s": take_s, "restore_s": restore_s, "from_world1_s": from_w1_s, "state_bytes": _tensor_bytes(leaves),
        "expert_bytes": expert_bytes, "written_expert_bytes": written, "share": share,
        "written_replicated_bytes": replicated_written, "d2h_bytes": copied, "entries_tiled": tiled,
    }


def _pp_leg(pg, mesh, cfg, replica, seed: int, tokens, work_dir: str, path_p1: str, loss_a: float) -> dict:
    """Leg (c) on one rank: the parent's pp = 1 take into pp = 2, two
    pipelined AdamW steps (the first's loss, gradients and parameters
    against the unpipelined step's from the same state), the pp = 2 take
    and its restore, the next step on both."""
    import torch

    from torchsnapshot_tpu_torch import Snapshot, TensorTreeState, telemetry
    from torchsnapshot_tpu_torch.parallel import pipeline as pl

    rank = pg.rank
    live = PipelineState.of(cfg, replica, mesh)
    app = {"pp": TensorTreeState(live.targets(mesh))}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot(path_p1, pg=pg).restore(app)
    torch.cuda.synchronize()
    from_pp1_s = time.monotonic() - t0
    _require_same_pp(app["pp"].tree, live.tree(), f"rank {rank}: the pp = 1 take restored into pp = 2")
    del app

    ref = _unpipelined_reference(live, replica, tokens)
    before = telemetry.metrics().counters_snapshot()
    losses, step_ms = [], []
    for i in range(PP_STEPS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        losses.append(live.step(tokens))
        torch.cuda.current_stream().synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
        if i == 0:
            gaps = _first_step_gaps(live, ref, replica.model)
    ref_loss = ref["loss"]
    del ref
    moves = _pipeline_moves(before)
    route = pl.transport(mesh.get_group(0), tokens.device)
    losses = [float(x) for x in losses]
    _require(all(x == x and abs(x) < 1e4 for x in losses), f"pipelined losses not finite: {losses}")
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    _require(rel <= PP_LOSS_RTOL, f"pipelined loss {losses[0]!r} against the unpipelined {ref_loss!r}: {rel:.3e} > {PP_LOSS_RTOL:.3e}")
    worst = {k: max(gaps[k].items(), key=lambda kv: kv[1]) for k in ("grad", "control", "update")}
    log(
        f"moe (c) rank {rank}: step 1 against the unpipelined step: loss {rel:.3e}, gradients {worst['grad'][1]:.3e} "
        f"({worst['grad'][0]}; control {worst['control'][1]:.3e}, {worst['control'][0]}), parameters {gaps['update_all']:.3e} "
        f"of the update (largest leaf {worst['update'][1]:.3e}, {worst['update'][0]})"
    )
    _require(worst["grad"][1] <= PP_GRAD_RTOL,
             f"rank {rank}: the pipelined gradient of {worst['grad'][0]} is {worst['grad'][1]:.3e} from the unpipelined one")
    _require(gaps["update_all"] <= PP_UPDATE_RTOL,
             f"rank {rank}: the pipelined step's parameters are {gaps['update_all']:.3e} of its update from the unpipelined step's")
    moved = sum(moves[k]["bytes"] for k in ("hop", "broadcast", "sum"))
    if route == "gloo via host":
        _require(moves["d2h_bytes"] == moves["h2d_bytes"] == moved,
                 f"rank {rank}: the device-copy counters {moves['d2h_bytes']} / {moves['h2d_bytes']} against {moved} bytes moved")

    path = os.path.join(work_dir, "pp2")
    state_bytes = _tree_bytes(live.tree())
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot.take(path, {"pp": TensorTreeState(live.tree())}, pg=pg, replicated=["pp/**"])
    take_s = time.monotonic() - t0
    tiled = _require_tiling(path)
    stage_bytes = _sharded_bytes(path)
    _, written = _rank_blobs(path, rank, "sharded/")
    share = written / stage_bytes
    _require(abs(share - 0.5) <= 0.01, f"rank {rank} wrote {share:.4f} of the stage bytes")
    digest = live.digest(rank)

    app = {"pp": TensorTreeState(live.targets(mesh))}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot(path, pg=pg).restore(app)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    _require_same_pp(app["pp"].tree, live.tree(), f"rank {rank}: the pp = 2 restore")
    fresh = PipelineState(cfg, app["pp"].tree, mesh)
    loss_live = live.step(tokens)
    loss_fresh = fresh.step(tokens)
    torch.cuda.synchronize()
    _require(same_bits(loss_live, loss_fresh), f"next pipelined losses differ after the pp = 2 restore: {loss_live} vs {loss_fresh}")
    del live, fresh, app
    torch.cuda.empty_cache()
    return {
        "from_pp1_s": from_pp1_s, "losses": losses, "loss_rel_to_unpipelined": rel, "step_ms": step_ms,
        "transport": route, "transfers": moves, "take_s": take_s, "restore_s": restore_s,
        "state_bytes": state_bytes, "stage_bytes": stage_bytes, "written_stage_bytes": written, "share": share,
        "entries_tiled": tiled, "digest": digest, "next_loss": float(loss_live),
        "unpipelined_loss": ref_loss, "unpipelined_loss_is_parents": ref_loss == loss_a,
        "grad_gap": worst["grad"], "control_gap": worst["control"], "update_gap_leaf": worst["update"],
        "update_gap": gaps["update_all"], "gaps": gaps,
    }


def moe_worker(pg, seed: int, work_dir: str, path_w1: str, path_p1: str, loss_a: float) -> dict:
    """One rank of the moe phase's legs (b) and (c) (spawned by
    ``run_multiprocess``; the parent built every kernel): a gloo default
    group, a ``cuda`` mesh of 2; the MoE configuration trained ``STEPS``
    steps from ``--seed`` (the state of the parent's world-1 take), then
    leg (b) expert parallel and leg (c) the pipeline."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from torchsnapshot_tpu_torch.models.transformer import init_train_state, make_train_step, random_tokens
    from torchsnapshot_tpu_torch.ops import device_digest as dd
    from torchsnapshot_tpu_torch.ops import device_pack as dp
    from torchsnapshot_tpu_torch.ops import flash_attention as fa
    from torchsnapshot_tpu_torch.ops import kernels
    from torchsnapshot_tpu_torch.test_utils import init_torch_group

    t_start = time.monotonic()
    os.environ["TORCHSNAPSHOT_TPU_PEER_TIER"] = "0"  # the write paths without the tier, as the sharded phase
    rank = pg.rank
    torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    missing = [n for n in kernels.kernel_names() if not os.path.exists(kernels._library_path(n))]
    _require(not missing, f"rank {rank}: kernels {missing} not built by the parent")
    init_torch_group(pg)
    try:
        cfg = moe_config()
        tokens = torch.from_numpy(random_tokens(cfg, 8, 1024, seed)).cuda()
        replica = init_train_state(cfg, seed=seed)
        train_step = make_train_step(cfg)
        for counts in (fa.launch_counts, dd.launch_counts, dp.launch_counts):
            for k in counts:
                counts[k] = 0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(STEPS):
            replica, _ = train_step(replica, tokens)
        torch.cuda.current_stream().synchronize()
        step_ms = (time.monotonic() - t0) / STEPS * 1e3
        record = {"rank": rank, "device": torch.cuda.current_device(), "step_ms": step_ms,
                  "replica_leaves": _require_replicas_equal(pg, replica)}
        record["b"] = _ep_leg(pg, init_device_mesh("cuda", (pg.world_size,)), cfg, replica, seed, work_dir, path_w1)
        pp_mesh = init_device_mesh("cuda", (pg.world_size,), mesh_dim_names=("pp",))
        record["c"] = _pp_leg(pg, pp_mesh, cfg, replica, seed, tokens, work_dir, path_p1, loss_a)
        record["launches"] = {**fa.launch_counts, **dd.launch_counts, **dp.launch_counts}
        record["worker_s"] = time.monotonic() - t_start
        return record
    finally:
        dist.destroy_process_group()


def _batched_leg(args, work_dir: str, cfg, state, tokens) -> dict:
    """Leg (a)'s batched take with ``ENABLE_BATCHING`` and ``DEVICE_PACK``:
    one pack launch per slab of two or more card members, the restore bit
    for bit, the restored model's evaluation logits equal the live one's."""
    import torch

    from torchsnapshot_tpu_torch import Snapshot, knobs
    from torchsnapshot_tpu_torch.flatten import flatten
    from torchsnapshot_tpu_torch.models.transformer import init_train_state
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    path = os.path.join(work_dir, "moe_batched")
    now = {k: v.clone() for k, v in _state_tensors(state).items()}
    _, leaves = flatten(state.state_dict(), prefix="train")
    packs_before = dp.launch_counts["device_pack"]
    with knobs.enable_batching(), knobs.enable_device_pack():
        torch.cuda.synchronize()
        t0 = time.monotonic()
        Snapshot.take(path, {"train": state})
        take_s = time.monotonic() - t0
    packs = dp.launch_counts["device_pack"] - packs_before
    members: dict = {}
    for key, e in Snapshot(path).metadata.manifest.items():
        if getattr(e, "byte_range", None) is not None:
            members.setdefault(e.location, []).append(getattr(leaves[key.partition("/")[2]], "is_cuda", False))
    want = sum(1 for cuda in members.values() if sum(cuda) > 1)
    _require(packs == want and want > 0, f"moe batched take: {packs} pack launches for {want} slabs of card members")
    fresh = init_train_state(cfg, seed=args.seed + 6)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot(path).restore({"train": fresh})
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    _require_same_state(now, fresh, "moe batched take")
    with torch.no_grad():
        same = same_bits(state.model(tokens), fresh.model(tokens))
    _require(same, "evaluation logits of the batched take's restore differ")
    shutil.rmtree(path, ignore_errors=True)
    del fresh, now
    torch.cuda.empty_cache()
    return {"take_s": take_s, "restore_s": restore_s, "slabs": len(members), "pack_launches": packs}


def moe_phase(args, work_dir: str, card: str) -> dict:
    """The MoE configuration: leg (a) in this process, legs (b) and (c) in
    two spawned processes, then their world-1 and pp = 1 restores here.
    Returns the kernels' launches of the phase (workers' included)."""
    import torch

    from torchsnapshot_tpu_torch import RngState, Snapshot, TensorTreeState
    from torchsnapshot_tpu_torch.models.transformer import (
        init_train_state,
        is_moe_layer,
        make_train_step,
        random_tokens,
    )
    from torchsnapshot_tpu_torch.ops import device_digest as dd
    from torchsnapshot_tpu_torch.ops import device_pack as dp
    from torchsnapshot_tpu_torch.ops import flash_attention as fa
    from torchsnapshot_tpu_torch.test_utils import run_multiprocess

    t_phase = time.monotonic()
    legs = {}
    moe_dir = os.path.join(work_dir, "moe")
    os.makedirs(moe_dir, exist_ok=True)
    cfg = moe_config()
    tokens = torch.from_numpy(random_tokens(cfg, 8, 1024, args.seed)).cuda()
    torch.manual_seed(args.seed)
    state = init_train_state(cfg, seed=args.seed)
    train_step = make_train_step(cfg)
    for counts in (fa.launch_counts, dd.launch_counts, dp.launch_counts):
        for k in counts:
            counts[k] = 0

    # (a) One process: train, take, restore into a fresh state.
    t_leg = time.monotonic()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    losses = []
    for _ in range(STEPS):
        state, loss = train_step(state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) / STEPS * 1e3
    losses = [float(x) for x in losses]
    _require(all(x == x and abs(x) < 1e4 for x in losses), f"losses not finite: {losses}")
    tensors = _state_tensors(state)
    n_params = sum(p.numel() for p in state.model.parameters())
    expert_params = sum(p.numel() for p in state.model.parameters() if p.dim() == 3)
    state_bytes = sum(t.numel() * t.element_size() for k, t in tensors.items() if t.is_cuda)
    expert_bytes = sum(t.numel() * t.element_size() for t in tensors.values() if _is_expert_leaf(t))
    log(
        f"moe: {n_params / 1e6:.1f} M params ({expert_params / 1e6:.1f} M expert-stacked, "
        f"{sum(1 for i in range(cfg.n_layers) if is_moe_layer(cfg, i))} MoE blocks of {cfg.n_experts} experts), "
        f"train state {state_bytes / 1e9:.3f} GB ({expert_bytes / 1e9:.3f} GB expert-stacked); "
        f"{STEPS} steps, {step_ms:.1f} ms/step (first step included), losses {losses}"
    )
    torch.rand(3)
    torch.rand(3, device="cuda")
    path_a = os.path.join(moe_dir, "a")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot.take(path_a, {"train": state, "rng": RngState()})
    take_s = time.monotonic() - t0
    at_a1 = {k: v.clone() for k, v in _state_tensors(state).items()}
    # The same state as a tree of tensors (leg b restores it into the
    # expert-parallel layout) and as pp = 1 stage stacks (leg c, into pp =
    # 2), declared replicated as a data-parallel job declares its state: a
    # rank of a larger world then sees every entry.
    path_w1, path_p1 = os.path.join(moe_dir, "w1"), os.path.join(moe_dir, "pp1")
    Snapshot.take(path_w1, {"train": TensorTreeState(_state_tensors(state))}, replicated=["train/**"])
    pp1 = PipelineState.of(cfg, state)
    t0 = time.monotonic()
    Snapshot.take(path_p1, {"pp": TensorTreeState(pp1.tree())}, replicated=["pp/**"])
    pp1_take_s = time.monotonic() - t0
    pp1_bytes = _tree_bytes(pp1.tree())
    fresh = init_train_state(cfg, seed=args.seed + 1)
    _require(not same_bits(fresh.model.layers[1].w_in, state.model.layers[1].w_in), "fresh model equals the trained one")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot(path_a).restore({"train": fresh, "rng": RngState()})
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    _require_same_state(at_a1, fresh, "moe restore (a)")
    with torch.no_grad():
        logits_a = state.model(tokens)
        logits_b = fresh.model(tokens)
    torch.cuda.synchronize()
    _require(bool(torch.isfinite(logits_a).all()) and logits_a.shape == (8, 1024, cfg.vocab_size), "evaluation logits")
    _require(same_bits(logits_a, logits_b), "evaluation logits differ after restore")
    del logits_a, logits_b
    _, loss_a = train_step(state, tokens)
    _, loss_b = train_step(fresh, tokens)
    torch.cuda.synchronize()
    _require(same_bits(loss_a, loss_b), f"next-step losses differ: {loss_a} vs {loss_b}")
    del fresh
    torch.cuda.empty_cache()
    digests_before = dd.launch_counts["device_digest"]
    async_record = async_and_incremental(args, moe_dir, card, cfg, state, tokens, train_step, take_s, label="moe")
    # One digest launch each: the async take's (recording), the base's and the incremental take's.
    _require(dd.launch_counts["device_digest"] - digests_before == 3,
             f"the async and incremental takes launched the digest {dd.launch_counts['device_digest'] - digests_before} times, not 3")
    batched = _batched_leg(args, moe_dir, cfg, state, tokens)
    legs["a"] = time.monotonic() - t_leg
    log(
        f"moe (a): take {take_s:.3f} s ({state_bytes / take_s / 1e9:.2f} GB/s), restore {restore_s:.3f} s "
        f"({state_bytes / restore_s / 1e9:.2f} GB/s) of {state_bytes / 1e9:.3f} GB; restored state, logits and "
        f"next-step loss {float(loss_a)!r} bit-identical; pp = 1 stacks take {pp1_take_s:.3f} s of "
        f"{pp1_bytes / 1e9:.3f} GB; batched take with the pack {batched['take_s']:.3f} s ({batched['slabs']} slabs, "
        f"{batched['pack_launches']} pack launches), restore {batched['restore_s']:.3f} s bit-identical, logits equal; "
        f"on {card}"
    )
    del state
    torch.cuda.empty_cache()

    # (b), (c): two processes on the card.
    t_leg = time.monotonic()
    records = run_multiprocess(
        moe_worker, MOE_RANKS, args=(args.seed, moe_dir, path_w1, path_p1, float(loss_a)), timeout=600.0
    )
    legs["workers"] = time.monotonic() - t_leg

    # (b2) World 1: the expert-parallel snapshot into plain tensors,
    # continuing with the live run's loss bit for bit.
    t_leg = time.monotonic()
    dest = {k: torch.zeros_like(v) for k, v in at_a1.items()}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot(os.path.join(moe_dir, "ep")).restore({"train": TensorTreeState(dest)})
    torch.cuda.synchronize()
    ep_w1_s = time.monotonic() - t0
    for k, v in at_a1.items():
        _require(same_bits(dest[k], v), f"world-1 restore of the expert-parallel snapshot: {k} differs")
    loss_w1 = _next_loss(cfg, dest, STEPS, tokens, train_step)
    _require(same_bits(loss_w1, loss_a), f"next loss after the world-1 restore {loss_w1} vs {loss_a}")
    del dest, at_a1
    torch.cuda.empty_cache()

    # (c4) pp = 1: the pp = 2 snapshot into full stacks; the unpipelined
    # model from them.
    app = {"pp": TensorTreeState(pp1.targets())}
    del pp1
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot(os.path.join(moe_dir, "pp2")).restore(app)
    torch.cuda.synchronize()
    pp1_restore_s = time.monotonic() - t0
    pp = PipelineState(cfg, app["pp"].tree)
    del app
    for r in records:
        _require(pp.digest(r["rank"]) == r["c"]["digest"], f"pp = 1 restore: stage {r['rank']} differs from rank {r['rank']}'s")
    model = pp.to_model(seed=args.seed + 7)
    del pp
    with torch.no_grad():
        logits = model(tokens)[:, :-1]
        seq_loss = float(torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1)))
    del model, logits
    pipelined = records[0]["c"]["next_loss"]
    rel_pp1 = abs(seq_loss - pipelined) / abs(pipelined)
    _require(rel_pp1 <= PP_LOSS_RTOL, f"unpipelined loss {seq_loss!r} from the pp = 1 restore against the pipelined {pipelined!r}")
    legs["world1"] = time.monotonic() - t_leg
    torch.cuda.empty_cache()

    launches = {**fa.launch_counts, **dd.launch_counts, **dp.launch_counts}
    for r in records:
        for k, v in r["launches"].items():
            launches[k] += v
    launches = {k: launches[k] for k in MOE_PATH_KERNELS}
    _require(all(launches.values()), f"moe: a kernel of the path never launched: {launches}")
    shutil.rmtree(moe_dir, ignore_errors=True)
    wall_s = time.monotonic() - t_phase
    for r in records:
        b, c = r["b"], r["c"]
        hop = c["transfers"]["hop"]
        log(
            f"moe: rank {r['rank']} on card {r['device']}: {r['step_ms']:.1f} ms/step unpipelined (two processes "
            f"on the card); (b) expert-parallel take {b['take_s']:.3f} s ({b['state_bytes'] / b['take_s'] / 1e9:.2f} GB/s "
            f"of the {b['state_bytes'] / 1e9:.3f} GB state), wrote {b['written_expert_bytes'] / 1e9:.4f} of "
            f"{b['expert_bytes'] / 1e9:.4f} GB expert-stacked ({b['share']:.6f}) and {b['written_replicated_bytes'] / 1e9:.4f} "
            f"GB replicated, {b['d2h_bytes'] / 1e9:.4f} GB to the host, {b['entries_tiled']} entries tiled; restore "
            f"{b['restore_s']:.3f} s ({b['state_bytes'] / b['restore_s'] / 1e9:.2f} GB/s); the world-1 take into the "
            f"layout {b['from_world1_s']:.3f} s; (c) the pp = 1 take into pp = 2 {c['from_pp1_s']:.3f} s; pipelined "
            f"steps {', '.join(f'{x:.1f}' for x in c['step_ms'])} ms, losses {c['losses']} (step 1 within "
            f"{c['loss_rel_to_unpipelined']:.3e} of the unpipelined {c['unpipelined_loss']!r}, the parent's "
            f"{'the same' if c['unpipelined_loss_is_parents'] else repr(float(loss_a))}); step 1's gradients within "
            f"{c['grad_gap'][1]:.3e} ({c['grad_gap'][0]}; the microbatched unpipelined control's largest "
            f"{c['control_gap'][1]:.3e}, {c['control_gap'][0]}), its parameters within {c['update_gap']:.3e} of "
            f"the unpipelined update (largest leaf {c['update_gap_leaf'][1]:.3e}, {c['update_gap_leaf'][0]}); "
            f"hops {hop['calls']} by {c['transport']}, {hop['bytes'] / 1e6:.1f} MB in {hop['seconds'] * 1e3:.1f} ms "
            f"({hop['seconds'] * 1e3 / max(1, hop['calls']):.2f} ms a hop); output broadcasts "
            f"{c['transfers']['broadcast']['seconds'] * 1e3:.1f} ms, input cotangent sums "
            f"{c['transfers']['sum']['seconds'] * 1e3:.1f} ms, {c['transfers']['d2h_bytes'] / 1e6:.1f} MB to the "
            f"host and back; pp = 2 take {c['take_s']:.3f} s "
            f"({c['state_bytes'] / c['take_s'] / 1e9:.2f} GB/s of {c['state_bytes'] / 1e9:.3f} GB), wrote "
            f"{c['written_stage_bytes'] / 1e9:.4f} of {c['stage_bytes'] / 1e9:.4f} GB of stages ({c['share']:.6f}), "
            f"restore {c['restore_s']:.3f} s ({c['state_bytes'] / c['restore_s'] / 1e9:.2f} GB/s), next loss "
            f"{c['next_loss']!r} bit for bit; launches {r['launches']}; worker {r['worker_s']:.1f} s"
        )
    log(
        f"moe: world-1 restore of the expert-parallel snapshot {ep_w1_s:.3f} s, bit-identical, next loss "
        f"{float(loss_w1)!r} bit for bit; pp = 1 restore of the pp = 2 snapshot {pp1_restore_s:.3f} s, stages "
        f"bit-identical, unpipelined loss {seq_loss!r} within {rel_pp1:.3e} of the pipelined {pipelined!r}; "
        f"launches {launches}; legs " + ", ".join(f"({k}) {v:.1f} s" for k, v in legs.items())
        + f"; phase {wall_s:.1f} s on {card}"
    )
    record = {
        "card": card, "params": n_params, "expert_params": expert_params, "state_bytes": state_bytes,
        "expert_bytes": expert_bytes, "step_ms": step_ms, "losses": losses, "take_s": take_s,
        "restore_s": restore_s, "next_loss": float(loss_a), "pp1_take_s": pp1_take_s, "batched": batched,
        **async_record, "ranks": records, "ep_world1_restore_s": ep_w1_s, "pp1_restore_s": pp1_restore_s,
        "pp1_sequential_loss": seq_loss, "launches": launches, "legs_s": legs, "wall_s": wall_s,
    }
    _headline(
        "moe", take_s=take_s, restore_s=restore_s, step_ms=step_ms,
        ep_take_s=[r["b"]["take_s"] for r in records], pp_step_ms=[r["c"]["step_ms"][-1] for r in records],
        hop_ms=[r["c"]["transfers"]["hop"]["seconds"] * 1e3 / max(1, r["c"]["transfers"]["hop"]["calls"]) for r in records],
        launches="/".join(f"{k}:{launches[k]}" for k in MOE_PATH_KERNELS),
    )
    print(json.dumps({"moe": record}), flush=True)
    return launches


# ----------------------------------------------------------------------
# Phase 14: ring attention over a sequence-parallel group
# ----------------------------------------------------------------------

# The kernels the ring path must launch (both workers' counted windows
# together): the chunk kernel in each ring step of training (causal on
# the diagonal; unmasked only on rank 1, whose block 0 is behind it), the
# digest in the replica checks.
RING_PATH_KERNELS = ("flash_chunk", "device_digest")
RING_RANKS = 2
# Leg (a)'s attention at the model's width: q, k, v (b, seq, heads, dim).
RING_QKV = (8, 1024, 16, 64)
# Leg (a): the ring's q, k, v gradients against the world-1 flash step's,
# relative L2 per tensor. Both round f32 gradients to bf16 once (at most
# 2^-8 of a value each, so at most 2^-7 apart) on top of f32 gaps of
# ~1e-5; 2^-6 is the moe phase's gradient limit (PP_GRAD_RTOL).
RING_GRAD_RTOL = 2.0 ** -6
# Leg (b): the first sp step's parameters against the world-1 flash
# step's, relative to the update. The loss and the gradients keep the moe
# phase's limits, and so does (c2)'s later step; this one does not. AdamW's
# first update is lr * g / (|g| + eps), lr times the sign of g: an element
# whose gradient changes sign between two sound computations moves 2 lr.
# The ring rounds the second half's attention outputs otherwise than the
# one-pass kernel (leg (a): one bf16 ulp), which flips the signs of a few
# gradients near 0. Readings on an H100 (PERF.md, the ring findings): 7.462e-2 in four
# runs (the embedding's leaf 0.11); the control with the world-1 forward
# and the gradient summed over two halves of the batch 1.962e-2; a mutated
# copy whose gradients are not summed over sp 0.786 and 1.001 (its
# gradients 0.69 and 0.96). 2^-3 is 1.7x the sound reading and 6x under
# the broken one.
RING_FIRST_UPDATE_RTOL = 2.0 ** -3
RING_TIMEOUT_S = 600.0


def ring_configs() -> tuple:
    """``(flash, ring_flash)``: the main configuration, and the same model
    with ring attention with the chunk kernel."""
    cfg = main_config()
    return cfg, dataclasses.replace(cfg, attn_impl="ring_flash")


def _rel_l2(a, b) -> float:
    """``||a - b|| / ||b||`` in f32."""
    return _rel_gap(_norm2(a.float() - b.float()), _norm2(b))


class _FailTogether:
    """Leg (e): the ring phase's workers fail together. A rank whose check
    fails posts its error under ``<prefix>/error`` in the package's store;
    the legs meet at gates that read that key; and a watcher thread in every
    rank polls it and interrupts its main thread (a ``KeyboardInterrupt``)
    when a peer's error lands, wherever that thread waits (in a take's
    store collectives, or a gloo transfer that the peer never joins)."""

    POLL_S = 0.2

    def __init__(self, pg, prefix: str) -> None:
        import threading

        self.pg, self.prefix, self.key = pg, prefix, f"{prefix}/error"
        self.peer_error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, name="fail-together", daemon=True)
        self._thread.start()

    def _watch(self) -> None:
        import _thread

        while not self._stop.wait(self.POLL_S):
            try:
                raw = self.pg.store.try_get(self.key)
            except OSError:
                return  # the store's host is gone: the main thread's next wait fails by itself
            if raw is not None and not self._stop.is_set():
                self.peer_error = raw.decode(errors="replace")
                _thread.interrupt_main()
                return

    def gate(self, name: str, timeout: float = RING_TIMEOUT_S) -> None:
        """Wait until every rank reached gate ``name``; raise at once if a
        rank posted its error."""
        store = self.pg.store
        store.set(f"{self.prefix}/{name}/{self.pg.rank}", b"1")
        keys = [f"{self.prefix}/{name}/{r}" for r in range(self.pg.world_size)]
        deadline = time.monotonic() + timeout
        while True:
            got = store.multi_get([self.key] + keys)
            if got[self.key] is not None:
                self.peer_error = got[self.key].decode(errors="replace")
                raise AssertionError(f"rank {self.pg.rank}: a peer failed: {self.peer_error}")
            if all(got[k] is not None for k in keys):
                return
            _require(time.monotonic() < deadline, f"rank {self.pg.rank}: gate {name!r} timed out")
            time.sleep(0.02)

    def fail(self, exc: BaseException) -> BaseException:
        """What the worker raises for ``exc``: its own failure, posted for
        its peers first; or a peer's, named."""
        self.close()
        if self.peer_error is not None:
            return AssertionError(f"rank {self.pg.rank} stopped: a peer failed first: {self.peer_error}")
        with contextlib.suppress(OSError):  # a store whose host is gone: the peers fail on it anyway
            self.pg.store.set(self.key, f"rank {self.pg.rank}: {exc!r}"[:2000].encode())
        return exc

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


def _ring_attention_leg(mesh, seed: int) -> dict:
    """Leg (a) on one rank: the ring and ring_flash output blocks and q, k,
    v gradients against the world-1 flash entries' on the same inputs; the
    chunk kernel's causal and unmasked launches at the ring's shapes held
    against the plain version."""
    import torch

    from torchsnapshot_tpu_torch.ops import flash_attention as fa
    from torchsnapshot_tpu_torch.ops.ring_attention import ring_causal_attention

    r, n = mesh.get_local_rank(0), mesh.size(0)
    b, seq, h, d = RING_QKV
    s = seq // n
    blk = lambda t: t[:, r * s:(r + 1) * s]  # noqa: E731
    q, k, v = _qkv(RING_QKV, torch.bfloat16, seed, fused_qkv=True)
    g = torch.randn(RING_QKV, generator=torch.Generator(device="cuda").manual_seed(seed + 1), device="cuda")
    g = g.to(torch.bfloat16)
    want = fa.flash_causal_forward(q, k, v)
    q1, k1, v1 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fa.flash_causal_attention(q1, k1, v1).backward(g)
    rtol, atol = fa.FUSED_TOL[torch.bfloat16]
    out = {}
    for impl, flash in (("ring", False), ("ring_flash", True)):
        modes = dict(fa.chunk_launches_by_mode)
        ql, kl, vl = (blk(t).detach().clone().requires_grad_() for t in (q, k, v))
        y = ring_causal_attention(ql, kl, vl, mesh=mesh, use_flash=flash)
        y.backward(blk(g))
        torch.cuda.synchronize()
        err = (y.detach().float() - blk(want).float()).abs().max().item()
        torch.testing.assert_close(y.detach().float(), blk(want).float(), rtol=rtol, atol=atol)
        gaps = {name: _rel_l2(t.grad, blk(w.grad)) for name, t, w in (("q", ql, q1), ("k", kl, k1), ("v", vl, v1))}
        _require(max(gaps.values()) <= RING_GRAD_RTOL,
                 f"rank {r}: {impl} gradients {gaps} against flash's (limit {RING_GRAD_RTOL:.3e})")
        out[impl] = {"max_abs_err": err, "grad_gaps": gaps,
                     "chunk_launches": {m: fa.chunk_launches_by_mode[m] - modes[m] for m in modes}}
    # The chunk kernel at the ring's shapes: this rank's queries against
    # each block at or behind them (the diagonal causal, the rest unmasked).
    checks = {}
    for src in range(r + 1):
        kv = torch.stack((k[:, src * s:(src + 1) * s], v[:, src * s:(src + 1) * s]))
        errs = fa.compare_with_plain(blk(q), kv[0], kv[1], 128)
        checks[f"src {src}"] = {m: errs[m] for m in ("flash_chunk_causal", "flash_chunk_unmasked", "chunk_atol")}
    out["chunk_checks"] = checks
    del q, k, v, g, want, q1, k1, v1
    torch.cuda.empty_cache()
    return out


def _step_record(state, train_step, tokens, halves: bool = False) -> dict:
    """One step of ``state`` (in place): its loss; per parameter its
    gradient and its value before and after AdamW. With ``halves`` (a
    world-1 step, the control of the sp step's gradient sum) the gradient
    is accumulated in the parameters' dtype over two halves of the batch,
    as the sp step sums two ranks' halves of the sequence."""
    from torchsnapshot_tpu_torch.models.transformer import loss_fn

    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    if halves:
        state.optimizer.zero_grad(set_to_none=True)
        half = tokens.shape[0] // 2
        losses = []
        for part in (tokens[:half], tokens[half:]):
            loss = loss_fn(state.model, part) / 2
            loss.backward()
            losses.append(float(loss))
        state.optimizer.step()
        loss = sum(losses)
    else:
        _, loss = train_step(state, tokens)
    return {
        "loss": float(loss), "before": before,
        "grad": {n: p.grad.detach().clone() for n, p in state.model.named_parameters()},
        "after": {n: p.detach().clone() for n, p in state.model.named_parameters()},
    }


def _step_gaps(got: dict, want: dict) -> dict:
    """``got``'s step against ``want``'s (both ``_step_record``s from the
    same parameters): the loss's relative gap; the largest leaf gradient's
    relative L2 gap; the parameters' L2 gap after the step relative to
    ``want``'s update, over all leaves, and the largest leaf's."""
    grads, updates = {}, {}
    diff2 = update2 = 0.0
    for n, after in want["after"].items():
        grads[n] = _rel_l2(got["grad"][n], want["grad"][n].to(got["grad"][n].device))
        after = after.to(got["after"][n].device).float()
        d2, u2 = _norm2(got["after"][n].float() - after), _norm2(after - got["before"][n].float())
        updates[n] = _rel_gap(d2, u2)
        diff2, update2 = diff2 + d2, update2 + u2
    return {
        "loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
        "grad": max(grads.items(), key=lambda kv: kv[1]),
        "update": _rel_gap(diff2, update2),
        "update_leaf": max(updates.items(), key=lambda kv: kv[1]),
    }


def _gaps_line(g: dict) -> str:
    return (
        f"loss {g['loss']:.3e}, gradients {g['grad'][1]:.3e} ({g['grad'][0]}), parameters {g['update']:.3e} of "
        f"the update (largest leaf {g['update_leaf'][1]:.3e}, {g['update_leaf'][0]})"
    )


def _require_step_gaps(g: dict, what: str, update_rtol: float = PP_UPDATE_RTOL) -> None:
    """The moe phase's limits on a step against another (the parameters'
    limit given for the sp run's first step)."""
    _require(g["loss"] <= PP_LOSS_RTOL and g["grad"][1] <= PP_GRAD_RTOL and g["update"] <= update_rtol,
             f"{what}: {_gaps_line(g)}; limits {PP_LOSS_RTOL:.3e}, {PP_GRAD_RTOL:.3e}, {update_rtol:.3e}")


def ring_worker(pg, seed: int, work_dir: str) -> dict:
    """One rank of the ring phase (spawned by ``run_multiprocess``; the
    parent built every kernel): a gloo default group, a ``cuda`` mesh with
    an ``sp`` dimension of 2; legs (a)-(c), meeting at gates."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from torchsnapshot_tpu_torch import Snapshot, telemetry
    from torchsnapshot_tpu_torch.models.transformer import init_train_state, make_train_step, random_tokens
    from torchsnapshot_tpu_torch.ops import device_digest as dd
    from torchsnapshot_tpu_torch.ops import device_pack as dp
    from torchsnapshot_tpu_torch.ops import flash_attention as fa
    from torchsnapshot_tpu_torch.ops import kernels
    from torchsnapshot_tpu_torch.test_utils import init_torch_group

    t_start = time.monotonic()
    os.environ["TORCHSNAPSHOT_TPU_PEER_TIER"] = "0"  # the write paths without the tier, as the ranks phase
    rank = pg.rank
    torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    missing = [n for n in kernels.kernel_names() if not os.path.exists(kernels._library_path(n))]
    _require(not missing, f"rank {rank}: kernels {missing} not built by the parent")
    init_torch_group(pg)
    together = _FailTogether(pg, "ring")
    try:
        mesh = init_device_mesh("cuda", (pg.world_size,), mesh_dim_names=("sp",))
        record = {"rank": rank, "device": torch.cuda.current_device(), "sp_rank": mesh.get_local_rank(0)}
        together.gate("start")
        record["a"] = _ring_attention_leg(mesh, seed)
        together.gate("a")

        # (b) Training: the world-1 flash step on a replica, then STEPS
        # sequence-parallel steps from the same initial state.
        cfg_flash, cfg_ring = ring_configs()
        tokens = torch.from_numpy(random_tokens(cfg_ring, 8, 1024, seed)).cuda()
        replica = init_train_state(cfg_flash, seed=seed)
        want = _step_record(replica, make_train_step(cfg_flash), tokens)
        replica = init_train_state(cfg_flash, seed=seed)
        control = _step_gaps(_step_record(replica, None, tokens, halves=True), want)
        del replica
        state = init_train_state(cfg_ring, seed=seed)
        train_step = make_train_step(cfg_ring, mesh)
        for counts in (fa.launch_counts, fa.chunk_launches_by_mode, dd.launch_counts, dp.launch_counts):
            for k in counts:
                counts[k] = 0
        before = telemetry.metrics().counters_snapshot()
        losses, step_ms = [], []
        for i in range(STEPS):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            if i == 0:
                got = _step_record(state, train_step, tokens)
                losses.append(got["loss"])
            else:
                losses.append(float(train_step(state, tokens)[1]))
            torch.cuda.current_stream().synchronize()
            step_ms.append((time.monotonic() - t0) * 1e3)
            if i == 0:
                gaps = _step_gaps(got, want)
                del got, want
                log(f"ring (b) rank {rank}: step 1 against the world-1 flash step: {_gaps_line(gaps)}; the control "
                    f"(the world-1 step's gradient summed over two halves of the batch): {_gaps_line(control)}")
                _require_step_gaps(gaps, f"rank {rank}: the sp step against the world-1 step", RING_FIRST_UPDATE_RTOL)
        moves = _pipeline_moves(before)
        _require(all(x == x and abs(x) < 1e4 for x in losses), f"rank {rank}: losses not finite: {losses}")
        record["b"] = {"losses": losses, "step_ms": step_ms, "gaps": gaps, "control": control, "moves": moves,
                       "replica_leaves": _require_replicas_equal(pg, state)}
        together.gate("b")

        # (c) The sp job's take, each rank writing its share of the
        # replicated bytes; restored at world 2 into another seed's state,
        # the next step's loss bit for bit. Rank 0 leaves the saved
        # state's digests and the live run's next step for the parent.
        path = os.path.join(work_dir, "sp2")
        saved = {k: v.clone() for k, v in _state_tensors(state).items()}
        torch.cuda.synchronize()
        t0 = time.monotonic()
        Snapshot.take(path, {"train": state}, pg=pg, replicated=["train/**"])
        take_s = time.monotonic() - t0
        together.gate("taken")
        written, _ = _rank_blob_bytes(path, rank)
        total = _replicated_bytes(path)
        share = written / total
        _require(abs(share - 0.5) <= 0.1, f"rank {rank} wrote {share:.4f} of the replicated bytes")
        fresh = init_train_state(cfg_ring, seed=seed + 1)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        Snapshot(path, pg=pg).restore({"train": fresh})
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        _require_same_state(saved, fresh, f"rank {rank}: the world-2 restore")
        digests = _leaf_digests(fresh)
        nxt = _step_record(state, train_step, tokens)
        _, loss_fresh = train_step(fresh, tokens)
        torch.cuda.synchronize()
        _require(nxt["loss"] == float(loss_fresh),
                 f"rank {rank}: next losses differ after the world-2 restore: {nxt['loss']!r} vs {float(loss_fresh)!r}")
        if rank == 0:
            torch.save({key: nxt[key] if key == "loss" else {n: t.cpu() for n, t in nxt[key].items()}
                        for key in ("loss", "grad", "after")}, os.path.join(work_dir, "next_step.pt"))
        record["c"] = {"take_s": take_s, "restore_s": restore_s, "written_bytes": written, "replicated_bytes": total,
                       "share": share, "next_loss": nxt["loss"], "digests": digests}
        del nxt, fresh, saved
        record["launches"] = {**fa.launch_counts, **dd.launch_counts, **dp.launch_counts}
        record["chunk_modes"] = dict(fa.chunk_launches_by_mode)
        together.gate("c")
        record["worker_s"] = time.monotonic() - t_start
        return record
    except BaseException as e:
        raise together.fail(e)
    finally:
        together.close()
        dist.destroy_process_group()


def _unmasked_chunk_record(seed: int) -> dict:
    """The chunk kernel's unmasked mode at a ring step's shape (bf16 (8,
    512, 16, 64), the queries a slice of the fused qkv, k and v of one
    stacked buffer, as the ring passes them): held against its plain
    version, timed as the kernels phase times a kernel, beside SDPA
    (``is_causal=False``) on the same inputs."""
    import torch
    import torch.nn.functional as F

    from torchsnapshot_tpu_torch.ops import flash_attention as fa

    b, seq, h, d = RING_QKV
    s = seq // RING_RANKS
    q, k, v = _qkv((b, s, h, d), torch.bfloat16, seed, fused_qkv=True)
    kv = torch.stack((k, v))
    k, v = kv[0], kv[1]
    errs = fa.compare_with_plain(q, k, v, 128)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))

    def fn():
        return fa.flash_attention_chunk(q, k, v, causal=False)

    flops = fa.attention_flops(b, h, s, s, d, causal=False)
    nbytes = 3 * b * s * h * d * q.element_size() + 4 * b * h * s * (d + 2)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    rec = {
        "ms": cuda_ms(fn),
        "plain_ms": cuda_ms(lambda: fa.flash_attention_chunk_plain(q, k, v, False), iters=3),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=False)),
        "bound_ms": max(bytes_ms, op_ms),
        "bound_by": "bytes" if bytes_ms > op_ms else "operations",
        "max_abs_err": errs["flash_chunk_unmasked"],
    }
    device_ms, host_us = held_times(fn)
    sdpa_device_ms, _ = held_times(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=False))
    log(
        f"kernel flash_chunk unmasked {(b, s, h, d)} bf16 (a ring step's block): {rec['ms']:.4f} ms back to back, "
        f"{flops / rec['ms'] / 1e9:.1f} TFLOP/s; device {device_ms:.4f} ms, host {host_us:.1f} us per call (plain "
        f"{rec['plain_ms']:.4f} ms, SDPA is_causal=False {rec['library_ms']:.4f} ms, device {sdpa_device_ms:.4f} ms; "
        f"bound {rec['bound_ms']:.4f} ms by {rec['bound_by']}: bytes {nbytes / 1e6:.3f} MB {bytes_ms:.4f} ms, "
        f"operations {flops / 1e9:.3f} GFLOP {op_ms:.4f} ms), max |err| {rec['max_abs_err']:.3e} (chunk o/l atol "
        f"{errs['chunk_atol']:.3e}, m and l {fa.F32_TOL})"
    )
    rec["device_ms"], rec["host_us"], rec["sdpa_device_ms"] = device_ms, host_us, sdpa_device_ms
    return rec


def ring_phase(args, work_dir: str, card: str) -> dict:
    """Legs (a)-(c) in two spawned processes on the card, then (c2) the
    sp job's snapshot restored here at world 1 and continued with a flash
    step, and the unmasked chunk timed. Returns the launches of the ring
    path (both workers' counted windows), by kernel and by chunk mode, and
    the unmasked mode's kernel record."""
    import torch

    from torchsnapshot_tpu_torch import Snapshot
    from torchsnapshot_tpu_torch.models.transformer import init_train_state, make_train_step, random_tokens
    from torchsnapshot_tpu_torch.test_utils import run_multiprocess

    t_phase = time.monotonic()
    ring_dir = os.path.join(work_dir, "ring")
    os.makedirs(ring_dir, exist_ok=True)
    records = run_multiprocess(ring_worker, RING_RANKS, args=(args.seed, ring_dir), timeout=RING_TIMEOUT_S)
    workers_s = time.monotonic() - t_phase

    # (c2) World 1: the sp = 2 snapshot into a flash model's state,
    # bit-identical to the saved state by digest; its next flash step
    # against the sp run's next step.
    cfg_flash, _ = ring_configs()
    tokens = torch.from_numpy(random_tokens(cfg_flash, 8, 1024, args.seed)).cuda()
    fresh = init_train_state(cfg_flash, seed=args.seed + 2)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    Snapshot(os.path.join(ring_dir, "sp2")).restore({"train": fresh})
    torch.cuda.synchronize()
    world1_restore_s = time.monotonic() - t0
    want_digests = records[0]["c"]["digests"]
    got_digests = _leaf_digests(fresh)
    _require(sorted(got_digests) == sorted(want_digests), "the world-1 restore holds other leaves")
    for p in want_digests:
        _require(got_digests[p] == want_digests[p], f"world-1 restore of the sp = 2 snapshot: {p} differs")
    flash_step = make_train_step(cfg_flash)
    got = _step_record(fresh, flash_step, tokens)
    sp_next = torch.load(os.path.join(ring_dir, "next_step.pt"))
    world1_gaps = _step_gaps(got, sp_next)
    log(f"ring (c2): the world-1 restore's next flash step against the sp run's: {_gaps_line(world1_gaps)}")
    _require_step_gaps(world1_gaps, "the world-1 restore's next step against the sp run's")
    del got, sp_next
    torch.cuda.synchronize()
    t0 = time.monotonic()
    flash_step(fresh, tokens)
    torch.cuda.current_stream().synchronize()
    flash_step_ms = (time.monotonic() - t0) * 1e3
    del fresh
    torch.cuda.empty_cache()
    unmasked = _unmasked_chunk_record(args.seed)

    launches = {k: sum(r["launches"][k] for r in records) for k in RING_PATH_KERNELS}
    modes = {m: sum(r["chunk_modes"][m] for r in records) for m in ("causal", "unmasked")}
    _require(all(launches.values()) and all(modes.values()),
             f"ring: a kernel or chunk mode of the path never launched: {launches}, {modes}")
    shutil.rmtree(ring_dir, ignore_errors=True)
    wall_s = time.monotonic() - t_phase
    for r in records:
        a, b, c = r["a"], r["b"], r["c"]
        ring_moves, sums = b["moves"].get("ring", {}), b["moves"].get("sp_sum", {})
        log(
            f"ring: rank {r['rank']} (sp {r['sp_rank']}) on card {r['device']}: (a) attention {RING_QKV} bf16 against "
            f"the world-1 flash entries: "
            + "; ".join(
                f"{impl} output max |err| {a[impl]['max_abs_err']:.3e} (FUSED_TOL bf16), gradients "
                + ", ".join(f"d{n} {g:.3e}" for n, g in a[impl]["grad_gaps"].items())
                + f" (limit {RING_GRAD_RTOL:.3e}), chunk launches {a[impl]['chunk_launches']}"
                for impl in ("ring", "ring_flash")
            )
            + "; chunk kernel against plain "
            + "; ".join(f"{src}: causal {e['flash_chunk_causal']:.3e}, unmasked {e['flash_chunk_unmasked']:.3e}"
                        for src, e in a["chunk_checks"].items())
        )
        log(
            f"ring: rank {r['rank']} (b) ring_flash at sp = 2: steps {', '.join(f'{x:.1f}' for x in b['step_ms'])} ms, "
            f"losses {b['losses']}; step 1 against the world-1 flash step: {_gaps_line(b['gaps'])} (the control: "
            f"{_gaps_line(b['control'])}); "
            f"{b['replica_leaves']} leaves' digests equal across the ranks; ring hops {ring_moves.get('calls', 0)}, "
            f"{ring_moves.get('bytes', 0) / 1e6:.1f} MB in {ring_moves.get('seconds', 0.0) * 1e3:.1f} ms "
            f"({ring_moves.get('seconds', 0.0) * 1e3 / max(1, ring_moves.get('calls', 0)):.2f} ms a hop); sp sums "
            f"{sums.get('calls', 0)}, {sums.get('bytes', 0) / 1e6:.1f} MB in {sums.get('seconds', 0.0) * 1e3:.1f} ms; "
            f"{b['moves']['d2h_bytes'] / 1e6:.1f} MB to the host and {b['moves']['h2d_bytes'] / 1e6:.1f} MB back; "
            f"(c) take {c['take_s']:.3f} s, wrote {c['written_bytes'] / 1e9:.4f} of {c['replicated_bytes'] / 1e9:.4f} GB "
            f"replicated ({c['share']:.4f}), restore at world 2 {c['restore_s']:.3f} s bit-identical, next loss "
            f"{c['next_loss']!r} bit for bit; launches {r['launches']}, chunk modes {r['chunk_modes']}; worker "
            f"{r['worker_s']:.1f} s"
        )
    log(
        f"ring: world-1 restore of the sp = 2 snapshot {world1_restore_s:.3f} s, every leaf's digest equal; its next "
        f"flash step against the sp run's next step: "
        f"{_gaps_line(world1_gaps)}; one more flash step {flash_step_ms:.1f} ms (this process alone on the card); "
        f"launches {launches}, chunk modes {modes}; workers "
        f"{workers_s:.1f} s, phase {wall_s:.1f} s on {card}"
    )
    record = {
        "card": card, "ranks": [{k: v for k, v in r.items() if k != "c"} for r in records],
        "take_s": [r["c"]["take_s"] for r in records], "restore_s": [r["c"]["restore_s"] for r in records],
        "shares": [r["c"]["share"] for r in records], "world1_restore_s": world1_restore_s,
        "world1_gaps": world1_gaps, "flash_step_ms": flash_step_ms, "launches": launches, "chunk_modes": modes,
        "unmasked_chunk": unmasked, "workers_s": workers_s, "wall_s": wall_s,
    }
    _headline(
        "ring", ring_step_ms=[r["b"]["step_ms"][-1] for r in records], flash_step_ms=flash_step_ms,
        hop_ms=[r["b"]["moves"].get("ring", {}).get("seconds", 0.0) * 1e3
                / max(1, r["b"]["moves"].get("ring", {}).get("calls", 0)) for r in records],
        unmasked_ms=[unmasked["ms"], unmasked["device_ms"], unmasked["library_ms"], unmasked["bound_ms"]],
        launches="/".join(f"{k}:{launches[k]}" for k in RING_PATH_KERNELS) + f"; modes {modes['causal']}/{modes['unmasked']}",
    )
    print(json.dumps({"ring": record}, default=str), flush=True)
    return {**launches, "flash_chunk_unmasked": modes["unmasked"], "record": {
        k: unmasked[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")
    }}


# ----------------------------------------------------------------------
# The dcp phase: interop with torch.distributed.checkpoint
# ----------------------------------------------------------------------


# The kernels the dcp phase must launch: the training steps and the
# evaluation forward (flash), the world-1 restore's digests.
DCP_PATH_KERNELS = ("flash_fwd", "flash_chunk", "device_digest")
DCP_RANKS = 2
DCP_TURNS = 2
DCP_TIMEOUT_S = 600.0


def _zero_state(state) -> None:
    """Every tensor of a train state set to 0 (the RNG's state aside): a
    restore into it must write each one."""
    import torch

    with torch.no_grad():
        for name, t in _state_tensors(state).items():
            if name != "rng":
                t.zero_()


def _digests(tensors: dict) -> dict:
    """The ``mlh64`` digest of every tensor by name: the CUDA ones in one
    launch of the digest kernel, the host ones on the host."""
    from torchsnapshot_tpu_torch.ops import device_digest as dd

    cuda = [(k, t) for k, t in sorted(tensors.items()) if t.is_cuda]
    rows = dd.materialize_many(dd.digest_many_async([(t, None) for _, t in cuda]))
    out = {k: (int(r[0]), int(r[1])) for (k, _), r in zip(cuda, rows)}
    out.update({k: dd.digest_host(t) for k, t in tensors.items() if not t.is_cuda})
    return out


def dcp_worker(pg, seed: int, work_dir: str) -> dict:
    """One rank of the dcp phase's leg (c) (spawned by
    ``run_multiprocess``; the parent built every kernel): a gloo default
    group and a ``cuda`` mesh of 2, as in the sharded phase; the train
    state's ``Shard(0)`` ``DTensor``s saved by ``dcp.save`` through
    ``SnapshotStorageWriter``, then loaded through ``SnapshotStorageReader``
    into ``Shard(1)``. The ranks meet at gates and fail together."""
    import torch
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    from torch.distributed.device_mesh import init_device_mesh

    from torchsnapshot_tpu_torch.models.transformer import init_train_state, make_train_step, random_tokens
    from torchsnapshot_tpu_torch.ops import flash_attention as fa
    from torchsnapshot_tpu_torch.ops import kernels
    from torchsnapshot_tpu_torch.test_utils import init_torch_group
    from torchsnapshot_tpu_torch.tricks.dcp import SnapshotStorageReader, SnapshotStorageWriter

    t_start = time.monotonic()
    os.environ["TORCHSNAPSHOT_TPU_PEER_TIER"] = "0"  # the write paths without the tier, as the sharded phase
    rank = pg.rank
    torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    missing = [n for n in kernels.kernel_names() if not os.path.exists(kernels._library_path(n))]
    _require(not missing, f"rank {rank}: kernels {missing} not built by the parent")
    init_torch_group(pg)
    together = _FailTogether(pg, "dcp")
    try:
        mesh = init_device_mesh("cuda", (pg.world_size,))
        cfg = main_config()
        tokens = torch.from_numpy(random_tokens(cfg, 8, 1024, seed)).cuda()
        state = init_train_state(cfg, seed=seed)
        train_step = make_train_step(cfg)
        fa.reset_launch_counts()
        for _ in range(STEPS):
            state, _ = train_step(state, tokens)
        torch.cuda.synchronize()
        leaves = _replica_leaves(state, seed)
        record = {"rank": rank, "device": torch.cuda.current_device(), "flash_chunk": fa.launch_counts["flash_chunk"]}
        together.gate("trained")

        path = os.path.join(work_dir, "w2")
        tree = _dtensor_tree(leaves, mesh)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        dcp.save({"train": tree}, storage_writer=SnapshotStorageWriter(path))
        record["save_s"] = time.monotonic() - t0
        _, written = _rank_blobs(path, rank, "sharded/")
        sharded_total = sum(
            t.numel() * t.element_size() for t in leaves.values() if t.is_cuda and t.dim() > 0
        )
        share = written / sharded_total
        _require(abs(share - 0.5) <= 0.01, f"rank {rank} wrote {share:.4f} of the sharded bytes")
        record.update({"written_bytes": written, "sharded_bytes": sharded_total, "share": share})
        together.gate("saved")

        dest = _dtensor_tree(_replica_leaves(init_train_state(cfg, seed=seed + 1), seed + 1), mesh, _tp_dim)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        dcp.load({"train": dest}, storage_reader=SnapshotStorageReader(path))
        torch.cuda.synchronize()
        record["load_s"] = time.monotonic() - t0
        _require_shards(dest, leaves, f"rank {rank}: the reader's load into Shard(1)")
        together.gate("loaded")
        dist.barrier()
        record["worker_s"] = time.monotonic() - t_start
        return record
    except BaseException as e:
        raise together.fail(e)
    finally:
        together.close()
        dist.destroy_process_group()


def dcp_phase(args, work_dir: str, card: str) -> dict:
    """Legs (a)-(d) of the module docstring on the main configuration.
    Returns the phase's launches by kernel (counts set to 0 at its
    start)."""
    import torch
    import torch.distributed.checkpoint as dcp

    from torchsnapshot_tpu_torch import Snapshot
    from torchsnapshot_tpu_torch.fsck import verify_snapshot
    from torchsnapshot_tpu_torch.models.transformer import init_train_state, make_train_step, random_tokens
    from torchsnapshot_tpu_torch.ops import device_digest as dd
    from torchsnapshot_tpu_torch.ops import flash_attention as fa
    from torchsnapshot_tpu_torch.test_utils import run_multiprocess
    from torchsnapshot_tpu_torch.tricks.dcp import (
        SnapshotStorageReader,
        SnapshotStorageWriter,
        migrate_dcp_to_snapshot,
        migrate_snapshot_to_dcp,
    )
    from torchsnapshot_tpu_torch.tricks.train_state import TrainStateStateful

    t_phase = time.monotonic()
    root = os.path.join(work_dir, "dcp")
    os.makedirs(root, exist_ok=True)
    fa.reset_launch_counts()
    dd.reset_launch_counts()
    cfg = main_config()
    tokens = torch.from_numpy(random_tokens(cfg, 8, 1024, args.seed)).cuda()
    state = init_train_state(cfg, seed=args.seed)
    train_step = make_train_step(cfg)
    for _ in range(STEPS):
        state, _ = train_step(state, tokens)
    torch.cuda.synchronize()
    live = {k: t.clone() for k, t in _state_tensors(state).items()}
    state_bytes = sum(t.numel() * t.element_size() for t in live.values())
    record = {"card": card, "train_state_bytes": state_bytes}

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        return time.monotonic() - t0

    # (a) Migration both ways through DCP's own FileSystemWriter / Reader.
    src, snap_a, out_a = (os.path.join(root, n) for n in ("dcp_src", "snap_a", "dcp_out"))
    a = {"fs_save_s": timed(lambda: dcp.save(state.state_dict(), storage_writer=dcp.FileSystemWriter(src)))}
    a["to_snapshot_s"] = timed(lambda: migrate_dcp_to_snapshot(src, snap_a, key="train"))
    fresh = init_train_state(cfg, seed=args.seed + 1)
    a["restore_s"] = timed(lambda: Snapshot(snap_a).restore({"train": fresh}))
    _require_same_state(live, fresh, "(a) DCP -> snapshot -> Snapshot.restore")
    del fresh
    tmpl = init_train_state(cfg, seed=args.seed + 2)
    a["to_dcp_s"] = timed(lambda: migrate_snapshot_to_dcp(snap_a, out_a, tmpl.state_dict(), key="train"))
    del tmpl
    resumed_a = init_train_state(cfg, seed=args.seed + 3)
    sd = resumed_a.state_dict()
    a["fs_load_s"] = timed(lambda: dcp.load(sd, storage_reader=dcp.FileSystemReader(out_a)))
    resumed_a.load_state_dict(sd)
    _require_same_state(live, resumed_a, "(a) snapshot -> DCP -> dcp.load")
    del sd
    record["a"] = a

    # (b) Interception: the writer and the reader on the train state.
    b = {}
    p_w, p_t, p_as = (os.path.join(root, n) for n in ("writer", "take", "async"))
    b["writer_s"] = timed(lambda: dcp.save({"train": state}, storage_writer=SnapshotStorageWriter(p_w)))
    dst = init_train_state(cfg, seed=args.seed + 4)
    b["writer_restore_s"] = timed(lambda: Snapshot(p_w).restore({"train": dst}))
    _require_same_state(live, dst, "(b) dcp.save through the writer -> Snapshot.restore")
    fsck = verify_snapshot(p_w, deep=True)
    _require(fsck.ok and fsck.crcs_verified > 0, f"(b) deep fsck of the writer's snapshot: {fsck.problems[:3]}")
    b["fsck_crcs"] = fsck.crcs_verified
    b["take_s"] = timed(lambda: Snapshot.take(p_t, {"train": state}))
    _zero_state(dst)
    b["reader_s"] = timed(lambda: dcp.load({"train": dst}, storage_reader=SnapshotStorageReader(p_t)))
    _require_same_state(live, dst, "(b) Snapshot.take -> dcp.load through the reader")
    with torch.no_grad():
        logits_live, logits_dst = state.model(tokens), dst.model(tokens)
    _require(bool(torch.isfinite(logits_live).all()) and same_bits(logits_live, logits_dst),
             "(b) evaluation logits differ after the reader's load")
    del logits_live, logits_dst
    t0 = time.monotonic()
    future = dcp.async_save({"train": state}, storage_writer=SnapshotStorageWriter(p_as))
    b["async_visible_s"] = time.monotonic() - t0
    future.result()
    b["async_s"] = time.monotonic() - t0
    _require(os.path.exists(os.path.join(p_as, ".snapshot_metadata")), "(b) async_save left no commit marker")
    _zero_state(dst)
    Snapshot(p_as).restore({"train": dst})
    _require_same_state(live, dst, "(b) dcp.async_save through the writer -> Snapshot.restore")
    for p in (p_w, p_t, p_as):
        shutil.rmtree(p, ignore_errors=True)

    # In turns: the three writers, then the three readers.
    turns = {k: [] for k in ("take", "writer", "fs_writer", "restore", "reader", "fs_reader")}
    for turn in range(DCP_TURNS):
        paths = {k: os.path.join(root, f"{k}_{turn}") for k in ("take", "writer", "fs_writer")}
        turns["take"].append(timed(lambda: Snapshot.take(paths["take"], {"train": state})))
        turns["writer"].append(timed(
            lambda: dcp.save({"train": state}, storage_writer=SnapshotStorageWriter(paths["writer"]))))
        turns["fs_writer"].append(timed(
            lambda: dcp.save({"train": state}, storage_writer=dcp.FileSystemWriter(paths["fs_writer"]))))
        for kind, run in (
            ("restore", lambda: Snapshot(paths["take"]).restore({"train": dst})),
            ("reader", lambda: dcp.load({"train": dst}, storage_reader=SnapshotStorageReader(paths["writer"]))),
            ("fs_reader", lambda: dcp.load({"train": dst}, storage_reader=dcp.FileSystemReader(paths["fs_writer"]))),
        ):
            _zero_state(dst)
            turns[kind].append(timed(run))
            _require_same_state(live, dst, f"(b) turn {turn}: {kind}")
        for p in paths.values():
            shutil.rmtree(p, ignore_errors=True)
    b["turns"] = turns
    del dst
    torch.cuda.empty_cache()
    record["b"] = b

    # (c) Two ranks: Shard(0) through the writer, into Shard(1) through the
    # reader; then the world-1 restore here, by digest.
    c_dir = os.path.join(root, "ranks")
    os.makedirs(c_dir, exist_ok=True)
    t0 = time.monotonic()
    workers = run_multiprocess(dcp_worker, DCP_RANKS, args=(args.seed, c_dir), timeout=DCP_TIMEOUT_S)
    workers_s = time.monotonic() - t0
    want = _replica_leaves(state, args.seed)
    dest = {k: torch.zeros_like(v) for k, v in want.items()}
    from torchsnapshot_tpu_torch import TensorTreeState

    world1_s = timed(lambda: Snapshot(os.path.join(c_dir, "w2")).restore({"train": TensorTreeState(dest)}))
    got, expect = _digests(dest), _digests(want)
    _require(sorted(got) == sorted(expect), "(c) the world-1 restore holds other leaves")
    for k in expect:
        _require(got[k] == expect[k], f"(c) world-1 restore of the world-2 DCP save: {k} differs")
    record["c"] = {"ranks": workers, "workers_s": workers_s, "world1_restore_s": world1_s, "leaves": len(expect)}
    del dest, want
    shutil.rmtree(c_dir, ignore_errors=True)

    # (d) TrainStateStateful: taken, restored into a fresh model and AdamW.
    p_d = os.path.join(root, "train_state")
    d = {"take_s": timed(lambda: Snapshot.take(
        p_d, {"train": TrainStateStateful(state.model, state.optimizer, step=state.step)}))}
    resumed_d = init_train_state(cfg, seed=args.seed + 6)
    adapter = TrainStateStateful(resumed_d.model, resumed_d.optimizer)
    d["restore_s"] = timed(lambda: Snapshot(p_d).restore({"train": adapter}))
    resumed_d.step = adapter.step
    resumed_d.rng.set_state(state.rng.get_state())  # the adapter holds model and optimizers, not the RNG
    _require(resumed_d.step == state.step, "(d) the step differs")
    _require_same_state(live, resumed_d, "(d) TrainStateStateful")
    record["d"] = d

    # The next step: the live state's, (a)'s and (d)'s, bit for bit.
    resumed_a.rng.set_state(state.rng.get_state())
    _, loss_live = train_step(state, tokens)
    _, loss_a = train_step(resumed_a, tokens)
    _, loss_d = train_step(resumed_d, tokens)
    torch.cuda.synchronize()
    _require(same_bits(loss_live, loss_a) and same_bits(loss_live, loss_d),
             f"next-step losses differ: live {loss_live}, (a) {loss_a}, (d) {loss_d}")
    after = _state_tensors(state)
    for other, what in ((resumed_a, "(a)"), (resumed_d, "(d)")):
        _require_same_state({k: v for k, v in after.items()}, other, f"{what} after the next step")
    record["next_loss"] = float(loss_live)
    del resumed_a, resumed_d, live, after
    launches = {**fa.launch_counts, **dd.launch_counts}
    _require(all(launches[k] for k in DCP_PATH_KERNELS), f"dcp: a kernel of the path never launched: {launches}")
    record["launches"] = {k: launches[k] for k in DCP_PATH_KERNELS}
    record["wall_s"] = time.monotonic() - t_phase
    shutil.rmtree(root, ignore_errors=True)

    gb = state_bytes / 1e9
    log(f"dcp (a): train state {gb:.3f} GB; dcp.save FileSystemWriter {a['fs_save_s']:.3f} s, "
        f"migrate_dcp_to_snapshot {a['to_snapshot_s']:.3f} s, Snapshot.restore {a['restore_s']:.3f} s, "
        f"migrate_snapshot_to_dcp {a['to_dcp_s']:.3f} s, dcp.load FileSystemReader {a['fs_load_s']:.3f} s; "
        f"bit-identical both ways")
    log(f"dcp (b): dcp.save through SnapshotStorageWriter {b['writer_s']:.3f} s, restored by Snapshot.restore "
        f"{b['writer_restore_s']:.3f} s bit-identical, deep fsck {b['fsck_crcs']} CRCs; Snapshot.take "
        f"{b['take_s']:.3f} s, dcp.load through SnapshotStorageReader {b['reader_s']:.3f} s bit-identical, logits "
        f"equal; dcp.async_save through the writer {b['async_visible_s']:.3f} s visible, {b['async_s']:.3f} s to "
        f"commit, bit-identical; in turns (s): "
        + "; ".join(f"{k} {', '.join(f'{x:.3f}' for x in v)}" for k, v in turns.items()))
    for r in workers:
        log(f"dcp (c): rank {r['rank']} on card {r['device']}: dcp.save through the writer at world 2 "
            f"{r['save_s']:.3f} s, wrote {r['written_bytes'] / 1e9:.4f} of {r['sharded_bytes'] / 1e9:.4f} GB "
            f"sharded ({r['share']:.6f}); dcp.load through the reader into Shard(1) {r['load_s']:.3f} s, every "
            f"local shard equal; worker {r['worker_s']:.1f} s")
    log(f"dcp (c): world-1 Snapshot.restore of the world-2 DCP save {world1_s:.3f} s, {len(expect)} leaves' "
        f"digests equal; (d) TrainStateStateful take {d['take_s']:.3f} s, restore into a fresh model and AdamW "
        f"{d['restore_s']:.3f} s; next-step loss {float(loss_live)!r} bit for bit for the live state, (a) and (d), "
        f"parameters too; launches {record['launches']}; workers {workers_s:.1f} s, phase "
        f"{record['wall_s']:.1f} s on {card}")
    _headline("dcp", fs_save_s=a["fs_save_s"], writer_s=turns["writer"], take_s=turns["take"],
              fs_writer_s=turns["fs_writer"], reader_s=turns["reader"], restore_s=turns["restore"],
              fs_reader_s=turns["fs_reader"], w2_save_s=[r["save_s"] for r in workers],
              w2_load_s=[r["load_s"] for r in workers], next_loss=float(loss_live))
    print(json.dumps({"dcp": record}, default=str), flush=True)
    del state
    torch.cuda.empty_cache()
    return record["launches"]


if __name__ == "__main__":
    sys.exit(main())
