"""Canonical metric names — the single registration point.

Every metric the package emits is declared here exactly once, as a
snake_case constant, and call sites reference the constant (never a
string literal). ``tools/check_metric_names.py`` enforces both halves
statically: a literal metric name at a call site, a non-snake_case
value, or a duplicate declaration fails the lane. This is what keeps
the exposition namespace stable enough for dashboards to key off.

Label conventions (labels are free-form at call sites, but keep them
small and low-cardinality):

- ``phase``:  staging | writing | loading | mirroring; commit | bookkeeping
              (the manager); place (restore placement)
- ``op``:     save | async_save | restore (the manager's public calls)
- ``role``:   snapshot-commit | ts-stage | ts-consume | storage (threads)
- ``plugin``: fs | s3 | gcs | memory | tiered
- ``scope``:  which retry strategy instance (s3 | gcs | mirror)
- ``kind``:   take | async_take | restore | async_restore | mirror;
              hop | broadcast | sum (the pipeline schedule's moves)
- ``route``:  kernel | plain (the training loss's)
"""

# -- pipeline (scheduler.py) -------------------------------------------------

SNAPSHOT_PHASE_SECONDS = "snapshot_phase_seconds"
MEMORY_BUDGET_WAIT_SECONDS = "memory_budget_wait_seconds"
MEMORY_BUDGET_PEAK_STAGED_BYTES = "memory_budget_peak_staged_bytes"

# -- storage plugins (storage_plugins/{fs,s3,gcs}.py) ------------------------

STORAGE_WRITE_BYTES_TOTAL = "storage_write_bytes_total"
# Bytes the port copies between the card and host memory: a take's
# staging and a restore's placement (io_preparer.DeviceCopier, pinned), and
# a pipeline move's round trip on gloo (parallel/pipeline.py).
DEVICE_TO_HOST_BYTES_TOTAL = "device_to_host_bytes_total"
HOST_TO_DEVICE_BYTES_TOTAL = "host_to_device_bytes_total"
STORAGE_WRITE_OPS_TOTAL = "storage_write_ops_total"
STORAGE_WRITE_SECONDS = "storage_write_seconds"
STORAGE_READ_BYTES_TOTAL = "storage_read_bytes_total"
STORAGE_READ_OPS_TOTAL = "storage_read_ops_total"
STORAGE_READ_SECONDS = "storage_read_seconds"
# Zero-pack / direct write-path accounting (storage_plugins/fs.py):
# bytes that went out through the vectorized pwritev kernel (each one a
# byte the slab-pack pass did NOT copy) and through O_DIRECT.
FS_VECTORIZED_WRITE_BYTES_TOTAL = "fs_vectorized_write_bytes_total"
FS_DIRECT_WRITE_BYTES_TOTAL = "fs_direct_write_bytes_total"
# batcher.py: slab bytes staged zero-pack — the pack pass they avoided.
BATCHER_PACK_BYTES_AVOIDED_TOTAL = "batcher_pack_bytes_avoided_total"

# -- retry machinery (storage_plugins/retry.py, gcs.py) ----------------------

STORAGE_RETRY_ATTEMPTS_TOTAL = "storage_retry_attempts_total"
STORAGE_RETRY_BACKOFF_SECONDS_TOTAL = "storage_retry_backoff_seconds_total"
STORAGE_RETRIES_EXHAUSTED_TOTAL = "storage_retries_exhausted_total"
GCS_RECOVER_ATTEMPTS_TOTAL = "gcs_recover_attempts_total"

# -- tiered mirror (tiered/mirror.py) ----------------------------------------

MIRROR_BLOBS_PENDING = "mirror_blobs_pending"
MIRROR_BLOBS_INFLIGHT = "mirror_blobs_inflight"
MIRROR_BLOBS_DONE_TOTAL = "mirror_blobs_done_total"
MIRROR_BYTES_TOTAL = "mirror_bytes_total"
MIRROR_SNAPSHOTS_PENDING = "mirror_snapshots_pending"
MIRROR_JOBS_DONE_TOTAL = "mirror_jobs_done_total"
MIRROR_JOBS_FAILED_TOTAL = "mirror_jobs_failed_total"
MIRROR_RESUME_TOTAL = "mirror_resume_total"
MIRROR_UPLOAD_LAG_SECONDS = "mirror_upload_lag_seconds"

# -- peer tier (tiered/peer.py) ----------------------------------------------

PEER_PUSH_BLOBS_TOTAL = "peer_push_blobs_total"
PEER_PUSH_BYTES_TOTAL = "peer_push_bytes_total"
PEER_PUSH_FAILURES_TOTAL = "peer_push_failures_total"
PEER_PULL_HITS_TOTAL = "peer_pull_hits_total"
PEER_PULL_MISSES_TOTAL = "peer_pull_misses_total"
PEER_PULL_BYTES_TOTAL = "peer_pull_bytes_total"
PEER_CACHE_BYTES = "peer_cache_bytes"
PEER_CACHE_STEPS = "peer_cache_steps"
PEER_TIER_DEGRADED_STATE = "peer_tier_degraded"

# -- content-addressed chunk store (cas/) ------------------------------------
#
# Write-side dedup accounting: chunks newly materialized into the store
# vs. writes satisfied by an existing chunk (the bytes a dense-retention
# run did NOT spend), plus the mirror's chunk-level shipping skips and
# the peer tier's inventory-by-digest dedup.

CAS_CHUNKS_WRITTEN_TOTAL = "cas_chunks_written_total"
CAS_BYTES_WRITTEN_TOTAL = "cas_bytes_written_total"
CAS_CHUNKS_DEDUPED_TOTAL = "cas_chunks_deduped_total"
CAS_BYTES_DEDUPED_TOTAL = "cas_bytes_deduped_total"
CAS_CHUNKS_RECLAIMED_TOTAL = "cas_chunks_reclaimed_total"
CAS_BYTES_RECLAIMED_TOTAL = "cas_bytes_reclaimed_total"
MIRROR_CHUNKS_SKIPPED_TOTAL = "mirror_chunks_skipped_total"
PEER_PUSH_CHUNKS_DEDUPED_TOTAL = "peer_push_chunks_deduped_total"
PEER_PUSH_BYTES_DEDUPED_TOTAL = "peer_push_bytes_deduped_total"

# -- coordination (dist_store.py, fanout.py, tiered/peer.py) -----------------
#
# What cross-rank coordination costs, attributed per structure: store
# wire round trips (requests + wall seconds, labeled by op), barrier
# arrive/depart wait time (labeled by phase and impl=tree|linear), the
# fan-out owner-table exchange, and endpoint-registry resolution. The
# per-op deltas land in SnapshotReport.coordination; the
# ``coordination-bound`` doctor rule and the scale-model harness
# (torchsnapshot_tpu/scalemodel) read them against wall time.

COORD_STORE_REQUESTS_TOTAL = "coordination_store_requests_total"
COORD_STORE_SECONDS_TOTAL = "coordination_store_seconds_total"
COORD_BARRIER_WAIT_SECONDS_TOTAL = "coordination_barrier_wait_seconds_total"
COORD_EXCHANGE_SECONDS_TOTAL = "coordination_exchange_seconds_total"
COORD_ENDPOINT_SECONDS_TOTAL = "coordination_endpoint_seconds_total"
# ShardedStore request routing, labeled shard=<index>: the skew input
# the ``store-hot-shard`` doctor rule reads (one shard absorbing a
# disproportionate request share means the crc32 route degenerated for
# this key population).
COORD_STORE_SHARD_REQUESTS_TOTAL = "coordination_store_shard_requests_total"

# -- wire observatory (telemetry/wire.py; dist_store.py, tiered/peer.py) -----
#
# The socket-level view of every byte the coordination store, peer
# tier, and CDN move (docs/observability.md "Wire observatory"). Frames
# and bytes are counted at the shared framing layer itself
# (``send_frame``/``recv_frame``), labeled ``endpoint`` (store | peer)
# and ``dir`` (send | recv); dials, per-RPC latency, pool checkouts and
# accept-queue depth at the client/server seams. The ``*_TOTAL``
# counters feed the per-op ``wire`` split in SnapshotReport; the
# histograms feed the fleet plane and the ``wire-dial-stalled`` /
# ``wire-hot-endpoint`` doctor rules.

WIRE_FRAMES_TOTAL = "wire_frames_total"
WIRE_BYTES_TOTAL = "wire_bytes_total"
WIRE_INFLIGHT_FRAMES = "wire_inflight_frames"
WIRE_DIALS_TOTAL = "wire_dials_total"
WIRE_DIAL_SECONDS_TOTAL = "wire_dial_seconds_total"
WIRE_DIAL_SECONDS = "wire_dial_seconds"
WIRE_RPCS_TOTAL = "wire_rpcs_total"
WIRE_RPC_SECONDS_TOTAL = "wire_rpc_seconds_total"
WIRE_RPC_SECONDS = "wire_rpc_seconds"
WIRE_POOL_CHECKOUTS_TOTAL = "wire_pool_checkouts_total"
WIRE_ACCEPT_QUEUE_DEPTH = "wire_accept_queue_depth"
# Frames whose propagation header failed its integrity check (chaos
# corruption, protocol skew): the transfer proceeded context-free.
WIRE_CONTEXT_DEGRADED_TOTAL = "wire_context_degraded_total"

# -- self-healing reads (scheduler.py) ---------------------------------------
#
# A restore read whose bytes failed checksum verification was re-read
# from an alternate tier (the corruption ladder, docs/chaos.md): how
# many blobs were rerouted and how many bytes the reroutes served,
# labeled by the tier that finally vouched for the bytes. The
# ``storage-corruption`` doctor rule cites these.

STORAGE_DEGRADED_READS_TOTAL = "storage_degraded_reads_total"
STORAGE_DEGRADED_READ_BYTES_TOTAL = "storage_degraded_read_bytes_total"

# -- manager (manager.py) ----------------------------------------------------

MANAGER_SAVES_TOTAL = "manager_saves_total"
MANAGER_RESTORES_TOTAL = "manager_restores_total"
MANAGER_GC_STEPS_TOTAL = "manager_gc_steps_total"
MANAGER_RETAINED_STEPS = "manager_retained_steps"
# The public calls from entry to return (label ``op``: save | async_save |
# restore) and their phases on rank 0 (label ``phase``: commit, the index
# update with retention and GC; bookkeeping, the post-commit history,
# ledger, SLO, CDN and autotune hooks).
MANAGER_CALL_SECONDS = "manager_call_seconds"
MANAGER_PHASE_SECONDS = "manager_phase_seconds"

# -- restore placement (snapshot.py) -----------------------------------------
#
# Label ``phase``: place, one host-to-device placement batch or the final
# wait for the copy streams.

RESTORE_PHASE_SECONDS = "restore_phase_seconds"

# -- checkpoint threads (scheduler.py, snapshot.py, storage_plugins/fs.py) ----
#
# Storage service time: one blocking storage call on its worker thread,
# without the executor queue and the event loop that storage_*_seconds
# include. Thread CPU: ``time.thread_time()`` of each checkpoint thread's
# unit of work, counted once per thread at the outermost unit (label
# ``role``: snapshot-commit | ts-stage | ts-consume | storage). It is
# what the checkpoint's threads burned beside training, not a GIL wait.

STORAGE_READ_SERVICE_SECONDS = "storage_read_service_seconds"
STORAGE_WRITE_SERVICE_SECONDS = "storage_write_service_seconds"
CHECKPOINT_THREAD_CPU_SECONDS_TOTAL = "checkpoint_thread_cpu_seconds_total"

# -- async capture (io_preparer.py) ------------------------------------------
#
# Card bytes that an async take's on-device clones hold, counted at the
# capture, and bytes x seconds from the capture until the drain drops
# the clone.

ASYNC_CAPTURE_DEVICE_BYTES_TOTAL = "async_capture_device_bytes_total"
ASYNC_CAPTURE_DEVICE_BYTE_SECONDS_TOTAL = "async_capture_device_byte_seconds_total"

# -- reports / sinks (telemetry/sink.py) -------------------------------------

SNAPSHOT_REPORTS_TOTAL = "snapshot_reports_total"

# -- utilities (utils/rss_profiler.py) ---------------------------------------

RSS_PEAK_DELTA_BYTES = "rss_peak_delta_bytes"

# -- stall watchdog (telemetry/watchdog.py) ----------------------------------

WATCHDOG_STALLS_TOTAL = "watchdog_stalls_total"

# -- checkpoint CDN (cdn/) ---------------------------------------------------
#
# Pub/sub weight streaming from a training job to a serving fleet
# (docs/cdn.md): the publisher's announce accounting, each subscriber's
# chunk-sync byte split by serving tier (durable storage read vs.
# peer-to-peer pull vs. already-held), and the staleness/swap timings
# the ``cdn-staleness-high`` doctor rule reads.

CDN_PUBLISHES_TOTAL = "cdn_publishes_total"
CDN_ANNOUNCE_BYTES_TOTAL = "cdn_announce_bytes_total"
CDN_UPDATES_APPLIED_TOTAL = "cdn_updates_applied_total"
CDN_PULL_BYTES_TOTAL = "cdn_pull_bytes_total"
CDN_CHUNKS_HELD_TOTAL = "cdn_chunks_held_total"
CDN_STALENESS_SECONDS = "cdn_staleness_seconds"
CDN_SWAP_SECONDS = "cdn_swap_seconds"

# -- run-level goodput (telemetry/goodput.py) --------------------------------
#
# Gauges refreshed from the run ledger after every committed manager
# step (and by the ``goodput`` CLI): the run-so-far attribution of wall
# time into train vs. checkpoint-overhead buckets, plus the storage
# spend per retained step. See docs/goodput.md.

GOODPUT_OVERHEAD_FRACTION = "goodput_overhead_fraction"
GOODPUT_TRAIN_SECONDS = "goodput_train_seconds"
GOODPUT_VISIBLE_STALL_SECONDS = "goodput_visible_stall_seconds"
GOODPUT_RECOVERY_SECONDS = "goodput_recovery_seconds"
GOODPUT_LOST_WORK_SECONDS = "goodput_lost_work_seconds"
GOODPUT_LOST_STEPS = "goodput_lost_steps"
GOODPUT_STORAGE_BYTES_PER_STEP = "goodput_storage_bytes_per_step"
GOODPUT_INCREMENTAL_REUSE_RATIO = "goodput_incremental_reuse_ratio"

# -- SLO engine & incident bundles (telemetry/slo.py, telemetry/bundle.py) ---
#
# Per-objective burn-rate gauges refreshed by the rank-0 per-step SLO
# evaluation (labelled ``objective=<SLO_* id>``), the breach counter the
# edge-triggered ledger posting bumps, and the black-box capture
# counter. See docs/observability.md "SLOs & incident bundles".

OBJECTIVE_BURN_RATE = "slo_burn_rate"
OBJECTIVE_BREACHES_TOTAL = "slo_breaches_total"
BUNDLE_CAPTURES_TOTAL = "bundle_captures_total"

# -- pipeline parallelism (parallel/pipeline.py) -----------------------------
#
# The moves of ``pipelined_apply`` (forward and backward), labelled
# ``kind``: an activation's or a cotangent's hop, the output's broadcast
# from the last stage, the input cotangent's sum. Seconds include a CUDA
# tensor's host round trip on a gloo group (its bytes also count in
# DEVICE_TO_HOST_BYTES_TOTAL and HOST_TO_DEVICE_BYTES_TOTAL).

PIPELINE_TRANSFERS_TOTAL = "pipeline_transfers_total"
PIPELINE_TRANSFER_BYTES_TOTAL = "pipeline_transfer_bytes_total"
PIPELINE_TRANSFER_SECONDS_TOTAL = "pipeline_transfer_seconds_total"

# -- the LFM2 model's sparse layers (models/lfm2.py) -------------------------
#
# Counted on the card in each training step and added one step late (the
# copy to the host is queried, never waited for): the top-k assignments,
# labelled ``held`` (1: on an expert this rank holds, 0: on an absent
# one), and per step and sparse layer the token count of the most-loaded
# held expert, summed, and that count times the number of experts held
# (over the held assignments: the most-loaded expert's load over the mean
# held expert's, 1 where routing is even).

MOE_ASSIGNMENTS_TOTAL = "moe_assignments_total"
MOE_HELD_MAX_TOKENS_TOTAL = "moe_held_max_tokens_total"
MOE_HELD_MAX_TOKENS_SCALED_TOTAL = "moe_held_max_tokens_scaled_total"

# -- the training loss (ops/cross_entropy.py) --------------------------------
#
# The rows (tokens) each call of the loss took, labelled ``route``: kernel
# (bf16 logits on the card, the hand-written kernels) or plain (the f32
# version: CPU tensors, f32 logits).

LOSS_ROWS_TOTAL = "loss_rows_total"

# ---------------------------------------------------------------------------
# Flight-recorder span/instant names (telemetry/trace.py).
#
# Same single-registration rule as the metrics above, with a colon-case
# convention (``layer:operation``) so a Perfetto timeline groups by
# layer. ``SPAN_``-prefixed constants name begin/end spans,
# ``INSTANT_``-prefixed ones point-in-time events.
# ``tools/check_span_names.py`` lints both halves: declared exactly once
# here, colon/snake-case values, no string literals at
# ``trace_annotation``/``span``/``instant`` call sites.
# ---------------------------------------------------------------------------

# snapshot.py operation envelopes
SPAN_TAKE = "snapshot:take"
SPAN_RESTORE = "snapshot:restore"
SPAN_ASYNC_TAKE_STAGE = "snapshot:async_take:stage"
SPAN_ASYNC_TAKE_COMMIT = "snapshot:async_take:commit"
SPAN_ASYNC_RESTORE_READS = "snapshot:async_restore:reads"

# manager.py: the public calls (each closes with one observation of
# MANAGER_CALL_SECONDS), the rank-0 commit with its GC nested inside, and
# the post-commit bookkeeping (both observed in MANAGER_PHASE_SECONDS)
SPAN_MANAGER_SAVE = "manager:save"
SPAN_MANAGER_ASYNC_SAVE = "manager:async_save"
SPAN_MANAGER_RESTORE = "manager:restore"
SPAN_MANAGER_COMMIT = "manager:commit"
SPAN_MANAGER_GC = "manager:gc"
SPAN_MANAGER_BOOKKEEPING = "manager:bookkeeping"

# snapshot.py plans and placement: a take's plan up to the manifest
# gather, a restore's plan up to its first read, each placement batch
# (observed in RESTORE_PHASE_SECONDS) and the hand-off to load_state_dict
SPAN_TAKE_PLAN = "take:plan"
SPAN_RESTORE_PLAN = "restore:plan"
SPAN_RESTORE_PLACE = "restore:place"
SPAN_RESTORE_APPLY = "restore:apply"

# scheduler.py pipeline stages
SPAN_PIPELINE_BUDGET_ACQUIRE = "pipeline:budget_acquire"
SPAN_PIPELINE_STAGE = "pipeline:stage"
SPAN_PIPELINE_WRITE_DRAIN = "pipeline:write_drain"
SPAN_PIPELINE_CONSUME = "pipeline:consume"

# io_preparer / sharded_io_preparer per-leaf executor kernels (the
# D2H+serialize and deserialize+copy inside the pipeline spans above)
SPAN_LEAF_STAGE = "stage:leaf"
SPAN_LEAF_CONSUME = "consume:leaf"
# Device-snapshot async takes: the pre-return capture pass (on-device
# clone dispatch + mutable-host-leaf copies) — the only staging-flavored
# work left inside async_take's training-visible span.
SPAN_DEVICE_CAPTURE = "stage:device_capture"

# storage plugins (fs/s3/gcs); the fs native fast path additionally
# stamps its executor-thread kernel I/O
SPAN_STORAGE_WRITE = "storage:write"
SPAN_STORAGE_READ = "storage:read"
SPAN_FS_NATIVE_WRITE = "storage:fs_native_write"
SPAN_FS_NATIVE_READ = "storage:fs_native_read"
# Zero-pack / direct write kernels: the vectorized pwritev+CRC gather
# write and the O_DIRECT aligned-body write.
SPAN_FS_NATIVE_PWRITEV = "storage:fs_native_pwritev"
SPAN_FS_NATIVE_DIRECT_WRITE = "storage:fs_native_direct_write"
INSTANT_STORAGE_RETRY = "storage:retry"
INSTANT_GCS_RECOVER = "storage:gcs_recover"

# models/lfm2.py: torch.profiler ranges (record_function) around the
# forward of each sublayer, so that a device trace reads by layer: the
# short-conv and attention mixers, the dense and the sparse feed-forward,
# and the head with the loss
SPAN_LFM2_CONV = "lfm2:conv"
SPAN_LFM2_ATTN = "lfm2:attn"
SPAN_LFM2_FFN = "lfm2:ffn"
SPAN_LFM2_MOE = "lfm2:moe"
SPAN_LFM2_LOSS = "lfm2:loss"

# batcher.py slab staging / spanning-read dispatch. The vectorized
# variant is a DISTINCT span: its presence (and stage_slab's absence)
# is the observable pin that the slab-pack pass did not run.
SPAN_BATCHER_STAGE_SLAB = "batcher:stage_slab"
SPAN_BATCHER_STAGE_SLAB_VECTORIZED = "batcher:stage_slab_vectorized"
SPAN_BATCHER_CONSUME_SPANNING = "batcher:consume_spanning"

# tiered mirror
SPAN_MIRROR_JOB = "mirror:job"
SPAN_MIRROR_BLOB = "mirror:blob"

# peer tier (tiered/peer.py): one push job / per-blob transfer, and a
# restore-side pull from a surviving peer's RAM
SPAN_PEER_JOB = "peer:job"
SPAN_PEER_PUSH = "peer:push"
SPAN_PEER_PULL = "peer:pull"

# dist_store.py barriers: one span per arrive/depart phase (args carry
# impl=tree|linear and the barrier prefix) — the coordination wall the
# scale-model harness attributes vs world size.
SPAN_BARRIER_ARRIVE = "barrier:arrive"
SPAN_BARRIER_DEPART = "barrier:depart"
# fanout.py: one owner-table exchange round (needs gather + window
# publication + peer consumption) under a restore round's nonce prefix.
SPAN_FANOUT_EXCHANGE = "fanout:exchange"

# cdn/ — the publish announce, one subscriber chunk-sync round (diff +
# owner fetch + peer pulls), and the staged-buffers-to-live hot swap.
SPAN_CDN_PUBLISH = "cdn:publish"
SPAN_CDN_SYNC = "cdn:sync"
SPAN_CDN_SWAP = "cdn:swap"

# telemetry/wire.py: the two sides of one framed RPC. The client span's
# args carry the propagated trace id + its own span id; the handler
# span's args carry the received trace id + parent span id (= the
# client's span id), so the trace merge CLI can stitch them into one
# causally-linked cross-process trace.
SPAN_WIRE_RPC = "wire:rpc"
SPAN_WIRE_HANDLER = "wire:handler"

# utils/rss_profiler.py: a new peak RSS delta was observed
INSTANT_RSS_PEAK = "rss:peak"

# telemetry/watchdog.py: an open span outlived the stall deadline
INSTANT_WATCHDOG_STALL = "watchdog:stall"

# ---------------------------------------------------------------------------
# Checkpoint-doctor verdict ids (telemetry/doctor.py).
#
# Same single-registration rule as the metrics and spans above, with a
# kebab-case convention (``what-is-wrong``) so verdict ids read like
# alert names. ``RULE_``-prefixed constants name diagnosis rules; the
# snaplint ``doctor-rule-ids`` rule lints both halves: declared exactly
# once here, kebab-case values, no string literals at
# ``doctor_rule``/``Verdict`` emit sites.
# ---------------------------------------------------------------------------

# The take's wall clock is the staging (D2H + serialize) phase: the
# device link, not storage, bounds the checkpoint.
RULE_D2H_BOUND = "d2h-bound"
# Requests spent a large fraction of the op blocked in
# MemoryBudget.acquire: the host-memory budget, not I/O, is the limit.
RULE_BUDGET_STARVED = "budget-starved"
# Cross-rank aggregation shows one rank far beyond the median for a
# phase: page that rank, not the storage team.
RULE_STRAGGLER_RANK = "straggler-rank"
# The write drain after staging dominates the take: the storage tier
# (or its link) is the bottleneck.
RULE_STORAGE_TIER_SLOW = "storage-tier-slow"
# The background mirror's durability lag / queue depth is growing
# faster than the take cadence drains it.
RULE_MIRROR_LAGGING = "mirror-lagging"
# One blob's write span dominates the op: a single stuck/slow write
# tail, not uniform slowness.
RULE_WRITE_TAIL_STALL = "write-tail-stall"
# A non-terminal progress heartbeat was left behind: an op died
# mid-flight (crash, preemption) without finishing.
RULE_INTERRUPTED_TAKE = "interrupted-take"
# The stall watchdog fired during this op (the trace carries the
# culprit span).
RULE_WATCHDOG_STALLED = "watchdog-stalled"
# Storage retries during the op exceeded the storm threshold.
RULE_RETRY_STORM = "retry-storm"
# An async take's training-visible span (async_take return-to-caller
# time) exceeded the visible-budget knob: staging leaked back into the
# caller's thread — the regression the device-snapshot path exists to
# prevent.
RULE_ASYNC_VISIBLE_STALL = "async-visible-stall"
# The write-path autotuner is oscillating: a tunable's decision log
# shows an A -> B -> A value cycle inside the trend window — the policy
# keeps applying and reverting the same move instead of converging
# (evidence cites the .tuner-state.json entries).
RULE_TUNER_THRASHING = "tuner-thrashing"
# A restore's storage reads exceeded what the manifest said it needed
# by the amplification threshold: whole-shard reads serving partial
# destinations, a dead fan-out (every rank fetching every shard), or
# re-reads — the report's bytes_fetched/bytes_needed fields carry the
# ratio.
RULE_RESTORE_READ_AMPLIFIED = "restore-read-amplified"
# Bench-trial rules (bench.py's former private heuristics): the take's
# achieved throughput fell below half of a *stable* bracketing probe
# pair — the slowdown happened inside the take.
RULE_IN_TAKE_STALL = "in-take-stall"
# Adjacent link probes disagreed beyond the stability factor: the
# link itself was moving; efficiency ratios are not trustworthy.
RULE_LINK_UNSTABLE = "link-unstable"
# Trend analysis: a step's metric sits beyond median + k*MAD of its
# rolling baseline.
RULE_TREND_REGRESSION = "trend-regression"
# Run-level goodput (ledger-driven): checkpointing ate more than the
# overhead-fraction threshold of this run's wall time (visible stalls +
# restores + lost work against the run ledger's measured span).
RULE_GOODPUT_DEGRADED = "goodput-degraded"
# An interruption's recovery cost (work lost since the last committed
# step plus the restore that followed) exceeded the recovery budget —
# the checkpoint interval, not the per-save latency, is what needs
# attention (evidence cites the ledger records).
RULE_RECOVERY_COST_HIGH = "recovery-cost-high"
# A restore that had an eligible peer-RAM copy was (partly) served from
# storage instead: peer transfers failed or fell through, so recovery
# paid storage latency the peer tier existed to avoid. Evidence cites
# the peer transfer failures and the per-tier byte split.
RULE_PEER_TIER_DEGRADED = "peer-tier-degraded"
# Coordination (store round-trips + barrier waits + the fan-out
# exchange), not data movement, ate a large fraction of the op's wall:
# the world size outgrew the coordination topology. Evidence cites the
# report's coordination split (barrier_wait_s / store_s / store_ops /
# exchange_s from the barrier:* spans' counters); the levers are the
# tree-barrier fanout, store shards, and batched store ops
# (docs/scaling.md).
RULE_COORDINATION_BOUND = "coordination-bound"
# The content-addressed store is on but recent committed steps reused
# ~none of their bytes even though the on-device digests say the state
# was mostly unchanged — the dedup path is broken in practice (chunks
# dir wiped/relocated, nondeterministic serialization, or an ineligible
# root silently running the legacy layout). Evidence cites the ledger's
# step-committed storage records.
RULE_DEDUP_INEFFECTIVE = "dedup-ineffective"
# Stored bytes failed digest verification: a restore rerouted reads
# around a corrupt tier copy (report ``degraded_reads``/``tier_split``
# evidence), or ``fsck --repair`` rewrote/quarantined damaged chunks
# (``repair-performed`` ledger events). The store healed — or could
# not — but the medium is rotting either way; audit the tier named by
# the evidence (docs/chaos.md).
RULE_STORAGE_CORRUPTION = "storage-corruption"
# The serving fleet is falling behind the publisher: the median
# publish-to-swap latency across the ledger's cdn-swapped records
# exceeds the knob'd staleness budget
# (TORCHSNAPSHOT_TPU_CDN_STALENESS_BUDGET_SECONDS). Cites the ledger's
# publish/swap events and the per-subscriber staleness spread.
RULE_CDN_STALENESS_HIGH = "cdn-staleness-high"
# Dial latencies are clustering at whole-second values — the kernel's
# SYN-retransmit quanta, i.e. a listen backlog overflowing under fan-in
# (the PR 15 peer-server bug class, now auto-detected from the fleet
# plane's recent-dial samples). The fix is the server's
# ``request_queue_size``, not the network.
RULE_WIRE_DIAL_STALLED = "wire-dial-stalled"
# One serving endpoint moved a disproportionate byte share of a fan-out
# round: owner election degenerated (or the fleet's chunk->owner hash
# is skewed), so a single peer's NIC is the round's critical path.
RULE_WIRE_HOT_ENDPOINT = "wire-hot-endpoint"
# One coordination-store shard absorbed a disproportionate request
# share: the crc32 key route degenerated for this key population, so
# sharding stopped spreading load (docs/scaling.md).
RULE_STORE_HOT_SHARD = "store-hot-shard"
# Critical-path analysis (telemetry/critpath.py): the dominant
# path segment of a step's critical-path attribution differs from the
# rolling window's modal dominant segment — the bottleneck MOVED (e.g.
# write drain gave way to coordination), which a magnitude-only trend
# check cannot see when the wall clock barely shifts.
RULE_CRITICAL_PATH_SHIFTED = "critical-path-shifted"
# A signal-of-record bench leg slowed beyond its declared tolerance
# (median + k*MAD over the preceding BENCH_r*.json records, with
# relative/absolute floors sized to the measured round-to-round link
# drift): the regression is in the code, not the noise. Emitted by the
# diff engine / ``tools/bench_diff.py``, never from a live op.
RULE_BENCH_REGRESSION = "bench-regression"
# A declared SLO objective is burning its error budget: the fast window
# caught a cliff or the slow window caught drift (telemetry/slo.py's
# multi-window burn-rate math over the ledger/history samples). Cites
# the per-window burn, bad-sample counts and any slo-breach ledger
# events already posted for the objective.
RULE_SLO_BURNING = "slo-burning"
# A restore's cold-start split (event-loop spin-up + plugin open +
# native-module load, recorded since PR 15) dominates the op wall
# beyond the knob'd fraction budget
# (TORCHSNAPSHOT_TPU_COLD_START_BUDGET_FRACTION): the r06 "first-trial
# restores 10-28 s vs sub-1 s warm" soft spot, ranked. Cites the
# ``{event_loop_s, plugin_open_s, native_load_s}`` breakdown.
RULE_RESTORE_COLD_START_SLOW = "restore-cold-start-slow"

# ---------------------------------------------------------------------------
# Run-ledger event ids (telemetry/ledger.py).
#
# Same single-registration rule as the families above, with the doctor
# rules' kebab-case convention. ``EVENT_``-prefixed constants name the
# typed records the manager, snapshot envelopes, tiered mirror,
# preemption saver, and GC post to ``<root>/.ledger.jsonl``; snaplint's
# ``ledger-event-ids`` rule lints both halves: declared exactly once
# here, kebab-case values, no literal event strings at
# ``post_event``/``post_event_for_snapshot`` call sites.
# ---------------------------------------------------------------------------

# A manager opened (or resumed) a run at a root: carries the stable
# run id and the 1-based segment number (one segment per process
# lifetime; a restart resumes the run id and increments the segment).
EVENT_RUN_START = "run-start"
# A step committed through the manager: the retention-visible moment,
# with the step's storage accounting (new vs. base-referenced bytes).
EVENT_STEP_COMMITTED = "step-committed"
# A take/async_take blocked training for its visible span (the whole
# wall for sync takes; return-to-caller for async ones).
EVENT_VISIBLE_STALL = "visible-stall"
# An async take's background D2H + serialize drain finished — overhead
# that OVERLAPPED training rather than stalling it.
EVENT_STAGED_DRAIN = "staged-drain"
# A tiered mirror job settled: how long the step's bytes existed only
# on the fast tier, and what replication moved.
EVENT_MIRROR_SETTLED = "mirror-settled"
# A restore/async_restore completed: recovery (or resume) time paid.
EVENT_RESTORE_SERVED = "restore-served"
# The preemption saver agreed a coordinated save target (or gave up):
# the interruption point the lost-work accounting anchors on.
EVENT_PREEMPTION = "preemption"
# Retention GC deleted a step's blobs; its step-committed storage
# records are pruned from the ledger in the same pass.
EVENT_GC_RECLAIMED = "gc-reclaimed"
# ``fsck --repair`` acted on a damaged blob/chunk: rewrote it from a
# tier whose copy verified, or quarantined it (no tier verified —
# ``chunks/.quarantine/``). The ``storage-corruption`` doctor rule
# cites these records; fields carry the location, action and tiers.
EVENT_REPAIR_PERFORMED = "repair-performed"
# The manager's post-commit CDN hook announced a step to a topic:
# carries the topic, sequence number, manifest digest and the announced
# chunk-set accounting (the publish half the ``cdn-staleness-high``
# rule correlates swaps against).
EVENT_CDN_PUBLISHED = "cdn-published"
# A subscriber hot-swapped an announced step into its serving buffers:
# carries the subscriber id, step, publish-to-swap staleness and the
# bytes-on-wire split (durable read vs. peer pull vs. already held).
EVENT_CDN_SWAPPED = "cdn-swapped"
# The rank-0 SLO evaluation saw an objective transition into breach
# (edge-triggered: one record per episode, not per evaluated step):
# carries the objective id, the target, both window burns and the
# offending last sample. The ``slo-burning`` doctor rule and the
# incident-bundle trigger both key off these records.
EVENT_SLO_BREACH = "slo-breach"

# ---------------------------------------------------------------------------
# Crash-point ids (chaos/crashpoints.py).
#
# Same single-registration rule as the families above, with the doctor
# rules' kebab-case convention. ``CRASH_``-prefixed constants name the
# kill points threaded through the take/commit/GC/mirror paths —
# ``crashpoint(names.CRASH_...)`` is a no-op in production and raises
# ``SimulatedCrash`` when the chaos engine armed that point, so the
# crash-matrix harness (chaos/harness.py) can kill an op at every
# declared point and assert the store's global invariants. snaplint's
# ``crashpoint-ids`` rule lints both halves: declared exactly once
# here, kebab-case values, no literal ids at ``crashpoint()`` sites.
# The harness enumerates this registry — adding a constant here IS
# adding the point to the matrix.
# ---------------------------------------------------------------------------

# Every rank's data writes drained durably (sync_complete returned);
# nothing control-plane exists yet.
CRASH_TAKE_WRITES_DONE = "take-writes-done"
# This rank's checksum table is durable (always before the barrier).
CRASH_CHECKSUM_TABLE_WRITTEN = "checksum-table-written"
# A CAS chunk's bytes just landed in ``chunks/`` — no map, no manifest,
# no pin references it yet (the stray-sweep + grace-window case).
CRASH_CAS_CHUNK_WRITTEN = "cas-chunk-written"
# This rank's ``cas/{rank}`` path->digest map committed.
CRASH_CAS_MAP_WRITTEN = "cas-map-written"
# Rank 0, inside the commit window: the manifest rewrite ran but the
# ``.snapshot_metadata`` marker does NOT exist yet (the step must read
# as never-happened).
CRASH_PRE_COMMIT_MARKER = "pre-commit-marker"
# The commit marker is durable; the manager index does not name the
# step yet (committed-but-unindexed).
CRASH_COMMIT_MARKER = "commit-marker"
# The tiered take handed its blob inventory to the background mirror.
CRASH_MIRROR_ENQUEUED = "mirror-enqueued"
# The post-commit peer-tier push hook ran (enqueue, not settle).
CRASH_PEER_ENQUEUED = "peer-enqueued"
# Rank 0 pinned the committing step's chunks in the refcount journal;
# the index write has not happened (pinned-but-uncommitted).
CRASH_REFCOUNT_PINNED = "refcount-pinned"
# The index backup slot is written, the primary is not (torn pair).
CRASH_INDEX_BACKUP_WRITTEN = "index-backup-written"
# Both index slots name the new step; retention deletes still pending.
CRASH_INDEX_WRITTEN = "index-written"
# Chunk GC unpinned the dropped steps; reclaim deletes still pending.
CRASH_GC_UNPINNED = "gc-unpinned"
# Step GC deleted a dropped step's commit marker; its data blobs (and
# telemetry leftovers) are still on disk.
CRASH_GC_MARKER_DELETED = "gc-marker-deleted"
# The CDN publisher wrote the announce record for a step but has NOT
# advanced the topic head yet (torn announce: subscribers must never
# observe the record).
CRASH_CDN_PUBLISH_ANNOUNCED = "cdn-publish-announced"
# A CDN subscriber finished staging an announced step's chunks into its
# shadow buffers; the hot swap has not happened (the live weights must
# still be the previous step's).
CRASH_CDN_SWAP_STAGED = "cdn-swap-staged"

# ---------------------------------------------------------------------------
# Wire RPC op ids (telemetry/wire.py; dist_store.py, tiered/peer.py).
#
# Same single-registration rule as the families above, kebab-case.
# ``RPC_``-prefixed constants name every operation that rides the shared
# socket framing (``send_frame``/``recv_frame``): the op id travels in
# the optional wire-context header, labels the per-RPC wire metrics,
# and keys the peer transport's request dispatch. snaplint's
# ``rpc-op-ids`` rule lints both halves: declared exactly once here,
# kebab-case values, no literal op strings at frame-send call sites
# (``PeerClient.request`` / ``wire.propagate``).
# ---------------------------------------------------------------------------

# Coordination-store commands (dist_store.py `_CMD_*` wire protocol).
RPC_STORE_SET = "store-set"
RPC_STORE_TRY_GET = "store-try-get"
RPC_STORE_ADD = "store-add"
RPC_STORE_DELETE = "store-delete"
RPC_STORE_MULTI_SET = "store-multi-set"
RPC_STORE_MULTI_GET = "store-multi-get"
RPC_STORE_MULTI_DELETE = "store-multi-delete"
RPC_STORE_SCAN = "store-scan"
# Peer-tier transport commands (tiered/peer.py request dispatch). The
# constants ARE the on-wire command strings: client and server both
# reference them, so the protocol and the observability namespace
# cannot drift apart.
RPC_PEER_PUSH = "peer-push"
RPC_PEER_COMMIT = "peer-commit"
RPC_PEER_PULL = "peer-pull"
RPC_PEER_REFCHUNKS = "peer-refchunks"
RPC_PEER_LIST = "peer-list"
RPC_PEER_EVICT = "peer-evict"
RPC_PEER_STATS = "peer-stats"
RPC_PEER_PING = "peer-ping"
# Composite client-side operations that open a propagation context
# spanning several frames (fanout.py's owner-table exchange, a CDN
# subscriber's chunk-sync round).
RPC_FANOUT_EXCHANGE = "fanout-exchange"
RPC_CDN_SYNC = "cdn-sync"
RPC_CDN_PUBLISH = "cdn-publish"

# ---------------------------------------------------------------------------
# SLO objective ids (telemetry/slo.py).
#
# Same single-registration rule as the families above, kebab-case
# ("what-is-promised"). ``SLO_``-prefixed constants name the declared
# service-level objectives the rank-0 per-step evaluation judges with
# multi-window burn-rate math; the id labels the ``slo_burn_rate``
# gauge, keys the per-objective target/disable knobs, and travels in
# ``slo-breach`` ledger events. snaplint's ``slo-ids`` rule lints both
# halves: declared exactly once here, kebab-case values, no literal ids
# at ``Objective(...)`` declaration sites.
# ---------------------------------------------------------------------------

# Visible training stall per take/async_take stays under the async
# visible budget (TORCHSNAPSHOT_TPU_ASYNC_VISIBLE_BUDGET_SECONDS).
SLO_TAKE_VISIBLE_STALL = "take-visible-stall"
# A restore/async_restore serves within the restore wall budget
# (TORCHSNAPSHOT_TPU_SLO_RESTORE_SECONDS).
SLO_RESTORE_WALL = "restore-wall"
# A step's bytes exist only on the fast tier no longer than the mirror
# durability-lag budget (TORCHSNAPSHOT_TPU_SLO_MIRROR_LAG_SECONDS).
SLO_MIRROR_LAG = "mirror-durability-lag"
# CDN publish-to-swap staleness per subscriber swap stays under the
# staleness budget (TORCHSNAPSHOT_TPU_CDN_STALENESS_BUDGET_SECONDS).
SLO_CDN_STALENESS = "cdn-staleness"
# Checkpoint overhead (visible stall + restore) per commit interval
# stays under the overhead fraction budget
# (TORCHSNAPSHOT_TPU_SLO_OVERHEAD_FRACTION).
SLO_GOODPUT_OVERHEAD = "goodput-overhead"
# Coordination's share of a take's wall stays under the coordination
# fraction budget (TORCHSNAPSHOT_TPU_SLO_COORDINATION_FRACTION).
SLO_COORDINATION_FRACTION = "coordination-fraction"
