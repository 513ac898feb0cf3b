// Pack many device byte ranges into one contiguous slab in one launch.
//
// Replaces the jitted XLA program of torchsnapshot_tpu/ops/device_pack.py
// (`_pack_jit`, :52, which bitcasts each member to its uint8 memory image
// and concatenates): the batcher's device members of one slab, each a
// tensor or a dim-0 row range of one, leave the card in one device-to-host
// copy of the packed slab instead of one copy per member.
//
// What bounds it: bytes. It reads each member byte once and writes it once,
// so the floor is 2 x slab bytes / 3.35 TB/s; no arithmetic to speak of.
// What the design does about it:
//
// - No search per unit. The slab is cut into fixed tiles of kTileBytes
//   (16 KiB: 2,500 tiles at 41 MB, 8,100 at 133 MB). The wrapper's table
//   gives, per tile, the member that holds its first byte (computed once on
//   the host). A block takes a tile and reads each of the tile's members'
//   offsets and addresses once, into shared memory. Each member that starts
//   inside the tile marks the first 16-byte unit whose first byte it holds;
//   a block-wide prefix maximum over the marks then gives every unit its
//   owner. Members of zero bytes own no unit: the next member starts at the
//   same place and is marked instead.
// - Bulk asynchronous copies for aligned spans. A tile is put together in
//   shared memory and leaves in one cp.async.bulk to the slab. The units of
//   a member whose source sits at a 16-byte-aligned distance from its slab
//   offset come in by cp.async.bulk too, one per member span of the tile,
//   issued by the first warp as soon as the records are in and completing
//   on one mbarrier while the block works out the owners. chip_pack_probe.py
//   times this kernel against one that moves every unit with 16-byte vector
//   loads and stores straight to the slab and one that only bulk-copies, on
//   the same table: kernels alone 0.0913 / 0.1043 / 0.0922 ms at the train
//   state's 133 MB slab, 0.0305 / 0.0374 / 0.0301 ms at 10,000 members of
//   4 KiB (NVIDIA H100 80GB HBM3, 700 W). Bulk copies beat vector loads on
//   the aligned spans by 11-24% across the probe's runs.
// - A path wider than a byte for the rest. A unit inside a member whose
//   source sits k bytes past that alignment (odd sizes before it, row
//   ranges at odd rows) loads the two aligned 16-byte source words that
//   hold its bytes and shifts them into place with __funnelshift_r per
//   32-bit word. An aligned word that holds none of the member's bytes is
//   never loaded. A unit that straddles two members takes the tail of one
//   and the head of the other the same way, from the words that hold
//   them. Only a unit over three or more members (some shorter than a
//   unit) gathers its bytes one at a time. 0.0425 against the vector
//   kernel's 0.0532 ms at 10,000 members of 4,093 bytes.
// - Tiles in flight. A block's chain of round trips (its records, its
//   loads, its store) is hidden by the other blocks of its SM: at most 40
//   registers a thread keep six blocks resident, 96 KiB of tiles an SM,
//   each thread with two units' loads in flight at a time.
// - The host's cost per call. ts_pack queues the table's copy on a side
//   stream, the pack stream's wait for it, the kernel and the events that
//   free the wrapper's pinned table slot, in one call. chip_pack_probe.py
//   queued the same work from Python with torch.cuda.Stream and Event:
//   104.1 / 109.4 against 56.9 / 69.7 us a call at the train state's slab
//   (NVIDIA H100 80GB HBM3, 700 W), so the queueing stays here.
//
// The output is the members' bytes in order, bit for bit what `pack_plain`
// and the host serializer give.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnitsPerThread = 4;
constexpr int kTileUnits = kThreads * kUnitsPerThread;
constexpr int64_t kTileBytes = int64_t{kTileUnits} * 16;
// Member records a block keeps in shared memory; a tile of members shorter
// than 64 bytes on average reads the rest from the (cached) table.
constexpr int kCached = 256;
// Blocks resident on an SM (at most 40 registers a thread): the tiles in
// flight are what hides a block's chain of round trips to memory (its
// records, its loads, its store), so more of them move more bytes.
constexpr int kMinBlocks = 6;
// A thread's units whose loads are in flight together.
constexpr int kInFlight = 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

struct Tile {
  const int64_t* offsets;  // the table's slab offsets, from the tile's first member
  const int64_t* srcs;     // the table's source addresses, same
  int count;               // members with a record cached in shared memory
  const int64_t* begin;    // shared: count + 1 slab offsets
  const int64_t* src;      // shared: count source addresses

  __device__ __forceinline__ int64_t begin_of(int j) const { return j <= count ? begin[j] : offsets[j]; }
  __device__ __forceinline__ const uint8_t* src_of(int j) const {
    return reinterpret_cast<const uint8_t*>(j < count ? src[j] : srcs[j]);
  }
};

// Bytes k .. k + 15 of the 32 bytes lo:hi (little-endian), 0 <= k < 16.
__device__ __forceinline__ uint4 shift_bytes(const uint4& lo, const uint4& hi, int k) {
  const uint32_t x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int ws = k >> 2;
  const int sh = (k & 3) * 8;
  uint32_t y[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    y[i] = (ws & 2) ? ((ws & 1) ? x[i + 3] : x[i + 2]) : ((ws & 1) ? x[i + 1] : x[i]);
  }
  return make_uint4(__funnelshift_r(y[0], y[1], sh), __funnelshift_r(y[1], y[2], sh),
                    __funnelshift_r(y[2], y[3], sh), __funnelshift_r(y[3], y[4], sh));
}

// The first c bytes of v, the rest zero (0 <= c <= 16).
__device__ __forceinline__ uint4 first_bytes(const uint4& v, int c) {
  const auto keep = [c](uint32_t w, int at) {
    const int n = c - at;
    return n >= 4 ? w : (n <= 0 ? 0u : w & ((1u << (8 * n)) - 1u));
  };
  return make_uint4(keep(v.x, 0), keep(v.y, 4), keep(v.z, 8), keep(v.w, 12));
}

// Bytes [a, a + c) of device memory in the low bytes of a 16-byte value
// (the rest unspecified), 1 <= c <= 16: the one or two aligned 16-byte
// words that hold them, shifted into place.
__device__ __forceinline__ uint4 load_bytes(uintptr_t a, int c) {
  const int k = static_cast<int>(a & 15);
  const uint4* word = reinterpret_cast<const uint4*>(a - k);
  const uint4 lo = __ldg(word);
  const uint4 hi = k + c > 16 ? __ldg(word + 1) : make_uint4(0u, 0u, 0u, 0u);
  return shift_bytes(lo, hi, k);
}

// The unit at slab position pos, which starts inside member j (local) and
// runs past its end. Where it holds bytes of j and of the next member
// alone (the tail of one, the head of the other), each part comes from
// the aligned words that hold it; a unit over more members (some shorter
// than a unit, or of zero bytes) gathers its bytes one by one.
__device__ __forceinline__ uint4 straddle(const Tile& tile, int j, int64_t pos, int64_t total) {
  const int64_t end = pos + 16 < total ? pos + 16 : total;
  int64_t b = tile.begin_of(j);
  int64_t e = tile.begin_of(j + 1);
  const int na = static_cast<int>((e < end ? e : end) - pos);
  const int nb = static_cast<int>(end - pos) - na;
  if (nb == 0 || tile.begin_of(j + 2) >= end) {
    const uint4 va = first_bytes(load_bytes(reinterpret_cast<uintptr_t>(tile.src_of(j)) + (pos - b), na), na);
    if (nb == 0) return va;
    const uint4 vb = first_bytes(load_bytes(reinterpret_cast<uintptr_t>(tile.src_of(j + 1)), nb), nb);
    const uint4 placed = shift_bytes(make_uint4(0u, 0u, 0u, 0u), vb, 16 - na);
    return make_uint4(va.x | placed.x, va.y | placed.y, va.z | placed.z, va.w | placed.w);
  }
  uint64_t w0 = 0;
  uint64_t w1 = 0;
  const uint8_t* s = tile.src_of(j);
#pragma unroll 1
  for (int q = 0; q < 16 && pos + q < total; ++q) {
    const int64_t p = pos + q;
    while (p >= e) {
      ++j;
      b = e;
      e = tile.begin_of(j + 1);
      s = tile.src_of(j);
    }
    const uint64_t byte = s[p - b];
    if (q < 8) {
      w0 |= byte << (8 * q);
    } else {
      w1 |= byte << (8 * (q - 8));
    }
  }
  return make_uint4(static_cast<uint32_t>(w0), static_cast<uint32_t>(w0 >> 32), static_cast<uint32_t>(w1),
                    static_cast<uint32_t>(w1 >> 32));
}

// Member j's span of whole 16-byte units in [t0, t1) that a bulk copy
// brings, [lo, hi): empty unless its source sits at a 16-byte-aligned
// distance from its slab offset.
__device__ __forceinline__ bool bulk_span(const Tile& tile, int j, int64_t t0, int64_t t1, int64_t& lo,
                                          int64_t& hi) {
  const int64_t b = tile.begin_of(j);
  lo = max((b + 15) & ~int64_t{15}, t0);
  hi = min(tile.begin_of(j + 1) & ~int64_t{15}, t1);
  return hi > lo && ((reinterpret_cast<uintptr_t>(tile.src_of(j)) - static_cast<uintptr_t>(b)) & 15) == 0;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) pack_tiles(const int64_t* __restrict__ offsets,
                                                       const int64_t* __restrict__ srcs,
                                                       const int64_t* __restrict__ tile_first, int n,
                                                       int64_t total, uint8_t* __restrict__ out) {
  __shared__ __align__(128) uint8_t stage[kTileBytes];
  __shared__ __align__(16) int own[kTileUnits];
  __shared__ int64_t begin[kCached + 1];
  __shared__ int64_t src[kCached];
  __shared__ int warp_max[kThreads / 32];
  __shared__ __align__(8) uint64_t bar;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTileBytes;
  const int64_t t1 = t0 + kTileBytes < total ? t0 + kTileBytes : total;
  const uint32_t bar_addr = smem_u32(&bar);
  const int first = static_cast<int>(tile_first[blockIdx.x]);
  // The member that holds the next tile's first byte ends this tile's range
  // (it may start exactly there and hold none of this tile).
  const int last = blockIdx.x + 1 < gridDim.x ? static_cast<int>(tile_first[blockIdx.x + 1]) : n - 1;
  const int k = last - first + 1;

  Tile tile;
  tile.offsets = offsets + first;
  tile.srcs = srcs + first;
  tile.count = k < kCached ? k : kCached;
  tile.begin = begin;
  tile.src = src;
  for (int j = tid; j <= tile.count; j += kThreads) {
    begin[j] = tile.offsets[j];
    if (j < tile.count) src[j] = tile.srcs[j];
  }
#pragma unroll
  for (int i = 0; i < kUnitsPerThread; ++i) own[i * kThreads + tid] = 0;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_addr) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The first warp: one bulk copy per aligned member's span of the tile,
  // all completing on the mbarrier, whose one arrival carries their bytes.
  if (warp == 0) {
    uint32_t bytes = 0;
    int64_t lo;
    int64_t hi;
    for (int j = lane; j < k; j += 32) {
      if (bulk_span(tile, j, t0, t1, lo, hi)) bytes += static_cast<uint32_t>(hi - lo);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) bytes += __shfl_xor_sync(0xffffffffu, bytes, d);
    if (lane == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar_addr), "r"(bytes)
                   : "memory");
    }
    __syncwarp();
    for (int j = lane; j < k; j += 32) {
      if (bulk_span(tile, j, t0, t1, lo, hi)) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                smem_u32(stage + (lo - t0))),
            "l"(reinterpret_cast<uint64_t>(tile.src_of(j) + (lo - tile.begin_of(j)))),
            "r"(static_cast<uint32_t>(hi - lo)), "r"(bar_addr)
            : "memory");
      }
    }
  }

  // Mark: member j starts inside the tile and holds the first byte of unit
  // ceil((begin - t0) / 16); of several members that reach the same unit's
  // first byte that way, the last one holds it.
  for (int j = 1 + tid; j < k; j += kThreads) {
    const int64_t u = (tile.begin_of(j) - t0 + 15) >> 4;
    if (u < kTileUnits && (j + 1 == k || ((tile.begin_of(j + 1) - t0 + 15) >> 4) != u)) {
      own[u] = j;
    }
  }
  __syncthreads();

  // Prefix maximum over the marks: each thread scans four consecutive
  // units, the warps' totals carry across.
  {
    int4 v = reinterpret_cast<int4*>(own)[tid];
    v.y = max(v.x, v.y);
    v.z = max(v.y, v.z);
    v.w = max(v.z, v.w);
    int incl = v.w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl = max(incl, o);
    }
    if (lane == 31) warp_max[warp] = incl;
    int carry = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) carry = 0;
    __syncthreads();
    for (int w = 0; w < warp; ++w) carry = max(carry, warp_max[w]);
    v.x = max(v.x, carry);
    v.y = max(v.y, carry);
    v.z = max(v.z, carry);
    v.w = max(v.w, carry);
    reinterpret_cast<int4*>(own)[tid] = v;
  }
  __syncthreads();

  // The units the bulk copies leave, kInFlight of a thread's units at a
  // time: issue each one's loads, then shift or gather, and store into
  // the tile.
#pragma unroll
  for (int r = 0; r < kUnitsPerThread; r += kInFlight) {
    uint4 lo[kInFlight];
    uint4 hi[kInFlight];
    int shift[kInFlight];  // 1..15: inside one member; -1: straddles; 0: none here
    int owner[kInFlight];
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      const int u = (r + i) * kThreads + tid;
      const int64_t pos = t0 + 16 * int64_t{u};
      shift[i] = 0;
      if (pos >= t1) continue;
      const int j = own[u];
      owner[i] = j;
      const int64_t b = tile.begin_of(j);
      if (pos + 16 > tile.begin_of(j + 1)) {
        shift[i] = -1;
        continue;
      }
      const uintptr_t a = reinterpret_cast<uintptr_t>(tile.src_of(j)) + static_cast<uintptr_t>(pos - b);
      shift[i] = static_cast<int>(a & 15);  // 0: an aligned member's unit, which a bulk copy brings
      if (shift[i] == 0) continue;
      const uint4* word = reinterpret_cast<const uint4*>(a & ~uintptr_t{15});
      lo[i] = __ldg(word);
      hi[i] = __ldg(word + 1);
    }
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      if (shift[i] == 0) continue;
      const int u = (r + i) * kThreads + tid;
      reinterpret_cast<uint4*>(stage)[u] = shift[i] < 0 ? straddle(tile, owner[i], t0 + 16 * int64_t{u}, total)
                                                        : shift_bytes(lo[i], hi[i], shift[i]);
    }
  }

  // The tile leaves in one bulk copy once the bulk loads have landed and
  // every thread's stores are visible to the copy engine.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n"
          ".reg .pred P1;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
          "selp.b32 %0, 1, 0, P1;\n"
          "}\n"
          : "=r"(done)
          : "r"(bar_addr), "r"(0u)
          : "memory");
    }
    const uint32_t bytes = static_cast<uint32_t>((t1 - t0 + 15) & ~int64_t{15});
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
                     reinterpret_cast<uint64_t>(out + t0)),
                 "r"(smem_u32(stage)), "r"(bytes)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

}  // namespace

// host_table: pinned host memory holding (2 n + 1 + tiles) int64, tiles =
// ceil(total / tile_bytes): n + 1 slab offsets (non-decreasing, offsets[0]
// = 0, offsets[n] = total), n device source addresses, then per tile the
// member that holds its first byte (the last member that starts at or
// before it). It is copied to table_dev (device memory of the same size)
// on copy_stream, which then records `copied`; `stream` waits for that,
// launches the kernel and records `used` (both events of
// ts_pack_event_create). tile_bytes: the tile the table was cut by, which
// must be kTileBytes. out: device buffer of total bytes rounded up to a
// multiple of 16, 16-byte aligned. Returns the CUDA error of the first
// call that fails (0 on success).
extern "C" int ts_pack(const void* host_table, void* table_dev, int n, int64_t total, int64_t tile_bytes,
                       void* out, void* stream, void* copy_stream, void* copied, void* used) {
  if (n < 0 || total < 0 || tile_bytes != kTileBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || total == 0) return 0;
  const int64_t tiles = (total + kTileBytes - 1) / kTileBytes;
  if (tiles > 0x7fffffff || (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaStream_t cs = static_cast<cudaStream_t>(copy_stream);
  const size_t table_bytes = sizeof(int64_t) * static_cast<size_t>(2 * int64_t{n} + 1 + tiles);
  cudaError_t err = cudaMemcpyAsync(table_dev, host_table, table_bytes, cudaMemcpyHostToDevice, cs);
  if (err == cudaSuccess) err = cudaEventRecord(static_cast<cudaEvent_t>(copied), cs);
  if (err == cudaSuccess) err = cudaStreamWaitEvent(s, static_cast<cudaEvent_t>(copied), 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t* offsets = static_cast<const int64_t*>(table_dev);
  const int64_t* srcs = offsets + n + 1;
  const int64_t* tile_first = srcs + n;
  pack_tiles<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(offsets, srcs, tile_first, n, total,
                                                               static_cast<uint8_t*>(out));
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaEventRecord(static_cast<cudaEvent_t>(used), s);
  return static_cast<int>(err);
}

// An event without timing for ts_pack's `copied` or `used`, on the
// current device; null on failure.
extern "C" void* ts_pack_event_create() {
  cudaEvent_t event = nullptr;
  return cudaEventCreateWithFlags(&event, cudaEventDisableTiming) == cudaSuccess ? event : nullptr;
}

// 1 once the work `event` last recorded has run (or it was never
// recorded), 0 while it has not, the negated CUDA error otherwise.
extern "C" int ts_pack_event_done(void* event) {
  const cudaError_t err = cudaEventQuery(static_cast<cudaEvent_t>(event));
  if (err == cudaSuccess) return 1;
  if (err == cudaErrorNotReady) return 0;
  return -static_cast<int>(err);
}
