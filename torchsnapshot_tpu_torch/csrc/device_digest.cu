// The mlh64 content digest of many device byte ranges in one launch.
//
// Replaces the jitted XLA program of torchsnapshot_tpu/ops/device_digest.py
// (`_digest_jax_impl`, :190, and `_digest_many_jit`, :237, the one dispatch
// per device group that incremental.py makes). For each segment (a tensor,
// or a dim-0 row range of one) it computes, bit for bit as `digest_host`
// does:
//
//     lanes  = the segment's bytes as little-endian uint32 (itemsize a
//              multiple of 4), uint16 (itemsize 2) or uint8 (1-byte types)
//     w(i)   = mix32(i * 0x9E3779B9 + seed), i the lane index as uint32
//     acc    = sum_i lane_i * w(i) mod 2^32, for seed 0x243F6A88 and 0xB7E15162
//     digest = mix32(acc ^ (nbytes mod 2^32)), per seed
//
// What bounds it: bytes. It reads each byte once and writes 8 bytes per
// segment, so the floor is bytes / 3.35 TB/s.
//
// The integer work per lane. The weights depend only on the lane index
// within a segment, never on the data, and every segment starts at lane 0.
// The first version of this kernel computed both weights anew for every
// lane of every segment: the index product, two seed adds, two mix32s (2
// multiplies, 3 shifts, 3 xors each), the lane's extraction and two
// multiply-adds, about 22 32-bit integer instructions per lane (11 per
// byte of bf16). The SMs cannot dispatch that many integer instructions in
// the byte floor's time, and they held the kernel near 62% of it. This design computes each weight
// once per window and shares it across every segment that reaches that
// window: per lane it does the extraction and two multiply-adds, plus ~19
// instructions per weight pair divided among the segments that share it
// (24 to 32 on a transformer's train state), about 4 per lane in all.
//
// Design: the wrapper sorts each lane width's segments longest first, so
// the segments that reach window j (bytes [j W, (j + 1) W), W = 32 KiB)
// are a prefix of their group. A window's prefix is cut into slices of at
// most 32 segments; one block digests one (window, slice) item. Its
// threads compute the weights of their lanes in a sub-window (4, 8 or 16
// KiB for 1-, 2- and 4-byte lanes: 16 lanes, 32 weight registers a thread)
// once, then walk the slice: 8 independent 16-byte loads in flight per
// thread, across segments, and two multiply-adds per lane. A warp sums a
// segment's lanes with `redux.sync` into its own shared slot; after the
// window the block adds each segment's two sums to its output row with two
// atomicAdds. Addition mod 2^32 is associative and commutative, so the
// bits are the same in any order and every run. Segments that are not
// 16-byte aligned (row ranges at odd offsets) or end inside a sub-window
// take a scalar path in the same loop, with the same weights: one lane-wide
// load per lane, masked at the segment's end. A second kernel applies the
// final mix, which gives a segment of zero bytes mix32(0 ^ 0). The output
// is (n, 2) uint32 in the wrapper's spec order.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kSeed1 = 0x243F6A88u;
constexpr uint32_t kSeed2 = 0xB7E15162u;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kWindowBytes = 32 * 1024;  // one item's span of each segment
constexpr int kSlice = 32;                   // most segments per item
constexpr int kLoads = 8;                    // 16-byte loads in flight per thread

// The wrapper's table: n_segs Segments (sorted by lane width, then longest
// first), then n_windows Windows. ops/device_digest.py's SEGMENT_DTYPE and
// WINDOW_DTYPE give the same layout.
struct Segment {
  int64_t addr;
  int64_t nbytes;
  int32_t row;  // the output row, in spec order
  int32_t lane_bytes;
};
struct Window {
  int32_t item_begin;  // the window's first item
  int32_t seg_begin;   // its group's first segment
  int32_t n_reach;     // the group's segments longer than index * kWindowBytes
  int32_t index;
};
static_assert(sizeof(Segment) == 24 && sizeof(Window) == 16, "table layout");

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Lane l of 16 bytes (l a compile-time constant after unrolling).
template <int LANE>
__device__ __forceinline__ uint32_t lane_of(const uint4& q, int l) {
  const uint32_t words[4] = {q.x, q.y, q.z, q.w};
  const uint32_t w = words[(l * LANE) / 4];
  if (LANE == 4) return w;
  if (LANE == 2) return (l & 1) ? w >> 16 : w & 0xFFFFu;
  return __byte_perm(w, 0, 0x4440 | (l & 3));
}

template <int LANE>
__device__ __forceinline__ uint32_t load_lane(const unsigned char* p) {
  if (LANE == 4) return *reinterpret_cast<const uint32_t*>(p);
  if (LANE == 2) return *reinterpret_cast<const uint16_t*>(p);
  return *p;
}

// One segment's sums over the sub-window into this warp's slot.
__device__ __forceinline__ void add_part(uint32_t* slot, uint32_t a1, uint32_t a2) {
  a1 = __reduce_add_sync(0xFFFFFFFFu, a1);
  a2 = __reduce_add_sync(0xFFFFFFFFu, a2);
  if ((threadIdx.x & 31) == 0) {
    slot[0] += a1;
    slot[1] += a2;
  }
}

// The n segments of `seg` (a slice, longest first) over bytes [window,
// window + kWindowBytes) of each, into part[slot][seed] of this warp.
template <int LANE>
__device__ __forceinline__ void digest_window(
    const Segment* seg, int n, int64_t window, uint32_t (*part)[2]) {
  constexpr int kPos = LANE;          // 16-byte positions a thread owns per sub-window
  constexpr int kLanes = 16 / LANE;   // lanes per position
  constexpr int kSub = kThreads * 16 * kPos;
  constexpr int kSegs = kLoads / kPos;  // segments whose loads are in flight together
  for (int64_t base = window; base < window + kWindowBytes; base += kSub) {
    if (seg[0].nbytes <= base) break;  // longest first: no segment reaches it
    // Position p of this thread: bytes [off(p), off(p) + 16) of every segment.
    uint32_t w1[kPos][kLanes], w2[kPos][kLanes];
#pragma unroll
    for (int p = 0; p < kPos; ++p) {
      const int64_t off = base + static_cast<int64_t>(threadIdx.x + p * kThreads) * 16;
      uint32_t b = static_cast<uint32_t>(off / LANE) * kGolden;
#pragma unroll
      for (int l = 0; l < kLanes; ++l, b += kGolden) {
        w1[p][l] = mix32(b + kSeed1);
        w2[p][l] = mix32(b + kSeed2);
      }
    }
    const int64_t end = base + kSub;
    int s = 0;
    while (s < n) {
      bool fast = s + kSegs <= n;
#pragma unroll
      for (int u = 0; u < kSegs; ++u) {
        fast = fast && seg[s + u].nbytes >= end && (seg[s + u].addr & 15) == 0;
      }
      if (fast) {  // kSegs segments that cover the sub-window, 16-byte aligned
        uint4 q[kSegs][kPos];
#pragma unroll
        for (int u = 0; u < kSegs; ++u) {
          const uint4* v = reinterpret_cast<const uint4*>(seg[s + u].addr + base) + threadIdx.x;
#pragma unroll
          for (int p = 0; p < kPos; ++p) q[u][p] = __ldg(v + p * kThreads);
        }
#pragma unroll
        for (int u = 0; u < kSegs; ++u) {
          uint32_t a1 = 0, a2 = 0;
#pragma unroll
          for (int p = 0; p < kPos; ++p) {
#pragma unroll
            for (int l = 0; l < kLanes; ++l) {
              const uint32_t x = lane_of<LANE>(q[u][p], l);
              a1 += x * w1[p][l];
              a2 += x * w2[p][l];
            }
          }
          add_part(part[s + u], a1, a2);
        }
        s += kSegs;
        continue;
      }
      // One segment: the scalar path where it is unaligned or ends here.
      const Segment g = seg[s];
      if (g.nbytes <= base) break;  // nor does any later one reach it
      const unsigned char* ptr = reinterpret_cast<const unsigned char*>(g.addr);
      const bool aligned = (g.addr & 15) == 0;
      uint32_t a1 = 0, a2 = 0;
#pragma unroll
      for (int p = 0; p < kPos; ++p) {
        const int64_t off = base + static_cast<int64_t>(threadIdx.x + p * kThreads) * 16;
        if (aligned && off + 16 <= g.nbytes) {
          const uint4 q = __ldg(reinterpret_cast<const uint4*>(ptr + off));
#pragma unroll
          for (int l = 0; l < kLanes; ++l) {
            const uint32_t x = lane_of<LANE>(q, l);
            a1 += x * w1[p][l];
            a2 += x * w2[p][l];
          }
        } else if (off < g.nbytes) {
#pragma unroll
          for (int l = 0; l < kLanes; ++l) {
            const int64_t at = off + l * LANE;
            const uint32_t x = at < g.nbytes ? load_lane<LANE>(ptr + at) : 0u;
            a1 += x * w1[p][l];
            a2 += x * w2[p][l];
          }
        }
      }
      add_part(part[s], a1, a2);
      ++s;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) digest_items(
    const Segment* __restrict__ segs, const Window* __restrict__ windows, int n_windows,
    uint32_t* __restrict__ acc) {
  __shared__ Segment slice[kSlice];
  __shared__ uint32_t part[kWarps][kSlice][2];
  // The item's window: the last one whose first item is at or before it.
  const int item = blockIdx.x;
  int lo = 0, hi = n_windows - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (windows[mid].item_begin <= item) lo = mid; else hi = mid - 1;
  }
  const Window w = windows[lo];
  // Its slice of the window's prefix: slices of equal length, +-1.
  const int n_items = (w.n_reach + kSlice - 1) / kSlice;
  const int i = item - w.item_begin;
  const int s0 = w.seg_begin + static_cast<int>(static_cast<int64_t>(i) * w.n_reach / n_items);
  const int s1 = w.seg_begin + static_cast<int>(static_cast<int64_t>(i + 1) * w.n_reach / n_items);
  const int n = s1 - s0;
  if (threadIdx.x < n) slice[threadIdx.x] = segs[s0 + threadIdx.x];
  for (int k = threadIdx.x; k < kWarps * kSlice * 2; k += kThreads) (&part[0][0][0])[k] = 0;
  __syncthreads();
  const int64_t window = static_cast<int64_t>(w.index) * kWindowBytes;
  uint32_t(*mine)[2] = part[threadIdx.x / 32];
  const int lane_bytes = slice[0].lane_bytes;  // one lane width per group
  if (lane_bytes == 4) {
    digest_window<4>(slice, n, window, mine);
  } else if (lane_bytes == 2) {
    digest_window<2>(slice, n, window, mine);
  } else {
    digest_window<1>(slice, n, window, mine);
  }
  __syncthreads();
  if (threadIdx.x < 2 * n) {
    const int s = threadIdx.x >> 1, k = threadIdx.x & 1;
    uint32_t sum = 0;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) sum += part[wp][s][k];
    atomicAdd(acc + 2 * slice[s].row + k, sum);
  }
}

__global__ void digest_finalize(const Segment* __restrict__ segs, int n_segs, uint32_t* __restrict__ acc) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_segs) return;
  const uint32_t nbytes = static_cast<uint32_t>(segs[r].nbytes);
  uint32_t* row = acc + 2 * segs[r].row;
  row[0] = mix32(row[0] ^ nbytes);
  row[1] = mix32(row[1] ^ nbytes);
}

}  // namespace

// table: host memory of table_bytes, n_segs Segments then n_windows
// Windows; table_dev: device scratch of table_bytes it is copied to; out:
// device (n_segs, 2) uint32. window_bytes and slice_segments are the
// wrapper's constants, checked against this file's. Zeroes `out`, copies
// the table, launches n_items blocks and the finalize kernel, all on
// `stream`; returns the CUDA error of these calls (0 on success).
extern "C" int ts_digest_many(
    const void* table, int64_t table_bytes, void* table_dev, int n_segs, int n_windows,
    int n_items, int64_t window_bytes, int slice_segments, void* out, void* stream) {
  if (n_segs < 0 || n_windows < 0 || n_items < 0 || window_bytes != kWindowBytes ||
      slice_segments != kSlice ||
      table_bytes != static_cast<int64_t>(n_segs) * static_cast<int64_t>(sizeof(Segment)) +
                         static_cast<int64_t>(n_windows) * static_cast<int64_t>(sizeof(Window))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_segs == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* acc = static_cast<uint32_t*>(out);
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(uint32_t) * 2 * static_cast<size_t>(n_segs), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Pageable host memory: the copy is staged before the call returns.
  err = cudaMemcpyAsync(table_dev, table, static_cast<size_t>(table_bytes), cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Segment* segs = static_cast<const Segment*>(table_dev);
  const Window* windows = reinterpret_cast<const Window*>(segs + n_segs);
  if (n_items > 0) {
    digest_items<<<n_items, kThreads, 0, st>>>(segs, windows, n_windows, acc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  digest_finalize<<<(n_segs + kThreads - 1) / kThreads, kThreads, 0, st>>>(segs, n_segs, acc);
  return static_cast<int>(cudaGetLastError());
}
