// The mlh64 content digest of many device byte ranges in one launch.
//
// Replaces the jitted XLA program of torchsnapshot_tpu/ops/device_digest.py
// (`_digest_jax_impl` and `_digest_many_jit`, the one dispatch per device
// group that incremental.py makes). For each segment (a tensor, or a dim-0
// row range of one) it computes, bit for bit as `digest_host` does:
//
//     lanes  = the segment's bytes as little-endian uint32 (itemsize a
//              multiple of 4), uint16 (itemsize 2) or uint8 (1-byte types)
//     w(i)   = mix32(i * 0x9E3779B9 + seed), i the lane index as uint32
//     acc    = sum_i lane_i * w(i) mod 2^32, for seed 0x243F6A88 and 0xB7E15162
//     digest = mix32(acc ^ (nbytes mod 2^32)), per seed
//
// What bounds it: it reads each byte once and writes 8 bytes per segment,
// so the floor is bytes / 3.35 TB/s. Per lane it also does two mix32s
// (2 multiplies, 3 shifts, 3 xors each) and two multiply-adds, about 20
// 32-bit integer operations: ~5 per byte for uint32 lanes, ~10 for uint16,
// ~20 for uint8. At Hopper's integer rate that is near the byte floor for
// the 2-byte types a bf16 train state holds, so the design keeps the
// integer work to that minimum and the loads wide.
//
// Design: the wrapper passes a table of segments (address, bytes, lane
// width, index of the segment's first tile). Segments are cut into tiles
// of `tile_bytes`; a grid of blocks, sized to fill the card, walks the
// tiles with a grid-stride loop and finds each tile's segment by binary
// search over the table. A block's threads read the tile with 16-byte
// loads where the address is 16-byte aligned (scalar loads for an
// unaligned head and the tail), keep two uint32 sums in registers, reduce
// them with warp shuffles and shared memory, and add them to the
// segment's output row with atomicAdd. Addition mod 2^32 is associative and
// commutative, so the atomics give the same bits in any order. A second
// kernel applies the final mix. The output is (n, 2) uint32.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kSeed1 = 0x243F6A88u;
constexpr uint32_t kSeed2 = 0xB7E15162u;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;

// One row of the wrapper's int64 table.
struct Segment {
  int64_t addr;
  int64_t nbytes;
  int64_t lane_bytes;
  int64_t tile_begin;
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ void add_lane(uint32_t v, uint32_t i, uint32_t& a1, uint32_t& a2) {
  const uint32_t b = i * kGolden;
  a1 += v * mix32(b + kSeed1);
  a2 += v * mix32(b + kSeed2);
}

template <int LANE>
__device__ __forceinline__ uint32_t load_lane(const unsigned char* p) {
  if (LANE == 4) return *reinterpret_cast<const uint32_t*>(p);
  if (LANE == 2) return *reinterpret_cast<const uint16_t*>(p);
  return *p;
}

// The lanes of 16 bytes whose first lane has index i0.
template <int LANE>
__device__ __forceinline__ void add_16_bytes(const uint4 q, uint32_t i0, uint32_t& a1, uint32_t& a2) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (LANE == 4) {
      add_lane(w[k], i0 + k, a1, a2);
    } else if (LANE == 2) {
      add_lane(w[k] & 0xFFFFu, i0 + 2 * k, a1, a2);
      add_lane(w[k] >> 16, i0 + 2 * k + 1, a1, a2);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) add_lane((w[k] >> (8 * j)) & 0xFFu, i0 + 4 * k + j, a1, a2);
    }
  }
}

// Bytes [b0, b1) of the segment at `seg` into this thread's sums. The
// segment's base is LANE-aligned (an element boundary), so the unaligned
// head before the first 16-byte boundary holds whole lanes.
template <int LANE>
__device__ __forceinline__ void digest_range(
    const unsigned char* seg, int64_t b0, int64_t b1, uint32_t& a1, uint32_t& a2) {
  const unsigned char* p = seg + b0;
  const int64_t n = b1 - b0;
  int64_t head = (16 - static_cast<int64_t>(reinterpret_cast<uintptr_t>(p) & 15)) & 15;
  if (head > n) head = n;
  for (int64_t off = threadIdx.x * LANE; off < head; off += kThreads * LANE) {
    add_lane(load_lane<LANE>(p + off), static_cast<uint32_t>((b0 + off) / LANE), a1, a2);
  }
  const int64_t nvec = (n - head) / 16;
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  const int64_t lane0 = (b0 + head) / LANE;  // lane index of v[0]'s first lane
  constexpr int kPer16 = 16 / LANE;
  int64_t k = threadIdx.x;
  // Four loads in flight per thread before their lanes are summed.
  for (; k + 3 * kThreads < nvec; k += 4 * kThreads) {
    const uint4 q0 = __ldg(v + k);
    const uint4 q1 = __ldg(v + k + kThreads);
    const uint4 q2 = __ldg(v + k + 2 * kThreads);
    const uint4 q3 = __ldg(v + k + 3 * kThreads);
    add_16_bytes<LANE>(q0, static_cast<uint32_t>(lane0 + k * kPer16), a1, a2);
    add_16_bytes<LANE>(q1, static_cast<uint32_t>(lane0 + (k + kThreads) * kPer16), a1, a2);
    add_16_bytes<LANE>(q2, static_cast<uint32_t>(lane0 + (k + 2 * kThreads) * kPer16), a1, a2);
    add_16_bytes<LANE>(q3, static_cast<uint32_t>(lane0 + (k + 3 * kThreads) * kPer16), a1, a2);
  }
  for (; k < nvec; k += kThreads) {
    add_16_bytes<LANE>(__ldg(v + k), static_cast<uint32_t>(lane0 + k * kPer16), a1, a2);
  }
  for (int64_t off = head + nvec * 16 + threadIdx.x * LANE; off < n; off += kThreads * LANE) {
    add_lane(load_lane<LANE>(p + off), static_cast<uint32_t>((b0 + off) / LANE), a1, a2);
  }
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, o);
  return x;
}

__global__ void __launch_bounds__(kThreads) digest_tiles(
    const Segment* __restrict__ segs, int n_segs, int64_t n_tiles, int64_t tile_bytes,
    uint32_t* __restrict__ acc) {
  __shared__ uint32_t part[2][kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    // The tile's segment: the last one whose first tile is at or before t
    // (a segment of no tiles shares its tile_begin with the next one).
    int lo = 0, hi = n_segs - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (segs[mid].tile_begin <= t) lo = mid; else hi = mid - 1;
    }
    const Segment s = segs[lo];
    const int64_t b0 = (t - s.tile_begin) * tile_bytes;
    const int64_t b1 = b0 + tile_bytes < s.nbytes ? b0 + tile_bytes : s.nbytes;
    const unsigned char* base = reinterpret_cast<const unsigned char*>(s.addr);
    uint32_t a1 = 0, a2 = 0;
    if (s.lane_bytes == 4) {
      digest_range<4>(base, b0, b1, a1, a2);
    } else if (s.lane_bytes == 2) {
      digest_range<2>(base, b0, b1, a1, a2);
    } else {
      digest_range<1>(base, b0, b1, a1, a2);
    }
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    if (lane == 0) {
      part[0][warp] = a1;
      part[1][warp] = a2;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t s1 = 0, s2 = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        s1 += part[0][w];
        s2 += part[1][w];
      }
      atomicAdd(acc + 2 * lo, s1);
      atomicAdd(acc + 2 * lo + 1, s2);
    }
    __syncthreads();  // `part` is rewritten by the next tile
  }
}

__global__ void digest_finalize(const Segment* __restrict__ segs, int n_segs, uint32_t* __restrict__ acc) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_segs) return;
  const uint32_t nbytes = static_cast<uint32_t>(segs[r].nbytes);
  acc[2 * r] = mix32(acc[2 * r] ^ nbytes);
  acc[2 * r + 1] = mix32(acc[2 * r + 1] ^ nbytes);
}

// Blocks that fill the card, found once per device.
int grid_limit() {
  static int limit[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 132;
  if (limit[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, digest_tiles, kThreads, 0);
    limit[dev] = (sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
  }
  return limit[dev];
}

}  // namespace

// segs: device pointer to n_segs rows of {addr, nbytes, lane_bytes,
// tile_begin} (int64); out: device (n_segs, 2) uint32. tile_bytes must be a
// positive multiple of 16. Runs on `stream`; returns the CUDA error of the
// launches (0 on success).
extern "C" int ts_digest_many(
    const void* segs, int n_segs, int64_t n_tiles, int64_t tile_bytes, void* out, void* stream) {
  if (n_segs <= 0) return 0;
  if (tile_bytes <= 0 || tile_bytes % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Segment* s = static_cast<const Segment*>(segs);
  uint32_t* acc = static_cast<uint32_t*>(out);
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(uint32_t) * 2 * static_cast<size_t>(n_segs), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_tiles > 0) {
    const int64_t limit = grid_limit();
    const int grid = static_cast<int>(n_tiles < limit ? n_tiles : limit);
    digest_tiles<<<grid, kThreads, 0, st>>>(s, n_segs, n_tiles, tile_bytes, acc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  digest_finalize<<<(n_segs + kThreads - 1) / kThreads, kThreads, 0, st>>>(s, n_segs, acc);
  return static_cast<int>(cudaGetLastError());
}
