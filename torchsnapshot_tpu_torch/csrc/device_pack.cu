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
//
// Design: the wrapper builds a table on the host: n + 1 slab offsets (the
// members' starts in order, then the slab's size) and n source addresses,
// and queues its copy to the card from pinned memory, so the host does not
// wait for the stream. The kernel runs a grid-stride loop over the slab in
// 16-byte units. A thread finds the member that holds its unit's first
// byte by a binary search over the offsets (the last member that starts at
// or before it: members of zero bytes are never chosen, since the next
// member starts at the same place). When the unit lies inside that member
// and the source address is 16-byte aligned, it moves the unit with one
// 16-byte load and one 16-byte store (the slab is at least 256-byte
// aligned and units start at multiples of 16). Otherwise -- a unit that
// straddles members, or a member whose bytes do not sit at a 16-byte
// aligned distance from its slab offset (odd sizes before it, row ranges
// at odd rows) -- it copies the unit's bytes one by one, stepping to the
// next member as each ends. The output is the members' bytes in order,
// bit for bit what `pack_plain` and the host serializer give.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 8192;

__device__ __forceinline__ int find_member(const int64_t* __restrict__ offsets, int n, int64_t pos) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (offsets[mid] <= pos) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__global__ void pack_units(const int64_t* __restrict__ offsets, const int64_t* __restrict__ srcs, int n,
                           int64_t total, uint8_t* __restrict__ out) {
  const int64_t units = (total + 15) / 16;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; u < units; u += stride) {
    const int64_t pos = u * 16;
    int m = find_member(offsets, n, pos);
    const int64_t begin = offsets[m];
    const uint8_t* src = reinterpret_cast<const uint8_t*>(srcs[m]) + (pos - begin);
    if (pos + 16 <= offsets[m + 1] && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      *reinterpret_cast<uint4*>(out + pos) = __ldg(reinterpret_cast<const uint4*>(src));
      continue;
    }
    const int64_t end = pos + 16 < total ? pos + 16 : total;
    for (int64_t p = pos; p < end; ++p) {
      while (p >= offsets[m + 1]) ++m;
      out[p] = reinterpret_cast<const uint8_t*>(srcs[m])[p - offsets[m]];
    }
  }
}

}  // namespace

// table_dev: device memory holding (2 n + 1) int64: n + 1 slab offsets
// (non-decreasing, offsets[0] = 0, offsets[n] = total), then n device
// source addresses, copied there on `stream` by the wrapper; out: device buffer of `total` bytes. Launches the kernel on `stream`;
// returns the CUDA error of the launch (0 on success).
extern "C" int ts_pack(const void* table_dev, int n, int64_t total, void* out, void* stream) {
  if (n < 0 || total < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || total == 0) return 0;
  const int64_t* offsets = static_cast<const int64_t*>(table_dev);
  const int64_t* srcs = offsets + n + 1;
  const int64_t units = (total + 15) / 16;
  const int64_t want = (units + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  pack_units<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(offsets, srcs, n, total,
                                                                       static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
