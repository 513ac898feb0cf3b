// The training loss: the integer-label cross-entropy of bf16 logits, forward
// and backward, computed in f32.
//
// For logits x (rows, V) and targets t (rows,), row r's loss is
//
//     loss[r] = lse[r] - x[r, t[r]],   lse[r] = log sum_j exp(x[r, j]),
//
// reduced over rows as a mean (divisor rows) or a sum (divisor 1), and the
// gradient of the reduced loss, given its incoming gradient g, is
//
//     dx[r, j] = (exp(x[r, j] - lse[r]) - [j == t[r]]) * g / divisor.
//
// No TPU kernel computed it: the JAX package leaves its loss to optax's
// softmax_cross_entropy_with_integer_labels under XLA. It exists because the
// plain version on this card (cast the logits to f32, log-softmax, NLL, and
// each one's backward) moves ~10 times the bytes the loss needs, over
// 50,304-65,536 logits a token.
//
// What bounds it: bytes. The forward reads the logits once (2 V bytes a row);
// the backward reads them once more and writes the bf16 gradient (4 V bytes a
// row); per element a handful of f32 operations and one exp2. What the design
// does about it:
//
// - One block a row (rows outnumber the SMs 60-120 times at the callers'
//   shapes); its threads walk the row in 16-byte loads of 8 bf16, four loads
//   issued before any is used, so that each SM keeps tens of KB in flight.
// - The forward keeps an online maximum and sum of exp2 per thread, in f32
//   and in the log2 domain (one FFMA and one MUFU.EX2 an element), merged by
//   warp shuffles and then across warps in shared memory. One thread reads
//   the target's logit and writes the row's lse and loss; the caller reduces
//   the rows' losses (torch's full sum, in a fixed order with no atomics, so
//   two runs give the same bits).
// - The backward reads the incoming gradient from device memory (no host
//   synchronisation), recomputes exp(x - lse) from the saved lse, and writes
//   the gradient rounded to bf16 once, in 16-byte stores. There is no f32
//   buffer of the logits' size.
// - A target outside [0, V) trips a device-side assert in the forward.

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;          // bf16 logits a 16-byte load
constexpr int kThreads = 256;    // threads a row's block
constexpr int kUnroll = 4;       // loads a thread issues before using them
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// (m, s): the running maximum of x log2(e) and the sum of 2^(x log2(e) - m).
// m starts at -FLT_MAX, not -inf, so that merging two empty states gives
// 2^0 * 0 and not 2^NaN.
struct Online {
  float m = -FLT_MAX;
  float s = 0.f;

  __device__ __forceinline__ void add8(const uint4& raw) {
    float x[kVec];
    unpack8(raw, x);
    float top = x[0];
#pragma unroll
    for (int i = 1; i < kVec; ++i) top = fmaxf(top, x[i]);
    const float top2 = top * kLog2e;
    if (top2 > m) {
      s *= ex2(m - top2);
      m = top2;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) s += ex2(fmaf(x[i], kLog2e, -m));
  }

  __device__ __forceinline__ void merge(float om, float os) {
    const float top = fmaxf(m, om);
    s = s * ex2(m - top) + os * ex2(om - top);
    m = top;
  }
};

__global__ void __launch_bounds__(kThreads) cross_entropy_fwd_kernel(
    const __nv_bfloat16* __restrict__ logits, const int64_t* __restrict__ targets, float* __restrict__ lse,
    float* __restrict__ row_loss, int64_t vocab) {
  const int64_t r = blockIdx.x;
  const __nv_bfloat16* row = logits + r * vocab;
  const uint4* vec = reinterpret_cast<const uint4*>(row);
  const int nvec = static_cast<int>(vocab / kVec);
  Online acc;
  int i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < nvec; i += kUnroll * kThreads) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = __ldg(vec + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc.add8(raw[u]);
  }
  for (; i < nvec; i += kThreads) acc.add8(__ldg(vec + i));

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, acc.m, off);
    const float os = __shfl_xor_sync(0xffffffffu, acc.s, off);
    acc.merge(om, os);
  }
  __shared__ float wm[kThreads / 32], ws[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    wm[warp] = acc.m;
    ws[warp] = acc.s;
  }
  __syncthreads();
  if (warp != 0) return;
  Online total;
  if (lane < kThreads / 32) {
    total.m = wm[lane];
    total.s = ws[lane];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, total.m, off);
    const float os = __shfl_xor_sync(0xffffffffu, total.s, off);
    total.merge(om, os);
  }
  if (lane == 0) {
    const int64_t t = targets[r];
    assert(t >= 0 && t < vocab);
    const float value = (total.m + log2f(total.s)) * kLn2;
    lse[r] = value;
    row_loss[r] = value - __bfloat162float(row[t]);
  }
}

__device__ __forceinline__ uint4 grad8(const uint4& raw, int target_lane, float l2, float g) {
  float x[kVec];
  unpack8(raw, x);
  uint4 out;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int k = 0; k < kVec; k += 2) {
    float p0 = ex2(fmaf(x[k], kLog2e, -l2));
    float p1 = ex2(fmaf(x[k + 1], kLog2e, -l2));
    if (k == target_lane) p0 -= 1.f;
    if (k + 1 == target_lane) p1 -= 1.f;
    h[k / 2] = __floats2bfloat162_rn(p0 * g, p1 * g);
  }
  return out;
}

__global__ void __launch_bounds__(kThreads) cross_entropy_bwd_kernel(
    const __nv_bfloat16* __restrict__ logits, const int64_t* __restrict__ targets, const float* __restrict__ lse,
    const float* __restrict__ grad, __nv_bfloat16* __restrict__ dlogits, int64_t vocab, int64_t divisor) {
  const int64_t r = blockIdx.x;
  const uint4* vec = reinterpret_cast<const uint4*>(logits + r * vocab);
  uint4* dvec = reinterpret_cast<uint4*>(dlogits + r * vocab);
  const int nvec = static_cast<int>(vocab / kVec);
  const float g = __ldg(grad) / static_cast<float>(divisor);
  const float l2 = __ldg(lse + r) * kLog2e;
  const int64_t t = targets[r];
  int i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < nvec; i += kUnroll * kThreads) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = __ldg(vec + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = int64_t{i + u * kThreads} * kVec;
      dvec[i + u * kThreads] = grad8(raw[u], static_cast<int>(t - j < kVec && t >= j ? t - j : -1), l2, g);
    }
  }
  for (; i < nvec; i += kThreads) {
    const int64_t j = int64_t{i} * kVec;
    dvec[i] = grad8(__ldg(vec + i), static_cast<int>(t - j < kVec && t >= j ? t - j : -1), l2, g);
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

int check(const void* logits, int64_t rows, int64_t vocab, int64_t divisor) {
  if (rows <= 0 || rows > 0x7fffffff || vocab <= 0 || vocab % kVec || vocab / kVec > 0x7fffffff - kUnroll * kThreads ||
      divisor <= 0 || !aligned16(logits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// lse (rows,) and row_loss (rows,) from bf16 logits (rows, vocab), contiguous
// with a 16-byte aligned base, vocab a multiple of 8, and int64 targets
// (rows,). Returns 0 or the CUDA error of the launch.
extern "C" int ts_cross_entropy_fwd(const void* logits, const void* targets, void* lse, void* row_loss, int64_t rows,
                                    int64_t vocab, int device, void* stream) {
  int err = check(logits, rows, vocab, 1);
  if (err) return err;
  // Autograd may call from a thread of its own: make the device current.
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cross_entropy_fwd_kernel<<<static_cast<unsigned>(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(logits), static_cast<const int64_t*>(targets), static_cast<float*>(lse),
      static_cast<float*>(row_loss), vocab);
  return static_cast<int>(cudaGetLastError());
}

// dlogits (rows, vocab) bf16 from the logits, targets and lse of the forward
// and grad, the incoming gradient of its reduced loss (one f32 on the card).
extern "C" int ts_cross_entropy_bwd(const void* logits, const void* targets, const void* lse, const void* grad,
                                    void* dlogits, int64_t rows, int64_t vocab, int64_t divisor, int device,
                                    void* stream) {
  int err = check(logits, rows, vocab, divisor);
  if (err) return err;
  if (!aligned16(dlogits)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cross_entropy_bwd_kernel<<<static_cast<unsigned>(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(logits), static_cast<const int64_t*>(targets),
      static_cast<const float*>(lse), static_cast<const float*>(grad), static_cast<__nv_bfloat16*>(dlogits), vocab,
      divisor);
  return static_cast<int>(cudaGetLastError());
}
