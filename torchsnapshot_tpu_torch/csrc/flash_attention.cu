// Flash attention forward for Hopper (sm_90a): one templated kernel, two
// entry points.
//
// Replaces the two Pallas kernels of torchsnapshot_tpu/ops/flash_attention.py:
//   - flash_fwd   <- _flash_kernel, reached through _flash_causal_forward
//                    (pallas_call at :395): causal softmax(q k^T / sqrt(d)) v,
//                    normalized, stored in the input dtype.
//   - flash_chunk <- _flash_chunk_kernel, reached through flash_attention_chunk
//                    (pallas_call at :223): causal or unmasked, stores the
//                    UNNORMALIZED f32 accumulator plus the row max m and the
//                    normalizer l.
// Both run the Pallas body's tile update (_online_softmax_update, :56-102):
// q scaled before the dot, f32 logits, masked logits = -1e30, tiles past the
// causal frontier skipped, exp(logits - m_new) and the alpha rescale.
//
// Bound on the H100 (published SXM peaks: 3.35 TB/s, 67 TFLOP/s f32 outside
// the tensor cores, 989 TFLOP/s bf16 in them):
//   operations ~ 2*b*h*s_q*s_k*d for a causal call (half of the 4*b*h*s^2*d
//   of QK^T and PV), twice that unmasked;
//   bytes ~ 4*b*s*h*d*itemsize for the fused kernel (q, k, v read, o written),
//   3*b*s*h*d*itemsize + 4*b*h*s*(d+2) for the chunk kernel (f32 o, m, l).
//   At the training shape (8, 1024, 16, 64) bf16 that is 17.2 GFLOP against
//   67 MB: 256 FLOP per byte, just under the card's bf16 balance point (~295),
//   so the least time is the bytes' 0.020 ms with the tensor-core operations
//   close behind at 0.017 ms. This kernel does its products as f32 FMAs
//   (67 TFLOP/s peak: 0.26 ms), so as written the operations bound it.
//
// What the design does about it: the TPU grid's sequential k axis becomes a
// loop inside the block, so the running max / normalizer / accumulator stay
// in registers for the whole row tile and only q, k, v are read and o (m, l)
// written once - the s^2 logits never reach device memory. One block of 256
// threads owns one (batch*head, 64-row q tile); K and V tiles of 64 rows are
// staged through shared memory as f32, and each thread computes a 4x4 logit
// micro-tile and a 4 x (d/16) slice of the accumulator with plain f32 FMAs.
// The arithmetic is f32 for bf16 inputs too, as in the Pallas body. Tensor
// cores (wgmma, with TMA loads) would lift the operation bound by an order of
// magnitude for bf16; that is later work, and f32 inputs would then need a
// separate path to keep f32 accuracy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // 16 x 16: ty picks 4 rows, tx 4 key columns
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {
  int64_t b, s, h;  // in elements; the head dim is contiguous
};

template <int D>
constexpr size_t smem_bytes() {
  // Q and K rows padded by one float so the 16 column threads of a warp hit
  // 16 different banks; V is read along d, which is already conflict-free.
  return sizeof(float) *
         (kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D + kBlockQ * (kBlockK + 1));
}

// FUSED: normalize and store o in T at (b, s, h, d).
// !FUSED: store the f32 accumulator at (b, h, s, d) and m, l at (b, h, s).
template <typename T, int D, bool CAUSAL, bool FUSED>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, Strides qs, Strides kvs,
                       int h, int s_q, int s_k, float scale,
                       T* __restrict__ o, float* __restrict__ o_acc,
                       float* __restrict__ m_out, float* __restrict__ l_out) {
  constexpr int DC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                          // [kBlockQ][D + 1]
  float* Ks = Qs + kBlockQ * (D + 1);        // [kBlockK][D + 1]
  float* Vs = Ks + kBlockK * (D + 1);        // [kBlockK][D]
  float* Ps = Vs + kBlockK * D;              // [kBlockQ][kBlockK + 1]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int bi = bh / h;
  const int hi = bh - bi * h;
  const int q0 = blockIdx.y * kBlockQ;

  const T* qb = q + bi * qs.b + hi * qs.h;
  const T* kb = k + bi * kvs.b + hi * kvs.h;
  const T* vb = v + bi * kvs.b + hi * kvs.h;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, c = idx - (idx / D) * D;
    Qs[r * (D + 1) + c] = to_float(qb[(int64_t)(q0 + r) * qs.s + c]) * scale;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = s_k / kBlockK;
  if (CAUSAL) {
    // Tiles whose first key lies past the tile's last query contribute
    // nothing (the Pallas kernels' pl.when(ki*block_k <= qi*block_q +
    // block_q - 1)).
    const int last = (q0 + kBlockQ - 1) / kBlockK + 1;
    n_tiles = last < n_tiles ? last : n_tiles;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // previous tile's Ks/Vs/Ps reads are done
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int r = idx / D, c = idx - (idx / D) * D;
      const int64_t off = (int64_t)(k0 + r) * kvs.s + c;
      Ks[r * (D + 1) + c] = to_float(kb[off]);
      Vs[r * D + c] = to_float(vb[off]);
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * (D + 1) + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      float row_max = kNegBig;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (CAUSAL && q0 + row < k0 + tx + 16 * j) sc[i][j] = kNegBig;
        row_max = fmaxf(row_max, sc[i][j]);
      }
      // The 16 threads of one row group are 16 consecutive lanes.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        row_sum += p;
        Ps[row * (kBlockK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] = l[i] * alpha + row_sum;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (kBlockK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (FUSED) {
      T* orow = o + (((int64_t)bi * s_q + row) * h + hi) * D;
      const float inv = 1.f / l[i];
#pragma unroll
      for (int j = 0; j < DC; ++j) store(orow + tx + 16 * j, acc[i][j] * inv);
    } else {
      const int64_t r = (int64_t)bh * s_q + row;
      float* orow = o_acc + r * D;
#pragma unroll
      for (int j = 0; j < DC; ++j) orow[tx + 16 * j] = acc[i][j];
      if (tx == 0) {
        m_out[r] = m[i];
        l_out[r] = l[i];
      }
    }
  }
}

template <typename T, int D, bool CAUSAL, bool FUSED>
cudaError_t launch(const void* q, const void* k, const void* v, Strides qs,
                   Strides kvs, int b, int h, int s_q, int s_k, void* o,
                   float* o_acc, float* m, float* l, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D, CAUSAL, FUSED>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, s_q / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      qs, kvs, h, s_q, s_k, 1.f / sqrtf((float)D), static_cast<T*>(o), o_acc, m, l);
  return cudaGetLastError();
}

template <typename T, bool CAUSAL, bool FUSED>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       Strides qs, Strides kvs, int b, int h, int s_q, int s_k,
                       void* o, float* o_acc, float* m, float* l, cudaStream_t st) {
  if (d == 64)
    return launch<T, 64, CAUSAL, FUSED>(q, k, v, qs, kvs, b, h, s_q, s_k, o, o_acc, m, l, st);
  if (d == 128)
    return launch<T, 128, CAUSAL, FUSED>(q, k, v, qs, kvs, b, h, s_q, s_k, o, o_acc, m, l, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Shapes and strides are checked by the
// Python wrapper (torchsnapshot_tpu_torch/ops/flash_attention.py); a bad
// value that slips through is refused with cudaErrorInvalidValue. Returns
// the launch's cudaError_t.
int ts_flash_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                 int b, int h, int s, int d, int64_t q_sb, int64_t q_ss,
                 int64_t q_sh, int64_t kv_sb, int64_t kv_ss, int64_t kv_sh,
                 void* stream) {
  if (s % kBlockQ || s % kBlockK) return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, kvs{kv_sb, kv_ss, kv_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float, true, true>(d, q, k, v, qs, kvs, b, h, s, s, o,
                                         nullptr, nullptr, nullptr, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, true, true>(d, q, k, v, qs, kvs, b, h, s, s,
                                                 o, nullptr, nullptr, nullptr, st);
  return cudaErrorInvalidValue;
}

int ts_flash_chunk(const void* q, const void* k, const void* v, float* o_acc,
                   float* m, float* l, int dtype, int causal, int b, int h,
                   int s_q, int s_k, int d, int64_t q_sb, int64_t q_ss,
                   int64_t q_sh, int64_t kv_sb, int64_t kv_ss, int64_t kv_sh,
                   void* stream) {
  if (s_q % kBlockQ || s_k % kBlockK) return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, kvs{kv_sb, kv_ss, kv_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return causal ? dispatch_d<float, true, false>(d, q, k, v, qs, kvs, b, h, s_q, s_k,
                                                   nullptr, o_acc, m, l, st)
                  : dispatch_d<float, false, false>(d, q, k, v, qs, kvs, b, h, s_q, s_k,
                                                    nullptr, o_acc, m, l, st);
  }
  if (dtype == 1) {
    return causal ? dispatch_d<__nv_bfloat16, true, false>(d, q, k, v, qs, kvs, b, h,
                                                           s_q, s_k, nullptr, o_acc, m, l, st)
                  : dispatch_d<__nv_bfloat16, false, false>(d, q, k, v, qs, kvs, b, h,
                                                            s_q, s_k, nullptr, o_acc, m, l, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
