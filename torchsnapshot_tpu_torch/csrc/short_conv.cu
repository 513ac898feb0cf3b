// The gated short convolution of an LFM2 conv layer, forward and backward.
//
// models/lfm2.py splits the in_proj output P (b, s, 3d) into B, C and x
// (each (b, s, d), in that order along the last dimension) and computes
//
//     y[t] = C[t] * (w[0] * Bx[t-2] + w[1] * Bx[t-1] + w[2] * Bx[t]),  Bx = B * x,
//
// a depthwise causal convolution of three taps along the sequence (w is
// (3, d), taps by channels; Bx before the sequence's start is zero). No
// kernel of the port computed it; ops/short_conv.py has its plain version.
//
// What bounds it: bytes. The forward reads P once and writes y (4 d bf16 a
// token); the backward reads P and dy and writes dP (7 d bf16 a token);
// the arithmetic is a handful of FMAs an element. What the design does
// about it:
//
// - One thread owns 8 channels (one 16-byte load of each of B, C, x) of one
//   sequence over a tile of consecutive positions, and walks the tile in
//   order, carrying the last two Bx in registers: every element of P is
//   loaded once, apart from a halo of two positions at a tile's start (and
//   in the backward two more at its end). Threads of a warp hold
//   consecutive channels, so a warp's loads are 512 contiguous bytes.
// - Arithmetic in f32, the output rounded to bf16 once.
// - The backward's tap gradient dw[j] = sum over (b, t) of g[t] Bx[t-2+j]
//   (g = dy * C) is summed per thread over its tile, written as one f32
//   partial a tile, and reduced by a second kernel over the tiles in a
//   fixed order: no atomics, so two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;         // channels a thread (one 16-byte bf16 load)
constexpr int kThreads = 128;   // threads a block, along the channels
constexpr int kFwdTile = 32;    // positions a forward thread walks
constexpr int kBwdTile = 128;   // positions a backward thread walks
constexpr int kReduceThreads = 256;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* in) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void zero8(float* v) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) v[i] = 0.f;
}

// Bx at position t of the sequence at `row` (rows of 3d elements), or zero
// outside [0, s).
__device__ __forceinline__ void load_bx(const __nv_bfloat16* row, int64_t t, int64_t s, int64_t d,
                                        int64_t c, float* bx) {
  if (t < 0 || t >= s) {
    zero8(bx);
    return;
  }
  float b[kVec], x[kVec];
  load8(row + t * 3 * d + c, b);
  load8(row + t * 3 * d + 2 * d + c, x);
#pragma unroll
  for (int i = 0; i < kVec; ++i) bx[i] = b[i] * x[i];
}

// g = dy * C at position t, or zero outside [0, s).
__device__ __forceinline__ void load_g(const __nv_bfloat16* row, const __nv_bfloat16* dyrow, int64_t t,
                                       int64_t s, int64_t d, int64_t c, float* dy, float* cc, float* g) {
  if (t >= s) {
    zero8(dy);
    zero8(cc);
    zero8(g);
    return;
  }
  load8(dyrow + t * d + c, dy);
  load8(row + t * 3 * d + d + c, cc);
#pragma unroll
  for (int i = 0; i < kVec; ++i) g[i] = dy[i] * cc[i];
}

__global__ void __launch_bounds__(kThreads) short_conv_fwd_kernel(
    const __nv_bfloat16* __restrict__ p, const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ y,
    int64_t s, int64_t d, int tiles_per_row) {
  const int64_t c = (int64_t{blockIdx.x} * kThreads + threadIdx.x) * kVec;
  if (c >= d) return;
  const int64_t b = blockIdx.y / tiles_per_row;
  const int64_t t0 = int64_t{blockIdx.y % tiles_per_row} * kFwdTile;
  const int64_t t1 = t0 + kFwdTile < s ? t0 + kFwdTile : s;
  const __nv_bfloat16* row = p + b * s * 3 * d;
  __nv_bfloat16* yrow = y + b * s * d;
  float w0[kVec], w1[kVec], w2[kVec], bx1[kVec], bx2[kVec];
  load8(w + c, w0);
  load8(w + d + c, w1);
  load8(w + 2 * d + c, w2);
  load_bx(row, t0 - 2, s, d, c, bx2);
  load_bx(row, t0 - 1, s, d, c, bx1);
#pragma unroll 4
  for (int64_t t = t0; t < t1; ++t) {
    float bb[kVec], cc[kVec], xx[kVec], out[kVec];
    const __nv_bfloat16* at = row + t * 3 * d + c;
    load8(at, bb);
    load8(at + d, cc);
    load8(at + 2 * d, xx);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float bx = bb[i] * xx[i];
      const float conv = fmaf(w2[i], bx, fmaf(w1[i], bx1[i], w0[i] * bx2[i]));
      out[i] = cc[i] * conv;
      bx2[i] = bx1[i];
      bx1[i] = bx;
    }
    store8(yrow + t * d + c, out);
  }
}

// dP (b, s, 3d) = (dB, dC, dx) and one f32 partial of dw (3, d) a tile:
//   dC[t] = dy[t] conv[t];  dBx[u] = w[2] g[u] + w[1] g[u+1] + w[0] g[u+2];
//   dB = dBx x;  dx = dBx B;  dw[j] += g[t] Bx[t-2+j].
__global__ void __launch_bounds__(kThreads) short_conv_bwd_kernel(
    const __nv_bfloat16* __restrict__ p, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ dy, __nv_bfloat16* __restrict__ dp, float* __restrict__ partial,
    int64_t s, int64_t d, int tiles_per_row) {
  const int64_t c = (int64_t{blockIdx.x} * kThreads + threadIdx.x) * kVec;
  if (c >= d) return;
  const int64_t b = blockIdx.y / tiles_per_row;
  const int64_t t0 = int64_t{blockIdx.y % tiles_per_row} * kBwdTile;
  const int64_t t1 = t0 + kBwdTile < s ? t0 + kBwdTile : s;
  const __nv_bfloat16* row = p + b * s * 3 * d;
  const __nv_bfloat16* dyrow = dy + b * s * d;
  __nv_bfloat16* drow = dp + b * s * 3 * d;
  float w0[kVec], w1[kVec], w2[kVec];
  load8(w + c, w0);
  load8(w + d + c, w1);
  load8(w + 2 * d + c, w2);
  float bx1[kVec], bx2[kVec];  // Bx at u-1, u-2
  load_bx(row, t0 - 2, s, d, c, bx2);
  load_bx(row, t0 - 1, s, d, c, bx1);
  // dy, C and g at u and u+1; g at u+2 is loaded in the loop.
  float dy0[kVec], c0[kVec], g0[kVec], dy1[kVec], c1[kVec], g1[kVec];
  load_g(row, dyrow, t0, s, d, c, dy0, c0, g0);
  load_g(row, dyrow, t0 + 1, s, d, c, dy1, c1, g1);
  float dw0[kVec], dw1[kVec], dw2[kVec];
  zero8(dw0);
  zero8(dw1);
  zero8(dw2);
#pragma unroll 2
  for (int64_t u = t0; u < t1; ++u) {
    float dy2[kVec], c2[kVec], g2[kVec], bb[kVec], xx[kVec];
    load_g(row, dyrow, u + 2, s, d, c, dy2, c2, g2);
    const __nv_bfloat16* at = row + u * 3 * d + c;
    load8(at, bb);
    load8(at + 2 * d, xx);
    float db[kVec], dc[kVec], dx[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float bx = bb[i] * xx[i];
      const float conv = fmaf(w2[i], bx, fmaf(w1[i], bx1[i], w0[i] * bx2[i]));
      dc[i] = dy0[i] * conv;
      const float dbx = fmaf(w0[i], g2[i], fmaf(w1[i], g1[i], w2[i] * g0[i]));
      db[i] = dbx * xx[i];
      dx[i] = dbx * bb[i];
      dw0[i] = fmaf(g0[i], bx2[i], dw0[i]);
      dw1[i] = fmaf(g0[i], bx1[i], dw1[i]);
      dw2[i] = fmaf(g0[i], bx, dw2[i]);
      bx2[i] = bx1[i];
      bx1[i] = bx;
      dy0[i] = dy1[i];
      c0[i] = c1[i];
      g0[i] = g1[i];
      dy1[i] = dy2[i];
      c1[i] = c2[i];
      g1[i] = g2[i];
    }
    __nv_bfloat16* out = drow + u * 3 * d + c;
    store8(out, db);
    store8(out + d, dc);
    store8(out + 2 * d, dx);
  }
  float* part = partial + int64_t{blockIdx.y} * 3 * d + c;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    part[i] = dw0[i];
    part[d + i] = dw1[i];
    part[2 * d + i] = dw2[i];
  }
}

// dw[k] = the sum over tiles of partial[tile][k], tile by tile in order.
__global__ void __launch_bounds__(kReduceThreads) short_conv_dw_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ dw, int tiles, int64_t n) {
  const int64_t k = int64_t{blockIdx.x} * kReduceThreads + threadIdx.x;
  if (k >= n) return;
  float acc = 0.f;
#pragma unroll 8
  for (int i = 0; i < tiles; ++i) acc += partial[int64_t{i} * n + k];
  dw[k] = acc;
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

int check(int64_t b, int64_t s, int64_t d, int64_t tile) {
  if (b <= 0 || s <= 0 || d <= 0 || d % kVec) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = b * ((s + tile - 1) / tile);
  if (tiles > 0x7fffffff || (d / kVec + kThreads - 1) / kThreads > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// y (b, s, d) from P (b, s, 3d) and w (3, d), all contiguous bf16 with
// 16-byte-aligned bases. Returns 0 or the CUDA error of the launch.
extern "C" int ts_short_conv_fwd(const void* p, const void* w, void* y, int64_t b, int64_t s, int64_t d,
                                 int device, void* stream) {
  int err = check(b, s, d, kFwdTile);
  if (err) return err;
  if (!aligned16(p) || !aligned16(w) || !aligned16(y)) return static_cast<int>(cudaErrorInvalidValue);
  // Autograd may call from a thread of its own: make the device current.
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_per_row = static_cast<int>((s + kFwdTile - 1) / kFwdTile);
  const dim3 grid(static_cast<unsigned>((d / kVec + kThreads - 1) / kThreads),
                  static_cast<unsigned>(b * tiles_per_row));
  short_conv_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(p), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), s, d, tiles_per_row);
  return static_cast<int>(cudaGetLastError());
}

// The number of f32 (3, d) partials ts_short_conv_bwd needs at (b, s).
extern "C" int64_t ts_short_conv_bwd_tiles(int64_t b, int64_t s) { return b * ((s + kBwdTile - 1) / kBwdTile); }

// dP (b, s, 3d) bf16 and dw (3, d) f32 from P, w and dy (b, s, d), with
// `partial` scratch of ts_short_conv_bwd_tiles(b, s) x 3d floats.
extern "C" int ts_short_conv_bwd(const void* p, const void* w, const void* dy, void* dp, void* partial,
                                 void* dw, int64_t b, int64_t s, int64_t d, int device, void* stream) {
  int err = check(b, s, d, kBwdTile);
  if (err) return err;
  if (!aligned16(p) || !aligned16(w) || !aligned16(dy) || !aligned16(dp) || !aligned16(partial)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_per_row = static_cast<int>((s + kBwdTile - 1) / kBwdTile);
  const int tiles = static_cast<int>(b * tiles_per_row);
  const dim3 grid(static_cast<unsigned>((d / kVec + kThreads - 1) / kThreads), static_cast<unsigned>(tiles));
  short_conv_bwd_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(p), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(dy), static_cast<__nv_bfloat16*>(dp), static_cast<float*>(partial), s, d,
      tiles_per_row);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t n = 3 * d;
  short_conv_dw_reduce_kernel<<<static_cast<unsigned>((n + kReduceThreads - 1) / kReduceThreads), kReduceThreads,
                                0, st>>>(static_cast<const float*>(partial), static_cast<float*>(dw), tiles, n);
  return static_cast<int>(cudaGetLastError());
}
