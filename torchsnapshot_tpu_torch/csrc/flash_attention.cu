// Flash attention forward for Hopper (sm_90a): one TMA + wgmma pipeline with
// two element configurations behind one C interface, picked by the input
// dtype and head dim.
//
// Replaces the two Pallas kernels of torchsnapshot_tpu/ops/flash_attention.py:
//   - ts_flash_fwd   <- _flash_kernel, reached through _flash_causal_forward
//                       (pallas_call at :395): causal softmax(q k^T / sqrt(d)) v,
//                       normalized, stored in the input dtype.
//   - ts_flash_chunk <- _flash_chunk_kernel, reached through flash_attention_chunk
//                       (pallas_call at :223): causal or unmasked, stores the
//                       UNNORMALIZED f32 accumulator plus the row max m and the
//                       normalizer l.
// Both compute the Pallas body's tile update (_online_softmax_update, :56-102):
// f32 logits scaled by 1/sqrt(d), masked logits out of the softmax, tiles past
// the causal frontier skipped, exp(logits - m_new) and the alpha rescale.
//
// Bound on the H100 (published SXM peaks: 3.35 TB/s, 989 TFLOP/s bf16 in the
// tensor cores, 67 TFLOP/s f32 outside them). A causal call needs
// 2*b*h*s_q*s_k*d FLOPs (half of QK^T plus PV), an unmasked one twice that.
// Bytes: q, k, v read once, o written once (the chunk entry writes f32 o, m,
// l). At the training shape (8, 1024, 16, 64) bf16 that is 17.2 GFLOP against
// 67 MB (fused) or 84 MB (chunk): 256 FLOP per byte, just under the card's
// bf16 balance point (~295), so the bytes bound it (0.020 / 0.025 ms) with the
// tensor-core operations close behind (0.017 ms). At d = 64 the softmax's
// exponentials (one per visible logit, 16 per SM clock) cost about as much
// again as the products.
//
// bf16: the Hopper design (namespace hopper).
//   - Work items are (batch*head, 128-row q tile) pairs. One persistent block
//     per SM (2 consumer warpgroups + 1 producer warpgroup) walks its share,
//     dealt heaviest causal q tile first in rounds of alternating direction,
//     so the next item's loads overlap the last one's epilogue and the tail
//     is short. Each consumer warpgroup owns 64 rows, and the TPU grid's
//     sequential k axis is a loop inside the block, so the running max /
//     normalizer / accumulator stay in registers (setmaxnreg moves registers
//     from the producer to the consumers).
//   - One producer lane loads q and K/V tiles of 128 keys through a ring
//     of shared-memory stages with TMA (4-D tensor maps (d, h, s, b) over the
//     tensors' own strides, so the strided q/k/v slices of a fused projection
//     are read in place; 128B swizzle; completion on mbarriers). Rows past the
//     end of a sequence come in as zeros and are masked.
//   - S = Q K^T is wgmma m64n128k16 (A = Q, B = the K tile, both from shared
//     memory, K-major), f32 in registers. The products of bf16 inputs are
//     exact in f32, so only the summation order differs from the Pallas body;
//     1/sqrt(d) is applied to the f32 logits (the body scales q first: for
//     d = 64 the scale is a power of two and the two agree bit for bit, for
//     d = 128 they differ by f32 ulps).
//   - The online softmax runs on the accumulator fragment: quad shuffles for
//     the row max, masks only on the causal diagonal tile and a ragged last
//     tile, l summed from the f32 probabilities. It runs while the previous
//     tile's P V product is on the tensor cores, and the two warpgroups take
//     turns there (named barriers), so one's softmax also runs under the
//     other's products.
//   - O += P V is wgmma with A = P from registers (the m64n128 accumulator
//     layout is the A-fragment layout of the next product) and B = the V tile
//     in shared memory, MN-major. P goes in as two bf16 terms, P_hi = bf16(P)
//     and P_lo = bf16(P - P_hi), into the same f32 accumulator: one bf16
//     rounding would move each weight by up to 2^-8, the split leaves 2^-16,
//     which keeps the chunk entry's f32 output near the body's f32 P V. The
//     split costs 1.5x the tensor-core products of an unsplit kernel.
//   - No atomics and a fixed summation order: the same inputs give the same
//     bits, which the bitwise continuation of a restored training run needs.
//
// f32 (d = 64 and 128): 3xTF32 on the same pipeline (hopper::Tf32<D>). f32
// inputs need f32 accuracy (2e-5). With f32 FMAs the products bound the
// kernel (67 TFLOP/s: 0.26 ms at (8, 1024, 16, 64), 2.05 ms at (2, 4096, 16,
// 128)); one tf32 product keeps 10 mantissa bits, far too few. So every
// product is three tf32 products into one f32 accumulator, a_hi b_hi + a_hi
// b_lo + a_lo b_hi (hi = x rounded to tf32, lo = x - hi, |lo| <= 2^-11 |x|;
// the tensor cores drop lo's own low bits, ~2^-21 of x, and lo lo, ~2^-22 of
// the product, is left out): 3 x 17.2 GFLOP at 495 TFLOP/s is 0.10 ms at the
// training shape, where the bytes now bound it; 3 x 137.4 GFLOP is 0.83 ms at
// (2, 4096, 16, 128).
//   - tf32 wgmma takes no transpose immediates, so both shared operands are
//     K-major, and V must arrive as v^T. The A-fragment of a tf32 k8 step
//     holds columns t, t+4 where the S accumulator holds 2t, 2t+1.
//     One pre-pass kernel (namespace split, one launch per entry call) fixes
//     both: it reads q, k, v through their strides and writes contiguous
//     scratch, hi and lo of q and k, and of v^T with the keys of every group of
//     8 stored in the order (0, 2, 4, 6, 1, 3, 5, 7). P then goes from the
//     registers into the product as it lies, split by rounding (hi) and a
//     subtraction (lo). The pre-pass moves 101 MB in and 201 MB out at the
//     training shape: about 0.09 ms of bytes, the price of the design.
//   - Tiles: 128 q rows, whose hi + lo stay in shared memory for the item
//     (registers hold S, P and O). A box is [rows][32 f32], one 128-byte
//     swizzle row, so a k8 step is 32 bytes, as bf16's k16 step, and the
//     descriptor walk is the same.
//       d = 64: q 64 KiB, two K/V stages of 64 keys, 64 KiB each (K hi + lo,
//       v^T hi + lo): 192 KiB of shared memory.
//       d = 128: q alone is 128 KiB, so 32-key tiles: K hi + lo 32 KiB in
//       one stage, v^T hi + lo 32 KiB in two, so that V_t loads while step
//       t - 1 runs: 224 KiB. K_{t+1} loads once both warpgroups have their
//       S_t. S = Q K^T is m64n32k8; at N = 32 each product reads 3 KiB of
//       shared memory for 16 K multiply-adds, so shared-memory reads rather
//       than the tensor cores bound the QK half.
//   - Everything else (the persistent walk, TMA ring, turns, online softmax,
//     epilogue) is the bf16 design's code, and the summation order is fixed:
//     the same inputs give the same bits.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kNegBig = -1e30f;  // the Pallas body's masked logit / initial max

struct Strides {
  int64_t b, s, h;  // in elements; the head dim is contiguous
};

constexpr int kMaxDevices = 64;

// x rounded to tf32 (to nearest, ties away from zero, as cvt.rna.tf32.f32):
// its low 13 mantissa bits zero. x - tf32_rna(x) is exact.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// Host set-up of a kernel instantiation on the current device, done once per
// device: allow the kernel its dynamic shared memory (a per-device setting)
// and read the device's SM count into `sms`. `cache` is the instantiation's
// own per-device record (0 = not set up yet); later calls only read it.
template <typename Kernel>
cudaError_t device_setup(std::atomic<int>* cache, Kernel kernel, int smem, int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if ((*sms = cache[device].load(std::memory_order_acquire))) return cudaSuccess;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  cache[device].store(*sms, std::memory_order_release);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Hopper: TMA + wgmma kernel, one pipeline for two element configurations
// (Bf16<D>: bf16 read in place; Tf32<D>: the 3xTF32 split scratch)
// ---------------------------------------------------------------------------
namespace hopper {

constexpr int kTile = 128;               // q rows per block
constexpr int kConsumerWarps = 8;        // two warpgroups of 64 q rows each
constexpr int kThreads = 32 * (kConsumerWarps + 4);  // + one producer warpgroup
// Registers per thread after the split (setmaxnreg): the producer needs few,
// the consumers hold S, P and O. 2 * 128 * 232 + 128 * 40 = 384 * 168, the
// budget the launch gets at one block per SM.
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kRowBytes = 128;           // one 128-byte swizzle row of a box
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Arrive once and expect `bytes` more from TMA loads before the phase ends.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.b32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 4-D (d, h, s, b) tensor map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// One box of a 3-D (inner, rows, n) tensor map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int n) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(n)
      : "memory");
}

// wgmma shared-memory matrix descriptor for a 128B-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// A K-major operand from `addr` (a k step's 32 bytes inside a 128-byte
// swizzle row): 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) { return desc_sw128(addr, 16, 1024); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma registers across
// the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define TS_F8(a, i)                                                                   \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]), "+f"(a[i + 4]),         \
      "+f"(a[i + 5]), "+f"(a[i + 6]), "+f"(a[i + 7])
#define TS_F16(a) TS_F8(a, 0), TS_F8(a, 8)
#define TS_F32(a) TS_F16(a), TS_F8(a, 16), TS_F8(a, 24)
#define TS_F64(a) TS_F32(a), TS_F8(a, 32), TS_F8(a, 40), TS_F8(a, 48), TS_F8(a, 56)

// d[64] (+)= A (64x16, shared, K-major) * B (16x128, shared, K-major).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : TS_F64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[32] += A (64x16, registers) * B (16x64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : TS_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64] += A (64x16, registers) * B (16x128, shared, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : TS_F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// tf32 takes no transpose immediates: both shared operands are K-major.
// d[32] (+)= A (64x8 tf32, shared) * B (8x64 tf32, shared).
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[32], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : TS_F32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[32] += A (64x8 tf32, registers) * B (8x64 tf32, shared).
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : TS_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[16] (+)= A (64x8 tf32, shared) * B (8x32 tf32, shared).
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[16], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : TS_F16(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64] += A (64x8 tf32, registers) * B (8x128 tf32, shared).
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : TS_F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef TS_F64
#undef TS_F32
#undef TS_F16
#undef TS_F8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// One unit of a block's work: the (q tile, batch*head) pair and its key
// tiles. Items are numbered heaviest causal q tile first and dealt out in
// rounds of gridDim.x, in alternating directions, which evens out the
// blocks' total walks.
struct Item {
  int qt, bi, hi, bh, n_tiles;  // bh = bi * h + hi
};

// The item of this block's round r; rounds only grow it.
__device__ __forceinline__ int item_index(int r) {
  const int g = gridDim.x, b = blockIdx.x;
  return r * g + ((r & 1) ? g - 1 - b : b);
}

// `keys`: keys per K/V tile; a causal q tile of kTile rows sees the key
// tiles up to its last row.
template <bool CAUSAL>
__device__ __forceinline__ Item item_at(int w, int bhs, int h, int n_qt, int n_k, int keys) {
  Item it;
  it.qt = n_qt - 1 - w / bhs;
  it.bh = w - (w / bhs) * bhs;
  it.bi = it.bh / h;
  it.hi = it.bh - it.bi * h;
  it.n_tiles = CAUSAL ? min(n_k, (it.qt + 1) * (kTile / keys)) : n_k;
  return it;
}

// Named barriers 1 and 2 (0 is __syncthreads) hand the tensor cores from one
// consumer warpgroup to the other: 128 threads wait, 128 arrive.
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// A dimension of size 1 gets a packed stride (its own stride is never used,
// and may be anything torch chose); boxes of `box` elements, 128B swizzle.
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, int rank,
                const void* base, const uint64_t* sizes, uint64_t* strides,
                const cuuint32_t* box);

// bf16 q, k, v read in place: 4-D maps (d, h, s, b) over their own strides.
// Tiles of 128 q rows and 128 keys; a box is [128 rows][64 bf16].
template <int D>
struct Bf16 {
  using Out = __nv_bfloat16;
  static constexpr int kD = D;
  static constexpr int kKeys = 128;                 // keys per K/V tile
  static constexpr int kPSteps = kKeys / 16;        // k16 steps of P V
  static constexpr int kBoxCols = 64;               // bf16 columns of one swizzle row
  static constexpr int kBox = kTile * kRowBytes;    // 16 KiB
  static constexpr int kQBytes = (D / kBoxCols) * kBox;
  static constexpr int kKBytes = kQBytes;
  static constexpr int kVBytes = kQBytes;
  static constexpr int kKStages = D == 64 ? 3 : 2;  // K and V ring depths
  static constexpr int kVStages = kKStages;
  struct Maps {
    CUtensorMap q, k, v;
  };

  static bool encode(Maps* m, const void* q, const void* k, const void* v, Strides qs,
                     Strides kvs, int b, int h, int s_q, int s_k) {
    return encode4(&m->q, q, qs, b, h, s_q) && encode4(&m->k, k, kvs, b, h, s_k) &&
           encode4(&m->v, v, kvs, b, h, s_k);
  }
  static bool encode4(CUtensorMap* map, const void* base, Strides st, int b, int h, int s) {
    const uint64_t sizes[4] = {(uint64_t)D, (uint64_t)h, (uint64_t)s, (uint64_t)b};
    uint64_t strides[3] = {(uint64_t)st.h * 2, (uint64_t)st.s * 2, (uint64_t)st.b * 2};
    const cuuint32_t box[4] = {kBoxCols, 1, kTile, 1};
    return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 4, base, sizes, strides, box);
  }

  __device__ static void load_q(const Maps& m, uint32_t dst, uint32_t bar, const Item& it, int) {
#pragma unroll
    for (int c = 0; c < D / kBoxCols; ++c)
      tma_load(dst + c * kBox, &m.q, bar, c * kBoxCols, it.hi, it.qt * kTile, it.bi);
  }
  __device__ static void load_k(const Maps& m, uint32_t dst, uint32_t bar, const Item& it, int t,
                                int) {
#pragma unroll
    for (int c = 0; c < D / kBoxCols; ++c)
      tma_load(dst + c * kBox, &m.k, bar, c * kBoxCols, it.hi, t * kKeys, it.bi);
  }
  __device__ static void load_v(const Maps& m, uint32_t dst, uint32_t bar, const Item& it, int t,
                                int) {
#pragma unroll
    for (int c = 0; c < D / kBoxCols; ++c)
      tma_load(dst + c * kBox, &m.v, bar, c * kBoxCols, it.hi, t * kKeys, it.bi);
  }

  // S = Q K^T for one key tile: D/16 steps of 16 head dims; the K-major
  // operands advance 32 bytes inside the 128-byte swizzle row, then to the
  // next column box. Started, not waited for.
  __device__ static void start_qk(float (&s)[64], uint32_t q, uint32_t k) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t koff = (kk >> 2) * kBox + (kk & 3) * 32;
      wgmma_ss_n128(s, desc_k(q + koff), desc_k(k + koff), kk > 0);
    }
    wgmma_commit();
  }

  // O += P V for one key tile, P as two bf16 terms: 8 steps of 16 keys; the
  // MN-major V operand advances 16 rows (2048 bytes) a step, and its second
  // column box (d = 128) lies one box (the leading byte offset) further on.
  // Started, not waited for.
  __device__ static void start_pv(float (&acc)[D / 2], const uint32_t (&p_hi)[kPSteps][4],
                                  const uint32_t (&p_lo)[kPSteps][4], uint32_t v) {
#pragma unroll
    for (int kk = 0; kk < kPSteps; ++kk) {
      const uint64_t dv = desc_sw128(v + kk * 16 * kRowBytes, kBox, 1024);
      wgmma_rs(acc, p_hi[kk], dv);
      wgmma_rs(acc, p_lo[kk], dv);
    }
    wgmma_commit();
  }

  // The m64n128 accumulator layout is the bf16 A-fragment layout of the next
  // product: key step kk is s[8kk .. 8kk+7], in pairs.
  __device__ static void split(const float (&s)[64], uint32_t (&p_hi)[kPSteps][4],
                               uint32_t (&p_lo)[kPSteps][4]) {
#pragma unroll
    for (int kk = 0; kk < kPSteps; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x0 = s[8 * kk + 2 * j], x1 = s[8 * kk + 2 * j + 1];
        const __nv_bfloat162 hi2 = __floats2bfloat162_rn(x0, x1);
        p_hi[kk][j] = *reinterpret_cast<const uint32_t*>(&hi2);
        p_lo[kk][j] = pack_bf16(x0 - __low2float(hi2), x1 - __high2float(hi2));
      }
  }

  __device__ static void store2(Out* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// f32 through 3xTF32: reads the pre-pass's contiguous scratch, (hi, lo) of
// q and k as (2, b*h, s, D) and of vᵀ as (2, b*h, D, s_k), through 3-D maps
// (inner, rows, part * b*h + bh). Tiles of 128 q rows; a box is [rows][32
// f32], one 128-byte swizzle row per row. Shared memory:
//   D = 64: 64-key tiles; q hi + lo 64 KiB, each of two stages K hi + lo and
//   vᵀ hi + lo 32 KiB each: 192 KiB.
//   D = 128: 32-key tiles; q hi + lo 128 KiB, one stage of K hi + lo and two
//   of vᵀ hi + lo, 32 KiB each: 224 KiB.
template <int D>
struct Tf32 {
  using Out = float;
  static constexpr int kD = D;
  static constexpr int kKeys = D == 64 ? 64 : 32;   // keys per K/V tile
  static constexpr int kKStages = D == 64 ? 2 : 1;
  static constexpr int kVStages = 2;
  static constexpr int kPSteps = kKeys / 8;         // k8 steps of P V
  static constexpr int kBoxCols = 32;               // f32 columns of one swizzle row
  static constexpr int kQCols = D / kBoxCols;       // column boxes of a q or K tile
  static constexpr int kVCols = kKeys / kBoxCols;   // column boxes of a vᵀ tile
  static constexpr int kQBox = kTile * kRowBytes;   // [128 q rows][32]: 16 KiB
  static constexpr int kKBox = kKeys * kRowBytes;   // [keys][32]
  static constexpr int kVBox = D * kRowBytes;       // [D head dims][32 keys]
  static constexpr int kQBytes = 2 * kQCols * kQBox;  // (hi, lo) x column boxes
  static constexpr int kKBytes = 2 * kQCols * kKBox;
  static constexpr int kVBytes = 2 * kVCols * kVBox;
  struct Maps {
    CUtensorMap q, k, vt;
  };

  static bool encode(Maps* m, const void* q, const void* k, const void* vt, Strides, Strides,
                     int b, int h, int s_q, int s_k) {
    const uint64_t n = 2ull * b * h;
    return encode3(&m->q, q, D, s_q, n, kTile) && encode3(&m->k, k, D, s_k, n, kKeys) &&
           encode3(&m->vt, vt, s_k, D, n, D);
  }
  static bool encode3(CUtensorMap* map, const void* base, uint64_t inner, uint64_t rows,
                      uint64_t n, int box_rows) {
    const uint64_t sizes[3] = {inner, rows, n};
    uint64_t strides[2] = {inner * 4, inner * rows * 4};
    const cuuint32_t box[3] = {kBoxCols, (cuuint32_t)box_rows, 1};
    return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 3, base, sizes, strides, box);
  }

  // Part p (0 = hi, 1 = lo), column box c lands at (p * columns + c) boxes.
  __device__ static void load_q(const Maps& m, uint32_t dst, uint32_t bar, const Item& it,
                                int bhs) {
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int c = 0; c < kQCols; ++c)
        tma_load(dst + (p * kQCols + c) * kQBox, &m.q, bar, c * kBoxCols, it.qt * kTile,
                 p * bhs + it.bh);
  }
  __device__ static void load_k(const Maps& m, uint32_t dst, uint32_t bar, const Item& it, int t,
                                int bhs) {
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int c = 0; c < kQCols; ++c)
        tma_load(dst + (p * kQCols + c) * kKBox, &m.k, bar, c * kBoxCols, t * kKeys,
                 p * bhs + it.bh);
  }
  __device__ static void load_v(const Maps& m, uint32_t dst, uint32_t bar, const Item& it, int t,
                                int bhs) {
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int c = 0; c < kVCols; ++c)
        tma_load(dst + (p * kVCols + c) * kVBox, &m.vt, bar, t * kKeys + c * kBoxCols, 0,
                 p * bhs + it.bh);
  }

  // S = Q K^T: D/8 steps of 8 head dims (32 bytes, as bf16's k16 step), each
  // three products q_hi k_hi + q_hi k_lo + q_lo k_hi into one accumulator.
  __device__ static void start_qk(float (&s)[kKeys / 2], uint32_t q, uint32_t k) {
    // q's tile, and K's with one stage, lie at the same address at every
    // step. Hidden from the compiler here, so that it builds each descriptor
    // beside its product rather than holding all 4 D/8 of them (2 D
    // registers) across the key loop, which spilled at D = 128.
    asm volatile("" : "+r"(q), "+r"(k));
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t qo = (kk >> 2) * kQBox + (kk & 3) * 32;
      const uint32_t ko = (kk >> 2) * kKBox + (kk & 3) * 32;
      const uint64_t q_hi = desc_k(q + qo), q_lo = desc_k(q + kQCols * kQBox + qo);
      const uint64_t k_hi = desc_k(k + ko), k_lo = desc_k(k + kQCols * kKBox + ko);
      wgmma_ss_tf32(s, q_hi, k_hi, kk > 0);
      wgmma_ss_tf32(s, q_hi, k_lo, 1);
      wgmma_ss_tf32(s, q_lo, k_hi, 1);
    }
    wgmma_commit();
  }

  // O += P V: kKeys/8 steps of 8 keys, B = the vᵀ tile (K-major along the
  // keys), three products P_hi v_hi + P_hi v_lo + P_lo v_hi each.
  __device__ static void start_pv(float (&acc)[D / 2], const uint32_t (&p_hi)[kPSteps][4],
                                  const uint32_t (&p_lo)[kPSteps][4], uint32_t v) {
#pragma unroll
    for (int kk = 0; kk < kPSteps; ++kk) {
      const uint32_t vo = (kk >> 2) * kVBox + (kk & 3) * 32;
      const uint64_t v_hi = desc_k(v + vo), v_lo = desc_k(v + kVCols * kVBox + vo);
      wgmma_rs_tf32(acc, p_hi[kk], v_hi);
      wgmma_rs_tf32(acc, p_hi[kk], v_lo);
      wgmma_rs_tf32(acc, p_lo[kk], v_hi);
    }
    wgmma_commit();
  }

  // In key group kk a thread holds keys 2t, 2t+1 of rows g, g+8 (s[4kk ..
  // 4kk+3]); the tf32 A fragment is (g, t), (g+8, t), (g, t+4), (g+8, t+4).
  // The pre-pass stored key 2t at column t and 2t+1 at t+4 of vᵀ, so the
  // registers go in as they lie: hi rounded to tf32, lo the rest.
  __device__ static void split(const float (&s)[kKeys / 2], uint32_t (&p_hi)[kPSteps][4],
                               uint32_t (&p_lo)[kPSteps][4]) {
#pragma unroll
    for (int kk = 0; kk < kPSteps; ++kk) {
      const float x[4] = {s[4 * kk], s[4 * kk + 2], s[4 * kk + 1], s[4 * kk + 3]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float hi = tf32_rna(x[j]);
        p_hi[kk][j] = __float_as_uint(hi);
        p_lo[kk][j] = __float_as_uint(x[j] - hi);
      }
    }
  }

  __device__ static void store2(Out* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

// Shared memory of one block: the q tile, the K and V rings, and the
// mbarriers (q_full, q_empty, then k_full, v_full, k_empty, v_empty, one per
// stage of their ring).
template <class C>
struct Layout {
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + C::kQBytes;
  static constexpr int kV = kK + C::kKStages * C::kKBytes;
  static constexpr int kBars = kV + C::kVStages * C::kVBytes;
  static constexpr int kSmem =
      kBars + 8 * (2 + 2 * C::kKStages + 2 * C::kVStages) + 1024;  // + alignment slack
  static_assert(kSmem <= 232448, "more shared memory than a block may have");
};

template <class C>
struct Smem {
  using L = Layout<C>;
  uint32_t q, k, v, bars;
  __device__ explicit Smem(uint32_t base)
      : q(base + L::kQ), k(base + L::kK), v(base + L::kV), bars(base + L::kBars) {}
  __device__ uint32_t k_at(int st) const { return k + st * C::kKBytes; }
  __device__ uint32_t v_at(int st) const { return v + st * C::kVBytes; }
  __device__ uint32_t q_full() const { return bars; }
  __device__ uint32_t q_empty() const { return bars + 8u; }
  __device__ uint32_t k_full(int st) const { return bars + 8u * (2 + st); }
  __device__ uint32_t v_full(int st) const { return bars + 8u * (2 + C::kKStages + st); }
  __device__ uint32_t k_empty(int st) const {
    return bars + 8u * (2 + C::kKStages + C::kVStages + st);
  }
  __device__ uint32_t v_empty(int st) const {
    return bars + 8u * (2 + 2 * C::kKStages + C::kVStages + st);
  }
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Mask one tile of N raw logits per thread's two rows (only the tiles that
// reach past the q tile's first row under the causal mask, and a ragged last
// tile), then the online-softmax update in logit units (logit = dot * scale;
// exp(x - m) is evaluated as exp2(dot * scale * log2(e) - m * log2(e))).
// Leaves the probabilities in s and the rescale of the accumulator's two rows
// in alpha.
template <bool CAUSAL, int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m_r)[2], float (&l_r)[2],
                                             float (&alpha)[2], int t, int q0, int s_k,
                                             int row0, int col, float scale) {
  constexpr int kKeys = 2 * N;
  if ((CAUSAL && (t + 1) * kKeys > q0) || (t + 1) * kKeys > s_k) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t * kKeys + 8 * i + col + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        if (key >= s_k || (CAUSAL && key > row)) s[4 * i + e] = -INFINITY;
      }
  }
  const float scale_log2 = scale * kLog2e;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      mx = fmaxf(mx, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_r[r], mx * scale);
    alpha[r] = exp2_approx((m_r[r] - m_new) * kLog2e);
    m_r[r] = m_new;
    const float mc = m_new * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * i + 2 * r + e];
        x = exp2_approx(fmaf(x, scale_log2, -mc));
        sum += x;
      }
    l_r[r] = l_r[r] * alpha[r] + sum;
  }
}

// Rescale the accumulator's rows, and split the probabilities into the two
// A fragments of the next P V product.
template <class C>
__device__ __forceinline__ void rescale_and_split(float (&acc)[C::kD / 2],
                                                  const float (&alpha)[2],
                                                  const float (&s)[C::kKeys / 2],
                                                  uint32_t (&p_hi)[C::kPSteps][4],
                                                  uint32_t (&p_lo)[C::kPSteps][4]) {
#pragma unroll
  for (int i = 0; i < C::kD / 8; ++i) {
    acc[4 * i + 0] *= alpha[0];
    acc[4 * i + 1] *= alpha[0];
    acc[4 * i + 2] *= alpha[1];
    acc[4 * i + 3] *= alpha[1];
  }
  C::split(s, p_hi, p_lo);
}

// The consumer warpgroups' walk over one item's key tiles, then its
// epilogue. `kv` counts the K/V tiles of the block's earlier items (the
// ring's position) and `iter` the earlier items (the q tile's phase).
// Accumulator fragment of m64nN (per thread): element 4*i + e is row
// r + 8*(e >> 1), column 8*i + 2*(lane % 4) + (e & 1), where r is the
// thread's first row.
//
// Step t starts S_t = Q K_t^T together with O += P_{t-1} V_{t-1}, then runs
// the softmax of S_t while the P V product is still on the tensor cores; the
// two warpgroups take turns there, so one's softmax also runs under the
// other's products. The first step (no P V yet) and the last (no S) are
// peeled off: a wgmma under a branch is serialized by the compiler.
template <class C, bool CAUSAL, bool FUSED>
__device__ __forceinline__ void consume(const Smem<C>& sm, int warp, int lane, const Item& item,
                                        int kv, int iter, bool last_item, int h, int s_q,
                                        int s_k, float scale, typename C::Out* __restrict__ o,
                                        float* __restrict__ o_acc, float* __restrict__ m_out,
                                        float* __restrict__ l_out) {
  constexpr int D = C::kD;
  const int qt = item.qt, bi = item.bi, hi = item.hi, n_tiles = item.n_tiles;
  const int q0 = qt * kTile;
  const int wg = warp >> 2;
  const int row0 = q0 + wg * 64 + ((warp & 3) << 4) + (lane >> 2);
  const int col = (lane & 3) << 1;
  const uint32_t q_tile = sm.q + wg * 64 * kRowBytes;
  // Ring slots and phases of this item's key tile t.
  auto kslot = [&](int t) { return (kv + t) % C::kKStages; };
  auto kphase = [&](int t) { return (uint32_t)((kv + t) / C::kKStages) & 1; };
  auto vslot = [&](int t) { return (kv + t) % C::kVStages; };
  auto vphase = [&](int t) { return (uint32_t)((kv + t) / C::kVStages) & 1; };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_r[2] = {kNegBig, kNegBig};
  float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums
  float s[C::kKeys / 2], alpha[2];
  uint32_t p_hi[C::kPSteps][4], p_lo[C::kPSteps][4];

  mbar_wait(sm.q_full(), iter & 1);

  // Step 0: S_0 alone.
  mbar_wait(sm.k_full(kslot(0)), kphase(0));
  __syncwarp();  // lanes leave the spin apart; wgmma needs the warp converged
  turn_wait(1 + wg);
  wgmma_fence();
  C::start_qk(s, q_tile, sm.k_at(kslot(0)));
  turn_pass(2 - wg);
  wgmma_wait_all();
  fence_regs(s);
  __syncwarp();
  if (lane == 0) mbar_arrive(sm.k_empty(kslot(0)));
  softmax_tile<CAUSAL>(s, m_r, l_r, alpha, 0, q0, s_k, row0, col, scale);
  rescale_and_split<C>(acc, alpha, s, p_hi, p_lo);

  // Steps 1 .. n_tiles - 1: S_t beside P_{t-1} V_{t-1}.
  for (int t = 1; t < n_tiles; ++t) {
    mbar_wait(sm.k_full(kslot(t)), kphase(t));
    mbar_wait(sm.v_full(vslot(t - 1)), vphase(t - 1));
    __syncwarp();
    turn_wait(1 + wg);
    wgmma_fence();
    C::start_qk(s, q_tile, sm.k_at(kslot(t)));
    C::start_pv(acc, p_hi, p_lo, sm.v_at(vslot(t - 1)));
    turn_pass(2 - wg);
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");  // S_t is in
    fence_regs(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.k_empty(kslot(t)));
    softmax_tile<CAUSAL>(s, m_r, l_r, alpha, t, q0, s_k, row0, col, scale);
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.v_empty(vslot(t - 1)));
    rescale_and_split<C>(acc, alpha, s, p_hi, p_lo);
  }

  // Last step: P V alone. Every S product of the item is done, so the q tile
  // is released to the next item's load. Warpgroup 1's pass after the
  // block's last item would have no wait to meet, so it is left out.
  __syncwarp();
  if (lane == 0) mbar_arrive(sm.q_empty());
  mbar_wait(sm.v_full(vslot(n_tiles - 1)), vphase(n_tiles - 1));
  __syncwarp();
  turn_wait(1 + wg);
  wgmma_fence();
  C::start_pv(acc, p_hi, p_lo, sm.v_at(vslot(n_tiles - 1)));
  if (wg == 0 || !last_item) turn_pass(2 - wg);
  wgmma_wait_all();
  fence_regs(acc);
  __syncwarp();
  if (lane == 0) mbar_arrive(sm.v_empty(vslot(n_tiles - 1)));

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= s_q) continue;  // the zero rows of a half tile
    if (FUSED) {
      typename C::Out* orow = o + (((int64_t)bi * s_q + row) * h + hi) * D + col;
      const float inv = 1.f / l_r[r];
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        C::store2(orow + 8 * i, acc[4 * i + 2 * r] * inv, acc[4 * i + 2 * r + 1] * inv);
    } else {
      const int64_t ri = (int64_t)item.bh * s_q + row;
      float* orow = o_acc + ri * D + col;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<float2*>(orow + 8 * i) =
            make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
      if ((lane & 3) == 0) {
        m_out[ri] = m_r[r];
        l_out[ri] = l_r[r];
      }
    }
  }
}

// FUSED: normalize and store o at (b, s, h, d) in the output type.
// !FUSED: store the f32 accumulator at (b, h, s, d) and m, l at (b, h, s).
// Persistent: one block per SM walks its share of the items, so the
// producer loads the next item's q and K/V while the consumers finish the
// last one.
template <class C, bool CAUSAL, bool FUSED>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ typename C::Maps maps, int b, int h, int s_q,
                   int s_k, float scale, typename C::Out* __restrict__ o,
                   float* __restrict__ o_acc, float* __restrict__ m_out,
                   float* __restrict__ l_out) {
  extern __shared__ uint8_t smem_raw[];
  // 128B swizzle repeats every 1024 bytes; the descriptors assume tiles start
  // on that boundary.
  const Smem<C> sm((smem_u32(smem_raw) + 1023u) & ~1023u);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bhs = b * h;
  const int n_qt = (s_q + kTile - 1) / kTile;
  const int n_k = (s_k + C::kKeys - 1) / C::kKeys;
  const int n_items = bhs * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full(), 1);
    mbar_init(sm.q_empty(), kConsumerWarps);
    for (int st = 0; st < C::kKStages; ++st) {
      mbar_init(sm.k_full(st), 1);
      mbar_init(sm.k_empty(st), kConsumerWarps);
    }
    for (int st = 0; st < C::kVStages; ++st) {
      mbar_init(sm.v_full(st), 1);
      mbar_init(sm.v_empty(st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // Producer warpgroup: one lane keeps the q tile and the K/V ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      int kv = 0;
      for (int iter = 0, w = item_index(0); w < n_items; w = item_index(++iter)) {
        const Item it = item_at<CAUSAL>(w, bhs, h, n_qt, n_k, C::kKeys);
        if (iter > 0) mbar_wait(sm.q_empty(), (iter - 1) & 1);
        mbar_expect_tx(sm.q_full(), C::kQBytes);
        C::load_q(maps, sm.q, sm.q_full(), it, bhs);
        for (int t = 0; t < it.n_tiles; ++t, ++kv) {
          const int ks = kv % C::kKStages, kround = kv / C::kKStages;
          if (kround > 0) mbar_wait(sm.k_empty(ks), (kround - 1) & 1);
          mbar_expect_tx(sm.k_full(ks), C::kKBytes);
          C::load_k(maps, sm.k_at(ks), sm.k_full(ks), it, t, bhs);
          const int vs = kv % C::kVStages, vround = kv / C::kVStages;
          if (vround > 0) mbar_wait(sm.v_empty(vs), (vround - 1) & 1);
          mbar_expect_tx(sm.v_full(vs), C::kVBytes);
          C::load_v(maps, sm.v_at(vs), sm.v_full(vs), it, t, bhs);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    if (warp >= 4) turn_pass(1);  // warpgroup 0 goes first
    int kv = 0;
    for (int iter = 0, w = item_index(0); w < n_items; w = item_index(++iter)) {
      const Item it = item_at<CAUSAL>(w, bhs, h, n_qt, n_k, C::kKeys);
      consume<C, CAUSAL, FUSED>(sm, warp, lane, it, kv, iter, item_index(iter + 1) >= n_items,
                                h, s_q, s_k, scale, o, o_acc, m_out, l_out);
      kv += it.n_tiles;
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &status);
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// `sizes` innermost first, `strides` in bytes for dims 1 .. rank-1. Rows past
// a dimension's end come in as zeros.
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, int rank,
                const void* base, const uint64_t* sizes, uint64_t* strides,
                const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (!fn || rank > 4) return false;
  uint64_t span = sizes[0] * elem_bytes;
  for (int i = 1; i < rank; ++i)
    if (sizes[i] > 1 && strides[i - 1] * sizes[i] > span) span = strides[i - 1] * sizes[i];
  cuuint64_t dims[4], st[3];
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) dims[i] = sizes[i];
  for (int i = 1; i < rank; ++i) st[i - 1] = sizes[i] == 1 ? span : strides[i - 1];
  return fn(map, type, rank, const_cast<void*>(base), dims, st, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class C, bool CAUSAL, bool FUSED>
cudaError_t launch(const void* q, const void* k, const void* v, Strides qs, Strides kvs,
                   int b, int h, int s_q, int s_k, void* o, float* o_acc, float* m, float* l,
                   cudaStream_t stream) {
  if (s_q % 64 || s_k % 64) return cudaErrorInvalidValue;
  typename C::Maps maps;
  if (!C::encode(&maps, q, k, v, qs, kvs, b, h, s_q, s_k)) return cudaErrorInvalidValue;
  auto kernel = flash_wgmma_kernel<C, CAUSAL, FUSED>;
  constexpr int smem = Layout<C>::kSmem;
  static std::atomic<int> sms_by_device[kMaxDevices];
  int sms = 0;
  const cudaError_t err = device_setup(sms_by_device, kernel, smem, &sms);
  if (err != cudaSuccess) return err;
  const int n_items = b * h * ((s_q + kTile - 1) / kTile);
  kernel<<<n_items < sms ? n_items : sms, kThreads, smem, stream>>>(
      maps, b, h, s_q, s_k, 1.f / sqrtf((float)C::kD), static_cast<typename C::Out*>(o), o_acc,
      m, l);
  return cudaGetLastError();
}

}  // namespace hopper

// ---------------------------------------------------------------------------
// f32: the pre-pass that splits q, k, v for 3xTF32
// ---------------------------------------------------------------------------
namespace split {

constexpr int kRows = 64;      // rows (q rows or keys) per block
constexpr int kThreads = 256;

// Blocks [0, b*h*s_q/64) each split a 64-row tile of q; the rest each split
// a 64-key tile of k and write the same keys of v transposed, keys permuted
// within groups of 8 (position c holds key ((c & 3) << 1) | (c >> 2) of its
// group; KEY_PERM in ops/flash_attention.py). Reads through the inputs'
// strides; writes hi = tf32_rna(x) and lo = x - hi to part 0 and 1 of
// q_out / k_out (2, b*h, s, D) and vt_out (2, b*h, D, s_k).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_split_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, Strides qs, Strides kvs, int h, int s_q,
                       int s_k, float* __restrict__ q_out, float* __restrict__ k_out,
                       float* __restrict__ vt_out) {
  // One column of padding: the transposed reads below hit 32 banks.
  __shared__ float tile[kRows][D + 1];
  const int bhs = gridDim.x / (s_q / kRows + s_k / kRows);
  int blk = blockIdx.x;
  const bool is_q = blk < bhs * (s_q / kRows);
  if (!is_q) blk -= bhs * (s_q / kRows);
  const int s = is_q ? s_q : s_k;
  const int bh = blk / (s / kRows);
  const int r0 = (blk - bh * (s / kRows)) * kRows;
  const int bi = bh / h, hi = bh - bi * h;
  const Strides st = is_q ? qs : kvs;
  const float* src = (is_q ? q : k) + bi * st.b + hi * st.h;
  float* dst = (is_q ? q_out : k_out) + ((int64_t)bh * s + r0) * D;
  const int64_t part = (int64_t)bhs * s * D;
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const float x = src[(int64_t)(r0 + r) * st.s + c];
    const float x_hi = tf32_rna(x);
    dst[i] = x_hi;
    dst[part + i] = x - x_hi;
  }
  if (is_q) return;  // uniform across the block

  const float* vsrc = v + bi * kvs.b + hi * kvs.h;
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    tile[r][c] = vsrc[(int64_t)(r0 + r) * kvs.s + c];
  }
  __syncthreads();
  float* vdst = vt_out + (int64_t)bh * D * s_k + r0;
  const int64_t vpart = (int64_t)bhs * D * s_k;
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int dim = i / kRows, c = i % kRows;
    const float x = tile[(c & ~7) | ((c & 3) << 1) | ((c >> 2) & 1)][dim];
    const float x_hi = tf32_rna(x);
    vdst[(int64_t)dim * s_k + c] = x_hi;
    vdst[vpart + (int64_t)dim * s_k + c] = x - x_hi;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, Strides qs, Strides kvs, int b,
                   int h, int s_q, int s_k, void* q_out, void* k_out, void* vt_out,
                   cudaStream_t stream) {
  if (s_q % kRows || s_k % kRows) return cudaErrorInvalidValue;
  const int blocks = b * h * (s_q / kRows + s_k / kRows);
  flash_split_f32_kernel<D><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      qs, kvs, h, s_q, s_k, static_cast<float*>(q_out), static_cast<float*>(k_out),
      static_cast<float*>(vt_out));
  return cudaGetLastError();
}

}  // namespace split

// dtype 1 = bfloat16 read in place, 2 = float32 as the pre-pass's split
// scratch (3xTF32); both on the TMA + wgmma pipeline at d = 64 or 128.
// Chosen by dtype and d alone.
template <bool CAUSAL, bool FUSED>
cudaError_t dispatch(int dtype, int d, const void* q, const void* k, const void* v,
                     Strides qs, Strides kvs, int b, int h, int s_q, int s_k, void* o,
                     float* o_acc, float* m, float* l, cudaStream_t st) {
  using namespace hopper;
  if (dtype == 1 && d == 64)
    return launch<Bf16<64>, CAUSAL, FUSED>(q, k, v, qs, kvs, b, h, s_q, s_k, o, o_acc, m, l, st);
  if (dtype == 1 && d == 128)
    return launch<Bf16<128>, CAUSAL, FUSED>(q, k, v, qs, kvs, b, h, s_q, s_k, o, o_acc, m, l, st);
  if (dtype == 2 && d == 64)
    return launch<Tf32<64>, CAUSAL, FUSED>(q, k, v, qs, kvs, b, h, s_q, s_k, o, o_acc, m, l, st);
  if (dtype == 2 && d == 128)
    return launch<Tf32<128>, CAUSAL, FUSED>(q, k, v, qs, kvs, b, h, s_q, s_k, o, o_acc, m, l, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype as in dispatch above; with dtype 2, q, k and v are the scratch that
// ts_flash_split_f32 wrote and the strides are not read. Shapes, strides and
// alignment are checked by the Python wrapper
// (torchsnapshot_tpu_torch/ops/flash_attention.py); a bad value that slips
// through is refused with cudaErrorInvalidValue. Returns the launch's
// cudaError_t.
int ts_flash_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                 int b, int h, int s, int d, int64_t q_sb, int64_t q_ss,
                 int64_t q_sh, int64_t kv_sb, int64_t kv_ss, int64_t kv_sh,
                 void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, kvs{kv_sb, kv_ss, kv_sh};
  return dispatch<true, true>(dtype, d, q, k, v, qs, kvs, b, h, s, s, o, nullptr, nullptr,
                              nullptr, static_cast<cudaStream_t>(stream));
}

int ts_flash_chunk(const void* q, const void* k, const void* v, float* o_acc,
                   float* m, float* l, int dtype, int causal, int b, int h,
                   int s_q, int s_k, int d, int64_t q_sb, int64_t q_ss,
                   int64_t q_sh, int64_t kv_sb, int64_t kv_ss, int64_t kv_sh,
                   void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, kvs{kv_sb, kv_ss, kv_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return causal ? dispatch<true, false>(dtype, d, q, k, v, qs, kvs, b, h, s_q, s_k, nullptr,
                                        o_acc, m, l, st)
                : dispatch<false, false>(dtype, d, q, k, v, qs, kvs, b, h, s_q, s_k, nullptr,
                                         o_acc, m, l, st);
}

// The pre-pass of the f32 kernel (d = 64 or 128): reads q (b, s_q, h, d) and
// k, v (b, s_k, h, d) through their strides and writes the split scratch
// q_out (2, b*h, s_q, d), k_out (2, b*h, s_k, d), vt_out (2, b*h, d, s_k).
int ts_flash_split_f32(const void* q, const void* k, const void* v, void* q_out, void* k_out,
                       void* vt_out, int b, int h, int s_q, int s_k, int d, int64_t q_sb,
                       int64_t q_ss, int64_t q_sh, int64_t kv_sb, int64_t kv_ss, int64_t kv_sh,
                       void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, kvs{kv_sb, kv_ss, kv_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return split::launch<64>(q, k, v, qs, kvs, b, h, s_q, s_k, q_out, k_out, vt_out, st);
  if (d == 128)
    return split::launch<128>(q, k, v, qs, kvs, b, h, s_q, s_k, q_out, k_out, vt_out, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
