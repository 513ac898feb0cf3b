#!/usr/bin/env python3
"""Two design questions of the device pack (``csrc/device_pack.cu``),
measured on one CUDA card.

Run from the root of a checkout: ``python3 chip_pack_probe.py``. It needs
one CUDA card and exits non-zero without one.

1. **Routes.** Three kernels on the same table (the wrapper's tile walk):
   ``VECTOR_SOURCE`` below moves every unit with 16-byte vector loads and
   stores straight from the sources to the slab, several in flight per
   thread; ``BULK_SOURCE`` moves each member's span of a tile into shared
   memory by ``cp.async.bulk`` under an ``mbarrier`` and the tile out by
   one more (aligned spans only: one block of one issuing thread per tile);
   the pack kernel itself does the latter for aligned spans and the former's
   register path, into shared memory, for the rest. Each is held bit for
   bit against ``pack_plain`` and timed in turns (vector, bulk, pack, pack,
   bulk, vector): its kernel's device time from the profiler (the pack's
   table copy apart) and back to back, at the three layouts of
   ``chip_smoke.pack_layouts``.
2. **Where the table copy is queued.** ``pack_async`` queues the table's
   copy to the card on a side stream, the pack stream's wait for it, the
   kernel, and the events that say when a pinned table slot is free again,
   all in one call of ``ts_pack`` (C). ``TorchStreamPack`` below queues the
   same work from Python with ``torch.cuda.Stream`` and ``torch.cuda.Event``
   and launches the kernel alone (``KERNEL_SOURCE``: the same
   ``device_pack.cu``, one entry more). Both are given the slab's
   ``PackLayout``, as the batcher gives it, held bit for bit against
   ``pack_plain`` and timed in turns (C, torch, torch, C) by the host's us
   a call, the card's ms behind a spin and back to back, at the three
   layouts.

Prints one line per measurement and a JSON record last.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

BULK_SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int64_t kTileBytes = 16 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One tile of the pack's table: each member's span of it copied into shared
// memory by cp.async.bulk, completing on one mbarrier, then the tile copied
// out by one cp.async.bulk. Every span must be 16-byte aligned, in the slab
// and at its source, and a multiple of 16 bytes.
__global__ void __launch_bounds__(32) bulk_tiles(const int64_t* __restrict__ offsets,
                                                 const int64_t* __restrict__ srcs,
                                                 const int64_t* __restrict__ tile_first,
                                                 int64_t total, uint8_t* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t buf[];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x != 0) return;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTileBytes;
  const int64_t t1 = t0 + kTileBytes < total ? t0 + kTileBytes : total;
  const uint32_t b = smem_u32(&bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
               "r"(static_cast<uint32_t>(t1 - t0)) : "memory");
  int j = static_cast<int>(tile_first[blockIdx.x]);
  for (int64_t p = t0; p < t1; ++j) {
    const int64_t e = offsets[j + 1] < t1 ? offsets[j + 1] : t1;
    if (e > p) {
      const uint8_t* s = reinterpret_cast<const uint8_t*>(srcs[j]) + (p - offsets[j]);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
              smem_u32(buf + (p - t0))),
          "l"(reinterpret_cast<uint64_t>(s)), "r"(static_cast<uint32_t>(e - p)), "r"(b)
          : "memory");
      p = e;
    }
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred P1;\nmbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\nselp.b32 %0, 1, 0, P1;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(0u)
        : "memory");
  }
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
                   reinterpret_cast<uint64_t>(out + t0)),
               "r"(smem_u32(buf)), "r"(static_cast<uint32_t>(t1 - t0)) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

}  // namespace

extern "C" int probe_bulk_pack(const void* table, int n, int64_t total, void* out, void* stream) {
  const int64_t tiles = (total + kTileBytes - 1) / kTileBytes;
  const int64_t* offsets = static_cast<const int64_t*>(table);
  bulk_tiles<<<static_cast<unsigned>(tiles), 32, kTileBytes, static_cast<cudaStream_t>(stream)>>>(
      offsets, offsets + n + 1, offsets + 2 * n + 1, total, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""

VECTOR_SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnitsPerThread = 4;
constexpr int kTileUnits = kThreads * kUnitsPerThread;
constexpr int64_t kTileBytes = int64_t{kTileUnits} * 16;
constexpr int kCached = kTileUnits;

struct Tile {
  const int64_t* offsets;
  const int64_t* srcs;
  int count;
  const int64_t* begin;
  const int64_t* src;
  __device__ __forceinline__ int64_t begin_of(int j) const { return j <= count ? begin[j] : offsets[j]; }
  __device__ __forceinline__ const uint8_t* src_of(int j) const {
    return reinterpret_cast<const uint8_t*>(j < count ? src[j] : srcs[j]);
  }
};

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

__device__ __forceinline__ uint4 straddle(const Tile& tile, int j, int64_t pos, int64_t total) {
  uint64_t w0 = 0, w1 = 0;
  int64_t b = tile.begin_of(j);
  int64_t e = tile.begin_of(j + 1);
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
    if (q < 8) w0 |= byte << (8 * q); else w1 |= byte << (8 * (q - 8));
  }
  return make_uint4(static_cast<uint32_t>(w0), static_cast<uint32_t>(w0 >> 32), static_cast<uint32_t>(w1),
                    static_cast<uint32_t>(w1 >> 32));
}

// The pack as 16-byte vector loads and stores, several in flight per
// thread, straight from the sources to the slab: the same tile walk, no
// shared staging and no bulk copies.
__global__ void __launch_bounds__(kThreads) vector_tiles(const int64_t* __restrict__ offsets,
                                                         const int64_t* __restrict__ srcs,
                                                         const int64_t* __restrict__ tile_first, int n,
                                                         int64_t total, uint8_t* __restrict__ out) {
  __shared__ __align__(16) int own[kTileUnits];
  __shared__ int64_t begin[kCached + 1];
  __shared__ int64_t src[kCached];
  __shared__ int warp_max[kThreads / 32];
  const int tid = threadIdx.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTileBytes;
  const int first = static_cast<int>(tile_first[blockIdx.x]);
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
  __syncthreads();
  for (int j = 1 + tid; j < k; j += kThreads) {
    const int64_t u = (tile.begin_of(j) - t0 + 15) >> 4;
    if (u < kTileUnits && (j + 1 == k || ((tile.begin_of(j + 1) - t0 + 15) >> 4) != u)) own[u] = j;
  }
  __syncthreads();
  {
    int4 v = reinterpret_cast<int4*>(own)[tid];
    v.y = max(v.x, v.y);
    v.z = max(v.y, v.z);
    v.w = max(v.z, v.w);
    const int lane = tid & 31;
    const int warp = tid >> 5;
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
  const int64_t t1 = t0 + kTileBytes < total ? t0 + kTileBytes : total;
  uint4 lo[kUnitsPerThread];
  uint4 hi[kUnitsPerThread];
  int shift[kUnitsPerThread];
  int owner[kUnitsPerThread];
#pragma unroll
  for (int i = 0; i < kUnitsPerThread; ++i) {
    const int u = i * kThreads + tid;
    const int64_t pos = t0 + 16 * int64_t{u};
    shift[i] = -2;
    if (pos >= t1) continue;
    const int j = own[u];
    owner[i] = j;
    const int64_t b = tile.begin_of(j);
    if (pos + 16 > tile.begin_of(j + 1)) {
      shift[i] = -1;
      continue;
    }
    const uintptr_t a = reinterpret_cast<uintptr_t>(tile.src_of(j)) + static_cast<uintptr_t>(pos - b);
    const int ks = static_cast<int>(a & 15);
    const uint4* word = reinterpret_cast<const uint4*>(a - ks);
    shift[i] = ks;
    lo[i] = __ldg(word);
    if (ks) hi[i] = __ldg(word + 1);
  }
#pragma unroll
  for (int i = 0; i < kUnitsPerThread; ++i) {
    if (shift[i] == -2) continue;
    const int64_t pos = t0 + 16 * int64_t{i * kThreads + tid};
    uint4 v;
    if (shift[i] == -1) {
      v = straddle(tile, owner[i], pos, total);
    } else if (shift[i] == 0) {
      v = lo[i];
    } else {
      v = shift_bytes(lo[i], hi[i], shift[i]);
    }
    *reinterpret_cast<uint4*>(out + pos) = v;
  }
}

}  // namespace

extern "C" int probe_vector_pack(const void* table, int n, int64_t total, void* out, void* stream) {
  const int64_t tiles = (total + kTileBytes - 1) / kTileBytes;
  const int64_t* offsets = static_cast<const int64_t*>(table);
  vector_tiles<<<static_cast<unsigned>(tiles), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      offsets, offsets + n + 1, offsets + 2 * n + 1, n, total, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""


# The pack kernel of csrc/device_pack.cu launched alone, on a table already
# on the card.
KERNEL_SOURCE = r"""
#include "device_pack.cu"

extern "C" int probe_kernel_pack(const void* table, int n, int64_t total, void* out, void* stream) {
  const int64_t tiles = (total + kTileBytes - 1) / kTileBytes;
  const int64_t* offsets = static_cast<const int64_t*>(table);
  pack_tiles<<<static_cast<unsigned>(tiles), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      offsets, offsets + n + 1, offsets + 2 * n + 1, n, total, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""

def log(msg: str) -> None:
    print(msg, flush=True)


def build_probes() -> dict:
    """Compile the probe's three sources, one nvcc each, started together;
    returns their entry points by name."""
    from torchsnapshot_tpu_torch.ops import kernels

    out_dir = os.path.join(kernels.CSRC_DIR, "build")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, source in (("vector", VECTOR_SOURCE), ("bulk", BULK_SOURCE), ("kernel", KERNEL_SOURCE)):
        src = os.path.join(out_dir, f"probe_{name}_pack.cu")
        lib_path = os.path.join(out_dir, f"libprobe_{name}_pack.so")
        with open(src, "w") as f:
            f.write(source)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC_DIR, "-o", lib_path, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                       lib_path)
    libs = {}
    for name, (proc, lib_path) in procs.items():
        text, _ = proc.communicate()
        for line in text.splitlines():
            if ("registers" in line or "spill" in line) and name != "kernel":
                log(f"ptxas probe {name}: {line.strip()}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} probe:\n{text}")
        lib = ctypes.CDLL(lib_path)
        fn = getattr(lib, f"probe_{name}_pack")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def kernel_ms(fn, iters: int) -> "float | None":
    """The tile kernel's mean card ms over ``iters`` calls of ``fn``, from
    the profiler's kernel records; None where it did not record one
    kernel a call (it sometimes loses them in a long process)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and "_tiles" in e.name]
    return sum(spans) / 1e3 / iters if len(spans) == iters else None


def routes(probes: dict) -> list:
    """The three routes on one table per layout, in turns; returns one
    record per layout."""
    import torch

    from chip_smoke import HBM_BYTES_PER_S, cuda_ms, pack_layouts
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    lib = dp._library()
    out = []
    for label, specs in pack_layouts(0):
        table, total, members = dp.build_table(specs)
        n = len(members)
        srcs, sizes = table[n + 1 : 2 * n + 1], table[1 : n + 1] - table[:n]
        aligned = not (total % 16 or (srcs % 16).any() or (sizes % 16).any())
        host = torch.from_numpy(table).pin_memory()
        table_dev = host.cuda()
        pack_table = torch.empty_like(table_dev)
        stream = torch.cuda.current_stream().cuda_stream
        copy_stream = torch.cuda.Stream()
        copied, used = lib.ts_pack_event_create(), lib.ts_pack_event_create()
        names = ["vector", "bulk", "pack"] if aligned else ["vector", "pack"]
        dst = {name: torch.empty(-(-total // 16) * 16, dtype=torch.uint8, device="cuda") for name in names}
        launch = {
            "vector": lambda: probes["vector"](table_dev.data_ptr(), n, total, dst["vector"].data_ptr(), stream),
            "bulk": lambda: probes["bulk"](table_dev.data_ptr(), n, total, dst["bulk"].data_ptr(), stream),
            "pack": lambda: lib.ts_pack(host.data_ptr(), pack_table.data_ptr(), n, total, dp.TILE_BYTES,
                                        dst["pack"].data_ptr(), stream, copy_stream.cuda_stream, copied, used),
        }
        plain = dp.pack_plain(specs)
        for name in names:
            if launch[name]() != 0:
                raise RuntimeError(f"{name} launch failed")
            torch.cuda.synchronize()
            if not torch.equal(dst[name][:total], plain):
                raise AssertionError(f"the {name} route differs from the plain version at {label}")
        kernel = {name: [] for name in names}
        back_to_back = {name: [] for name in names}
        for name in names + names[::-1]:
            kernel[name].append(kernel_ms(launch[name], iters=50))
            back_to_back[name].append(cuda_ms(launch[name], iters=50, warmup=5))
        bound_ms = 2 * total / HBM_BYTES_PER_S * 1e3
        rec = {"layout": label, "bytes": total, "bound_ms": bound_ms,
               "kernel_ms": {k: None if None in v else statistics.mean(v) for k, v in kernel.items()},
               "kernel_turns": kernel, "ms": {k: statistics.mean(v) for k, v in back_to_back.items()}}
        log(f"route {label}: {n} members, {total / 1e6:.3f} MB, bound {bound_ms:.4f} ms; kernel alone " + ", ".join(
            f"{k} {v:.4f} ms ({bound_ms / v:.1%})" if v else f"{k} not measured (the profiler lost kernels)"
            for k, v in rec["kernel_ms"].items())
            + "; back to back (the pack with its table copy, one table for every call) " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in rec["ms"].items()) + f"; turns {kernel}; all bit-identical to the plain "
            f"version")
        out.append(rec)
        del table_dev, pack_table, host, dst, plain, members, specs
    torch.cuda.empty_cache()
    return out


class TorchStreamPack:
    """``pack_async`` given a layout, with its table copy, the side
    stream, the wait and the slot events queued from Python by
    ``torch.cuda.Stream`` and ``torch.cuda.Event``, and the kernel launched
    alone: pinned table slots reused once their kernel has run, oldest
    first, as ``ops/device_pack.py``'s ``_PinnedTables`` reuses them."""

    def __init__(self, kernel) -> None:
        import torch

        self._kernel = kernel
        self._free = collections.deque()
        self._stream = torch.cuda.Stream()

    def __call__(self, specs, layout):
        import torch

        from torchsnapshot_tpu_torch.ops import device_pack as dp

        members = [t for t, _ in specs]
        size, n, total = layout.table.size, layout.n, layout.total
        out = torch.empty(-(-total // 16) * 16, dtype=torch.uint8, device=layout.device)
        slot = self._free.popleft() if self._free and self._free[0][3].query() else None
        if slot is None:
            slot = [torch.empty(0, dtype=torch.int64, pin_memory=True), None, torch.cuda.Event(), torch.cuda.Event()]
        if slot[0].numel() < size:
            slot[0] = torch.empty(size, dtype=torch.int64, pin_memory=True)
            slot[1] = torch.empty(size, dtype=torch.int64, device=layout.device)
        view = slot[0].numpy()
        view[:size] = layout.table
        layout.addresses(members, out=view[n + 1 : 2 * n + 1])
        stream = torch.cuda.current_stream()
        with torch.cuda.stream(self._stream):
            slot[1][:size].copy_(slot[0][:size], non_blocking=True)
            slot[2].record()
        stream.wait_event(slot[2])
        err = self._kernel(slot[1].data_ptr(), n, total, out.data_ptr(), stream.cuda_stream)
        slot[3].record(stream)
        self._free.append(slot)
        if err != 0:
            raise RuntimeError(f"probe pack: CUDA error {err} at launch")
        dp.launch_counts["device_pack"] += 1
        return out[:total]


def host_routes(probes: dict) -> list:
    """``pack_async`` (its queueing in C) against ``TorchStreamPack`` at the
    three layouts, given the slab's layout, in turns C, torch, torch, C;
    returns one record per layout."""
    import torch

    from chip_smoke import PACK_HOLD_CYCLES, cuda_ms, held_times, pack_layouts
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    torch_pack = TorchStreamPack(probes["kernel"])
    out = []
    for label, specs in pack_layouts(0):
        layout, members = dp.PackLayout.from_specs(specs)
        lspecs = list(zip(members, (r for _, r in specs)))
        calls = {"C": lambda: dp.pack_async(lspecs, layout=layout), "torch": lambda: torch_pack(lspecs, layout)}
        plain = dp.pack_plain(specs)
        for name, fn in calls.items():
            if not torch.equal(fn(), plain):
                raise AssertionError(f"the {name} queueing differs from the plain version at {label}")
            # Once unmeasured: the calls queued behind the spin take a slot each.
            held_times(fn, hold_cycles=PACK_HOLD_CYCLES)
        turns = {name: {"host_us": [], "device_ms": [], "ms": []} for name in calls}
        for name in ("C", "torch", "torch", "C"):
            device_ms, host_us = held_times(calls[name], hold_cycles=PACK_HOLD_CYCLES)
            turns[name]["host_us"].append(host_us)
            turns[name]["device_ms"].append(device_ms)
            turns[name]["ms"].append(cuda_ms(calls[name], iters=20, warmup=2))
        rec = {"layout": label, "members": len(specs), "turns": turns}
        log(f"queueing {label}: " + "; ".join(
            f"{name} host {', '.join(f'{v:.1f}' for v in t['host_us'])} us a call, card "
            f"{', '.join(f'{v:.4f}' for v in t['device_ms'])} ms, back to back "
            f"{', '.join(f'{v:.4f}' for v in t['ms'])} ms" for name, t in turns.items())
            + "; both bit-identical to the plain version")
        out.append(rec)
        del specs, lspecs, members, plain
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_pack_probe: no CUDA card; nothing run", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "torchsnapshot_tpu_torch")):
        print("chip_pack_probe: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import card_line

    card = card_line()
    log(card)
    probes = build_probes()
    record = {"card": card, "routes": routes(probes), "queueing": host_routes(probes)}
    print(json.dumps({"pack_probe": record}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
