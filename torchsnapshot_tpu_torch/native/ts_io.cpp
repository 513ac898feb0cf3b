// Native I/O runtime for torchsnapshot_tpu.
//
// The reference library has no native code (SURVEY.md §2.9) — it leans on
// aiofiles' thread pool and torch internals. Here the file-I/O and
// slab-packing hot paths are C++: plain C-ABI functions loaded via ctypes
// (ctypes releases the GIL for the duration of every call, so N executor
// threads drive N concurrent pwrite/pread streams at full bandwidth).
//
// Design rules:
//  - C ABI only (no pybind11 in this image); every function is
//    exception-free and returns 0 / -errno.
//  - No allocation of caller-visible memory: callers own all buffers, so
//    the Python side keeps zero-copy memoryview semantics.
//  - Threaded gather-memcpy for slab packing: memory bandwidth on a many-
//    core host is only reachable with multiple streams.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <limits.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <sys/uio.h>
#include <thread>
#include <unistd.h>
#include <vector>

#ifndef O_DIRECT
// Non-Linux libc: no O_DIRECT flag. ts_write_file_crc_direct then opens
// with a zero flag and behaves like the buffered fused write — callers
// treat the path as "supported but not actually direct", which is the
// correct degradation (bytes and CRCs are identical either way).
#define O_DIRECT 0
#endif
#ifndef IOV_MAX
#define IOV_MAX 1024
#endif

namespace {

// Saturate transfer sizes to 1 GiB per syscall (Linux caps rw syscalls at
// 0x7ffff000 bytes anyway; looping also gives EINTR handling a boundary).
constexpr uint64_t kMaxIoChunk = 1ull << 30;

int write_all(int fd, const char* buf, uint64_t len, uint64_t offset) {
  while (len > 0) {
    uint64_t n = len < kMaxIoChunk ? len : kMaxIoChunk;
    ssize_t w = ::pwrite(fd, buf, n, static_cast<off_t>(offset));
    if (w < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    buf += w;
    offset += static_cast<uint64_t>(w);
    len -= static_cast<uint64_t>(w);
  }
  return 0;
}

int read_all(int fd, char* buf, uint64_t len, uint64_t offset) {
  while (len > 0) {
    uint64_t n = len < kMaxIoChunk ? len : kMaxIoChunk;
    ssize_t r = ::pread(fd, buf, n, static_cast<off_t>(offset));
    if (r < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    if (r == 0) return -EIO;  // short file: caller asked past EOF
    buf += r;
    offset += static_cast<uint64_t>(r);
    len -= static_cast<uint64_t>(r);
  }
  return 0;
}

}  // namespace

extern "C" {

// Write `len` bytes to a fresh file at `path` (O_TRUNC). `do_fsync`:
// 0 = none (commit protocol tolerates torn data files; metadata is the
// barrier), 1 = fdatasync before close.
int ts_write_file(const char* path, const void* buf, uint64_t len,
                  int do_fsync) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC | O_CLOEXEC, 0644);
  if (fd < 0) return -errno;
  int rc = write_all(fd, static_cast<const char*>(buf), len, 0);
  if (rc == 0 && do_fsync) {
    if (::fdatasync(fd) != 0) rc = -errno;
  }
  if (::close(fd) != 0 && rc == 0) rc = -errno;
  return rc;
}

// Read exactly `len` bytes at `offset` from `path` into caller's buffer.
int ts_pread_range(const char* path, void* buf, uint64_t len,
                   uint64_t offset) {
  int fd = ::open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return -errno;
  int rc = read_all(fd, static_cast<char*>(buf), len, offset);
  if (::close(fd) != 0 && rc == 0) rc = -errno;
  return rc;
}

int64_t ts_file_size(const char* path) {
  struct stat st;
  if (::stat(path, &st) != 0) return -static_cast<int64_t>(errno);
  return static_cast<int64_t>(st.st_size);
}

// Scatter `n` source buffers into `dst` at `dst_offsets`, using up to
// `n_threads` threads. Work is split by bytes, and a single large source
// region is itself split across threads, so one 1 GiB tensor doesn't
// serialize the pack.
void ts_gather_memcpy(void* dst, const void** srcs, const uint64_t* sizes,
                      const uint64_t* dst_offsets, uint64_t n,
                      int n_threads) {
  uint64_t total = 0;
  for (uint64_t i = 0; i < n; ++i) total += sizes[i];
  if (total == 0) return;
  if (n_threads < 1) n_threads = 1;
  uint64_t per_thread = (total + n_threads - 1) / n_threads;

  auto worker = [&](uint64_t begin, uint64_t end) {
    // [begin, end) in concatenated-byte space.
    uint64_t pos = 0;
    for (uint64_t i = 0; i < n && pos < end; ++i) {
      uint64_t lo = pos, hi = pos + sizes[i];
      pos = hi;
      if (hi <= begin) continue;
      uint64_t s = begin > lo ? begin - lo : 0;
      uint64_t e = (end < hi ? end : hi) - lo;
      if (e <= s) continue;
      std::memcpy(static_cast<char*>(dst) + dst_offsets[i] + s,
                  static_cast<const char*>(srcs[i]) + s, e - s);
    }
  };

  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; ++t) {
    uint64_t begin = per_thread * t;
    if (begin >= total) break;
    uint64_t end = begin + per_thread < total ? begin + per_thread : total;
    threads.emplace_back(worker, begin, end);
  }
  worker(0, per_thread < total ? per_thread : total);
  for (auto& th : threads) th.join();
}

}  // extern "C"

// CRC32-C (Castagnoli) for storage integrity records. The integrity
// pass runs once over every byte a take writes and a restore reads, so
// on slow cores a byte-at-a-time table CRC rivals the I/O it protects:
// use the SSE4.2 crc32 instruction when the CPU has it (runtime
// detected), else slicing-by-8 tables.

namespace {

struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (uint32_t i = 0; i < 256; ++i)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

// Slicing-by-8 (little-endian): 8 bytes per step through 8 tables.
uint32_t crc32c_sw(const unsigned char* p, uint64_t len, uint32_t crc) {
  static const Crc32cTables tables;  // magic static: thread-safe init
  const auto& t = tables.t;
  while (len >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    v ^= crc;
    crc = t[7][v & 0xFF] ^ t[6][(v >> 8) & 0xFF] ^ t[5][(v >> 16) & 0xFF] ^
          t[4][(v >> 24) & 0xFF] ^ t[3][(v >> 32) & 0xFF] ^
          t[2][(v >> 40) & 0xFF] ^ t[1][(v >> 48) & 0xFF] ^
          t[0][(v >> 56) & 0xFF];
    p += 8;
    len -= 8;
  }
  while (len--) crc = t[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return crc;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2"))) uint32_t crc32c_hw(const unsigned char* p,
                                                     uint64_t len,
                                                     uint32_t crc) {
  uint64_t c = crc;
  while (len >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    c = __builtin_ia32_crc32di(c, v);
    p += 8;
    len -= 8;
  }
  crc = static_cast<uint32_t>(c);
  while (len--) crc = __builtin_ia32_crc32qi(crc, *p++);
  return crc;
}

bool crc32c_hw_available() {
  static const bool v = __builtin_cpu_supports("sse4.2");
  return v;
}
#else
uint32_t crc32c_hw(const unsigned char*, uint64_t, uint32_t) { return 0; }
bool crc32c_hw_available() { return false; }
#endif

}  // namespace

extern "C" {

uint32_t ts_crc32c(const void* buf, uint64_t len, uint32_t seed) {
  uint32_t crc = ~seed;
  const unsigned char* p = static_cast<const unsigned char*>(buf);
  crc = crc32c_hw_available() ? crc32c_hw(p, len, crc)
                              : crc32c_sw(p, len, crc);
  return ~crc;
}

// Fused write + integrity pass: write `len` bytes to a fresh file while
// computing the CRC32-C of every `page_size` page (seed 0 each, the
// integrity table's page format) in the same loop — each page is CRC'd
// while its bytes are still cache-hot from the write, and the blob
// makes one pass through memory instead of two. `out_page_crcs` must
// hold ceil(len / page_size) entries (0 pages for an empty blob).
int ts_write_file_crc(const char* path, const void* buf, uint64_t len,
                      uint64_t page_size, uint32_t* out_page_crcs,
                      int do_fsync) {
  if (page_size == 0) return -EINVAL;
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC | O_CLOEXEC, 0644);
  if (fd < 0) return -errno;
  const bool hw = crc32c_hw_available();
  const char* p = static_cast<const char*>(buf);
  uint64_t off = 0;
  int rc = 0;
  uint64_t page = 0;
  while (off < len) {
    uint64_t n = len - off < page_size ? len - off : page_size;
    rc = write_all(fd, p + off, n, off);
    if (rc != 0) break;
    const unsigned char* q = reinterpret_cast<const unsigned char*>(p + off);
    uint32_t crc = 0xFFFFFFFFu;
    crc = hw ? crc32c_hw(q, n, crc) : crc32c_sw(q, n, crc);
    out_page_crcs[page++] = ~crc;
    off += n;
  }
  if (rc == 0 && do_fsync) {
    if (::fdatasync(fd) != 0) rc = -errno;
  }
  if (::close(fd) != 0 && rc == 0) rc = -errno;
  return rc;
}

// Zero-pack vectorized write: gather `n` caller-owned buffers straight
// into a fresh file with pwritev — no staging-buffer pack pass — while
// (optionally) computing the CRC32-C of every `page_size` page of the
// CONCATENATED byte stream, pages crossing iovec boundaries freely.
// `out_page_crcs` may be NULL (plain vectorized write, no integrity
// pass); otherwise it must hold ceil(sum(lens) / page_size) entries.
// Writes go out in cache-sized batches (<= IOV_MAX iovecs each) and
// each batch is CRC'd immediately after its pwritev returns, while the
// bytes are still cache-hot — the same one-memory-pass property as
// ts_write_file_crc, without the pack that used to precede it.
int ts_pwritev_file_crc(const char* path, const void** bufs,
                        const uint64_t* lens, uint64_t n,
                        uint64_t page_size, uint32_t* out_page_crcs,
                        int do_fsync) {
  if (out_page_crcs != nullptr && page_size == 0) return -EINVAL;
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC | O_CLOEXEC, 0644);
  if (fd < 0) return -errno;
  const bool hw = crc32c_hw_available();
  // Batch bound: small enough that the post-write CRC pass still finds
  // the bytes in cache, large enough to amortize the syscall.
  constexpr uint64_t kBatchBytes = 4ull << 20;
  int rc = 0;
  uint64_t off = 0;          // file offset (== bytes fully written)
  uint64_t i = 0;            // current source buffer
  uint64_t part_off = 0;     // progress within bufs[i]
  // Rolling page-CRC state across batches/iovecs.
  uint64_t page = 0;
  uint64_t page_fill = 0;
  uint32_t crc = 0xFFFFFFFFu;
  struct iovec iov[IOV_MAX];
  while (i < n) {
    // Assemble the next batch of iovecs.
    uint64_t bi = i, bpart = part_off, batch_bytes = 0;
    int cnt = 0;
    while (bi < n && cnt < IOV_MAX && batch_bytes < kBatchBytes) {
      uint64_t avail = lens[bi] - bpart;
      if (avail == 0) { ++bi; bpart = 0; continue; }
      uint64_t take = avail < kBatchBytes - batch_bytes
                          ? avail
                          : kBatchBytes - batch_bytes;
      iov[cnt].iov_base =
          const_cast<char*>(static_cast<const char*>(bufs[bi])) + bpart;
      iov[cnt].iov_len = static_cast<size_t>(take);
      ++cnt;
      batch_bytes += take;
      bpart += take;
      if (bpart == lens[bi]) { ++bi; bpart = 0; }
    }
    if (cnt == 0) { i = bi; part_off = bpart; continue; }
    // Write the batch, handling short writes by advancing the iovecs.
    uint64_t written = 0;
    int k = 0;
    while (written < batch_bytes) {
      ssize_t w = ::pwritev(fd, iov + k, cnt - k,
                            static_cast<off_t>(off + written));
      if (w < 0) {
        if (errno == EINTR) continue;
        rc = -errno;
        break;
      }
      written += static_cast<uint64_t>(w);
      uint64_t adv = static_cast<uint64_t>(w);
      while (adv > 0 && k < cnt) {
        if (adv >= iov[k].iov_len) {
          adv -= iov[k].iov_len;
          ++k;
        } else {
          iov[k].iov_base = static_cast<char*>(iov[k].iov_base) + adv;
          iov[k].iov_len -= static_cast<size_t>(adv);
          adv = 0;
        }
      }
    }
    if (rc != 0) break;
    // CRC the batch's bytes (cache-hot), chaining pages across
    // iovec/batch boundaries.
    if (out_page_crcs != nullptr) {
      uint64_t ci = i, cpart = part_off, left = batch_bytes;
      while (left > 0) {
        uint64_t avail = lens[ci] - cpart;
        if (avail == 0) { ++ci; cpart = 0; continue; }
        uint64_t take = avail < left ? avail : left;
        const unsigned char* q =
            static_cast<const unsigned char*>(bufs[ci]) + cpart;
        while (take > 0) {
          uint64_t room = page_size - page_fill;
          uint64_t span = take < room ? take : room;
          crc = hw ? crc32c_hw(q, span, crc) : crc32c_sw(q, span, crc);
          page_fill += span;
          q += span;
          take -= span;
          left -= span;
          cpart += span;
          if (page_fill == page_size) {
            out_page_crcs[page++] = ~crc;
            crc = 0xFFFFFFFFu;
            page_fill = 0;
          }
        }
        if (cpart == lens[ci]) { ++ci; cpart = 0; }
      }
    }
    off += batch_bytes;
    i = bi;
    part_off = bpart;
  }
  if (rc == 0 && out_page_crcs != nullptr && page_fill > 0) {
    out_page_crcs[page++] = ~crc;
  }
  if (rc == 0 && do_fsync) {
    if (::fdatasync(fd) != 0) rc = -errno;
  }
  if (::close(fd) != 0 && rc == 0) rc = -errno;
  return rc;
}

// Page-cache-bypassing fused write for large ALIGNED buffers: open
// O_DIRECT, write the 4096-aligned body straight to the device (the
// trainer never re-reads checkpoint bytes — caching them only evicts
// pages it will), write the unaligned tail through a second buffered
// fd, and compute each `page_size` page's CRC32-C in the same loop.
// `out_page_crcs` may be NULL (no integrity consumer — the plain-write
// path): the CRC pass is skipped entirely, and `page_size` 0 then
// defaults to an internal chunking unit. The caller guarantees `buf`
// is kDirectAlign-aligned; filesystems without O_DIRECT (tmpfs) fail
// the open with EINVAL, which the Python side treats as a sticky
// per-plugin decline back to the buffered path.
constexpr uint64_t kDirectAlign = 4096;

int ts_write_file_crc_direct(const char* path, const void* buf,
                             uint64_t len, uint64_t page_size,
                             uint32_t* out_page_crcs, int do_fsync) {
  if (out_page_crcs != nullptr &&
      (page_size == 0 || page_size % kDirectAlign != 0)) {
    return -EINVAL;
  }
  if (page_size == 0) page_size = 4ull << 20;
  if (page_size % kDirectAlign != 0) return -EINVAL;
  if (reinterpret_cast<uintptr_t>(buf) % kDirectAlign != 0) return -EINVAL;
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC | O_CLOEXEC | O_DIRECT,
                  0644);
  if (fd < 0) return -errno;
  const bool hw = crc32c_hw_available();
  const char* p = static_cast<const char*>(buf);
  const uint64_t body = len / kDirectAlign * kDirectAlign;
  uint64_t off = 0;
  uint64_t page = 0;
  int rc = 0;
  int tail_fd = -1;
  while (off < len) {
    uint64_t n = len - off < page_size ? len - off : page_size;
    uint64_t direct_n = off + n <= body ? n : (body > off ? body - off : 0);
    if (direct_n > 0) {
      rc = write_all(fd, p + off, direct_n, off);
      if (rc != 0) break;
    }
    if (direct_n < n) {
      // Unaligned tail (final page only): buffered fd, same file.
      if (tail_fd < 0) {
        tail_fd = ::open(path, O_WRONLY | O_CLOEXEC);
        if (tail_fd < 0) { rc = -errno; break; }
      }
      rc = write_all(tail_fd, p + off + direct_n, n - direct_n,
                     off + direct_n);
      if (rc != 0) break;
    }
    if (out_page_crcs != nullptr) {
      const unsigned char* q =
          reinterpret_cast<const unsigned char*>(p + off);
      uint32_t crc = 0xFFFFFFFFu;
      crc = hw ? crc32c_hw(q, n, crc) : crc32c_sw(q, n, crc);
      out_page_crcs[page++] = ~crc;
    }
    off += n;
  }
  if (rc == 0 && do_fsync) {
    if (::fdatasync(fd) != 0) rc = -errno;
    if (rc == 0 && tail_fd >= 0 && ::fdatasync(tail_fd) != 0) rc = -errno;
  }
  if (tail_fd >= 0 && ::close(tail_fd) != 0 && rc == 0) rc = -errno;
  if (::close(fd) != 0 && rc == 0) rc = -errno;
  return rc;
}

// Fused read + integrity pass, the mirror of ts_write_file_crc: read
// `len` bytes at `offset` while computing each `page_size` page's
// CRC32-C (seed 0, the integrity table's page format) cache-hot.
int ts_pread_crc(const char* path, void* buf, uint64_t len, uint64_t offset,
                 uint64_t page_size, uint32_t* out_page_crcs) {
  if (page_size == 0) return -EINVAL;
  int fd = ::open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return -errno;
  const bool hw = crc32c_hw_available();
  char* p = static_cast<char*>(buf);
  uint64_t done = 0;
  int rc = 0;
  uint64_t page = 0;
  while (done < len) {
    uint64_t n = len - done < page_size ? len - done : page_size;
    rc = read_all(fd, p + done, n, offset + done);
    if (rc != 0) break;
    const unsigned char* q = reinterpret_cast<const unsigned char*>(p + done);
    uint32_t crc = 0xFFFFFFFFu;
    crc = hw ? crc32c_hw(q, n, crc) : crc32c_sw(q, n, crc);
    out_page_crcs[page++] = ~crc;
    done += n;
  }
  if (::close(fd) != 0 && rc == 0) rc = -errno;
  return rc;
}

}  // extern "C"
