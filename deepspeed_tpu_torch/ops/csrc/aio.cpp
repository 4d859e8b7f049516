// Async file I/O engine for tensor swapping (NVMe offload).
//
// The reference (csrc/aio/py_lib/deepspeed_aio_thread.cpp +
// deepspeed_py_aio_handle.cpp) keeps optimizer and parameter shards on NVMe
// and overlaps their reads and writes with compute through libaio.  This
// engine is a std::thread pool doing chunked pread/pwrite: the same overlap
// model (submit returns at once, wait() joins), and chunking across threads
// fills the NVMe queue the way several aio submissions do.  A copy of the
// JAX package's ops/csrc/aio.cpp.
//
// C ABI for ctypes (no PyTorch or pybind11 headers).  Handles are process-global
// int64 ids guarded by a mutex.

#ifndef _GNU_SOURCE
#define _GNU_SOURCE 1  // O_DIRECT
#endif

#include <fcntl.h>
#include <unistd.h>

#ifndef O_DIRECT
#define O_DIRECT 0  // platform without O_DIRECT: silently buffered
#endif

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Job {
  std::vector<std::thread> workers;
  std::atomic<int> status{0};  // 0 ok, else -errno of first failure
  std::atomic<bool> done{false};
};

std::mutex g_mu;
std::map<int64_t, Job*> g_jobs;
int64_t g_next_id = 1;

int rw_chunk_fd(int fd, char* buf, int64_t offset, int64_t nbytes,
                bool write) {
  int64_t done_b = 0;
  while (done_b < nbytes) {
    ssize_t r = write ? ::pwrite(fd, buf + done_b, nbytes - done_b, offset + done_b)
                      : ::pread(fd, buf + done_b, nbytes - done_b, offset + done_b);
    if (r < 0) return -errno;
    if (r == 0) return -EIO;  // short read: file smaller than requested
    done_b += r;
  }
  return 0;
}

int rw_chunk(const char* path, char* buf, int64_t offset, int64_t nbytes,
             bool write) {
  int fd = ::open(path, write ? (O_WRONLY | O_CREAT) : O_RDONLY, 0644);
  if (fd < 0) return -errno;
  int rc = rw_chunk_fd(fd, buf, offset, nbytes, write);
  ::close(fd);
  return rc;
}

// shared fan-out: split [offset, offset+nbytes) across worker threads.
// Chunk boundaries are rounded up to 4096 so O_DIRECT fds keep aligned
// offsets/lengths on every split (the tail stays aligned whenever the
// caller's total nbytes is aligned, which O_DIRECT requires anyway).
template <typename ChunkFn>
int64_t submit_impl(int64_t nbytes, int nthreads, ChunkFn chunk_fn) {
  if (nthreads < 1) nthreads = 1;
  if (nbytes < (int64_t)nthreads * (1 << 20)) {  // <1MB/thread: one thread
    nthreads = 1;
  }
  Job* job = new Job();
  int64_t chunk = (nbytes + nthreads - 1) / nthreads;
  chunk = (chunk + 4095) & ~(int64_t)4095;
  for (int t = 0; t < nthreads; ++t) {
    int64_t off = (int64_t)t * chunk;
    int64_t len = std::min(chunk, nbytes - off);
    if (len <= 0) break;
    job->workers.emplace_back([job, off, len, chunk_fn]() {
      int rc = chunk_fn(off, len);
      if (rc != 0) {
        int expected = 0;
        job->status.compare_exchange_strong(expected, rc);
      }
    });
  }
  std::lock_guard<std::mutex> lk(g_mu);
  int64_t id = g_next_id++;
  g_jobs[id] = job;
  return id;
}

int64_t submit(const char* path, void* buf, int64_t nbytes, int nthreads,
               bool write) {
  std::string p(path);
  return submit_impl(nbytes, nthreads,
                     [p, buf, write](int64_t off, int64_t len) {
                       return rw_chunk(p.c_str(), (char*)buf + off, off, len,
                                       write);
                     });
}

}  // namespace

extern "C" {

int64_t ds_aio_submit_write(const char* path, const void* buf, int64_t nbytes,
                            int nthreads) {
  return submit(path, const_cast<void*>(buf), nbytes, nthreads, true);
}

int64_t ds_aio_submit_read(const char* path, void* buf, int64_t nbytes,
                           int nthreads) {
  return submit(path, buf, nbytes, nthreads, false);
}

// Blocks until the job completes; returns 0 or -errno.  Frees the handle.
int ds_aio_wait(int64_t id) {
  Job* job = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_jobs.find(id);
    if (it == g_jobs.end()) return -EINVAL;
    job = it->second;
    g_jobs.erase(it);
  }
  for (auto& w : job->workers) w.join();
  int rc = job->status.load();
  delete job;
  return rc;
}

// Synchronous convenience wrappers (reference deepspeed_py_aio.cpp sync path).
int ds_aio_write(const char* path, const void* buf, int64_t nbytes,
                 int nthreads) {
  return ds_aio_wait(ds_aio_submit_write(path, buf, nbytes, nthreads));
}

int ds_aio_read(const char* path, void* buf, int64_t nbytes, int nthreads) {
  return ds_aio_wait(ds_aio_submit_read(path, buf, nbytes, nthreads));
}

// ---------------------------------------------------------------------------
// Persistent-fd API (reference deepspeed_py_aio_handle.cpp keeps an open
// handle + pinned buffers per swap file; the per-chunk open/close of the
// path API costs a syscall pair + dentry walk per op).  O_DIRECT bypasses
// the page cache — the reference's default for NVMe — and requires
// 4096-aligned buffer/offset/length; ds_aio_open falls back to buffered
// I/O when the filesystem refuses O_DIRECT, reporting which mode it got.
// ---------------------------------------------------------------------------

// returns fd >= 0, or -errno.  direct=1 requests O_DIRECT (best effort).
int64_t ds_aio_open(const char* path, int for_write, int direct) {
  int flags = for_write ? (O_RDWR | O_CREAT) : O_RDONLY;
  if (direct) {
    int fd = ::open(path, flags | O_DIRECT, 0644);
    if (fd >= 0) return fd;
  }
  int fd = ::open(path, flags, 0644);
  return fd >= 0 ? fd : -errno;
}

int ds_aio_is_direct(int64_t fd) {
  int fl = ::fcntl((int)fd, F_GETFL);
  return fl >= 0 && (fl & O_DIRECT) ? 1 : 0;
}

int ds_aio_close(int64_t fd) { return ::close((int)fd) == 0 ? 0 : -errno; }

// O_DIRECT requires 4096-aligned buffer/offset/length on EVERY op, not just
// at open time (a misaligned tail chunk would fail pread/pwrite with EINVAL
// mid-job).  When an op arrives misaligned on an O_DIRECT fd, drop to
// buffered mode for that fd via fcntl — same data path, page cache back in
// the loop — rather than surfacing a runtime EINVAL from a worker thread.
static void drop_direct_if_misaligned(int64_t fd, const void* buf,
                                      int64_t nbytes, int64_t offset) {
#if O_DIRECT != 0
  if (((uintptr_t)buf | (uint64_t)nbytes | (uint64_t)offset) & 4095) {
    int fl = ::fcntl((int)fd, F_GETFL);
    if (fl >= 0 && (fl & O_DIRECT)) {
      ::fcntl((int)fd, F_SETFL, fl & ~O_DIRECT);
    }
  }
#else
  (void)fd; (void)buf; (void)nbytes; (void)offset;
#endif
}

int64_t ds_aio_submit_pwrite(int64_t fd, const void* buf, int64_t nbytes,
                             int64_t offset, int nthreads) {
  drop_direct_if_misaligned(fd, buf, nbytes, offset);
  char* b = (char*)const_cast<void*>(buf);
  return submit_impl(nbytes, nthreads,
                     [fd, b, offset](int64_t off, int64_t len) {
                       return rw_chunk_fd((int)fd, b + off, offset + off, len,
                                          true);
                     });
}

int64_t ds_aio_submit_pread(int64_t fd, void* buf, int64_t nbytes,
                            int64_t offset, int nthreads) {
  drop_direct_if_misaligned(fd, buf, nbytes, offset);
  char* b = (char*)buf;
  return submit_impl(nbytes, nthreads,
                     [fd, b, offset](int64_t off, int64_t len) {
                       return rw_chunk_fd((int)fd, b + off, offset + off, len,
                                          false);
                     });
}

int ds_aio_pwrite(int64_t fd, const void* buf, int64_t nbytes, int64_t offset,
                  int nthreads) {
  return ds_aio_wait(ds_aio_submit_pwrite(fd, buf, nbytes, offset, nthreads));
}

int ds_aio_pread(int64_t fd, void* buf, int64_t nbytes, int64_t offset,
                 int nthreads) {
  return ds_aio_wait(ds_aio_submit_pread(fd, buf, nbytes, offset, nthreads));
}

}  // extern "C"
