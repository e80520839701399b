// Native async stream writer: overlap host file IO with the card's work.
//
// A copy of ns_tpu/runtime/native/stream_writer.cpp (the code is the JAX
// package's; built for the port by ns_tpu_torch/runtime/native/build.py
// into ns_tpu_torch/_build/). The streaming rollout loop
// (ns_tpu_torch/io/streaming.py) alternates
//   [the card computes chunk k+1]  with  [the host writes chunk k to disk].
// In pure Python the write leg holds the loop (np memmap assignment is a
// synchronous page-cache copy under the GIL), so the card sits idle for
// the IO tail of every chunk. This writer moves the copy+pwrite onto a
// C++ worker thread behind a bounded ring of owned buffers: the Python
// loop hands over (offset, ptr, nbytes), the memcpy into the ring happens
// on the calling thread (cheap, bounded), and the file write proceeds
// concurrently with the next chunk's launches.
//
// The reference's drivers do one giant np.savez at the end of a rollout
// (direct_fd/simulate.py:129-144): no streaming, no overlap.
//
// Plain C ABI for ctypes. Thread-safety contract: one writer handle is
// driven by one producer thread (the Python rollout loop); the consumer is
// the internal worker.
//
// Build: g++ -O2 -shared -fPIC -pthread -std=c++17.

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

struct Job {
  uint64_t offset;
  std::vector<char> data;  // owned copy; freed after pwrite
};

struct Writer {
  int fd = -1;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_push;  // producer waits: queue full
  std::condition_variable cv_pop;   // worker waits: queue empty
  std::deque<Job> queue;
  uint64_t queued_bytes = 0;
  uint64_t max_queued_bytes;
  bool closing = false;
  std::atomic<int> error{0};  // first errno seen by the worker

  explicit Writer(uint64_t max_bytes) : max_queued_bytes(max_bytes) {}
};

void worker_loop(Writer* w) {
  for (;;) {
    Job job;
    {
      std::unique_lock<std::mutex> lk(w->mu);
      w->cv_pop.wait(lk, [w] { return w->closing || !w->queue.empty(); });
      if (w->queue.empty()) return;  // closing and drained
      job = std::move(w->queue.front());
      w->queue.pop_front();
    }
    const char* p = job.data.data();
    uint64_t left = job.data.size(), off = job.offset;
    while (left > 0) {
      ssize_t n = pwrite(w->fd, p, left, static_cast<off_t>(off));
      if (n < 0) {
        int expected = 0;
        w->error.compare_exchange_strong(expected, errno ? errno : -1);
        break;
      }
      p += n;
      off += n;
      left -= static_cast<uint64_t>(n);
    }
    {
      std::lock_guard<std::mutex> lk(w->mu);
      w->queued_bytes -= job.data.size();
    }
    w->cv_push.notify_all();
  }
}

}  // namespace

extern "C" {

// Open `path` for writing (created/truncated) and pre-size it to
// `total_bytes` (0 = don't pre-size). `max_buffer_bytes` bounds the ring
// (producer blocks when exceeded — backpressure, not OOM). Returns an
// opaque handle, or 0 on failure.
void* nsio_open(const char* path, uint64_t total_bytes,
                uint64_t max_buffer_bytes) {
  int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return nullptr;
  if (total_bytes > 0 &&
      ftruncate(fd, static_cast<off_t>(total_bytes)) != 0) {
    close(fd);
    return nullptr;
  }
  auto* w = new Writer(max_buffer_bytes ? max_buffer_bytes
                                        : (uint64_t)256 << 20);
  w->fd = fd;
  w->worker = std::thread(worker_loop, w);
  return w;
}

// Queue nbytes at `offset`. Copies `ptr` into an owned buffer and returns
// immediately (blocks only when the ring is over its byte bound). Returns
// 0 on success, the worker's first errno if the writer already failed.
int nsio_submit(void* handle, uint64_t offset, const void* ptr,
                uint64_t nbytes) {
  auto* w = static_cast<Writer*>(handle);
  if (int e = w->error.load()) return e;
  Job job;
  job.offset = offset;
  job.data.resize(nbytes);
  std::memcpy(job.data.data(), ptr, nbytes);
  {
    std::unique_lock<std::mutex> lk(w->mu);
    // the escape hatch for a single job larger than the whole ring keys
    // on queued_bytes == 0, NOT queue.empty(): a popped-but-still-writing
    // job leaves the queue empty while its bytes are still counted, and
    // admitting the next job then would double the bound
    w->cv_push.wait(lk, [w, nbytes] {
      return w->queued_bytes + nbytes <= w->max_queued_bytes ||
             w->queued_bytes == 0;
    });
    w->queued_bytes += nbytes;
    w->queue.push_back(std::move(job));
  }
  w->cv_pop.notify_one();
  return 0;
}

// Block until every queued write has hit the fd; fdatasync it. Returns 0
// or the first errno.
int nsio_sync(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  {
    std::unique_lock<std::mutex> lk(w->mu);
    w->cv_push.wait(lk, [w] { return w->queued_bytes == 0; });
  }
  if (int e = w->error.load()) return e;
  return fdatasync(w->fd) == 0 ? 0 : errno;
}

// Drain, close, join, free. Returns 0 or the first errno.
int nsio_close(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->closing = true;
  }
  w->cv_pop.notify_all();
  if (w->worker.joinable()) w->worker.join();
  int err = w->error.load();
  if (close(w->fd) != 0 && err == 0) err = errno;
  delete w;
  return err;
}

}  // extern "C"
