// Native buffered/asynchronous dump writer.
//
// The port's copy of the JAX package's writer (csrc/io_writer.cpp), the
// analogue of the reference's FileIO policy classes (src/util/io/FileIO.h): StandardIOPolicy (synchronous stdio) and
// P2PIOPolicy (double-buffered relay I/O).  Diagnostics dumps and
// checkpoints stream multi-GB blocks; this writer overlaps file output with
// the simulation by queueing buffers to a background thread per open file,
// so the Python host thread returns to dispatching device work immediately.
//
// C ABI (consumed via ctypes from vpic_tpu_torch/native/io.py):
//   vpic_write_file(path, buf, n)          synchronous one-shot write
//   h = vpic_writer_open(path)             async writer handle
//   vpic_writer_write(h, buf, n)           enqueue a copy of buf (async)
//   vpic_writer_close(h)                   flush, join, close; returns bytes
//   vpic_writer_error(h)                   nonzero if any write failed

#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Chunk {
  std::vector<char> data;
};

struct Writer {
  FILE* fp = nullptr;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<Chunk> queue;
  bool done = false;
  bool error = false;
  long long written = 0;

  void run() {
    for (;;) {
      Chunk c;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return done || !queue.empty(); });
        if (queue.empty()) {
          if (done) return;
          continue;
        }
        c = std::move(queue.front());
        queue.pop_front();
      }
      size_t n = fwrite(c.data.data(), 1, c.data.size(), fp);
      {
        std::lock_guard<std::mutex> lk(mu);
        if (n != c.data.size()) error = true;
        written += static_cast<long long>(n);
        cv.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

int vpic_write_file(const char* path, const void* buf, size_t n) {
  FILE* fp = fopen(path, "wb");
  if (!fp) return -1;
  setvbuf(fp, nullptr, _IOFBF, 1 << 22);
  size_t w = fwrite(buf, 1, n, fp);
  fclose(fp);
  return w == n ? 0 : -1;
}

Writer* vpic_writer_open(const char* path) {
  FILE* fp = fopen(path, "wb");
  if (!fp) return nullptr;
  setvbuf(fp, nullptr, _IOFBF, 1 << 22);
  Writer* w = new Writer();
  w->fp = fp;
  w->worker = std::thread([w] { w->run(); });
  return w;
}

int vpic_writer_write(Writer* w, const void* buf, size_t n) {
  if (!w) return -1;
  Chunk c;
  c.data.resize(n);
  memcpy(c.data.data(), buf, n);
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->queue.push_back(std::move(c));
  }
  w->cv.notify_all();
  return 0;
}

long long vpic_writer_close(Writer* w) {
  if (!w) return -1;
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->done = true;
  }
  w->cv.notify_all();
  w->worker.join();
  fclose(w->fp);
  long long out = w->error ? -1 : w->written;
  delete w;
  return out;
}

int vpic_writer_error(Writer* w) {
  if (!w) return 1;
  std::lock_guard<std::mutex> lk(w->mu);
  return w->error ? 1 : 0;
}

}  // extern "C"
