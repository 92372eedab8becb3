// High-rate host sampler: RAPL energy + CPU jiffies + memory, on a native
// thread into a preallocated ring buffer.
//
// Rationale (SURVEY.md §5 tracing): the reference samples host CPU/memory
// from a *Python* loop at ~1.1 s (experiment/RunnerConfig.py:153-178) because
// that's what the GIL makes practical; its GPU power sampler is an external
// root subprocess at 100 ms. This native sampler reads
// /sys/class/powercap/*/energy_uj and /proc/stat at kHz rates with
// microsecond timestamps and zero Python involvement between start and stop,
// so the measurement window's energy integral has none of the interpreter's
// scheduling jitter. Bound via ctypes (no pybind11 needed).
//
// C ABI:
//   sampler_create(period_us, capacity, rapl_glob) -> handle (0 on error)
//   sampler_start(h)  / sampler_stop(h)
//   sampler_count(h)                  -> samples captured (clamped to capacity)
//   sampler_read(h, out, max_rows)    -> rows copied; each row is 5 doubles:
//       [t_s, energy_uj_total, cpu_busy_jiffies, cpu_total_jiffies, mem_avail_kb]
//   sampler_destroy(h)

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <glob.h>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Row {
  double t_s;
  double energy_uj;
  double cpu_busy;
  double cpu_total;
  double mem_avail_kb;
};

double read_file_ll(const char* path) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1.0;
  long long v = -1;
  if (std::fscanf(f, "%lld", &v) != 1) v = -1;
  std::fclose(f);
  return static_cast<double>(v);
}

struct Sampler {
  long period_us;
  std::vector<std::string> rapl_paths;
  std::vector<Row> ring;
  std::atomic<uint64_t> count{0};
  std::atomic<bool> running{false};
  std::thread thread;
  std::chrono::steady_clock::time_point t0;

  void discover_rapl(const char* pattern) {
    glob_t g;
    std::memset(&g, 0, sizeof(g));
    if (glob(pattern, 0, nullptr, &g) == 0) {
      for (size_t i = 0; i < g.gl_pathc; ++i) {
        std::string p = std::string(g.gl_pathv[i]) + "/energy_uj";
        if (read_file_ll(p.c_str()) >= 0) rapl_paths.push_back(p);
      }
    }
    globfree(&g);
  }

  Row sample_once() {
    Row r{};
    r.t_s = std::chrono::duration<double>(
                std::chrono::steady_clock::now() - t0)
                .count();
    double uj = 0.0;
    bool any = false;
    for (const auto& p : rapl_paths) {
      double v = read_file_ll(p.c_str());
      if (v >= 0) {
        uj += v;
        any = true;
      }
    }
    r.energy_uj = any ? uj : -1.0;

    // /proc/stat first line: cpu user nice system idle iowait irq softirq ...
    FILE* f = std::fopen("/proc/stat", "r");
    r.cpu_busy = r.cpu_total = -1.0;
    if (f) {
      long long u = 0, n = 0, s = 0, idle = 0, iow = 0, irq = 0, sirq = 0;
      if (std::fscanf(f, "cpu %lld %lld %lld %lld %lld %lld %lld", &u, &n, &s,
                      &idle, &iow, &irq, &sirq) >= 4) {
        r.cpu_busy = static_cast<double>(u + n + s + irq + sirq);
        r.cpu_total = r.cpu_busy + static_cast<double>(idle + iow);
      }
      std::fclose(f);
    }

    f = std::fopen("/proc/meminfo", "r");
    r.mem_avail_kb = -1.0;
    if (f) {
      char key[64];
      long long kb;
      while (std::fscanf(f, "%63s %lld kB\n", key, &kb) == 2) {
        if (std::strcmp(key, "MemAvailable:") == 0) {
          r.mem_avail_kb = static_cast<double>(kb);
          break;
        }
      }
      std::fclose(f);
    }
    return r;
  }

  void loop() {
    const auto period = std::chrono::microseconds(period_us);
    auto next = std::chrono::steady_clock::now();
    while (running.load(std::memory_order_relaxed)) {
      Row r = sample_once();
      uint64_t i = count.load(std::memory_order_relaxed);
      ring[i % ring.size()] = r;
      count.store(i + 1, std::memory_order_release);
      // Resync after stalls: if sampling ever overruns the period (busy
      // machine — exactly when we're measuring), don't try to amortise the
      // deficit by spinning at max rate; skip the missed slots.
      next += period;
      auto now = std::chrono::steady_clock::now();
      if (next < now) next = now;
      std::this_thread::sleep_until(next);
    }
  }
};

}  // namespace

extern "C" {

void* sampler_create(long period_us, long capacity, const char* rapl_glob) {
  if (period_us < 100 || capacity < 16) return nullptr;
  auto* s = new (std::nothrow) Sampler();
  if (!s) return nullptr;
  s->period_us = period_us;
  s->ring.resize(static_cast<size_t>(capacity));
  s->discover_rapl(rapl_glob && rapl_glob[0]
                       ? rapl_glob
                       : "/sys/class/powercap/intel-rapl:*");
  return s;
}

void sampler_start(void* h) {
  auto* s = static_cast<Sampler*>(h);
  if (!s || s->running.load()) return;
  s->count.store(0);
  s->t0 = std::chrono::steady_clock::now();
  s->running.store(true);
  s->thread = std::thread([s] { s->loop(); });
}

void sampler_stop(void* h) {
  auto* s = static_cast<Sampler*>(h);
  if (!s || !s->running.load()) return;
  s->running.store(false);
  if (s->thread.joinable()) s->thread.join();
  // Always close the window with a final reading so even windows shorter
  // than the period yield a [first, last] pair to difference.
  Row r = s->sample_once();
  uint64_t i = s->count.load(std::memory_order_relaxed);
  s->ring[i % s->ring.size()] = r;
  s->count.store(i + 1, std::memory_order_release);
}

long sampler_count(void* h) {
  auto* s = static_cast<Sampler*>(h);
  if (!s) return 0;
  uint64_t c = s->count.load(std::memory_order_acquire);
  uint64_t cap = s->ring.size();
  return static_cast<long>(c < cap ? c : cap);
}

long sampler_read(void* h, double* out, long max_rows) {
  auto* s = static_cast<Sampler*>(h);
  if (!s || !out || max_rows <= 0) return 0;
  uint64_t total = s->count.load(std::memory_order_acquire);
  uint64_t cap = s->ring.size();
  uint64_t have = total < cap ? total : cap;
  uint64_t n = have < static_cast<uint64_t>(max_rows)
                   ? have
                   : static_cast<uint64_t>(max_rows);
  // Oldest-first: when wrapped, start after the newest slot.
  uint64_t start = total <= cap ? 0 : total % cap;
  for (uint64_t i = 0; i < n; ++i) {
    const Row& r = s->ring[(start + i) % cap];
    out[i * 5 + 0] = r.t_s;
    out[i * 5 + 1] = r.energy_uj;
    out[i * 5 + 2] = r.cpu_busy;
    out[i * 5 + 3] = r.cpu_total;
    out[i * 5 + 4] = r.mem_avail_kb;
  }
  return static_cast<long>(n);
}

// Synchronous one-shot reading (5 doubles) — lets the binding snapshot the
// window edges independently of the ring buffer, so cumulative-counter
// deltas (energy, jiffies) survive a ring wrap on long runs.
void sampler_snapshot(void* h, double* out5) {
  // Only meaningful between sampler_start and sampler_destroy (t0 is set by
  // start); callers snapshot right after start and right after stop.
  auto* s = static_cast<Sampler*>(h);
  if (!s || !out5) return;
  Row r = s->sample_once();
  out5[0] = r.t_s;
  out5[1] = r.energy_uj;
  out5[2] = r.cpu_busy;
  out5[3] = r.cpu_total;
  out5[4] = r.mem_avail_kb;
}

int sampler_has_rapl(void* h) {
  auto* s = static_cast<Sampler*>(h);
  return s && !s->rapl_paths.empty() ? 1 : 0;
}

void sampler_destroy(void* h) {
  auto* s = static_cast<Sampler*>(h);
  if (!s) return;
  sampler_stop(s);
  delete s;
}

}  // extern "C"
