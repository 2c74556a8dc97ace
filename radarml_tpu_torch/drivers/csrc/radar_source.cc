// Native radar scan source: a lock-striped ring buffer with a producer
// thread, feeding host-pinned scan cubes to the Python driver layer at
// sensor cadence.
//
// Role: the reference's ingest path is the Walabot vendor C SDK
// (reference predict.py:168-216 Trigger/GetRawImage through the
// WalabotAPI wheel). CI has no radar hardware, so this shim plays that
// part natively: it either synthesizes scan cubes (planted Gaussian
// targets + exponential clutter, mirroring data/synthetic.py) or
// replays a caller-provided pool of recorded cubes, in both cases on a
// background thread at a configurable scan period so the consumer sees
// real-sensor timing. The Python side (drivers/native.py) wraps this
// with ctypes and adapts it to the RadarDriver session protocol.
//
// Design notes:
// * Single-producer/single-consumer ring with mutex+condvar handoff;
//   slots carry a sequence number so the consumer can detect drops
//   when it falls behind (the producer never blocks — newest-wins,
//   like a real sensor).
// * Synthetic generation uses a SplitMix64 PRNG and writes directly
//   into the slot buffer; one scan of the default 22x31x176 arena is
//   ~480 KB, well under L2, so generation is memory-bandwidth-trivial
//   compared to the scan period it simulates.

#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9e3779b97f4a7c15ull);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
  }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  double expo(double scale) {
    double u = uniform();
    if (u <= 0.0) u = 1e-12;
    return -scale * std::log(u);
  }
  int range(int lo, int hi) {  // [lo, hi)
    return lo + static_cast<int>(next() % static_cast<uint64_t>(hi - lo));
  }
};

struct Target {
  int i, j, k;
  float amplitude;
};

constexpr int kMaxTargets = 8;

struct Slot {
  std::vector<float> cube;
  Target targets[kMaxTargets];
  int n_targets = 0;
  uint64_t seq = 0;
  bool full = false;
};

struct ClassSig {
  double t_sd, p_sd, r_sd, amp;
  int lobes, gap;
};

// Mirrors data/synthetic.py _SIGNATURES (person, dog, cat).
const ClassSig kSigs[3] = {
    {2.5, 3.5, 6.0, 230.0, 3, 14},
    {1.6, 2.2, 4.0, 190.0, 2, 9},
    {1.0, 1.4, 2.5, 150.0, 1, 0},
};

class RadarSource {
 public:
  RadarSource(int nx, int ny, int nz, int capacity, uint64_t seed,
              double scan_period_us, int mode)
      : nx_(nx), ny_(ny), nz_(nz),
        cube_len_(static_cast<size_t>(nx) * ny * nz),
        capacity_(capacity < 2 ? 2 : capacity),
        period_us_(scan_period_us), mode_(mode), rng_(seed) {
    slots_.resize(capacity_);
    for (auto& s : slots_) s.cube.resize(cube_len_);
  }

  ~RadarSource() { stop(); }

  void load_pool(const float* cubes, const float* targets,
                 const int* n_targets, int n_cubes) {
    pool_.assign(cubes, cubes + cube_len_ * n_cubes);
    pool_targets_.assign(n_cubes * kMaxTargets, Target{0, 0, 0, 0.f});
    pool_ntargets_.assign(n_targets, n_targets + n_cubes);
    for (int c = 0; c < n_cubes; ++c) {
      for (int t = 0; t < n_targets[c] && t < kMaxTargets; ++t) {
        const float* row = targets + (c * kMaxTargets + t) * 4;
        pool_targets_[c * kMaxTargets + t] = Target{
            static_cast<int>(row[0]), static_cast<int>(row[1]),
            static_cast<int>(row[2]), row[3]};
      }
    }
    pool_count_ = n_cubes;
  }

  void start() {
    if (running_.exchange(true)) return;
    producer_ = std::thread([this] { run(); });
  }

  void stop() {
    if (!running_.exchange(false)) return;
    cv_.notify_all();
    if (producer_.joinable()) producer_.join();
  }

  // Blocking pop of the oldest unread scan. Returns 1 on success,
  // 0 on timeout, -1 if stopped and drained.
  int next(float* out_cube, float* out_targets, int max_targets,
           int* out_n, uint64_t* out_seq, int timeout_us) {
    std::unique_lock<std::mutex> lk(mu_);
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::microseconds(timeout_us);
    while (count_ == 0) {
      if (!running_ && count_ == 0) return -1;
      if (cv_.wait_until(lk, deadline) == std::cv_status::timeout)
        return 0;
    }
    Slot& s = slots_[tail_];
    std::memcpy(out_cube, s.cube.data(), cube_len_ * sizeof(float));
    int n = s.n_targets < max_targets ? s.n_targets : max_targets;
    for (int t = 0; t < n; ++t) {
      out_targets[t * 4 + 0] = static_cast<float>(s.targets[t].i);
      out_targets[t * 4 + 1] = static_cast<float>(s.targets[t].j);
      out_targets[t * 4 + 2] = static_cast<float>(s.targets[t].k);
      out_targets[t * 4 + 3] = s.targets[t].amplitude;
    }
    *out_n = n;
    *out_seq = s.seq;
    s.full = false;
    tail_ = (tail_ + 1) % capacity_;
    --count_;
    return 1;
  }

  uint64_t produced() const { return produced_.load(); }
  uint64_t dropped() const { return dropped_.load(); }

 private:
  void run() {
    auto next_tick = std::chrono::steady_clock::now();
    Slot scratch;
    scratch.cube.resize(cube_len_);
    while (running_) {
      // Generate outside the lock and publish by swapping buffers: with
      // no scan period the producer would otherwise hold mu_ almost
      // all the time and starve a consumer woken on cv_.
      fill(scratch);
      {
        std::lock_guard<std::mutex> lk(mu_);
        Slot& s = slots_[head_];
        if (s.full) {
          // Consumer behind: overwrite oldest (advance tail).
          s.full = false;
          tail_ = (tail_ + 1) % capacity_;
          --count_;
          dropped_.fetch_add(1);
        }
        s.cube.swap(scratch.cube);
        std::memcpy(s.targets, scratch.targets, sizeof(s.targets));
        s.n_targets = scratch.n_targets;
        s.seq = produced_.fetch_add(1);
        s.full = true;
        head_ = (head_ + 1) % capacity_;
        ++count_;
      }
      cv_.notify_one();
      if (period_us_ > 0) {
        next_tick += std::chrono::microseconds(
            static_cast<int64_t>(period_us_));
        std::this_thread::sleep_until(next_tick);
      }
    }
  }

  void fill(Slot& s) {
    if (mode_ == 1 && pool_count_ > 0) {
      int c = static_cast<int>(produced_.load() % pool_count_);
      std::memcpy(s.cube.data(), pool_.data() + cube_len_ * c,
                  cube_len_ * sizeof(float));
      s.n_targets = pool_ntargets_[c];
      for (int t = 0; t < s.n_targets && t < kMaxTargets; ++t)
        s.targets[t] = pool_targets_[c * kMaxTargets + t];
      return;
    }
    synth(s);
  }

  void synth(Slot& s) {
    // Separable blob: exp(-(di+dj+dk)) = ex[i]·ey[j]·ezl[k], so the
    // fill is multiply-adds with O(X+Y+Z·lobes) transcendentals
    // instead of O(X·Y·Z); speckle noise draws from a precomputed
    // 4096-entry exponential table (one PRNG step per voxel, no log).
    const ClassSig& sig = kSigs[rng_.range(0, 3)];
    int ti = rng_.range(3, nx_ - 3);
    int tj = rng_.range(3, ny_ - 3);
    int tk = rng_.range(nz_ / 8, nz_ - nz_ / 6);
    float* cube = s.cube.data();

    if (expo_table_.empty()) {
      expo_table_.resize(kExpoTableSize);
      for (int t = 0; t < kExpoTableSize; ++t) {
        const double u = (t + 0.5) / kExpoTableSize;
        expo_table_[t] = static_cast<float>(-8.0 * std::log(u));
      }
    }
    ex_.resize(nx_);
    ey_.resize(ny_);
    ezl_.resize(nz_);
    decay_.resize(nz_);
    const double inv_t = 1.0 / (2 * sig.t_sd * sig.t_sd);
    const double inv_p = 1.0 / (2 * sig.p_sd * sig.p_sd);
    const double inv_r = 1.0 / (2 * sig.r_sd * sig.r_sd);
    for (int i = 0; i < nx_; ++i)
      ex_[i] = static_cast<float>(std::exp(-(i - ti) * (i - ti) * inv_t));
    for (int j = 0; j < ny_; ++j)
      ey_[j] = static_cast<float>(std::exp(-(j - tj) * (j - tj) * inv_p));
    for (int k = 0; k < nz_; ++k) {
      double v = 0.0;
      for (int l = 0; l < sig.lobes; ++l) {
        const int lk = tk + l * sig.gap;
        v += sig.amp * std::pow(0.85, l) *
             std::exp(-(k - lk) * (k - lk) * inv_r);
      }
      ezl_[k] = static_cast<float>(v);
      decay_[k] = static_cast<float>(12.0 * std::exp(-k / 25.0));
    }

    for (int i = 0; i < nx_; ++i) {
      const float exi = ex_[i];
      for (int j = 0; j < ny_; ++j) {
        const float exy = exi * ey_[j];
        float* row = cube + (static_cast<size_t>(i) * ny_ + j) * nz_;
        for (int k = 0; k < nz_; ++k) {
          const float noise =
              expo_table_[rng_.next() & (kExpoTableSize - 1)];
          float v = exy * ezl_[k] + noise + decay_[k];
          row[k] = v > 255.0f ? 255.0f : v;
        }
      }
    }
    s.n_targets = 1;
    s.targets[0] = Target{ti, tj, tk, static_cast<float>(sig.amp)};
  }

  static constexpr int kExpoTableSize = 4096;
  std::vector<float> expo_table_, ex_, ey_, ezl_, decay_;

  const int nx_, ny_, nz_;
  const size_t cube_len_;
  const int capacity_;
  const double period_us_;
  const int mode_;  // 0 = synth, 1 = replay
  SplitMix64 rng_;

  std::vector<Slot> slots_;
  int head_ = 0, tail_ = 0, count_ = 0;
  std::mutex mu_;
  std::condition_variable cv_;
  std::thread producer_;
  std::atomic<bool> running_{false};
  std::atomic<uint64_t> produced_{0};
  std::atomic<uint64_t> dropped_{0};

  std::vector<float> pool_;
  std::vector<Target> pool_targets_;
  std::vector<int> pool_ntargets_;
  int pool_count_ = 0;
};

}  // namespace

extern "C" {

void* rs_create(int nx, int ny, int nz, int capacity, uint64_t seed,
                double scan_period_us, int mode) {
  return new RadarSource(nx, ny, nz, capacity, seed, scan_period_us, mode);
}

void rs_load_pool(void* h, const float* cubes, const float* targets,
                  const int* n_targets, int n_cubes) {
  static_cast<RadarSource*>(h)->load_pool(cubes, targets, n_targets, n_cubes);
}

void rs_start(void* h) { static_cast<RadarSource*>(h)->start(); }
void rs_stop(void* h) { static_cast<RadarSource*>(h)->stop(); }

int rs_next(void* h, float* out_cube, float* out_targets, int max_targets,
            int* out_n, uint64_t* out_seq, int timeout_us) {
  return static_cast<RadarSource*>(h)->next(
      out_cube, out_targets, max_targets, out_n, out_seq, timeout_us);
}

uint64_t rs_produced(void* h) {
  return static_cast<RadarSource*>(h)->produced();
}
uint64_t rs_dropped(void* h) {
  return static_cast<RadarSource*>(h)->dropped();
}

void rs_destroy(void* h) { delete static_cast<RadarSource*>(h); }

int rs_max_targets() { return kMaxTargets; }

}  // extern "C"
