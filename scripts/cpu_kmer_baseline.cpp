// Measured CPU baseline for canonical K=24 k-mer counting (VERDICT r2 #2a).
//
// Replaces the assumed 150 M kmers/s "optimized CPU socket" divisor in
// bench.py with a measurement: the same sort-and-count algorithm the device
// path uses (extract canonical 48-bit kmers -> LSD radix sort -> run-length
// spectrum), implemented the way an optimized CPU counter would (KMC2 /
// Jellyfish-class: 2-bit packing, rolling canonical extraction, parallel
// 8-bit LSD radix with per-thread histograms). Reports kmers/s at 1..T
// threads so a per-core rate can be extrapolated to any socket size
// (docs/counting_baseline.md carries the analysis).
//
// Build: g++ -O3 -march=native -pthread scripts/cpu_kmer_baseline.cpp -o /tmp/cpu_kmer_baseline
// Run:   /tmp/cpu_kmer_baseline [n_reads read_len reps]

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <atomic>
#include <random>
#include <thread>
#include <vector>

static const int K = 24;

struct Timer {
  std::chrono::steady_clock::time_point t0;
  Timer() : t0(std::chrono::steady_clock::now()) {}
  double s() const {
    return std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
        .count();
  }
};

// Extract canonical K=24 kmers from reads[r0, r1) into out (preallocated).
static void extract(const uint8_t* reads, int read_len, int64_t r0, int64_t r1,
                    uint64_t* out) {
  const uint64_t mask = (1ULL << (2 * K)) - 1;
  int64_t at = r0 * (read_len - K + 1);
  for (int64_t r = r0; r < r1; ++r) {
    const uint8_t* row = reads + r * read_len;
    uint64_t fwd = 0, rc = 0;
    for (int i = 0; i < read_len; ++i) {
      uint64_t c = row[i];
      fwd = ((fwd << 2) | c) & mask;
      rc = (rc >> 2) | ((3 - c) << (2 * (K - 1)));
      if (i >= K - 1) out[at++] = fwd < rc ? fwd : rc;
    }
  }
}

// Two-level KMC2-style sort-and-count: one MSD partition pass by the top
// 12 bits (4096 buckets, each L2-resident at this N), then per-bucket LSD
// radix over the remaining 36 bits with the run-length spectrum fused into
// the final scan. Buckets are processed in parallel. Returns spectrum.
static void sort_count48(std::vector<uint64_t>& keys,
                         std::vector<uint64_t>& tmp, int T,
                         std::vector<int64_t>& spectrum) {
  const int64_t n = (int64_t)keys.size();
  const int64_t chunk = (n + T - 1) / T;
  const int NB = 1 << 12;       // MSD buckets
  const int msd_shift = 48 - 12;
  std::vector<int64_t> hist((size_t)T * NB, 0);
  uint64_t* in = keys.data();
  uint64_t* out = tmp.data();
  // pass 1: parallel histogram + stable scatter into 4096 buckets
  {
    auto histo = [&](int t) {
      int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
      int64_t* h = hist.data() + (size_t)t * NB;
      for (int64_t i = lo; i < hi; ++i) h[in[i] >> msd_shift]++;
    };
    std::vector<std::thread> th;
    for (int t = 0; t < T; ++t) th.emplace_back(histo, t);
    for (auto& x : th) x.join();
    int64_t sum = 0;
    std::vector<int64_t> bucket_start(NB + 1);
    for (int d = 0; d < NB; ++d) {
      bucket_start[d] = sum;
      for (int t = 0; t < T; ++t) {
        int64_t c = hist[(size_t)t * NB + d];
        hist[(size_t)t * NB + d] = sum;
        sum += c;
      }
    }
    bucket_start[NB] = sum;
    auto scatter = [&](int t) {
      int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
      int64_t* h = hist.data() + (size_t)t * NB;
      for (int64_t i = lo; i < hi; ++i) out[h[in[i] >> msd_shift]++] = in[i];
    };
    th.clear();
    for (int t = 0; t < T; ++t) th.emplace_back(scatter, t);
    for (auto& x : th) x.join();
    // pass 2: per-bucket cache-resident LSD radix + fused spectrum
    std::vector<std::vector<int64_t>> spect(T, std::vector<int64_t>(256, 0));
    std::atomic<int> next{0};
    auto work = [&](int t) {
      std::vector<uint64_t> scratch;
      std::vector<int32_t> h256(512);
      int64_t* sp = spect[t].data();
      for (;;) {
        int b = next.fetch_add(1);
        if (b >= NB) break;
        int64_t lo = bucket_start[b], hi = bucket_start[b + 1];
        int64_t m = hi - lo;
        if (!m) continue;
        scratch.resize(m);
        uint64_t* a = out + lo;
        uint64_t* s = scratch.data();
        for (int shift = 0; shift < 36; shift += 9) {
          std::fill(h256.begin(), h256.end(), 0);
          for (int64_t i = 0; i < m; ++i) h256[(a[i] >> shift) & 511]++;
          int32_t acc = 0;
          for (int d = 0; d < 512; ++d) {
            int32_t c = h256[d];
            h256[d] = acc;
            acc += c;
          }
          for (int64_t i = 0; i < m; ++i) s[h256[(a[i] >> shift) & 511]++] = a[i];
          std::swap(a, s);
        }
        // 4 passes of 9 bits = 36 bits, even swaps: result in `out + lo`
        int64_t run = 1;
        for (int64_t i = 1; i < m; ++i) {
          if (a[i] == a[i - 1]) {
            ++run;
          } else {
            sp[std::min<int64_t>(run, 255)]++;
            run = 1;
          }
        }
        sp[std::min<int64_t>(run, 255)]++;
      }
    };
    th.clear();
    for (int t = 0; t < T; ++t) th.emplace_back(work, t);
    for (auto& x : th) x.join();
    std::fill(spectrum.begin(), spectrum.end(), 0);
    for (int t = 0; t < T; ++t)
      for (int d = 0; d < 256; ++d) spectrum[d] += spect[t][d];
  }
}

int main(int argc, char** argv) {
  int64_t n_reads = argc > 1 ? atoll(argv[1]) : 131072;
  int read_len = argc > 2 ? atoi(argv[2]) : 150;
  int reps = argc > 3 ? atoi(argv[3]) : 3;
  const int64_t kmers_per_read = read_len - K + 1;
  const int64_t n_kmers = n_reads * kmers_per_read;

  std::vector<uint8_t> reads((size_t)n_reads * read_len);
  std::mt19937_64 rng(0);
  for (auto& b : reads) b = (uint8_t)(rng() & 3);

  int hw = (int)std::thread::hardware_concurrency();
  if (hw < 1) hw = 1;
  std::vector<uint64_t> keys(n_kmers), tmp(n_kmers);
  std::vector<int64_t> spectrum(256);

  for (int T = 1; T <= hw; T *= 2) {
    double best = 1e30, best_ex = 1e30, best_sort = 1e30;
    for (int rep = 0; rep < reps; ++rep) {
      Timer t_all;
      {  // extraction
        Timer t;
        std::vector<std::thread> th;
        int64_t chunk = (n_reads + T - 1) / T;
        for (int tt = 0; tt < T; ++tt)
          th.emplace_back([&, tt] {
            int64_t lo = tt * chunk, hi = std::min(n_reads, lo + chunk);
            extract(reads.data(), read_len, lo, hi, keys.data());
          });
        for (auto& x : th) x.join();
        best_ex = std::min(best_ex, t.s());
      }
      {  // sort + run-length spectrum (two-level bucketed)
        Timer t;
        sort_count48(keys, tmp, T, spectrum);
        best_sort = std::min(best_sort, t.s());
      }
      best = std::min(best, t_all.s());
    }
    int64_t uniq = 0;
    for (auto c : spectrum) uniq += c;
    printf(
        "{\"threads\": %d, \"n_kmers\": %lld, \"extract_s\": %.3f, "
        "\"sort_count_s\": %.3f, \"total_s\": %.3f, \"mkmers_per_s\": %.1f, "
        "\"n_unique\": %lld}\n",
        T, (long long)n_kmers, best_ex, best_sort, best,
        best_ex + best_sort > 0 ? n_kmers / (best_ex + best_sort) / 1e6 : 0.0,
        (long long)uniq);
    fflush(stdout);
  }
  return 0;
}
