// Native host-side core for tensorfft_tpu.
//
// Counterpart of the reference's native host layers: the planner
// (src/base/Plan.h — validation + stage factorization), the twiddle/DFT table
// generation that the reference does per-warp on device with cosf/sinf
// (TensorRadix16.cu:104-145, DFTMatrix.h), the digit-reversal index math of
// the standalone Transposer kernel (src/base/Transposer.cu:65-93), the
// sine-superposition test-data generators (src/testing/TestingDataCreation.h)
// and an independent fp64 FFT oracle (the role cuFFT-Z2Z plays in
// src/testing/unitTesting/CuFFTTest.h:173-261) used to cross-check NumPy.
//
// Compiled with `make` into libtfft_host.so and loaded via ctypes
// (tensorfft_tpu/native/__init__.py).  All entry points are plain C ABI,
// operate on caller-allocated buffers, and return 0 on success.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr double kTau = 6.283185307179586476925286766559;

int thread_count(int64_t work) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 4;
  int64_t by_work = work / 65536;  // don't spawn threads for tiny jobs
  if (by_work < 1) by_work = 1;
  return static_cast<int>(std::min<int64_t>(hw, by_work));
}

template <typename Fn>
void parallel_for(int64_t n, Fn fn) {
  int nt = thread_count(n);
  if (nt <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + nt - 1) / nt;
  for (int i = 0; i < nt; ++i) {
    int64_t lo = i * chunk;
    int64_t hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& t : threads) t.join();
}

bool is_power_of_2(int64_t x) { return x > 0 && (x & (x - 1)) == 0; }

int exact_log2(int64_t x) {
  int p = 0;
  while (x > 1) {
    x >>= 1;
    ++p;
  }
  return p;
}

}  // namespace

extern "C" {

// --- planner core (Plan.h:41-100 analog) -----------------------------------

int tfft_is_power_of_2(int64_t x) { return is_power_of_2(x) ? 1 : 0; }

int tfft_exact_log2(int64_t x, int* out) {
  if (!is_power_of_2(x)) return 1;
  *out = exact_log2(x);
  return 0;
}

// Factor n = 2^p into padded-MAC-optimal block-complex radices (the DP from
// tensorfft_tpu/plan.py::optimal_radices, natively).  out_radices must hold
// >= 32 ints; *out_count receives the stage count.
int tfft_optimal_radices(int64_t n, int* out_radices, int* out_count) {
  if (!is_power_of_2(n) || n < 2) return 1;
  int p = exact_log2(n);
  // cost(2^a) = max(2^(a+1), 128)^2 / 2^a
  int64_t cost[9];
  for (int a = 1; a <= 8; ++a) {
    int64_t m = std::max<int64_t>(int64_t(2) << a, 128);
    cost[a] = m * m / (int64_t(1) << a);
  }
  std::vector<int64_t> best(p + 1, INT64_MAX);
  std::vector<int> choice(p + 1, 0);
  best[0] = 0;
  for (int q = 1; q <= p; ++q) {
    for (int a = 1; a <= std::min(8, q); ++a) {
      int64_t c = best[q - a] + cost[a];
      if (c < best[q]) {
        best[q] = c;
        choice[q] = a;
      }
    }
  }
  std::vector<int> radices;
  for (int q = p; q > 0; q -= choice[q]) radices.push_back(1 << choice[q]);
  std::sort(radices.begin(), radices.end());
  *out_count = static_cast<int>(radices.size());
  for (size_t i = 0; i < radices.size(); ++i) out_radices[i] = radices[i];
  return 0;
}

// --- table generation (DFTMatrix.h / TensorRadix16.cu twiddle analog) ------

// D[t*radix + r] = exp(sign * i * tau * t * r / radix); re/im of size radix^2.
int tfft_dft_matrix(int radix, int sign, double* re, double* im) {
  if (radix <= 0) return 1;
  parallel_for(radix, [&](int64_t lo, int64_t hi) {
    for (int64_t t = lo; t < hi; ++t) {
      for (int64_t r = 0; r < radix; ++r) {
        // reduce t*r mod radix first for large-angle accuracy
        double phase = sign * kTau * static_cast<double>((t * r) % radix) /
                       static_cast<double>(radix);
        re[t * radix + r] = std::cos(phase);
        im[t * radix + r] = std::sin(phase);
      }
    }
  });
  return 0;
}

// W[r*prior + k] = exp(sign * i * tau * r * k / (radix*prior)).
int tfft_stage_twiddle(int radix, int64_t prior, int sign, double* re,
                       double* im) {
  if (radix <= 0 || prior <= 0) return 1;
  int64_t denom = static_cast<int64_t>(radix) * prior;
  parallel_for(radix, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      for (int64_t k = 0; k < prior; ++k) {
        double phase = sign * kTau * static_cast<double>((r * k) % denom) /
                       static_cast<double>(denom);
        re[r * prior + k] = std::cos(phase);
        im[r * prior + k] = std::sin(phase);
      }
    }
  });
  return 0;
}

// --- digit reversal (Transposer.cu:65-93 analog) ----------------------------

// perm[j] = source index of output slot j under mixed-radix digit reversal
// for the given radix sequence (combine order).
int tfft_digit_reversal_perm(int64_t n, const int* radices, int count,
                             int64_t* perm) {
  int64_t prod = 1;
  for (int i = 0; i < count; ++i) prod *= radices[i];
  if (prod != n) return 1;
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t j = lo; j < hi; ++j) {
      // digits of j in combine order (first radix = least significant)
      int64_t rem = j;
      int64_t src = 0;
      for (int i = 0; i < count; ++i) {
        int64_t d = rem % radices[i];
        rem /= radices[i];
        src = src * radices[i] + d;
      }
      perm[j] = src;
    }
  });
  return 0;
}

// --- test-data generation (TestingDataCreation.h analog) -------------------

// mode 0: linear harmonics f(h)=h (CreateSineSuperpostionKernel,
// TestingDataCreation.h:100-104); mode 1: power-of-two harmonics f(h)=2^h
// (CreateSineSquareSuperpostionKernel, :40-43).
int tfft_sine_superposition(int64_t n, const double* weights, int n_weights,
                            int mode, double* out) {
  if (n <= 0 || n_weights < 0 || (mode != 0 && mode != 1)) return 1;
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t j = lo; j < hi; ++j) {
      double acc = 0.0;
      double freq = mode == 1 ? 1.0 : 0.0;
      for (int h = 0; h < n_weights; ++h) {
        double f = mode == 1 ? freq : static_cast<double>(h);
        acc += weights[h] * std::sin(kTau * f * static_cast<double>(j) /
                                     static_cast<double>(n));
        if (mode == 1) freq *= 2.0;
      }
      out[j] = acc;
    }
  });
  return 0;
}

// --- fp64 oracle (CuFFTTest.h:173-261 role) ---------------------------------

// In-place iterative Stockham FFT, forward (sign=-1) or inverse (sign=+1),
// optionally scaled by 1/n (the library's forward convention).  Used to
// cross-check numpy.fft — an oracle independent of any Python library.
// work_re/work_im are scratch of size n.
int tfft_fft_f64(int64_t n, int sign, int apply_scale, double* re, double* im,
                 double* work_re, double* work_im) {
  if (!is_power_of_2(n)) return 1;
  double* cur_re = re;
  double* cur_im = im;
  double* nxt_re = work_re;
  double* nxt_im = work_im;
  // radix-2 Stockham: state (K, M) with K transforms built, M = n/K columns.
  int64_t k = 1;
  int64_t m = n;
  while (m > 1) {
    m >>= 1;
    // combine pairs: for each kk < k, r in {0,1}, col j < m:
    //   out[(t*k + kk)*m + j] = sum_r e(t*r) W[r,kk] cur[kk*2m + r*m + j]
    parallel_for(k, [&](int64_t lo, int64_t hi) {
      for (int64_t kk = lo; kk < hi; ++kk) {
        double phase = sign * kTau * static_cast<double>(kk) /
                       static_cast<double>(2 * k);
        double wr = std::cos(phase), wi = std::sin(phase);
        const double* a_re = cur_re + kk * 2 * m;
        const double* a_im = cur_im + kk * 2 * m;
        double* o0_re = nxt_re + kk * m;
        double* o0_im = nxt_im + kk * m;
        double* o1_re = nxt_re + (k + kk) * m;
        double* o1_im = nxt_im + (k + kk) * m;
        for (int64_t j = 0; j < m; ++j) {
          double e_re = a_re[j], e_im = a_im[j];
          double tr = a_re[m + j], ti = a_im[m + j];
          double or_ = wr * tr - wi * ti;
          double oi = wr * ti + wi * tr;
          o0_re[j] = e_re + or_;
          o0_im[j] = e_im + oi;
          o1_re[j] = e_re - or_;
          o1_im[j] = e_im - oi;
        }
      }
    });
    std::swap(cur_re, nxt_re);
    std::swap(cur_im, nxt_im);
    k <<= 1;
  }
  if (cur_re != re) {
    std::memcpy(re, cur_re, sizeof(double) * n);
    std::memcpy(im, cur_im, sizeof(double) * n);
  }
  if (apply_scale) {
    double s = 1.0 / static_cast<double>(n);
    parallel_for(n, [&](int64_t lo, int64_t hi) {
      for (int64_t j = lo; j < hi; ++j) {
        re[j] *= s;
        im[j] *= s;
      }
    });
  }
  return 0;
}

int tfft_version() { return 1; }

}  // extern "C"
