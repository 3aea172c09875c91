// Native (host) loops of the RBF-SVC's plain version: the degrade ladder's
// host rung for SVC (models.resolve_fallback, through native/svc.py).
//
// The plain version (models/svc.py sq_dist and decision_sum) runs two
// loops of small torch ops: 4 ops a feature over the (N, S) distance
// buffer, and 2 ops a support vector over the (N, P) accumulator. Each op
// releases the GIL, so beside a busy host stage the 2·S accumulator steps
// wait for the GIL again and again: a demoted render's seconds followed
// the host's Python load. These are the same two loops in C++, one call
// each, in the same order: every difference, product and sum is an IEEE
// float32 operation rounded on its own (built with -ffp-contract=off, so
// no product is fused into an addition), hence the plain version's bits.
// The exponential between them stays torch's (native/svc.py).
#include <cstdint>

extern "C" {

// d2 (n, s) = sum over the features in ascending order of
// ((x - sv_hi) - sv_lo)^2, the first feature's square taken as it is.
// x (n, f), d2 (n, s) row-major; sv_hi_t and sv_lo_t (f, s) row-major
// (the support vectors transposed, so the inner loop runs along s).
void tcs_sq_dist(const float* x, uint64_t n, uint32_t f,
                 const float* sv_hi_t, const float* sv_lo_t, uint32_t s,
                 float* d2) {
  for (uint64_t i = 0; i < n; ++i) {
    const float* xi = x + i * f;
    float* out = d2 + i * s;
    for (uint32_t k = 0; k < f; ++k) {
      const float xv = xi[k];
      const float* hi = sv_hi_t + static_cast<uint64_t>(k) * s;
      const float* lo = sv_lo_t + static_cast<uint64_t>(k) * s;
      if (k == 0) {
        for (uint32_t j = 0; j < s; ++j) {
          const float d = (xv - hi[j]) - lo[j];
          out[j] = d * d;
        }
      } else {
        for (uint32_t j = 0; j < s; ++j) {
          const float d = (xv - hi[j]) - lo[j];
          out[j] = out[j] + d * d;
        }
      }
    }
  }
}

// acc_t (p, n) = sum over the support vectors in ascending order, from
// zero, of k_t[j, :] * coef_t[j, c]: the (n, p) decisions transposed.
// k_t (s, n) and coef_t (s, p) row-major. Rows go in blocks of kBlock,
// so a block's p accumulators stay in cache across the s steps.
void tcs_decision_sum_t(const float* k_t, uint32_t s, uint64_t n,
                        const float* coef_t, uint32_t p, float* acc_t) {
  constexpr uint64_t kBlock = 1024;
  for (uint64_t c = 0; c < p; ++c)
    for (uint64_t i = 0; i < n; ++i) acc_t[c * n + i] = 0.0f;
  for (uint64_t i0 = 0; i0 < n; i0 += kBlock) {
    const uint64_t m = (n - i0 < kBlock) ? n - i0 : kBlock;
    for (uint32_t j = 0; j < s; ++j) {
      const float* kj = k_t + static_cast<uint64_t>(j) * n + i0;
      const float* cj = coef_t + static_cast<uint64_t>(j) * p;
      for (uint32_t c = 0; c < p; ++c) {
        const float w = cj[c];
        float* a = acc_t + c * n + i0;
        for (uint64_t i = 0; i < m; ++i) a[i] = a[i] + kj[i] * w;
      }
    }
  }
}

}  // extern "C"
