// Native planner for ndrustfft_tpu — the C++ analog of rustfft's FftPlanner
// (reference delegates planning to rustfft 6.1.0, SURVEY.md §2.2 N1).
//
// Plan-time work lives here: integer factorization, balanced factor
// grouping for the matmul stage schedule, Bluestein padding selection, and
// angle-exact twiddle-table generation (integer phase reduction before the
// float multiply, so tables are accurate to f64 ulp at any n). The Python
// layer calls through ctypes and falls back to its own implementation when
// the shared library is unavailable.
//
// Build: g++ -O2 -shared -fPIC -o libndplanner.so planner.cpp  (see Makefile)

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Prime factorization of n into out[] (ascending). Returns count, or -1 if
// out_cap is too small.
int nd_prime_factors(int64_t n, int64_t* out, int out_cap) {
    int cnt = 0;
    for (int64_t d = 2; d * d <= n;) {
        while (n % d == 0) {
            if (cnt >= out_cap) return -1;
            out[cnt++] = d;
            n /= d;
        }
        d += (d == 2) ? 1 : 2;
    }
    if (n > 1) {
        if (cnt >= out_cap) return -1;
        out[cnt++] = n;
    }
    return cnt;
}

// Greedy balanced grouping of primes into k buckets of product <= max_base.
// Returns the number of buckets used, 0 on failure.
static int group_k(const int64_t* primes, int np_, int k, int64_t max_base,
                   int64_t* buckets) {
    for (int i = 0; i < k; ++i) buckets[i] = 1;
    // primes ascending; place from largest down
    for (int i = np_ - 1; i >= 0; --i) {
        int64_t p = primes[i];
        int best = -1;
        for (int j = 0; j < k; ++j) {
            if (buckets[j] * p <= max_base &&
                (best < 0 || buckets[j] < buckets[best])) {
                best = j;
            }
        }
        if (best < 0) return 0;
        buckets[best] *= p;
    }
    return k;
}

// Factor n into few balanced factors each <= max_base (descending order in
// out[]). Returns count, 0 when n has a prime factor > max_base (Bluestein
// territory), -1 on capacity error.
int nd_factorize(int64_t n, int64_t max_base, int64_t* out, int out_cap) {
    if (n <= 0) return -1;
    if (n == 1) {
        if (out_cap < 1) return -1;
        out[0] = 1;
        return 1;
    }
    int64_t primes[64];
    int np_ = nd_prime_factors(n, primes, 64);
    if (np_ < 0) return -1;
    if (primes[np_ - 1] > max_base) return 0;
    int k = 1;
    for (int64_t cap = max_base; cap < n; cap *= max_base) ++k;
    int64_t buckets[64];
    for (; k <= np_; ++k) {
        if (k > out_cap || k > 64) return -1;
        if (group_k(primes, np_, k, max_base, buckets)) {
            // sort descending, drop 1s
            int cnt = 0;
            for (int i = 0; i < k; ++i)
                if (buckets[i] > 1) out[cnt++] = buckets[i];
            if (cnt == 0) out[cnt++] = 1;
            for (int i = 0; i < cnt; ++i)
                for (int j = i + 1; j < cnt; ++j)
                    if (out[j] > out[i]) {
                        int64_t t = out[i];
                        out[i] = out[j];
                        out[j] = t;
                    }
            return cnt;
        }
    }
    return -1;
}

// Smallest 3-smooth number (2^a * 3^b) >= n (Bluestein padding; twin of
// plan.next_smooth).
int64_t nd_next_smooth(int64_t n) {
    int64_t best = 1;
    while (best < n) best *= 2;
    for (int64_t p3 = 1;; p3 *= 3) {
        int64_t p2 = 1;
        while (p2 * p3 < n) p2 *= 2;
        int64_t cand = p2 * p3;
        if (cand < best) best = cand;
        if (p3 >= n) break;
    }
    return best;
}

// cos/sin of pi * num / den with integer phase reduction (num mod 2*den),
// sign < 0 negates the angle. Fills re[i], im[i] for i in [0, count).
static void cis_fill(const int64_t* num, int64_t den, int sign, int64_t count,
                     double* re, double* im) {
    const double scale = M_PI / (double)den;
    const int64_t period = 2 * den;
    for (int64_t i = 0; i < count; ++i) {
        int64_t r = num[i] % period;
        if (r < 0) r += period;
        double ang = scale * (double)r;
        if (sign < 0) ang = -ang;
        re[i] = cos(ang);
        im[i] = sin(ang);
    }
}

// (f x f) DFT matrix W[t*f + k] = exp(sign*2i*pi*t*k/f), split re/im.
void nd_dft_matrix(int64_t f, int sign, double* re, double* im) {
    const int64_t den = f;
    const int64_t period = 2 * den;
    const double scale = M_PI / (double)den;
    for (int64_t t = 0; t < f; ++t) {
        for (int64_t k = 0; k < f; ++k) {
            int64_t r = (2 * ((t * k) % f)) % period;
            double ang = scale * (double)r;
            if (sign < 0) ang = -ang;
            re[t * f + k] = cos(ang);
            im[t * f + k] = sin(ang);
        }
    }
}

// (f x m) stage twiddle W_n^{j*p}, n = f*m, split re/im.
void nd_stage_twiddle(int64_t f, int64_t m, int sign, double* re, double* im) {
    const int64_t n = f * m;
    const double scale = M_PI / (double)n;
    for (int64_t j = 0; j < f; ++j) {
        for (int64_t p = 0; p < m; ++p) {
            int64_t r = (2 * ((j * p) % n)) % (2 * n);
            double ang = scale * (double)r;
            if (sign < 0) ang = -ang;
            re[j * m + p] = cos(ang);
            im[j * m + p] = sin(ang);
        }
    }
}

// Bluestein chirp exp(sign*i*pi*t^2/n) for t in [0, length).
void nd_chirp(int64_t n, int sign, int64_t length, double* re, double* im) {
    const double scale = M_PI / (double)n;
    const int64_t period = 2 * n;
    for (int64_t t = 0; t < length; ++t) {
        int64_t r = ((t % period) * (t % period)) % period;
        double ang = scale * (double)r;
        if (sign < 0) ang = -ang;
        re[t] = cos(ang);
        im[t] = sin(ang);
    }
}

}  // extern "C"
