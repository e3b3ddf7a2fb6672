// Sobol direction numbers on the host.
//
// The port's copy of the JAX package's native search: ops/qmc.py needs one
// 32-entry direction-number vector per dimension, derived from a primitive
// polynomial over GF(2) and odd initial values m_1..m_s.  Finding primitive
// polynomials is a search over 2^degree candidates with O(degree *
// 2^degree) order checks, fine in Python for a few hundred dimensions and
// far too slow for thousands.  _build.py compiles this file with the host
// C++ compiler at first use; ops/qmc.py loads it with ctypes.
//
// Initial values m_i are drawn from a splitmix64 counter hash, so this
// search and the plain Python one in ops/qmc.py (its twin) produce
// bit-identical tables.

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

constexpr int kBits = 32;

// splitmix64: deterministic, language-independent seed expansion.
uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// Multiply a*b in GF(2)[x] modulo `mod` (degree `deg`).
uint64_t polymulmod(uint64_t a, uint64_t b, uint64_t mod, int deg) {
  uint64_t result = 0;
  while (b) {
    if (b & 1) result ^= a;
    b >>= 1;
    a <<= 1;
    if ((a >> deg) & 1) a ^= mod;
  }
  return result;
}

// x^e mod `mod` by square and multiply.
uint64_t x_pow_mod(uint64_t e, uint64_t mod, int deg) {
  uint64_t result = 1, base = 2;
  while (e) {
    if (e & 1) result = polymulmod(result, base, mod, deg);
    base = polymulmod(base, base, mod, deg);
    e >>= 1;
  }
  return result;
}

void prime_factors(uint64_t n, std::vector<uint64_t>* out) {
  out->clear();
  for (uint64_t p = 2; p * p <= n; ++p) {
    if (n % p == 0) {
      out->push_back(p);
      while (n % p == 0) n /= p;
    }
  }
  if (n > 1) out->push_back(n);
}

bool is_primitive(uint64_t poly, int degree,
                  const std::vector<uint64_t>& factors, uint64_t order) {
  if (!(poly & 1)) return false;  // Constant term must be 1.
  if (x_pow_mod(order, poly, degree) != 1) return false;
  for (uint64_t q : factors) {
    if (x_pow_mod(order / q, poly, degree) == 1) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// Fill `out` (dim * 32 uint32, row-major) with direction numbers.
// Returns 0 on success.
int probnative_sobol_directions(int dim, uint32_t* out) {
  if (dim <= 0) return 1;

  // Dimension 0: van der Corput, v_k = 2^(31-k).
  for (int k = 0; k < kBits; ++k) out[k] = 1u << (kBits - 1 - k);
  if (dim == 1) return 0;

  int found = 0;
  int degree = 1;
  std::vector<uint64_t> factors;
  std::vector<uint32_t> m(kBits);

  while (found < dim - 1) {
    const uint64_t order = (1ull << degree) - 1;
    prime_factors(order, &factors);
    for (uint64_t poly = 1ull << degree;
         poly < (2ull << degree) && found < dim - 1; ++poly) {
      if (!is_primitive(poly, degree, factors, order)) continue;

      const int j = found + 1;  // Output dimension index.
      const int s = degree;
      // Odd initial values m_i < 2^i from the counter hash (i is 1-based).
      m[0] = 1;
      for (int i = 2; i <= s && i <= kBits; ++i) {
        const uint64_t h = splitmix64(static_cast<uint64_t>(j) * 64 + i);
        const uint32_t span = i >= 2 ? (1u << (i - 1)) : 1u;
        m[i - 1] = static_cast<uint32_t>(h % span) * 2u + 1u;
      }
      // Classic recurrence: m_k = XOR_i a_i 2^i m_{k-i}  ^  2^s m_{k-s} ^ m_{k-s}.
      for (int k = s; k < kBits; ++k) {
        uint32_t next = m[k - s] ^ (m[k - s] << s);
        for (int i = 1; i < s; ++i) {
          if ((poly >> (s - i)) & 1) next ^= m[k - i] << i;
        }
        m[k] = next;
      }
      for (int k = 0; k < kBits; ++k) {
        out[static_cast<size_t>(j) * kBits + k] =
            (m[k] << (kBits - 1 - k));
      }
      ++found;
    }
    ++degree;
    if (degree > 32) return 2;  // > ~67M dimensions: out of design range.
  }
  return 0;
}

}  // extern "C"
