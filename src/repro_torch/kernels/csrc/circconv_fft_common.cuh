// Device and host pieces shared by the FFT-form circconv kernels
// (circconv_fft.cu, one pass in shared memory, and circconv_fft4.cu, the
// four-step form past shared memory): complex arithmetic, the swizzled
// quarter-wave twiddle table, the fused radix-8 DIT passes of a power of
// two, the mixed-radix row transform (radix 8/4/2 passes, then radix-3 and
// radix-5 stages) for every D = 2^a 3^b 5^c, the launch plan, the float32
// and bfloat16 load/store traits, and the dynamic shared-memory opt-in.
//
// Included by each source into its own translation unit; every name lives
// in an anonymous namespace, so each library keeps its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int LOG_RADIX = 3;       // radix-2 stages a pass fuses (radix 8)

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ float2 cconj(float2 a) { return make_float2(a.x, -a.y); }

// 2^e for e in [-126, 127], exact
__device__ __forceinline__ float pow2(int e) { return __int_as_float((127 + e) << 23); }

__device__ __forceinline__ int swz(int p) {
  return p ^ (((p >> 4) ^ (p >> 8) ^ (p >> 12)) & 15);
}

__device__ __forceinline__ int bitrev(int j, int bits) {
  return bits ? static_cast<int>(__brev(static_cast<unsigned>(j)) >> (32 - bits)) : 0;
}

// tw[swz(k)] = e^{-2 pi i k / D} for k < D/4
__device__ void build_table(float2* tw, int logN) {
  const float step = -pow2(1 - logN);   // -2 / D: sincospif takes units of pi
  for (int k = threadIdx.x; k < (1 << (logN - 2)); k += blockDim.x) {
    float s, c;
    sincospif(static_cast<float>(k) * step, &s, &c);
    tw[swz(k)] = make_float2(c, s);
  }
}

// e^{-2 pi i k / D} for k < D/2 from the quarter table (Q = D/4 entries):
// e^{-2 pi i (k + Q) / D} = -i e^{-2 pi i k / D}; branch-free
__device__ __forceinline__ float2 twiddle(const float2* tw, int k, int logQ) {
  const float2 t = tw[swz(k & ((1 << logQ) - 1))];
  return (k >> logQ) ? make_float2(t.y, -t.x) : t;
}

// w e^{-+2 pi i m / 2^(s+1)} (sign - forward, + inverse) for m < 2^s <= 4:
// a rotation by 0, 1/8, 1/4 or 3/8 of a turn, with the constants folded
// once the stage loops are unrolled
template <bool INV>
__device__ __forceinline__ float2 rotate(float2 w, int m, int s) {
  constexpr float r = 0.70710678118654752f;
  const int eighths = (m << (3 - s - 1));   // the angle in eighths of a turn
  const float2 c = eighths == 1 ? make_float2(r, -r)
                 : eighths == 2 ? make_float2(0.f, -1.f)
                 : make_float2(-r, -r);     // eighths == 3
  if (eighths == 0) return w;
  if (eighths == 2) return INV ? make_float2(-w.y, w.x) : make_float2(w.y, -w.x);
  return cmul(w, INV ? cconj(c) : c);
}

// s of a row's scale a = 2^s, from the bits of max|x| and max|k| (mx[0], mx[1])
__device__ __forceinline__ int key_shift(const unsigned* mx) {
  const unsigned bx = mx[0], bk = mx[1];
  if (bx == 0u || bk == 0u) return 0;
  const int s = static_cast<int>(bx >> 23) - static_cast<int>(bk >> 23);
  return max(-100, min(100, s));
}

template <typename T>
struct Io;
template <>
struct Io<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  static __device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};
template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&a);
    u.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

// K radix-2 DIT stages fused into one pass, lengths 2h, 4h, ..., 2^K h
// (h = 2^logh), over nb rows of 2^logN points: a thread owns the 2^K points
// p + j h of one butterfly group and runs the K stages in registers.  The
// table is for 2^logT points.  SCALE: this is the first read of the loaded
// rows, which scales each key by its 2^s.  INV: the inverse (conjugate
// twiddles, unnormalised).
template <int K, bool SCALE, bool INV>
__device__ void stage(float2* buf, const float2* tw, const unsigned* mx, int nb,
                      int logN, int logT, int logh) {
  static_assert(K >= 1 && K <= 3, "rotate() covers passes of up to 3 stages");
  constexpr int P = 1 << K;
  const int logB = logN - K, h = 1 << logh;
  for (int b = threadIdx.x; b < (nb << logB); b += blockDim.x) {
    const int r = b >> logB, u = b & ((1 << logB) - 1);
    const int q = u & (h - 1);
    const int p = ((u >> logh) << (logh + K)) + q;
    float2* row = buf + (r << logN);
    float2 x[P];
    int at[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      at[j] = swz(p + j * h);
      x[j] = row[at[j]];
    }
    if (SCALE) {
      const float a = pow2(key_shift(mx + 2 * r));
#pragma unroll
      for (int j = 0; j < P; ++j) x[j].y *= a;
    }
#pragma unroll
    for (int s = 0; s < K; ++s) {
      // stage of length 2L, L = 2^s h: pairs (j, j + 2^s) with twiddle
      // e^{-+2 pi i (q + m h) / 2L}, m = j mod 2^s: the table's entry for q
      // rotated by m / 2^(s+1) of a turn
      float2 w0 = twiddle(tw, q << (logT - 1 - logh - s), logT - 2);
      if (INV) w0 = cconj(w0);
      float2 w[P / 2];
#pragma unroll
      for (int m = 0; m < (1 << s); ++m) w[m] = rotate<INV>(w0, m, s);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (j & (1 << s)) continue;
        const float2 t = cmul(w[j & ((1 << s) - 1)], x[j + (1 << s)]);
        x[j + (1 << s)] = csub(x[j], t);
        x[j] = cadd(x[j], t);
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) row[at[j]] = x[j];
  }
}

// In-place FFT of nb rows of 2^logN bit-reversed points; natural order out:
// passes of LOG_RADIX = 3 stages, the first taking the remainder (log2 D =
// 12: four passes).  Ends with __syncthreads.
template <bool SCALE, bool INV>
__device__ void fft(float2* buf, const float2* tw, const unsigned* mx, int nb, int logN,
                    int logT) {
  const int first = (logN - 1) % LOG_RADIX + 1;
  if (first == 1)
    stage<1, SCALE, INV>(buf, tw, mx, nb, logN, logT, 0);
  else if (first == 2)
    stage<2, SCALE, INV>(buf, tw, mx, nb, logN, logT, 0);
  else
    stage<3, SCALE, INV>(buf, tw, mx, nb, logN, logT, 0);
  __syncthreads();
  for (int logh = first; logh < logN; logh += LOG_RADIX) {
    stage<LOG_RADIX, false, INV>(buf, tw, mx, nb, logN, logT, logh);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The mixed-radix row transform, for D = 2^a 3^b 5^c that is not a power of
// two (the one-pass kernels) and for every four-step sub-transform.
//
// A row of n = 2^la m points, m = 3^n3 5^n5, is transformed in place by
// decimation in time with the stages in this order: the la radix-2 stages
// (fused three to a pass, as the power-of-two passes above, over the m
// sub-rows of 2^la points), then n3 radix-3 stages, then n5 radix-5 stages.
// So the input is loaded in that order's digit reversal (drev): point j goes
// to bitrev(j / m) + 2^la oddrev(j mod m), where oddrev reverses the base-5
// and base-3 digits of j mod m.  Each 2^la-point sub-row is swizzled as a
// power-of-two row is (addr), so the radix-2 passes see the layout they
// were tuned for, and the odd stages, whose butterflies take points 2^la P
// apart, read runs of consecutive points.  Twiddles come from a quarter-wave
// table of T = c n points (c = 1, or 2 for the real inverse's half-length
// transform, which reads every other entry), filled in double precision and
// rounded once (circconv_fft.cu, circconv_fft4.cu): an argument k / T in
// float32 is not exact when T is not a power of two.
// ---------------------------------------------------------------------------

// A row transform: n = 2^la m points, m = 3^n3 5^n5, magic = ceil(2^32 / m)
// (0 for m = 1).  As kernels/circconv.py's Radices (same fields, same order).
struct Radices {
  int n, la, n3, n5, m;
  unsigned magic;
};

// The plan of a launch, as kernels/circconv.py's Plan: `d`, the row
// transform of D points (one pass), or D = d1.n d2.n for the four-step
// kernels, with d1 the column and d2 the row sub-transform and `cols` the
// columns of a pass A / C tile.
struct Plan {
  Radices d, d1, d2;
  int cols;
};

// a row transform the kernels take: n = 2^la 3^n3 5^n5 with la >= 2 (the
// 16-byte loads and the quarter table need 4 | n) and n <= max_n, its
// fields consistent
bool radices_ok(const Radices& r, int max_n) {
  if (r.la < 2 || r.n3 < 0 || r.n5 < 0 || r.n > max_n) return false;
  int m = 1;
  for (int s = 0; s < r.n3 && m <= max_n; ++s) m *= 3;
  for (int s = 0; s < r.n5 && m <= max_n; ++s) m *= 5;
  const unsigned magic = m > 1 ? 0xFFFFFFFFu / m + 1u : 0u;
  return r.la < 31 && r.m == m && r.n == (static_cast<long long>(m) << r.la) &&
         r.magic == magic;
}

// x / m for x m < 2^32, from m's magic number
__device__ __forceinline__ int div_m(int x, int m, unsigned magic) {
  return m == 1 ? x : static_cast<int>(__umulhi(static_cast<unsigned>(x), magic));
}

// a point's address in rows of 2^la-point sub-rows, each swizzled alone
__device__ __forceinline__ int addr(int p, int la) {
  const int mask = (1 << la) - 1;
  return (p & ~mask) | swz(p & mask);
}

// where input point j of a row goes in the DIT's order
__device__ __forceinline__ int drev(int j, const Radices& r) {
  const int t = div_m(j, r.m, r.magic);
  int o = j - t * r.m, rev = 0, w = r.m;
  for (int s = 0; s < r.n5; ++s) {   // the outermost stages: the last digits
    w /= 5;
    rev += (o % 5) * w;
    o /= 5;
  }
  for (int s = 0; s < r.n3; ++s) {
    w /= 3;
    rev += (o % 3) * w;
    o /= 3;
  }
  return bitrev(t, r.la) + (rev << r.la);
}

// quarter tables in shared memory are padded to whole 16-point swizzle rows
__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }

// tw[swz(k)] = g[k] for k < T4: a quarter table made on the device once
__device__ void load_table(float2* tw, const float2* __restrict__ g, int T4) {
  for (int k = threadIdx.x; k < T4; k += blockDim.x) tw[swz(k)] = g[k];
}

// e^{-+2 pi i k / T} (sign - forward, + INV) for 0 <= k < T = 4 T4
template <bool INV>
__device__ __forceinline__ float2 twiddle_full(const float2* tw, int k, int T4) {
  const bool neg = k >= 2 * T4;
  if (neg) k -= 2 * T4;
  const bool rot = k >= T4;
  if (rot) k -= T4;
  float2 t = tw[swz(k)];
  if (rot) t = make_float2(t.y, -t.x);   // e^{-2 pi i (k + T/4) / T} = -i e^{-2 pi i k / T}
  if (neg) t = make_float2(-t.x, -t.y);
  return INV ? cconj(t) : t;
}

// K radix-2 DIT stages fused into one pass over nsub sub-rows of 2^la points
// (sub-row s at s 2^la), lengths 2h, ..., 2^K h (h = 2^logh): `stage` above
// with the sub-rows' table, whose entry k c2 is e^{-2 pi i k / 2^la}.
// SCALE: the first read of the loaded rows (sub-row s of data row s / m),
// which scales each key by its row's 2^s.
template <int K, bool SCALE, bool INV>
__device__ void stage2(float2* buf, const float2* tw, const unsigned* mx, const Radices& r,
                       int nsub, int logh, int c2) {
  static_assert(K >= 1 && K <= 3, "rotate() covers passes of up to 3 stages");
  constexpr int P = 1 << K;
  const int la = r.la, logB = la - K, h = 1 << logh;
  const int lq = la >= 2 ? la - 2 : 0;   // the sub-rows' quarter: 2^lq angles
  for (int b = threadIdx.x; b < (nsub << logB); b += blockDim.x) {
    const int s = b >> logB, u = b & ((1 << logB) - 1);
    const int q = u & (h - 1);
    const int p = ((u >> logh) << (logh + K)) + q;
    float2* row = buf + (s << la);
    float2 x[P];
    int at[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      at[j] = swz(p + j * h);
      x[j] = row[at[j]];
    }
    if (SCALE) {
      const float a = pow2(key_shift(mx + 2 * div_m(s, r.m, r.magic)));
#pragma unroll
      for (int j = 0; j < P; ++j) x[j].y *= a;
    }
#pragma unroll
    for (int st = 0; st < K; ++st) {
      const int k = q << (la - 1 - logh - st);   // angle k / 2^la, k < 2^(la-1)
      float2 w0 = tw[swz((k & ((1 << lq) - 1)) * c2)];
      if (k >> lq) w0 = make_float2(w0.y, -w0.x);
      if (INV) w0 = cconj(w0);
      float2 w[P / 2];
#pragma unroll
      for (int m = 0; m < (1 << st); ++m) w[m] = rotate<INV>(w0, m, st);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (j & (1 << st)) continue;
        const float2 t = cmul(w[j & ((1 << st) - 1)], x[j + (1 << st)]);
        x[j + (1 << st)] = csub(x[j], t);
        x[j] = cadd(x[j], t);
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) row[at[j]] = x[j];
  }
}

// the 3- and 5-point DFTs in registers, e^{-+2 pi i / RADIX}
template <bool INV>
__device__ __forceinline__ void dft(float2 (&x)[3]) {
  constexpr float s = 0.86602540378443865f;   // sin(2 pi / 3)
  const float2 t = cadd(x[1], x[2]), d = csub(x[1], x[2]);
  const float2 m = make_float2(fmaf(-0.5f, t.x, x[0].x), fmaf(-0.5f, t.y, x[0].y));
  const float2 isd = make_float2(-s * d.y, s * d.x);   // i s d
  x[0] = cadd(x[0], t);
  x[1] = INV ? cadd(m, isd) : csub(m, isd);
  x[2] = INV ? csub(m, isd) : cadd(m, isd);
}

template <bool INV>
__device__ __forceinline__ void dft(float2 (&x)[5]) {
  constexpr float c1 = 0.30901699437494742f, c2 = -0.80901699437494742f;   // cos(2 pi k / 5)
  constexpr float s1 = 0.95105651629515357f, s2 = 0.58778525229247313f;    // sin(2 pi k / 5)
  const float2 t1 = cadd(x[1], x[4]), t2 = cadd(x[2], x[3]);
  const float2 t3 = csub(x[1], x[4]), t4 = csub(x[2], x[3]);
  const float2 a1 = make_float2(x[0].x + c1 * t1.x + c2 * t2.x, x[0].y + c1 * t1.y + c2 * t2.y);
  const float2 a2 = make_float2(x[0].x + c2 * t1.x + c1 * t2.x, x[0].y + c2 * t1.y + c1 * t2.y);
  const float2 b1 = make_float2(s1 * t3.x + s2 * t4.x, s1 * t3.y + s2 * t4.y);
  const float2 b2 = make_float2(s2 * t3.x - s1 * t4.x, s2 * t3.y - s1 * t4.y);
  const float2 ib1 = make_float2(-b1.y, b1.x), ib2 = make_float2(-b2.y, b2.x);
  x[0] = cadd(x[0], cadd(t1, t2));
  x[1] = INV ? cadd(a1, ib1) : csub(a1, ib1);
  x[4] = INV ? csub(a1, ib1) : cadd(a1, ib1);
  x[2] = INV ? cadd(a2, ib2) : csub(a2, ib2);
  x[3] = INV ? csub(a2, ib2) : cadd(a2, ib2);
}

// One radix-RADIX stage over nb rows of r.n points: the stage of length
// L = h RADIX, h = 2^la P (P the product of the odd radices before it);
// butterfly (g, q) takes the points g L + q + j h, each times the twiddle
// e^{-+2 pi i q j / L}, the table's entry q j lmul (lmul = T / L).
template <int RADIX, bool INV>
__device__ void stage_odd(float2* buf, const float2* tw, const Radices& r, int nb, int P,
                          int lmul, int T4) {
  const unsigned magic = P > 1 ? 0xFFFFFFFFu / P + 1u : 0u;
  const int h = P << r.la;
  const int total = nb * (r.n / RADIX);
  for (int b = threadIdx.x; b < total; b += blockDim.x) {
    const int g = div_m(b >> r.la, P, magic);   // b / h
    const int q = b - g * h;
    const int base = g * h * RADIX + q;
    float2 x[RADIX];
    int at[RADIX];
#pragma unroll
    for (int j = 0; j < RADIX; ++j) {
      at[j] = addr(base + j * h, r.la);
      x[j] = buf[at[j]];
    }
#pragma unroll
    for (int j = 1; j < RADIX; ++j) x[j] = cmul(x[j], twiddle_full<INV>(tw, q * j * lmul, T4));
    dft<INV>(x);
#pragma unroll
    for (int j = 0; j < RADIX; ++j) buf[at[j]] = x[j];
  }
}

// In-place FFT of nb rows of r.n points (la >= 1), loaded at
// addr(drev(j)); natural order out, at addr(k).  The table is the quarter
// table of T = c r.n points.  Ends with __syncthreads.
template <bool SCALE, bool INV>
__device__ void fft_rows(float2* buf, const float2* tw, const unsigned* mx, const Radices& r,
                         int nb, int c) {
  const int nsub = nb * r.m, c2 = c * r.m;   // c2 = T / 2^la
  const int first = (r.la - 1) % LOG_RADIX + 1;
  if (first == 1)
    stage2<1, SCALE, INV>(buf, tw, mx, r, nsub, 0, c2);
  else if (first == 2)
    stage2<2, SCALE, INV>(buf, tw, mx, r, nsub, 0, c2);
  else
    stage2<3, SCALE, INV>(buf, tw, mx, r, nsub, 0, c2);
  __syncthreads();
  for (int logh = first; logh < r.la; logh += LOG_RADIX) {
    stage2<LOG_RADIX, false, INV>(buf, tw, mx, r, nsub, logh, c2);
    __syncthreads();
  }
  const int T = c * r.n, T4 = T >> 2;
  int P = 1;
  for (int s = 0; s < r.n3; ++s, P *= 3) {
    stage_odd<3, INV>(buf, tw, r, nb, P, T / ((3 * P) << r.la), T4);
    __syncthreads();
  }
  for (int s = 0; s < r.n5; ++s, P *= 5) {
    stage_odd<5, INV>(buf, tw, r, nb, P, T / ((5 * P) << r.la), T4);
    __syncthreads();
  }
}

// g[k] = e^{-2 pi i k / T} for k < count, in double, rounded once
__global__ void roots_kernel(float2* __restrict__ g, int count, int T) {
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < count;
       k += gridDim.x * blockDim.x) {
    double s, c;
    sincospi(-2.0 * k / T, &s, &c);
    g[k] = make_float2(static_cast<float>(c), static_cast<float>(s));
  }
}

// The launch set-up is made once per device and kept, so a launch after the
// first on its device makes no driver query (cudaGetDevice reads the
// thread's state): the shared memory a block may opt in to (0 until read),
// and for each kernel whether it has been allowed all of it.  Both are
// idempotent, so threads that race here do the same work twice, no harm.
constexpr int MAX_DEVICES = 64;   // devices past this are queried at every launch
std::atomic<int> optin_bytes[MAX_DEVICES];

size_t smem_optin(int dev) {
  int v = dev < MAX_DEVICES ? optin_bytes[dev].load(std::memory_order_relaxed) : 0;
  if (v == 0) {
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
        cudaSuccess)
      return 0;
    if (dev < MAX_DEVICES) optin_bytes[dev].store(v, std::memory_order_relaxed);
  }
  return static_cast<size_t>(v);
}

// Lets `kernel` take past 48 KB of dynamic shared memory: the device's whole
// opt-in, set once per device (`allowed` is the kernel's own flags).
template <typename K>
cudaError_t allow_smem(K kernel, std::atomic<bool>* allowed, int dev, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  if (dev < MAX_DEVICES && allowed[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_optin(dev)));
  if (e == cudaSuccess && dev < MAX_DEVICES)
    allowed[dev].store(true, std::memory_order_release);
  return e;
}

}  // namespace
