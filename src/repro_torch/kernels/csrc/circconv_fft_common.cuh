// Device and host pieces shared by the FFT-form circconv kernels
// (circconv_fft.cu, one pass in shared memory, and circconv_fft4.cu, the
// four-step form past shared memory): complex arithmetic, the swizzled
// quarter-wave twiddle table, the fused radix-8 DIT passes, the float32 and
// bfloat16 load/store traits, and the dynamic shared-memory opt-in.
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
