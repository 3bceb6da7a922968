// Paged-attention decode kernels for Hopper (sm_90a): float and int8 KV.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/paged_attention.py:
//   paged_attention_float  <- paged_attention       (body _attn_kernel)
//   paged_attention_int8   <- paged_attention_quant (body _attn_kernel_quant)
//
// One decode token per slot attends over the slot's paged K/V cache:
//   q (B, H*hd) post-rope; k/v pools (num_pages, ps, KV, hd); page table
//   (B, P) int32; pos (B,) int32; logical length T <= P*ps.
//   out[b, (kh*G + g)*hd + d] =
//       sum_t softmax_t(q_{kh,g} . k_t * hd^-0.5)[t] * v_t[d]
// over the positions t the decode mask admits.  Query head h = kh*G + g
// reads kv head kh (GQA with G = H/KV groups; G = 1 is MHA).  Position t
// of slot b lives at pool[table[b, t / ps], t % ps].
//
// The mask.  The reference masks a linear cache to idx <= pos and a
// sliding-window ring to the last min(pos + 1, T) writes.  Over idx in
// [0, T) both admit exactly the prefix [0, min(pos, T - 1)]: for a ring
// with pos < T the last pos + 1 writes are slots 0..pos, and with pos >= T
// every slot is admitted.  So the kernel reads n = min(pos, T - 1) + 1
// positions for either mask and never touches a page past
// (n - 1) / ps.  A masked score is -1e30 in the reference, whose softmax
// then gives it exactly zero weight, so skipping those positions changes
// only the order of the sums.
//
// int8 KV.  The pools hold int8 values and (num_pages, ps, KV, 1) float32
// scales.  As in the reference's _sdpa_quant, the k scale multiplies the
// score before hd^-0.5 and the v scale multiplies the probability, so the
// dequantized cache is never built; q may be float32 or bfloat16 and the
// output is written in the compute dtype (float32 or bfloat16).
//
// Design.  One block of 128 threads owns one (slot b, kv head kh) and all
// G query heads of its group, so each K/V row is read from device memory
// once.  It loops over the admitted positions in tiles of TR = 32: each
// tile's K and V rows (and scales) are staged in shared memory as float32
// with 16-byte loads (neighbouring threads on neighbouring 16-byte chunks
// of a row; a row is hd contiguous elements of one page).  Each warp
// scores its rows for every head (lanes split hd, then a shuffle sum);
// each warp then updates the online softmax of its heads with one lane per
// row: running max m, running sum l, and the rescale exp(m_old - m_new) of
// the float32 accumulator acc[g][d], which every thread updates for its
// own (g, d) elements with the tile's p * v.  The block writes acc / l at
// the end.  All sums are float32; there are no atomics, so results are
// deterministic.  A table entry outside [0, num_pages) is clamped (as the
// reference's gather clamps it), so a bad table never reads outside the
// pool.
//
// The TPU kernel copies a slot's whole K/V strip into VMEM and reduces
// once, to stay bit-identical with the gather read.  Here a slot's K strip
// alone is T*KV*hd*4 = 8 MB at the full-width serving shape (T 512, KV 32,
// hd 128), against 227 KB of shared memory a block, so the kernel tiles T
// and keeps the softmax online; its results match the gather read within
// float tolerance, not bit for bit.
//
// Bound.  The function must read q, the admitted K/V rows (and their
// scales) and write the output: at the main-path shape (B 8, KV 32, hd 128,
// float32, pos about 160) some 41 MB, or about 12 us at 3.35 TB/s.  Its
// operations (4 flops per admitted row, head and dimension: 21 MFLOP) take
// 0.3 us at the float32 rate, so it is bound by bytes.  What the design
// does about it: every admitted row is read once, with 16-byte loads, and
// no page past the mask is touched.  What it leaves for later: with B*KV
// blocks the card runs only B*KV/132 blocks an SM and each block waits on
// one tile's loads at a time; split-K over T (flash-decoding) for small
// B*KV, and cp.async or TMA double buffering of the tiles, would keep more
// bytes in flight.
//
// Shapes taken: hd a multiple of 16 bytes of the pool's element (float32
// hd % 4, bfloat16 hd % 8, int8 hd % 16) and any ps, P, T, KV, G that fit
// the shared memory (2*G*hd + 2*TR*hd + G*TR + 3*G + 2*TR floats).  pos is
// a written position, so >= 0 (the engine's always are): every slot then
// admits at least position 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;       // threads per block
constexpr int NW = NT / 32;   // warps per block
constexpr int TR = 32;        // positions per staged tile: one per lane

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes (16 / sizeof(T) elements) from device memory, as float32.
template <typename T>
__device__ __forceinline__ void load16(const T* __restrict__ src, float* dst) {
  constexpr int CH = 16 / sizeof(T);
  const int4 raw = __ldg(reinterpret_cast<const int4*>(src));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < CH; ++i) dst[i] = to_float(e[i]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

size_t smem_bytes(int G, int hd) {
  return sizeof(float) *
         (2 * (size_t)G * hd + 2 * (size_t)TR * hd + (size_t)G * TR + 3 * G +
          2 * TR);
}

template <typename TQ, typename TKV, typename TO, bool QUANT>
__global__ void __launch_bounds__(NT) paged_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ pos, TO* __restrict__ out, int P, int ps,
    int num_pages, int KV, int G, int hd, int T, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;              // G*hd   the group's queries
  float* sAcc = sQ + G * hd;     // G*hd   output accumulators
  float* sK = sAcc + G * hd;     // TR*hd  staged K rows
  float* sV = sK + TR * hd;      // TR*hd  staged V rows
  float* sP = sV + TR * hd;      // G*TR   scores, then probabilities
  float* sM = sP + G * TR;       // G      running max
  float* sL = sM + G;            // G      running sum
  float* sC = sL + G;            // G      this tile's rescale
  float* sKs = sC + G;           // TR     k scales (int8 pools)
  float* sVs = sKs + TR;         // TR     v scales (int8 pools)

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int H = KV * G;
  const int n = min(__ldg(pos + b), T - 1) + 1;   // admitted: [0, n)
  const int* trow = table + (long long)b * P;

  const TQ* qb = q + ((long long)b * H + (long long)kh * G) * hd;
  for (int e = tid; e < G * hd; e += NT) {
    sQ[e] = to_float(qb[e]);
    sAcc[e] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    sM[g] = -INFINITY;
    sL[g] = 0.f;
  }

  constexpr int CH = 16 / sizeof(TKV);
  const int cpr = hd / CH;                      // 16-byte chunks per row
  const long long row_stride = (long long)KV * hd;

  for (int t0 = 0; t0 < n; t0 += TR) {
    const int rows = min(TR, n - t0);
    __syncthreads();  // the last tile's readers are done with sK, sV, sP
#pragma unroll 4
    for (int c = tid; c < rows * cpr; c += NT) {
      const int r = c / cpr;
      const int j = c - r * cpr;
      const int t = t0 + r;
      const int page = min(max(__ldg(trow + t / ps), 0), num_pages - 1);
      const long long off = ((long long)page * ps + t % ps) * row_stride +
                            (long long)kh * hd + j * CH;
      load16(k_pool + off, sK + r * hd + j * CH);
      load16(v_pool + off, sV + r * hd + j * CH);
    }
    if (QUANT) {
      for (int r = tid; r < rows; r += NT) {
        const int t = t0 + r;
        const int page = min(max(__ldg(trow + t / ps), 0), num_pages - 1);
        const long long so = ((long long)page * ps + t % ps) * KV + kh;
        sKs[r] = __ldg(k_scale + so);
        sVs[r] = __ldg(v_scale + so);
      }
    }
    __syncthreads();

    // scores: warp w takes rows w, w + NW, ...; lanes split hd
    for (int r = warp; r < rows; r += NW) {
      const float* kr = sK + r * hd;
      for (int g = 0; g < G; ++g) {
        const float* qg = sQ + g * hd;
        float part = 0.f;
        for (int d = lane; d < hd; d += 32) part = fmaf(qg[d], kr[d], part);
        part = warp_sum(part);
        if (lane == 0) {
          float s = part;
          if (QUANT) s *= sKs[r];
          sP[g * TR + r] = s * scale;
        }
      }
    }
    __syncthreads();

    // online softmax: warp w takes heads w, w + NW, ...; lane = row
    for (int g = warp; g < G; g += NW) {
      const bool ok = lane < rows;
      const float s = ok ? sP[g * TR + lane] : -INFINITY;
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(p);
      sP[g * TR + lane] = ok ? (QUANT ? p * sVs[lane] : p) : 0.f;
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        sC[g] = c;
        sM[g] = m_new;
        sL[g] = sL[g] * c + psum;
      }
    }
    __syncthreads();

    // acc = acc * rescale + P V, each thread on its own (g, d) elements
    for (int e = tid; e < G * hd; e += NT) {
      const int g = e / hd;
      const int d = e - g * hd;
      const float* pg = sP + g * TR;
      float part = 0.f;
      for (int r = 0; r < rows; ++r) part = fmaf(pg[r], sV[r * hd + d], part);
      sAcc[e] = fmaf(sAcc[e], sC[g], part);
    }
  }
  __syncthreads();

  TO* ob = out + ((long long)b * H + (long long)kh * G) * hd;
  for (int e = tid; e < G * hd; e += NT)
    ob[e] = from_float<TO>(sAcc[e] / sL[e / hd]);
}

template <typename TQ, typename TKV, typename TO, bool QUANT>
int launch(const void* q, const void* k_pool, const void* k_scale,
           const void* v_pool, const void* v_scale, const void* table,
           const void* pos, void* out, int B, int P, int ps, int num_pages,
           int KV, int G, int hd, int T, float scale, void* stream) {
  auto kern = paged_attention_kernel<TQ, TKV, TO, QUANT>;
  const size_t smem = smem_bytes(G, hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(KV, B);
  kern<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<TO*>(out), P, ps, num_pages,
      KV, G, hd, T, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes.  dtype codes: 0 float32,
// 1 bfloat16.  Each launches on `stream` and returns a cudaError_t (0 on
// success).

extern "C" int paged_attention_smem_bytes(int G, int hd) {
  return static_cast<int>(smem_bytes(G, hd));
}

extern "C" int paged_attention_float(const void* q, const void* k_pool,
                                     const void* v_pool, const void* table,
                                     const void* pos, void* out, int B, int P,
                                     int ps, int num_pages, int KV, int G,
                                     int hd, int T, float scale, int dtype,
                                     void* stream) {
  if (dtype == 0)
    return launch<float, float, float, false>(
        q, k_pool, nullptr, v_pool, nullptr, table, pos, out, B, P, ps,
        num_pages, KV, G, hd, T, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16, false>(
        q, k_pool, nullptr, v_pool, nullptr, table, pos, out, B, P, ps,
        num_pages, KV, G, hd, T, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int paged_attention_int8(const void* q, const void* k_pool,
                                    const void* k_scale, const void* v_pool,
                                    const void* v_scale, const void* table,
                                    const void* pos, void* out, int B, int P,
                                    int ps, int num_pages, int KV, int G,
                                    int hd, int T, float scale, int q_dtype,
                                    int out_dtype, void* stream) {
  if ((q_dtype | out_dtype) & ~1) return static_cast<int>(cudaErrorInvalidValue);
  switch (q_dtype * 2 + out_dtype) {
    case 0:
      return launch<float, int8_t, float, true>(
          q, k_pool, k_scale, v_pool, v_scale, table, pos, out, B, P, ps,
          num_pages, KV, G, hd, T, scale, stream);
    case 1:
      return launch<float, int8_t, __nv_bfloat16, true>(
          q, k_pool, k_scale, v_pool, v_scale, table, pos, out, B, P, ps,
          num_pages, KV, G, hd, T, scale, stream);
    case 2:
      return launch<__nv_bfloat16, int8_t, float, true>(
          q, k_pool, k_scale, v_pool, v_scale, table, pos, out, B, P, ps,
          num_pages, KV, G, hd, T, scale, stream);
    case 3:
      return launch<__nv_bfloat16, int8_t, __nv_bfloat16, true>(
          q, k_pool, k_scale, v_pool, v_scale, table, pos, out, B, P, ps,
          num_pages, KV, G, hd, T, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
