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
// every slot is admitted.  So the kernels read n = min(pos, T - 1) + 1
// positions for either mask and never touch a page past (n - 1) / ps.  A
// masked score is -1e30 in the reference, whose softmax then gives it
// exactly zero weight, so skipping those positions changes only the order
// of the sums.  pos is a written position, so >= 0 (the engine's always
// are); a negative one reads as 0, so every slot admits position 0.
//
// int8 KV.  The pools hold int8 values and (num_pages, ps, KV, 1) float32
// scales.  As in the reference's _sdpa_quant, the k scale multiplies the
// score before hd^-0.5 and the v scale multiplies the probability, so the
// dequantized cache is never built; q may be float32 or bfloat16 and the
// output is written in the compute dtype (float32 or bfloat16).
//
// Bound.  The function must read q, the admitted K/V rows (and their
// scales) and write the output: at the serving shape (B 8, KV 32, hd 128,
// pos 128-160, 1,160 admitted rows) 38.3 MB in float32 (11.4 us at 3.35
// TB/s) and 9.9 MB over int8 pools (3.0 us).  Its operations (4 flops per
// admitted row, head and dimension) take under 0.4 us at the float32 rate,
// so it is bound by bytes.  To come near that, many bytes must be in
// flight on every SM at once, and no load may wait on arithmetic.
//
// Design (flash-decoding with pipelined page loads).
// - The plan comes from the host.  split_plan and head_block in
//   paged_attention.py pick, from the shapes alone (never from pos, so a
//   launch needs no host read of a device value), the split count S, the
//   chunk of positions a split takes, and GB, the query heads a block
//   keeps, and keep them per shape in a struct Plan beside the shapes.  The
//   entry points take that struct; they check the plan, and refuse a GB
//   that has no instantiation below (launch_split_for), but never derive
//   it.
// - Split-K.  The grid is (KV * ceil(G / GB), B, S): each block takes one
//   (slot, kv head, up to GB query heads of its group) and one chunk
//   [s * chunk, (s + 1) * chunk) of the slot's positions.  A block whose
//   chunk starts at or past its slot's n writes an empty partial (m = -inf,
//   l = 0) and exits.  Each other block writes its partial (running max m,
//   sum l, unnormalised acc[g][hd]) in float32 to a scratch buffer; a
//   second kernel combines a head's S partials by the log-sum-exp rule in
//   the order s = 0, 1, ... and writes acc / l in the output dtype.  With
//   S = 1 the first kernel writes the output itself and the scratch is
//   neither allocated nor touched (a null pointer).  No atomics anywhere,
//   so results are bitwise repeatable.
// - Pipelined loads.  A block reads its chunk's page-table entries once,
//   clamped to [0, num_pages) (as the reference's gather clamps them), into
//   shared memory beside pos, so no row load waits on a table read.  K and
//   V rows (and the int8 scales) are staged with 16-byte cp.async.cg into a
//   ring of up to three tiles of TR = 32 rows, in the pools' own dtype
//   (int8 stays int8, four times denser than float32), and converted at
//   use.  Tile t + 2 loads while tile t is scored; one barrier a tile.
//   paged_attention_prepare picks the ring's depth once per shape: three
//   tiles, or two or one where three do not fit the device's shared memory
//   (float32 rows of hd 384 take two, of hd 512 one; a one-tile ring loads
//   each tile after the last is scored, with a second barrier a tile).
// - Per-row-slot online softmax.  A row is split over LPR lanes, each
//   owning KCH chunks of 4 dims of each of its GB heads (KCH = min(4, 16 /
//   GB): at most 16 chunks, 64 float32 accumulators, a lane), so a warp
//   holds 32/LPR row slots; each slot takes its own rows of every tile and
//   keeps its own (m, l, acc) in registers.  Scores are summed over a row's
//   lanes in log2(LPR) shuffle rounds, two rows at a time, and kept in base
//   2 so each exponential is one ex2.approx.  At the end the slots of a
//   warp merge by shuffles, then the warps through shared memory, in a
//   fixed order.
// - int8 rows are converted with a byte permute and a subtraction, not the
//   quarter-rate integer-to-float conversion.
// - Both kernels launch as programmatic dependents (Hopper): the blocks of
//   one are scheduled while the work before it drains, and wait on
//   griddepcontrol.wait before they read what it wrote.
//
// Shapes taken: hd a multiple of 16 bytes of the pool's element (float32
// hd % 4, bfloat16 hd % 8, int8 hd % 16), hd <= 128 * KCH (512 for GB <=
// 4, 256 for GB 8, 128 for GB 16), any G, ps, P, T, KV whose blocks fit the
// shared memory with a one-tile ring (paged_attention_prepare says how much
// a shape needs).  hd over 512 is refused: the registers of a lane hold at
// most 16 of a row's 4-dim chunks, so a wider row would need more than 32
// lanes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;        // threads per block
constexpr int NW = NT / 32;    // warps per block
constexpr int TR = 32;         // rows per staged tile
constexpr int MAX_STAGES = 3;  // tiles in the ring, at most
constexpr int COMBINE_NT = 128;  // 4 heads a block in pass 2
constexpr unsigned FULL = 0xffffffffu;

// The 4-dim chunks a lane owns per head: at most 16 over the GB heads (64
// float32 accumulators), and at most 4 a head (a row of 128 then takes 8
// lanes).  A row of hd then fits 32 lanes while hd <= 128 * KCH.
__host__ __device__ constexpr int kch_of(int gb) { return gb <= 4 ? 4 : 16 / gb; }

// ---- cp.async --------------------------------------------------------------

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- four elements of a staged row, as float32 ---------------------------

__device__ __forceinline__ void ld4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&x)[4]) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + 2));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

// int8 to float32 without the quarter-rate I2F: with the sign bit flipped a
// byte is b + 128; placed under the exponent of 2^23 it reads 2^23 + b + 128
// as a float, exactly, and one subtraction leaves b.
__device__ __forceinline__ void ld4(const int8_t* p, float (&x)[4]) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p) ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Scores are kept in base 2 (scaled by log2 e), so each exponential is one
// ex2.approx (relative error under 2^-22).  weight(m, M) = 2^(m - M), and 0
// for a state that saw no row (m = -inf).
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float weight(float m, float M) {
  return m == -INFINITY ? 0.f : ex2(m - M);
}

// ---- shared memory of one block -------------------------------------------

// The ring of `ns` tiles (K and V tiles, the int8 scales) and the chunk's
// table entries, then, reusing them, the warps' partials for the merge.
size_t smem_bytes(int gb, int hd, int kv_bytes, bool quant, int chunk, int ps,
                  int stages) {
  const size_t ns = stages;
  const size_t ring = 2 * ns * TR * (size_t)hd * kv_bytes +
                      (quant ? 2 * ns * TR * sizeof(float) : 0) +
                      sizeof(int) * ((size_t)chunk / ps + 2);
  const size_t merge = sizeof(float) * NW * (size_t)gb * (hd + 2);
  return ring > merge ? ring : merge;
}

// ---- pass 1: one chunk of one (slot, kv head, head group) ----------------

// With one head a block (16 accumulators and 16 query values a thread),
// six blocks an SM fit, so more warps hide each other's chains of
// dependent loads and shuffles.
template <typename TKV, int GB, bool QUANT>
__global__ void __launch_bounds__(NT, GB <= 1 ? 6 : 1)
paged_attention_split_kernel(
    const void* __restrict__ q, int q_bf16, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ pos, float* __restrict__ part,
    void* __restrict__ out, int out_bf16, int B, int P, int ps,
    int num_pages, int KV, int G, int hd, int T, int S, int chunk, int ns,
    float scale) {
  constexpr int KCH = kch_of(GB);
  constexpr int RB = 2;                      // rows a slot scores at once
  extern __shared__ __align__(16) unsigned char smem[];

  // Launched as a programmatic dependent of the kernel before it (Hopper):
  // the blocks are scheduled while that kernel drains, and wait here until
  // it has finished and its writes (q, the cache rows) are visible.  Then
  // pass 2 may be scheduled as soon as every block of this pass has started.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int HG = (G + GB - 1) / GB;
  const int kh = blockIdx.x / HG;
  const int g0 = (blockIdx.x - kh * HG) * GB;
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  const int H = KV * G;
  const int tid = threadIdx.x;
  const long long BHS = (long long)B * H * S;
  float* part_m = S > 1 ? part + BHS * hd : nullptr;   // part: null at S = 1
  float* part_l = S > 1 ? part_m + BHS : nullptr;
  const long long head0 = (long long)b * H + (long long)kh * G + g0;

  const int tile_bytes = TR * hd * (int)sizeof(TKV);
  unsigned char* sK = smem;
  unsigned char* sV = smem + ns * tile_bytes;
  float* sKs = reinterpret_cast<float*>(smem + 2 * ns * tile_bytes);
  float* sVs = sKs + (QUANT ? ns * TR : 0);
  int* sTab = reinterpret_cast<int*>(sVs + (QUANT ? ns * TR : 0));

  // The chunk's table entries, clamped, once; read beside pos rather than
  // after it (cs < T, since S = ceil(T / chunk), so p0 < P).
  const int cs = s * chunk;
  const int p0 = cs / ps;
  const int npg = min((cs + chunk - 1) / ps, P - 1) - p0 + 1;
  const int* trow = table + (long long)b * P + p0;
  const int n = max(min(__ldg(pos + b), T - 1), 0) + 1;   // admitted: [0, n)
  for (int i = tid; i < npg; i += NT)
    sTab[i] = min(max(__ldg(trow + i), 0), num_pages - 1);
  if (cs >= n) {              // an empty partial (never at S = 1: n >= 1)
    for (int g = tid; g < GB && g0 + g < G; g += NT) {
      part_m[(head0 + g) * S + s] = -INFINITY;
      part_l[(head0 + g) * S + s] = 0.f;
    }
    return;
  }
  const int ce = min(cs + chunk, n);
  const int pd = ns > 1 ? ns - 1 : 1;              // tiles loaded ahead
  const int ntiles = (ce - cs + TR - 1) / TR;
  __syncthreads();

  constexpr int CH = 16 / sizeof(TKV);             // elements a 16-byte copy
  const int cpr = hd / CH;
  const long long row_stride = (long long)KV * hd;
  auto stage_tile = [&](int t) {
    if (t < ntiles) {
      const int t0 = cs + t * TR;
      const int rows = min(TR, ce - t0);
      const int st = t % ns;
      TKV* dk = reinterpret_cast<TKV*>(sK + st * tile_bytes);
      TKV* dv = reinterpret_cast<TKV*>(sV + st * tile_bytes);
      for (int c = tid; c < rows * cpr; c += NT) {
        const int r = c / cpr;
        const int j = c - r * cpr;
        const int tp = t0 + r;
        const long long off =
            ((long long)sTab[tp / ps - p0] * ps + tp % ps) * row_stride +
            (long long)kh * hd + j * CH;
        cp16(dk + r * hd + j * CH, k_pool + off);
        cp16(dv + r * hd + j * CH, v_pool + off);
      }
      if (QUANT) {
        for (int r = tid; r < rows; r += NT) {
          const int tp = t0 + r;
          const long long so =
              ((long long)sTab[tp / ps - p0] * ps + tp % ps) * KV + kh;
          cp4(sKs + st * TR + r, k_scale + so);
          cp4(sVs + st * TR + r, v_scale + so);
        }
      }
    }
    cp_commit();   // one group a tile, empty past the last
  };
  for (int t = 0; t < pd; ++t) stage_tile(t);

  // lanes: LPR to a row, KCH chunks of 4 dims each (chunk ci = k * LPR + li,
  // so a row's lanes read neighbouring 16-byte words); the warp's 32 / LPR
  // row slots take rows rsg, rsg + nrs, ... of each tile
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hd4 = hd >> 2;
  const int need = (hd4 + KCH - 1) / KCH;
  int lpr = 4;
  while (lpr < need) lpr <<= 1;
  const float scale2 = scale * LOG2E;
  const int rs = lane / lpr;
  const int li = lane - rs * lpr;
  const int nrs = NW * (32 / lpr);
  const int rsg = warp * (32 / lpr) + rs;
  const int rpt = TR / nrs;                        // rows a slot a tile

  float qr[GB][KCH][4], acc[GB][KCH][4], m[GB], l[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int k = 0; k < KCH; ++k) {
      const int ci = k * lpr + li;
      const bool ok = ci < hd4 && g0 + g < G;
      const long long e0 = (head0 + g) * hd + ci * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = 0.f;
        if (ok)
          v = q_bf16 ? __bfloat162float(
                           static_cast<const __nv_bfloat16*>(q)[e0 + e])
                     : static_cast<const float*>(q)[e0 + e];
        qr[g][k][e] = v;
        acc[g][k][e] = 0.f;
      }
    }
  }

  for (int t = 0; t < ntiles; ++t) {
    if (pd == 2) cp_wait<1>(); else cp_wait<0>();  // tile t has landed
    __syncthreads();   // ... for every thread, and tile t - 1 is done with
    if (ns > 1) stage_tile(t + pd);  // into tile t - 1's stage
    const int st = t % ns;
    const int rows = min(TR, ce - (cs + t * TR));
    const TKV* tk = reinterpret_cast<const TKV*>(sK + st * tile_bytes);
    const TKV* tv = reinterpret_cast<const TKV*>(sV + st * tile_bytes);

    for (int i0 = 0; i0 < rpt; i0 += RB) {
      float sc[RB][GB];
      int rr[RB];
      bool ok[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        rr[i] = rsg + (i0 + i) * nrs;
        ok[i] = i0 + i < rpt && rr[i] < rows;
#pragma unroll
        for (int g = 0; g < GB; ++g) sc[i][g] = 0.f;
        if (ok[i]) {
          // one partial sum a chunk, so the FMA chains run side by side
          float dk[KCH][GB];
#pragma unroll
          for (int k = 0; k < KCH; ++k) {
            const int ci = k * lpr + li;
#pragma unroll
            for (int g = 0; g < GB; ++g) dk[k][g] = 0.f;
            if (ci < hd4) {
              float x[4];
              ld4(tk + rr[i] * hd + ci * 4, x);
#pragma unroll
              for (int g = 0; g < GB; ++g)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  dk[k][g] = fmaf(qr[g][k][e], x[e], dk[k][g]);
            }
          }
#pragma unroll
          for (int k = 0; k < KCH; ++k)
#pragma unroll
            for (int g = 0; g < GB; ++g) sc[i][g] += dk[k][g];
        }
      }
      for (int o = lpr >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int i = 0; i < RB; ++i)
#pragma unroll
          for (int g = 0; g < GB; ++g)
            sc[i][g] += __shfl_xor_sync(FULL, sc[i][g], o);
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const float ks = (QUANT && ok[i]) ? sKs[st * TR + rr[i]] : 1.f;
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float v = sc[i][g];
          if (QUANT) v *= ks;
          sc[i][g] = ok[i] ? v * scale2 : -INFINITY;
        }
      }
      // online softmax of this slot: sc becomes the weights of the rows
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float mx = m[g];
#pragma unroll
        for (int i = 0; i < RB; ++i) mx = fmaxf(mx, sc[i][g]);
        const float c = weight(m[g], mx);
        float psum = 0.f;
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const float p = weight(sc[i][g], mx);
          psum += p;
          sc[i][g] = (QUANT && ok[i]) ? p * sVs[st * TR + rr[i]] : p;
        }
        if (mx != -INFINITY) {
          l[g] = l[g] * c + psum;
          m[g] = mx;
#pragma unroll
          for (int k = 0; k < KCH; ++k)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[g][k][e] *= c;
        }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        if (!ok[i]) continue;
#pragma unroll
        for (int k = 0; k < KCH; ++k) {
          const int ci = k * lpr + li;
          if (ci < hd4) {
            float x[4];
            ld4(tv + rr[i] * hd + ci * 4, x);
#pragma unroll
            for (int g = 0; g < GB; ++g)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[g][k][e] = fmaf(sc[i][g], x[e], acc[g][k][e]);
          }
        }
      }
    }
    if (ns == 1 && t + 1 < ntiles) {   // one stage: free once all have read it
      __syncthreads();
      stage_tile(t + 1);
    }
  }

  // merge the warp's row slots (lanes li of every slot hold the same dims)
  for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float mo = __shfl_xor_sync(FULL, m[g], o);
      const float lo = __shfl_xor_sync(FULL, l[g], o);
      const float M = fmaxf(m[g], mo);
      const float a = weight(m[g], M);
      const float c = weight(mo, M);
      l[g] = l[g] * a + lo * c;
      m[g] = M;
#pragma unroll
      for (int k = 0; k < KCH; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ao = __shfl_xor_sync(FULL, acc[g][k][e], o);
          acc[g][k][e] = acc[g][k][e] * a + ao * c;
        }
    }
  }

  // then the warps, through shared memory (the ring is free now)
  cp_wait<0>();
  __syncthreads();
  float* sW = reinterpret_cast<float*>(smem);       // NW x GB x hd
  float* sWm = sW + NW * GB * hd;                   // NW x GB
  float* sWl = sWm + NW * GB;                       // NW x GB
  if (rs == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int k = 0; k < KCH; ++k) {
        const int ci = k * lpr + li;
        if (ci < hd4)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sW[(warp * GB + g) * hd + ci * 4 + e] = acc[g][k][e];
      }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      sWm[warp * GB + g] = m[g];
      sWl[warp * GB + g] = l[g];
    }
  }
  __syncthreads();
  for (int e = tid; e < GB * hd; e += NT) {
    const int g = e / hd;
    const int d = e - g * hd;
    if (g0 + g >= G) break;
    float M = -INFINITY;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sWm[w * GB + g]);
    float A = 0.f, L = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float f = weight(sWm[w * GB + g], M);
      if (f == 0.f) continue;
      A += sW[(w * GB + g) * hd + d] * f;
      L += sWl[w * GB + g] * f;
    }
    if (S == 1) {             // the whole prefix: no pass 2, write the output
      const long long o = (head0 + g) * hd + d;
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(A / L);
      else
        static_cast<float*>(out)[o] = A / L;
      continue;
    }
    const long long i = (head0 + g) * S + s;
    part[i * hd + d] = A;
    if (d == 0) {
      part_m[i] = M;
      part_l[i] = L;
    }
  }
}

// ---- pass 2: a head's S partials, in the order s = 0, 1, ... -------------

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// One warp per (slot, query head).  Lanes read the S maxima and sums side by
// side (one latency, not S), then each lane sums its 4-dim chunks over the
// splits in order s = 0, 1, ..., whose loads do not depend on each other.
// An empty partial (m = -inf) has weight 0 and its acc is never read.
// Launched as a programmatic dependent of pass 1 (Hopper), so its blocks
// are scheduled while pass 1 drains; griddepcontrol.wait then holds them
// until pass 1 has finished and its partials are visible.
template <typename TO>
__global__ void __launch_bounds__(COMBINE_NT) paged_attention_combine_kernel(
    const float* __restrict__ part, TO* __restrict__ out, long long BH, int S,
    int hd) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const long long bh =
      (long long)blockIdx.x * (COMBINE_NT / 32) + (threadIdx.x >> 5);
  if (bh >= BH) return;
  const int lane = threadIdx.x & 31;
  const float* pm = part + BH * S * hd + bh * S;
  const float* pl = pm + BH * S;
  const float* pa = part + bh * S * hd;
  float M = -INFINITY;
  for (int s = lane; s < S; s += 32) M = fmaxf(M, pm[s]);
  M = warp_max(M);
  float L = 0.f;
  for (int s = lane; s < S; s += 32) L += pl[s] * weight(pm[s], M);
  L = warp_sum(L);
  const int hd4 = hd >> 2;
  for (int c0 = 0; c0 < hd4; c0 += 32) {
    const int c = c0 + lane;
    float A[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < S; s0 += 32) {
      const float wl = s0 + lane < S ? weight(pm[s0 + lane], M) : 0.f;
      const int js = min(32, S - s0);
#pragma unroll 4
      for (int j = 0; j < js; ++j) {
        const float w = __shfl_sync(FULL, wl, j);
        if (w != 0.f && c < hd4) {
          const float4 a = *reinterpret_cast<const float4*>(
              pa + (long long)(s0 + j) * hd + c * 4);
          A[0] = fmaf(w, a.x, A[0]);
          A[1] = fmaf(w, a.y, A[1]);
          A[2] = fmaf(w, a.z, A[2]);
          A[3] = fmaf(w, a.w, A[3]);
        }
      }
    }
    if (c < hd4) {
      TO* o = out + bh * hd + c * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = from_float<TO>(A[e] / L);
    }
  }
}

// ---- launch ---------------------------------------------------------------

// The shapes and the plan of a launch, made once per shape on the host
// (launch_plan in paged_attention.py keeps a ctypes Structure of the same
// fields, in this order): gb is head_block's, splits and chunk split_plan's.
// `stages`, the tiles of pass 1's ring, is the device's: paged_attention_prepare
// writes it.
struct Plan {
  int B, P, ps, num_pages, KV, G, gb, hd, T, splits, chunk, stages;
  float scale;
};

// Runs `f` with `device` current, then puts the caller's device back.
template <typename F>
int on_device(int device, F f) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (prev != device && (e = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(e);
  const int r = f();
  if (prev != device) cudaSetDevice(prev);
  return r;
}

// Launches `kern` on `stream` as a programmatic dependent of the work before
// it in the stream (the kernel itself waits with griddepcontrol.wait).
template <typename K, typename... A>
cudaError_t launch_pdl(K kern, dim3 grid, int threads, size_t smem,
                       cudaStream_t stream, A... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

struct Args {
  Plan p;
  const void* q; int q_bf16;
  const void* k_pool; const void* v_pool;
  const float* k_scale; const float* v_scale;
  const int* table; const int* pos; float* part; void* out; int out_bf16;
  cudaStream_t stream;
};

// Lets pass 1's instantiation for `p` take the device's whole opt-in shared
// memory (once per shape, from paged_attention_prepare), picks the deepest
// ring that fits it (MAX_STAGES tiles, at most the chunk's, else fewer) into
// p->stages, and returns the bytes a block then needs, or a negative
// cudaError_t: -cudaErrorInvalidConfiguration where even one tile does not
// fit.
template <typename TKV, int GB, bool QUANT>
int prepare_split(Plan* p) {
  int optin = 0, dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(paged_attention_split_kernel<TKV, GB, QUANT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const int tiles = (p->chunk + TR - 1) / TR;
  for (int ns = tiles < MAX_STAGES ? tiles : MAX_STAGES; ns >= 1; --ns) {
    const size_t smem = smem_bytes(GB, p->hd, sizeof(TKV), QUANT, p->chunk, p->ps, ns);
    if (smem <= (size_t)optin) {
      p->stages = ns;
      return static_cast<int>(smem);
    }
  }
  return -static_cast<int>(cudaErrorInvalidConfiguration);
}

template <typename TKV, int GB, bool QUANT>
int launch_split(const Args& a) {
  const Plan& p = a.p;
  const size_t smem =
      smem_bytes(GB, p.hd, sizeof(TKV), QUANT, p.chunk, p.ps, p.stages);
  const dim3 grid(p.KV * ((p.G + GB - 1) / GB), p.B, p.splits);
  return static_cast<int>(launch_pdl(
      paged_attention_split_kernel<TKV, GB, QUANT>, grid, NT, smem, a.stream,
      a.q, a.q_bf16, static_cast<const TKV*>(a.k_pool),
      static_cast<const TKV*>(a.v_pool), a.k_scale, a.v_scale, a.table, a.pos,
      a.part, a.out, a.out_bf16, p.B, p.P, p.ps, p.num_pages, p.KV, p.G, p.hd,
      p.T, p.splits, p.chunk, p.stages, p.scale));
}

// The instantiations of pass 1, one per GB that head_block may return
// (tests/test_torch_split_plan.py reads this table).  With `prepared`, the
// set-up of prepare_split into *prepared; else the launch of `a`.
template <typename TKV, bool QUANT>
int launch_split_for(const Args& a, Plan* prepared) {
  switch (a.p.gb) {
    case 1: return prepared ? prepare_split<TKV, 1, QUANT>(prepared) : launch_split<TKV, 1, QUANT>(a);
    case 2: return prepared ? prepare_split<TKV, 2, QUANT>(prepared) : launch_split<TKV, 2, QUANT>(a);
    case 4: return prepared ? prepare_split<TKV, 4, QUANT>(prepared) : launch_split<TKV, 4, QUANT>(a);
    case 8: return prepared ? prepare_split<TKV, 8, QUANT>(prepared) : launch_split<TKV, 8, QUANT>(a);
    case 16: return prepared ? prepare_split<TKV, 16, QUANT>(prepared) : launch_split<TKV, 16, QUANT>(a);
    default: return (prepared ? -1 : 1) * static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TO>
int launch_combine(const Args& a) {
  const long long BH = (long long)a.p.B * a.p.KV * a.p.G;
  constexpr int heads_per_block = COMBINE_NT / 32;
  const dim3 grid((unsigned)((BH + heads_per_block - 1) / heads_per_block));
  return static_cast<int>(launch_pdl(
      paged_attention_combine_kernel<TO>, grid, COMBINE_NT, 0, a.stream,
      static_cast<const float*>(a.part), static_cast<TO*>(a.out), BH,
      a.p.splits, a.p.hd));
}

// The host's plan, checked, not derived: its splits cover [0, T) and none
// starts past it (so every table read of pass 1 stays in its row), and a
// row's 4-dim chunks fit the lanes gb leaves (hd <= 128 * KCH); for a
// launch, the ring has the depth prepare gave it.
bool plan_ok(const Plan& p, bool prepare) {
  const int kch = p.gb >= 1 ? kch_of(p.gb) : 0;
  const bool ring_ok = prepare || (p.stages >= 1 && p.stages <= MAX_STAGES);
  return ring_ok && p.splits >= 1 && p.chunk >= 1 && p.ps >= 1 &&
         (long long)p.splits * p.chunk >= p.T &&
         (long long)(p.splits - 1) * p.chunk < p.T && p.hd % 4 == 0 &&
         p.hd >= 4 && kch >= 1 && p.hd <= 128 * kch;
}

// Pass 1 and, with more than one split, pass 2 (or, with `prepared`, pass
// 1's set-up into *prepared) on `device`, over pools of `kv_bytes`-byte
// elements.
template <bool QUANT>
int run(const Args& a, int kv_bytes, int device, Plan* prepared = nullptr) {
  const bool prepare = prepared != nullptr;
  const int refused = (prepare ? -1 : 1) * static_cast<int>(cudaErrorInvalidValue);
  if (!plan_ok(a.p, prepare) || (!prepare && a.p.splits > 1 && a.part == nullptr))
    return refused;
  return on_device(device, [&]() -> int {
    int e = refused;
    if constexpr (QUANT) {
      if (kv_bytes == 1) e = launch_split_for<int8_t, true>(a, prepared);
    } else {
      if (kv_bytes == 4) e = launch_split_for<float, false>(a, prepared);
      if (kv_bytes == 2) e = launch_split_for<__nv_bfloat16, false>(a, prepared);
    }
    if (prepare || e || a.p.splits == 1) return e;
    return a.out_bf16 ? launch_combine<__nv_bfloat16>(a) : launch_combine<float>(a);
  });
}

}  // namespace

// Plain C entry points, loaded with ctypes.  dtype codes: 0 float32,
// 1 bfloat16.  `plan` holds the shapes and the plan (struct Plan above).
// `part` is float32 scratch of B*H*splits*(hd + 2) elements (partial
// accumulators, then maxima, then sums), null when splits = 1.  Each runs
// on `device` (and puts the caller's device back), launches its kernels
// (pass 2 only when splits > 1) on `stream` and returns a cudaError_t (0
// on success).

// Once per shape, before its first launch: writes plan->stages, the
// deepest ring that fits the device, and returns the shared memory a block
// of `plan` then needs (bytes), having let its kernel take the device's
// opt-in; else a negative cudaError_t: -cudaErrorInvalidValue where the
// plan or the pools' element is not one the kernels take,
// -cudaErrorInvalidConfiguration where even a one-tile ring does not fit.
// `kv_bytes`: 4 float32, 2 bfloat16, 1 int8 pools (with `quant`).
extern "C" int paged_attention_prepare(void* plan, int kv_bytes, int quant,
                                       int device) {
  Args a{};
  Plan* p = static_cast<Plan*>(plan);
  a.p = *p;
  return quant ? run<true>(a, kv_bytes, device, p)
               : run<false>(a, kv_bytes, device, p);
}

extern "C" int paged_attention_float(const void* q, const void* k_pool,
                                     const void* v_pool, const void* table,
                                     const void* pos, void* part, void* out,
                                     const void* plan, int dtype, int device,
                                     void* stream) {
  const Args a{*static_cast<const Plan*>(plan), q, dtype, k_pool, v_pool,
               nullptr, nullptr, static_cast<const int*>(table),
               static_cast<const int*>(pos), static_cast<float*>(part), out,
               dtype, static_cast<cudaStream_t>(stream)};
  if (dtype & ~1) return static_cast<int>(cudaErrorInvalidValue);
  return run<false>(a, dtype ? 2 : 4, device);
}

extern "C" int paged_attention_int8(const void* q, const void* k_pool,
                                    const void* k_scale, const void* v_pool,
                                    const void* v_scale, const void* table,
                                    const void* pos, void* part, void* out,
                                    const void* plan, int q_dtype,
                                    int out_dtype, int device, void* stream) {
  const Args a{*static_cast<const Plan*>(plan), q, q_dtype, k_pool, v_pool,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(table), static_cast<const int*>(pos),
               static_cast<float*>(part), out, out_dtype,
               static_cast<cudaStream_t>(stream)};
  if ((q_dtype | out_dtype) & ~1) return static_cast<int>(cudaErrorInvalidValue);
  return run<true>(a, 1, device);
}
