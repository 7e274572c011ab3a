// Split-KV flash decode: one new token's GQA attention over a KV cache,
//   out[b, h] = softmax_s(q[b, h] . k[b, s, h / G] / sqrt(D)) . v[b, s, h / G]
// over the rows s < cache_len[b] (clamped to S), accumulated in fp32, the
// output in q's type.  A row with cache_len <= 0 gets the reference's
// answer under its -1e30 mask: every score equal, so the uniform mean of V
// over all S rows (no NaN).
//
// On request (lse != nullptr) it also writes each (b, head)'s log-sum-exp
// of the scores over its rows, lse = ln sum_s exp(score_s), a (B, Hq)
// fp32 tensor: what a cache split by rows over ranks merges its slices'
// outputs by, o = sum_r exp(lse_r - lse) o_r.  There a slice with
// cache_len <= 0 holds no valid row: it reads none and gives o = 0 and
// lse = -inf, a weight of exactly 0 in the merge.
//
// Replaces: src/repro/kernels/flash_decode/flash_decode.py, flash_decode
//   (body _kernel), the TPU drop-in for repro.nn.attention's
//   decode_attention_jnp.  On the TPU the grid (B, KVH, S / kv_block) walks
//   the KV blocks in order on one core and carries the running max m, sum l
//   and accumulator acc in VMEM from block to block.  Here blocks run in
//   parallel with nothing carried between them, so the S axis is split
//   across CTAs and a second kernel merges the splits.  Any S is taken
//   (the Pallas kernel needs S % kv_block == 0): rows past the end are
//   masked here.
//
// What bounds it on an H100: bytes.  Each K and V row is used by the G
//   query heads of its KV head and then never again: at Yi-6B's decode
//   shape (B 8, KVH 4, G 8, D 128, S ~4,160, bf16) K + V are 68 MB per layer
//   against 8.4 MFLOP per KV head row block, so the bound is ~0.020 ms at
//   3.35 TB/s.  One CTA per (b, kv head), the TPU grid without its
//   sequential axis, would give B * KVH = 32 CTAs for 132 SMs (4 at B = 1),
//   far below the card's memory rate.
//
// Every instance runs a partial kernel over the grid (splits, KVH * head
// groups, B) and then flash_decode_combine.  Each partial CTA takes a
// contiguous share of [0, min(cache_len, S)) -- computed on the device
// from cache_len, so no host sync is needed -- and writes one partial
// (m, l, acc[D]) per query head into an fp32 scratch (B, Hq, splits, 2|D)
// that the wrapper allocates; a split with no rows writes m = -1e30,
// l = 0, acc = 0.  flash_decode_combine, grid (Hq, B), merges the splits
// of one (b, head): out = sum_s acc_s 2^(m_s - M) / sum_s l_s 2^(m_s - M),
// written in q's type.  The wrapper (kernels/flash_decode/ops.py::plan)
// picks the instance and the split count, so the grid is one wave of at
// most two CTAs per SM.  Scores are kept in log2 units (exp2f).
//
// Instance 1, tensor cores: bf16 with G > 1 and D <= 128 (group_tile 16).
//   flash_decode_partial_tc.  The G query heads of a head group, zero-
//   padded to 16, are the A operand of S = Q K^T (mma.sync m16n8k16, bf16
//   in, fp32 out, FlashAttention-2's register layout), loaded once into
//   registers as fragments.  The CTA streams its rows in tiles of 64 rows
//   of K and of V through a 3-stage cp.async ring in shared memory (16-byte
//   .cg copies with a 128-byte L2 prefetch hint; rows at or past the end
//   are zero-filled, so no garbage reaches the products); smem rows are
//   padded by 16 bytes, so ldmatrix reads 8 rows without bank conflicts.
//   Each of the 4 warps owns 16 rows of every tile: K rows are the B
//   operand via ldmatrix, its S fragments get one online-softmax rescale
//   per tile, and the P fragments are reused in registers as the A
//   operand of P V, with V the B operand via ldmatrix.trans.  p keeps its
//   fp32 precision: it is split into hi = bf16(p) and lo = bf16(p - hi),
//   two MMAs whose sum is p to ~2^-16, as decode_attention_jnp and the
//   plain version keep p in fp32 (the Pallas kernel rounds p to bf16).
//   Padding G = 8 to 16 wastes half of each MMA; that costs nothing here,
//   the kernel is bound by bytes.  D is zero-padded to the instance's 64
//   or 128.  The warps' (m, l, O) are merged through shared memory at the
//   end.  3 stages x 34 KB = 102 KB of shared memory at D 128: two CTAs
//   per SM.  Tried on an H100 and no faster: p rounded to bf16 alone, 2
//   stages (also at 3 CTAs per SM), a grid with the head groups fastest.
//
// Instance 2, CUDA cores (the previous design): f32, G = 1, and bf16 with
//   D > 128.  flash_decode_partial, group_tile 1 or 8 (a group of G < 8
//   heads runs in a tile of 8 with the rest masked).  The CTA's 128
//   threads form row groups of P lanes (P = D / 8 rounded up to a power of
//   two); a lane holds 8 elements of D and loads them with 16-byte loads
//   (bf16: one, f32: two).  A row group reads TR consecutive rows of K and
//   V per step, once, for all GT query heads of its head group, whose
//   scaled q lives in registers; the next step's rows are loaded while
//   this step computes.  Scores are reduced across the row group by xor
//   shuffles and fed to an fp32 online softmax, rescaled once per TR rows;
//   p stays fp32.  The row groups' (m, l, acc) are merged through shared
//   memory.  f32 stays here because it is held at 1e-4, which TF32 cannot
//   meet; G = 1 because it has no head axis to feed an MMA and already runs
//   near its bound.  chip_smoke.py also times the bf16 G = 8 case on this
//   instance (group_tile 8), the design the tensor-core one replaced.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;               // 4 warps per CTA
constexpr float kMasked = -1e30f;           // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;

// 8 consecutive elements of one row, as loaded (16 bytes per load).
template <typename T> struct Chunk;
template <> struct Chunk<__nv_bfloat16> { uint4 r; };
template <> struct Chunk<float> { float4 a, b; };

__device__ __forceinline__ void load(const __nv_bfloat16* p,
                                     Chunk<__nv_bfloat16>& c) {
  c.r = __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void load(const float* p, Chunk<float>& c) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
  c.a = __ldg(p4);
  c.b = __ldg(p4 + 1);
}
__device__ __forceinline__ void zero(Chunk<__nv_bfloat16>& c) {
  c.r = make_uint4(0u, 0u, 0u, 0u);
}
__device__ __forceinline__ void zero(Chunk<float>& c) {
  c.a = make_float4(0.f, 0.f, 0.f, 0.f);
  c.b = c.a;
}
__device__ __forceinline__ void to_float(const Chunk<__nv_bfloat16>& c,
                                         float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&c.r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void to_float(const Chunk<float>& c,
                                         float (&f)[8]) {
  f[0] = c.a.x; f[1] = c.a.y; f[2] = c.a.z; f[3] = c.a.w;
  f[4] = c.b.x; f[5] = c.b.y; f[6] = c.b.z; f[7] = c.b.w;
}

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Rows r0 .. r0 + TR - 1 of K and V at this lane's 8 elements; rows at or
// past hi (and lanes past D) read nothing and hold zeros.
template <typename T, int TR>
__device__ __forceinline__ void fetch(const T* kb, const T* vb,
                                      size_t row_stride, int r0, int hi,
                                      bool has_chunk, Chunk<T> (&kr)[TR],
                                      Chunk<T> (&vr)[TR]) {
#pragma unroll
  for (int t = 0; t < TR; ++t) {
    if (r0 + t < hi && has_chunk) {
      load(kb + (r0 + t) * row_stride, kr[t]);
      load(vb + (r0 + t) * row_stride, vr[t]);
    } else {
      zero(kr[t]);
      zero(vr[t]);
    }
  }
}

// q (B, Hq, D); k, v (B, S, KVH, D); cache_len (B,) int32;
// part_ml (B, Hq, splits, 2) and part_acc (B, Hq, splits, D) fp32.
template <typename T, int GT, int TR>
__global__ void __launch_bounds__(kThreads)
flash_decode_partial(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const int* __restrict__ cache_len,
                     float* __restrict__ part_ml,
                     float* __restrict__ part_acc, int S, int Hq, int KVH,
                     int D, int G, int P, int splits, int lse_mode) {
  extern __shared__ float smem[];
  const int split = blockIdx.x;
  const int n_groups = (G + GT - 1) / GT;
  const int kvh = blockIdx.y / n_groups;
  const int h0 = kvh * G + (blockIdx.y % n_groups) * GT;   // first head
  const int ng = min(GT, kvh * G + G - h0);                // heads here
  const int b = blockIdx.z;

  const int lane = threadIdx.x & 31;
  const int rpw = 32 / P;                                  // rows per warp
  const int rg = (threadIdx.x >> 5) * rpw + lane / P;      // row group
  const int nrg = (kThreads / 32) * rpw;
  const int d0 = (lane % P) * 8;
  const bool has_chunk = d0 < D;

  const int len = cache_len[b];
  const bool none_valid = len <= 0;          // every score is the mask
  // ... or, merged by log-sum-exp, no row at all
  const int n_rows = none_valid ? (lse_mode ? 0 : S) : min(len, S);
  const int per = (n_rows + splits - 1) / splits;
  const int lo = min(split * per, n_rows);
  const int hi = min(lo + per, n_rows);

  // q pre-scaled by log2(e) / sqrt(D): scores come out in log2 units
  const float qscale = kLog2e / sqrtf(static_cast<float>(D));
  float qf[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < ng && has_chunk) {
      Chunk<T> c;
      load(q + (static_cast<size_t>(b) * Hq + h0 + g) * D + d0, c);
      to_float(c, qf[g]);
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[g][e] *= qscale;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[g][e] = 0.f;
    }
  }
  float m[GT], l[GT], acc[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kMasked;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  const size_t row_stride = static_cast<size_t>(KVH) * D;
  const size_t base_off =
      (static_cast<size_t>(b) * S * KVH + kvh) * D + d0;
  const T* kb = k + base_off;
  const T* vb = v + base_off;

  // the next tile's K/V are loaded while this tile is computed
  const int step = nrg * TR;
  Chunk<T> kr[TR], vr[TR];
  fetch<T, TR>(kb, vb, row_stride, lo + rg * TR, hi, has_chunk, kr, vr);
  for (int base = lo; base < hi; base += step) {
    const int r0 = base + rg * TR;
    Chunk<T> kn[TR], vn[TR];
    fetch<T, TR>(kb, vb, row_stride, r0 + step, hi, has_chunk, kn, vn);
    float s[TR][GT];
#pragma unroll
    for (int t = 0; t < TR; ++t) {
      float kf[8];
      to_float(kr[t], kf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qf[g][e], kf[e], dot);
        s[t][g] = dot;
      }
    }
    // every lane of a row group ends with the group's full dot products;
    // the TR * GT independent sums share each butterfly step, so their
    // shuffles overlap instead of forming TR * GT serial chains
    for (int off = P >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int t = 0; t < TR; ++t) {
#pragma unroll
        for (int g = 0; g < GT; ++g)
          s[t][g] += __shfl_xor_sync(0xffffffffu, s[t][g], off);
      }
    }
#pragma unroll
    for (int t = 0; t < TR; ++t) {
#pragma unroll
      for (int g = 0; g < GT; ++g)
        s[t][g] = r0 + t >= hi ? -INFINITY
                               : (none_valid ? kMasked : s[t][g]);
    }
    // online softmax, rescaled once per TR rows; s becomes p
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mt = m[g];
#pragma unroll
      for (int t = 0; t < TR; ++t) mt = fmaxf(mt, s[t][g]);
      const float corr = exp2f(m[g] - mt);
      m[g] = mt;
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int t = 0; t < TR; ++t) {
        s[t][g] = exp2f(s[t][g] - mt);
        l[g] += s[t][g];
      }
    }
#pragma unroll
    for (int t = 0; t < TR; ++t) {
      float vf[8];
      to_float(vr[t], vf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(s[t][g], vf[e],
                                                     acc[g][e]);
      }
    }
#pragma unroll
    for (int t = 0; t < TR; ++t) {
      kr[t] = kn[t];
      vr[t] = vn[t];
    }
  }

  // merge the CTA's row groups: smem m, l [nrg][GT] and acc [nrg][GT][D]
  float* sm_m = smem;
  float* sm_l = sm_m + nrg * GT;
  float* sm_acc = sm_l + nrg * GT;
  if (lane % P == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      sm_m[rg * GT + g] = m[g];
      sm_l[rg * GT + g] = l[g];
    }
  }
  if (has_chunk) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        sm_acc[(rg * GT + g) * D + d0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mx = kMasked;
    for (int r = 0; r < nrg; ++r) mx = fmaxf(mx, sm_m[r * GT + g]);
    float sum_l = 0.f, sum_acc = 0.f;
    for (int r = 0; r < nrg; ++r) {
      const float w = exp2f(sm_m[r * GT + g] - mx);
      sum_l = fmaf(sm_l[r * GT + g], w, sum_l);
      sum_acc = fmaf(sm_acc[(r * GT + g) * D + d], w, sum_acc);
    }
    const size_t row =
        (static_cast<size_t>(b) * Hq + h0 + g) * splits + split;
    part_acc[row * D + d] = sum_acc;
    if (d == 0) {
      part_ml[row * 2] = mx;
      part_ml[row * 2 + 1] = sum_l;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_combine(const float* __restrict__ part_ml,
                     const float* __restrict__ part_acc,
                     T* __restrict__ out, float* __restrict__ lse,
                     int Hq, int D, int splits) {
  const size_t bh = static_cast<size_t>(blockIdx.y) * Hq + blockIdx.x;
  const float* ml = part_ml + bh * splits * 2;
  const float* acc = part_acc + bh * splits * D;
  float mx = kMasked;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[2 * s]);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float sum_l = 0.f, sum_acc = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = exp2f(ml[2 * s] - mx);
      sum_l = fmaf(ml[2 * s + 1], w, sum_l);
      sum_acc = fmaf(acc[static_cast<size_t>(s) * D + d], w, sum_acc);
    }
    store(out + bh * D + d, sum_l > 0.f ? sum_acc / sum_l : 0.f);
  }
  if (lse != nullptr && threadIdx.x == 0) {
    // M and L in log2 units: lse = (M + log2 L) ln 2; no rows: -inf
    float sum_l = 0.f;
    for (int s = 0; s < splits; ++s)
      sum_l = fmaf(ml[2 * s + 1], exp2f(ml[2 * s] - mx), sum_l);
    lse[bh] = sum_l > 0.f ? (mx + log2f(sum_l)) * 0.6931471805599453f
                          : -INFINITY;
  }
}

// ------------------------------------------------ tensor-core instance -----

constexpr int kTcRows = 64;       // cache rows per tile (16 per warp)
constexpr int kTcStages = 3;      // tiles in flight in the cp.async ring
constexpr int kTcHeads = 16;      // query heads per CTA (the MMA's M)

// dynamic shared memory of the ring: K and V tiles, rows padded by 8
// elements (kernels/flash_decode/ops.py::tc_smem_bytes says the same)
constexpr size_t tc_smem_bytes(int dt) {
  return static_cast<size_t>(kTcStages) * 2 * kTcRows * (dt + 8) *
         sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1, with a 128-byte L2 prefetch
// hint (a row's neighbouring chunks come next); src_bytes = 0 zero-fills
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile(
      "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(dst),
      "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2,
                                                  uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x0, x1) -> hi = bf16(x), lo = bf16(x - hi), packed low element first
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// Rows r0 .. r0 + 63 of K and V (DT / 8 16-byte chunks each) into one
// stage of the ring; rows at or past hi and chunks past D are zero-filled.
template <int DT>
__device__ __forceinline__ void tc_load_tile(
    const __nv_bfloat16* kb, const __nv_bfloat16* vb, size_t row_stride,
    int r0, int hi, int D, __nv_bfloat16* ks, __nv_bfloat16* vs) {
  constexpr int RS = DT + 8;
  constexpr int CPR = DT / 8;
  for (int i = threadIdx.x; i < kTcRows * CPR; i += kThreads) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = r0 + r < hi && c * 8 < D;
    const size_t off = ok ? static_cast<size_t>(r0 + r) * row_stride + c * 8
                          : 0;
    const int n = ok ? 16 : 0;
    cp_async16(smem_u32(ks + r * RS + c * 8), kb + off, n);
    cp_async16(smem_u32(vs + r * RS + c * 8), vb + off, n);
  }
}

// q (B, Hq, D); k, v (B, S, KVH, D) bf16; cache_len (B,) int32;
// part_ml (B, Hq, splits, 2) and part_acc (B, Hq, splits, D) fp32.
template <int DT>
__global__ void __launch_bounds__(kThreads, 2)
flash_decode_partial_tc(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ cache_len,
                        float* __restrict__ part_ml,
                        float* __restrict__ part_acc, int S, int Hq,
                        int KVH, int D, int G, int splits,
                        int lse_mode) {
  constexpr int RS = DT + 8;                 // smem row stride, elements
  constexpr int TILE = kTcRows * RS;         // one K or V tile, elements
  constexpr int KT = DT / 16;                // MMA k-steps over D
  constexpr int NT = DT / 8;                 // 8-wide n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int split = blockIdx.x;
  const int n_groups = (G + kTcHeads - 1) / kTcHeads;
  const int kvh = blockIdx.y / n_groups;
  const int h0 = kvh * G + (blockIdx.y % n_groups) * kTcHeads;
  const int ng = min(kTcHeads, kvh * G + G - h0);
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int len = cache_len[b];
  const bool none_valid = len <= 0;          // every score is the mask
  // ... or, merged by log-sum-exp, no row at all
  const int n_rows = none_valid ? (lse_mode ? 0 : S) : min(len, S);
  const int per = (n_rows + splits - 1) / splits;
  const int lo = min(split * per, n_rows);
  const int hi = min(lo + per, n_rows);
  const int n_tiles = (hi - lo + kTcRows - 1) / kTcRows;

  const size_t row_stride = static_cast<size_t>(KVH) * D;
  const size_t base_off = (static_cast<size_t>(b) * S * KVH + kvh) * D;
  const __nv_bfloat16* kb = k + base_off;
  const __nv_bfloat16* vb = v + base_off;

  // start the ring before anything waits on memory
#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    if (st < n_tiles)
      tc_load_tile<DT>(kb, vb, row_stride, lo + st * kTcRows, hi, D,
                       ring + 2 * st * TILE, ring + (2 * st + 1) * TILE);
    cp_async_commit();
  }

  // Q as A fragments: this lane's heads ha, hb = ha + 8 of the group, at
  // d pairs (lane % 4) * 2 (+ 8) of each k-step; padded heads and d are 0
  const int ha = lane >> 2, hb = ha + 8;
  uint32_t qa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int head = (j & 1) ? hb : ha;
      const int d = kk * 16 + (lane & 3) * 2 + ((j & 2) ? 8 : 0);
      qa[kk][j] = head < ng && d < D
                      ? *reinterpret_cast<const uint32_t*>(
                            q + (static_cast<size_t>(b) * Hq + h0 + head) *
                                    D + d)
                      : 0u;
    }
  }

  const float scale = kLog2e / sqrtf(static_cast<float>(D));
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = kMasked, m_b = kMasked, l_a = 0.f, l_b = 0.f;
  const int wr = warp * 16;                  // this warp's rows of a tile

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kTcStages - 2>();          // tile t has landed
    __syncthreads();                         // for every thread; and the
                                             // stage refilled below is free
    {
      const int nt = t + kTcStages - 1;
      const int st = nt % kTcStages;
      if (nt < n_tiles)
        tc_load_tile<DT>(kb, vb, row_stride, lo + nt * kTcRows, hi, D,
                         ring + 2 * st * TILE, ring + (2 * st + 1) * TILE);
      cp_async_commit();
    }
    const __nv_bfloat16* ks = ring + 2 * (t % kTcStages) * TILE;
    const __nv_bfloat16* vs = ks + TILE;

    // S (16 heads x 16 rows) = Q K^T: two n-tiles of 8 rows
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    {
      const int r = wr + ((lane >> 4) << 3) + (lane & 7);
      const int c = ((lane >> 3) & 1) << 3;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(smem_u32(ks + r * RS + kk * 16 + c), b0, b1, b2, b3);
        mma_bf16(sc[0], qa[kk], b0, b1);
        mma_bf16(sc[1], qa[kk], b2, b3);
      }
    }
    // scale to log2 units, mask; sc[n][0..1] are head ha, [2..3] head hb,
    // at rows n * 8 + (lane % 4) * 2 + {0, 1} of the warp's 16
    const int rbase = lo + t * kTcRows + wr + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = rbase + n * 8 + (j & 1);
        sc[n][j] = row >= hi ? -INFINITY
                             : (none_valid ? kMasked : sc[n][j] * scale);
      }
    }
    // one online-softmax rescale per tile; m is uniform over the 4 lanes
    // of a head, l stays a per-lane partial sum until the end
    float mx_a = fmaxf(fmaxf(sc[0][0], sc[0][1]), fmaxf(sc[1][0], sc[1][1]));
    float mx_b = fmaxf(fmaxf(sc[0][2], sc[0][3]), fmaxf(sc[1][2], sc[1][3]));
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float p[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p[n][j] = exp2f(sc[n][j] - (j < 2 ? m_a : m_b));
    }
    l_a = fmaf(l_a, corr_a, (p[0][0] + p[0][1]) + (p[1][0] + p[1][1]));
    l_b = fmaf(l_b, corr_b, (p[0][2] + p[0][3]) + (p[1][2] + p[1][3]));
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= corr_a;
      o[n][1] *= corr_a;
      o[n][2] *= corr_b;
      o[n][3] *= corr_b;
    }
    // P (16 heads x 16 rows) as A fragments, hi and lo parts
    uint32_t ph[4], pl[4];
    split_bf16(p[0][0], p[0][1], ph[0], pl[0]);
    split_bf16(p[0][2], p[0][3], ph[1], pl[1]);
    split_bf16(p[1][0], p[1][1], ph[2], pl[2]);
    split_bf16(p[1][2], p[1][3], ph[3], pl[3]);
    // O += P V: V rows are the k axis, two 8-wide d n-tiles per ldmatrix
    {
      const int r = wr + (((lane >> 3) & 1) << 3) + (lane & 7);
      const int c = (lane >> 4) << 3;
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t v0, v1, v2, v3;
        ldmatrix_x4_trans(smem_u32(vs + r * RS + n2 * 16 + c), v0, v1, v2,
                          v3);
        mma_bf16(o[2 * n2], ph, v0, v1);
        mma_bf16(o[2 * n2], pl, v0, v1);
        mma_bf16(o[2 * n2 + 1], ph, v2, v3);
        mma_bf16(o[2 * n2 + 1], pl, v2, v3);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                           // the ring is free for reuse

  // merge the 4 warps: smem m, l [4][16] and O [4][16][DT]
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  float* sm_m = reinterpret_cast<float*>(smem_raw);
  float* sm_l = sm_m + 4 * kTcHeads;
  float* sm_o = sm_l + 4 * kTcHeads;
  const int wa = warp * kTcHeads + ha, wb = warp * kTcHeads + hb;
  if ((lane & 3) == 0) {
    sm_m[wa] = m_a;
    sm_l[wa] = l_a;
    sm_m[wb] = m_b;
    sm_l[wb] = l_b;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = n * 8 + (lane & 3) * 2;
    sm_o[wa * DT + d] = o[n][0];
    sm_o[wa * DT + d + 1] = o[n][1];
    sm_o[wb * DT + d] = o[n][2];
    sm_o[wb * DT + d + 1] = o[n][3];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mx = kMasked;
    for (int r = 0; r < 4; ++r) mx = fmaxf(mx, sm_m[r * kTcHeads + g]);
    float sum_l = 0.f, sum_acc = 0.f;
    for (int r = 0; r < 4; ++r) {
      const float w = exp2f(sm_m[r * kTcHeads + g] - mx);
      sum_l = fmaf(sm_l[r * kTcHeads + g], w, sum_l);
      sum_acc = fmaf(sm_o[(r * kTcHeads + g) * DT + d], w, sum_acc);
    }
    const size_t row =
        (static_cast<size_t>(b) * Hq + h0 + g) * splits + split;
    part_acc[row * D + d] = sum_acc;
    if (d == 0) {
      part_ml[row * 2] = mx;
      part_ml[row * 2 + 1] = sum_l;
    }
  }
}

template <int DT>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* cache_len, void* part_ml, void* part_acc,
                      void* out, void* lse, int B, int S, int Hq, int KVH,
                      int D, int splits, cudaStream_t stream) {
  const int G = Hq / KVH;
  constexpr size_t smem = tc_smem_bytes(DT);
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_partial_tc<DT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, KVH * ((G + kTcHeads - 1) / kTcHeads), B);
  flash_decode_partial_tc<DT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int*>(cache_len), static_cast<float*>(part_ml),
      static_cast<float*>(part_acc), S, Hq, KVH, D, G, splits,
      lse != nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_combine<__nv_bfloat16><<<dim3(Hq, B), kThreads, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Hq, D,
      splits);
  return cudaGetLastError();
}

// ------------------------------------------------- CUDA-core instance -----

template <typename T, int GT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* cache_len, void* part_ml, void* part_acc,
                   void* out, void* lse, int B, int S, int Hq, int KVH,
                   int D, int splits, cudaStream_t stream) {
  // rows per group per step; two steps' K/V are in registers at a time
  constexpr int TR = sizeof(T) == 2 ? 2 : 1;
  const int G = Hq / KVH;
  int P = 1;
  while (P * 8 < D) P *= 2;
  const int nrg = (kThreads / 32) * (32 / P);
  const size_t smem = static_cast<size_t>(nrg) * GT * (D + 2) * sizeof(float);
  const dim3 grid(splits, KVH * ((G + GT - 1) / GT), B);
  flash_decode_partial<T, GT, TR><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(cache_len),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), S, Hq,
      KVH, D, G, P, splits, lse != nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_combine<T><<<dim3(Hq, B), kThreads, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<T*>(out), static_cast<float*>(lse), Hq, D, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int group_tile, const void* q, const void* k,
                     const void* v, const void* cache_len, void* part_ml,
                     void* part_acc, void* out, void* lse, int B, int S,
                     int Hq, int KVH, int D, int splits,
                     cudaStream_t stream) {
  switch (group_tile) {
    case 1: return launch<T, 1>(q, k, v, cache_len, part_ml, part_acc, out,
                                lse, B, S, Hq, KVH, D, splits, stream);
    case 8: return launch<T, 8>(q, k, v, cache_len, part_ml, part_acc, out,
                                lse, B, S, Hq, KVH, D, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, Hq, D), k and v (B, S, KVH, D), out (B, Hq, D): contiguous, 16-byte
// aligned, all bf16 (is_bf16 = 1) or all f32; cache_len (B,) int32;
// part_ml (B, Hq, splits, 2) and part_acc (B, Hq, splits, D) fp32 scratch.
// group_tile picks the instance: 16 the tensor-core one (bf16, D <= 128;
// 16 query heads share a CTA, a group of fewer heads is zero-padded), 1 or
// 8 the CUDA-core one (a group of G < 8 heads runs in a tile of 8 with the
// rest masked).  lse, when not null, receives the (B, Hq) fp32
// log-sum-exp of each head's scores (a row with cache_len <= 0 then reads
// no row: out 0, lse -inf).  Returns the cudaError_t of the launches
// (0 = launched).
int flash_decode(const void* q, const void* k, const void* v,
                 const void* cache_len, void* part_ml, void* part_acc,
                 void* out, void* lse, int B, int S, int Hq, int KVH, int D,
                 int group_tile, int splits, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || KVH <= 0 || Hq % KVH != 0 || D <= 0 ||
      D % 8 != 0 || D > 256 || splits <= 0 || splits > 65535 ||
      B > 65535 ||
      (group_tile != 1 && group_tile != 8 && group_tile != kTcHeads) ||
      KVH * ((Hq / KVH + group_tile - 1) / group_tile) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group_tile == kTcHeads) {
    if (!is_bf16 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err =
        D <= 64 ? launch_tc<64>(q, k, v, cache_len, part_ml, part_acc, out,
                                lse, B, S, Hq, KVH, D, splits, s)
                : launch_tc<128>(q, k, v, cache_len, part_ml, part_acc, out,
                                 lse, B, S, Hq, KVH, D, splits, s);
    return static_cast<int>(err);
  }
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(group_tile, q, k, v, cache_len,
                                        part_ml, part_acc, out, lse, B, S,
                                        Hq, KVH, D, splits, s)
              : dispatch<float>(group_tile, q, k, v, cache_len, part_ml,
                                part_acc, out, lse, B, S, Hq, KVH, D, splits,
                                s);
  return static_cast<int>(err);
}

}  // extern "C"
