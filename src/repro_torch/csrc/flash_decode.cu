// Split-KV flash decode: one new token's GQA attention over a KV cache,
//   out[b, h] = softmax_s(q[b, h] . k[b, s, h / G] / sqrt(D)) . v[b, s, h / G]
// over the rows s < cache_len[b] (clamped to S), accumulated in fp32, the
// output in q's type.  A row with cache_len <= 0 gets the reference's
// answer under its -1e30 mask: every score equal, so the uniform mean of V
// over all S rows (no NaN).
//
// Replaces: src/repro/kernels/flash_decode/flash_decode.py, flash_decode
//   (body _kernel), the TPU drop-in for repro.nn.attention's
//   decode_attention_jnp.  On the TPU the grid (B, KVH, S / kv_block) walks
//   the KV blocks in order on one core and carries the running max m, sum l
//   and accumulator acc in VMEM from block to block.  Here blocks run in
//   parallel with nothing carried between them, so the S axis is split
//   across CTAs and a second kernel merges the splits.  The Pallas kernel
//   rounds p to bf16 before the PV product; this one keeps p in fp32, as
//   decode_attention_jnp and the reference flash_decode_ref do.  Any S is
//   taken (the Pallas kernel needs S % kv_block == 0): rows past the end
//   are masked here.
//
// What bounds it on an H100: bytes.  Each K and V row is used by the G
//   query heads of its KV head and then never again: at Yi-6B's decode
//   shape (B 8, KVH 4, G 8, D 128, S ~4,160, bf16) K + V are 68 MB per layer
//   against 8.4 MFLOP per KV head row block, so the bound is ~0.020 ms at
//   3.35 TB/s.  One CTA per (b, kv head), the TPU grid without its
//   sequential axis, would give B * KVH = 32 CTAs for 132 SMs (4 at B = 1),
//   far below the card's memory rate.
//
// Design:
//   * flash_decode_partial, grid (splits, KVH * head groups, B).  The
//     wrapper picks `splits` so the grid holds at most two CTAs per SM
//     (one wave at the G = 8 instance's occupancy); each
//     CTA takes a contiguous share of [0, min(cache_len, S)) -- the share is
//     computed on the device from cache_len, so no host sync is needed.
//     The CTA's 128 threads form row groups of P lanes (P = D / 8 rounded
//     up to a power of two); a lane holds 8 elements of D and loads them
//     with 16-byte loads (bf16: one, f32: two).  A row group reads TR
//     consecutive rows of K and V per step, once, for all GT query heads
//     of its head group, whose scaled q lives in registers; the next
//     step's rows are loaded while this step computes.  Scores are
//     reduced across the row group by xor shuffles and fed to an fp32
//     online softmax in log2 units (exp2f), rescaled once per TR rows.
//     The row groups' (m, l, acc) are merged through shared memory and the
//     CTA writes one partial (m, l, acc[D]) per query head into an fp32
//     scratch the wrapper allocates.  A split with no rows writes
//     m = -1e30, l = 0, acc = 0.
//   * flash_decode_combine, grid (Hq, B): merges the splits of one
//     (b, head), out = sum_s acc_s 2^(m_s - M) / sum_s l_s 2^(m_s - M),
//     written in q's type.
//   No tensor cores, TMA or cp.async pipeline: plain 16-byte loads, one
//   step ahead in registers.
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
                     int D, int G, int P, int splits) {
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
  const int n_rows = none_valid ? S : min(len, S);
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
                     T* __restrict__ out, int Hq, int D, int splits) {
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
}

template <typename T, int GT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* cache_len, void* part_ml, void* part_acc,
                   void* out, int B, int S, int Hq, int KVH, int D,
                   int splits, cudaStream_t stream) {
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
      KVH, D, G, P, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_combine<T><<<dim3(Hq, B), kThreads, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<T*>(out), Hq, D, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int group_tile, const void* q, const void* k,
                     const void* v, const void* cache_len, void* part_ml,
                     void* part_acc, void* out, int B, int S, int Hq,
                     int KVH, int D, int splits, cudaStream_t stream) {
  switch (group_tile) {
    case 1: return launch<T, 1>(q, k, v, cache_len, part_ml, part_acc, out,
                                B, S, Hq, KVH, D, splits, stream);
    case 8: return launch<T, 8>(q, k, v, cache_len, part_ml, part_acc, out,
                                B, S, Hq, KVH, D, splits, stream);
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
// group_tile (1 or 8) query heads share a CTA; a group of G < 8 heads
// runs in a tile of 8 with the rest masked.  Returns the cudaError_t of
// the launches (0 = launched).
int flash_decode(const void* q, const void* k, const void* v,
                 const void* cache_len, void* part_ml, void* part_acc,
                 void* out, int B, int S, int Hq, int KVH, int D,
                 int group_tile, int splits, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || KVH <= 0 || Hq % KVH != 0 || D <= 0 ||
      D % 8 != 0 || D > 256 || splits <= 0 || B > 65535 ||
      KVH * ((Hq / KVH + group_tile - 1) / group_tile) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(group_tile, q, k, v, cache_len,
                                        part_ml, part_acc, out, B, S, Hq,
                                        KVH, D, splits, s)
              : dispatch<float>(group_tile, q, k, v, cache_len, part_ml,
                                part_acc, out, B, S, Hq, KVH, D, splits, s);
  return static_cast<int>(err);
}

}  // extern "C"
