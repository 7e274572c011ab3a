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
// picks the instance from the type alone and the split count from the
// instance's CTAs per SM, so the grid is one wave.  Scores are kept in
// log2 units (exp2f).
//
// Instance 1, tensor cores: every bf16 call, G = 1 included, at D up to
//   256 (group_tile 16).  flash_decode_partial_tc<DT>, DT = 64, 128 or 256
//   (D zero-padded to it).  The G query heads of a head group, zero-padded
//   to 16, are the A operand of S = Q K^T (mma.sync m16n8k16, bf16 in,
//   fp32 out, FlashAttention-2's register layout).  The CTA streams its
//   rows in tiles of 64 rows of K and of V through a ring in shared
//   memory filled by the Tensor Memory Accelerator: K and V are 3-d tensor
//   maps (D, KVH, B * S) with boxes of 64 elements x 64 rows, 128-byte
//   swizzled, so a tile is DT / 64 boxes a tensor, asked for by one thread
//   and completing on the stage's mbarrier; rows past B * S and elements
//   past D arrive as zeros, and the last tile's V rows at or past the
//   split's end are zeroed before use (a row there may belong to another
//   split or hold garbage).  ldmatrix reads 8 rows at one swizzled chunk
//   without bank conflicts.  Each of the 4 warps owns 16 rows of every
//   tile: K rows are the B operand via ldmatrix, its S fragments get one
//   online-softmax rescale per tile, and the P fragments are reused in
//   registers as the A operand of P V, with V the B operand via
//   ldmatrix.trans.  p keeps its fp32 precision: it is split into
//   hi = bf16(p) and lo = bf16(p - hi), two MMAs whose sum is p to ~2^-16,
//   as decode_attention_jnp and the plain version keep p in fp32 (the
//   Pallas kernel rounds p to bf16).  Q's fragments live in registers at
//   DT <= 128 and in shared memory at DT 256 (read by ldmatrix each tile),
//   where 128 fp32 accumulators a thread leave no room for them.  The
//   warps' (m, l, O) are merged through shared memory at the end, and the
//   combine kernel is launched as a programmatic dependent, so its launch
//   overlaps the partial kernel's run.
//   What bounds it is bytes, and how evenly the card serves them.  With
//   G = 1 only 1 of the MMA's 16 rows is a head: the products cost 15/16
//   waste, far below the byte rate.  The ring (tc_stages, tc_ctas_per_sm)
//   is 2 stages and 4 CTAs an SM at DT 64, 3 stages and one CTA an SM at
//   DT 128 and 256: 64 KB of K and V in flight an SM at DT 64 and 128,
//   128 KB at 256, against the ~25 KB that 3.35 TB/s over 132 SMs needs at
//   ~1 us of loaded latency.  G = 1 ran on instance 2 until the card read
//   it at 69-75 % of its bound, behind SDPA: a step there holds only 8 KB
//   of K and V a CTA in registers.  The same ring filled by 16-byte
//   cp.async copies from every thread read at most ~89 % of the bound
//   whatever its depth, tiles, order or L2 hints, its CTAs ending up to a
//   quarter apart on the card's global timer with equal rows each; filled
//   by the copy engine they end within ~2 % and the kernel reads at the
//   ring's own streaming rate.  One bulk copy a 256-byte row instead of a
//   box ran far slower.  (Measured on an H100; PERF.md keeps the runs,
//   scripts/flash_decode_g1_ab.py times the committed design's variants.)
//
// Instance 2, CUDA cores: f32 (group_tile 1 for G = 1, 8 otherwise).
//   flash_decode_partial, a group of G < 8 heads runs in a tile of 8 with
//   the rest masked.  The CTA's 128 threads form row groups of P lanes
//   (P = D / 8 rounded up to a power of two); a lane holds 8 elements of D
//   and loads them with two 16-byte loads.  A row group
//   reads TR consecutive rows of K and V per step, once, for all GT query
//   heads of its head group, whose scaled q lives in registers; the next
//   step's rows are loaded while this step computes.  Scores are reduced
//   across the row group by xor shuffles and fed to an fp32 online
//   softmax, rescaled once per TR rows; p stays fp32.  The row groups'
//   (m, l, acc) are merged through shared memory.  f32 stays here because
//   it is held at 1e-4, which TF32 cannot meet.  bf16 ran here at G = 1
//   and D > 128 until instance 1 took them; the C entry point now refuses
//   bf16 on this instance.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;               // 4 warps per CTA
constexpr float kMasked = -1e30f;           // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;

// 8 consecutive elements of one row, as loaded (16 bytes per load).
template <typename T> struct Chunk;
template <> struct Chunk<float> { float4 a, b; };

__device__ __forceinline__ void load(const float* p, Chunk<float>& c) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
  c.a = __ldg(p4);
  c.b = __ldg(p4 + 1);
}
__device__ __forceinline__ void zero(Chunk<float>& c) {
  c.a = make_float4(0.f, 0.f, 0.f, 0.f);
  c.b = c.a;
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
  // launched as a programmatic dependent of the partial kernel, it may
  // start while that one runs: wait until its partials are written (a
  // no-op after an ordinary launch)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
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
constexpr int kTcHeads = 16;      // query heads per CTA (the MMA's M)

// The ring of each padded D: its stages and the CTAs an SM holds (the
// kernel's launch bounds; kernels/flash_decode/ops.py::TC_RING says the
// same), the fastest measured on an H100: deeper rings, or 2 or 3 CTAs an
// SM at DT 128, were no faster.
__host__ __device__ constexpr int tc_stages(int dt) {
  return dt == 64 ? 2 : 3;
}
__host__ __device__ constexpr int tc_ctas_per_sm(int dt) {
  return dt == 64 ? 4 : 1;
}

// Q's A fragments from shared memory (else registers)
__host__ __device__ constexpr bool tc_q_in_smem(int dt) { return dt > 128; }

// one K or V tile in shared memory: DT / 64 boxes of 64 rows x 128 bytes
__host__ __device__ constexpr int tc_tile_bytes(int dt) {
  return kTcRows * dt * 2;
}

// dynamic shared memory: 1 KB of slack to align the ring to 1024 bytes (a
// swizzled box's need), the ring's K and V tiles, at DT 256 Q's 16 rows
// (padded by 8 elements), then one mbarrier a stage
__host__ __device__ constexpr size_t tc_smem_bytes(int dt) {
  return 1024 + static_cast<size_t>(tc_stages(dt)) * 2 * tc_tile_bytes(dt) +
         (tc_q_in_smem(dt) ? kTcHeads * (dt + 8) * 2 : 0) +
         tc_stages(dt) * sizeof(uint64_t);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
// one arrival that also expects ``bytes`` of copies to complete
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// wait for the phase of ``parity`` to complete; a copy that never lands
// (a bad tensor map) traps after ~2^24 tries instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 24)) __trap();
  }
}
// one box of a 3-d tensor map (coordinates innermost first) -> shared
// memory by the copy engine, completing on the mbarrier ``bar``
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// Byte offset in a tile of row r's 16-byte chunk dc (of D): its box
// dc / 8, then its place in the box's 128-byte row, XOR-swizzled by the
// row as the tensor map's CU_TENSOR_MAP_SWIZZLE_128B lays it (so the 8
// rows an ldmatrix reads at one chunk fall in 8 different banks)
__device__ __forceinline__ uint32_t tc_swz(int r, int dc) {
  return (dc >> 3) * (kTcRows * 128) + r * 128 + (((dc & 7) ^ (r & 7)) << 4);
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

// Rows row .. row + 63 of K and V (rows of the maps' B * S) at KV head
// kvh into one stage of the ring: DT / 64 boxes a tensor, issued by one
// thread, completing on the stage's mbarrier.  Rows past B * S and
// elements past D arrive as zeros.
template <int DT>
__device__ __forceinline__ void tc_load_tile(const CUtensorMap* tk,
                                             const CUtensorMap* tv, int kvh,
                                             int row, uint32_t ks,
                                             uint32_t vs, uint32_t bar) {
  mbar_arrive_expect_tx(bar, 2 * tc_tile_bytes(DT));
#pragma unroll
  for (int h = 0; h < DT / 64; ++h) {
    tma_load_3d(ks + h * kTcRows * 128, tk, h * 64, kvh, row, bar);
    tma_load_3d(vs + h * kTcRows * 128, tv, h * 64, kvh, row, bar);
  }
}

// q (B, Hq, D); k, v (B, S, KVH, D) bf16; cache_len (B,) int32;
// part_ml (B, Hq, splits, 2) and part_acc (B, Hq, splits, D) fp32.
template <int DT>
__global__ void __launch_bounds__(kThreads, tc_ctas_per_sm(DT))
flash_decode_partial_tc(const __nv_bfloat16* __restrict__ q,
                        const __grid_constant__ CUtensorMap tmk,
                        const __grid_constant__ CUtensorMap tmv,
                        const int* __restrict__ cache_len,
                        float* __restrict__ part_ml,
                        float* __restrict__ part_acc, int S, int Hq,
                        int KVH, int D, int G, int splits,
                        int lse_mode) {
  constexpr int RS = DT + 8;                 // Q's smem row, elements
  constexpr int TB = tc_tile_bytes(DT);      // one K or V tile, bytes
  constexpr int KT = DT / 16;                // MMA k-steps over D
  constexpr int NT = DT / 8;                 // 8-wide n-tiles of O
  constexpr bool QS = tc_q_in_smem(DT);
  constexpr int ST = tc_stages(DT);          // stages of the ring
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring from the first 1024-byte boundary, then Q, then the barriers
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + (ring - raw) + ST * 2 * TB);
  const uint32_t bars =
      ring + ST * 2 * TB + (QS ? kTcHeads * RS * 2 : 0);

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
  // the combine kernel may be launched once every CTA of this grid has
  // passed here (or exited); it waits (griddepcontrol.wait) for the whole
  // grid's end, so this only takes its launch off the critical path.  In
  // a one-wave grid, which ops.plan gives wherever the splits can be cut,
  // that is at once; with more (b, head group) pairs than slots, splits
  // is 1 and the grid takes several waves: then it is as the last wave
  // starts.
  asm volatile("griddepcontrol.launch_dependents;\n");

  // the first row of this split in the maps' B * S rows
  const int row0 = b * S + lo;

  // one mbarrier a stage, then start the ring before anything waits on
  // memory
  if (threadIdx.x == 0) {
    for (int st = 0; st < ST; ++st) mbar_init(bars + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#pragma unroll
    for (int st = 0; st < ST - 1; ++st) {
      if (st < n_tiles)
        tc_load_tile<DT>(&tmk, &tmv, kvh, row0 + st * kTcRows,
                         ring + 2 * st * TB, ring + (2 * st + 1) * TB,
                         bars + 8 * st);
    }
  }
  __syncthreads();                           // the barriers are set up

  // Q as A fragments: this lane's heads ha, hb = ha + 8 of the group, at
  // d pairs (lane % 4) * 2 (+ 8) of each k-step; padded heads and d are 0.
  // At DT 256 Q's 16 rows go to shared memory instead, read each tile.
  const int ha = lane >> 2, hb = ha + 8;
  uint32_t qa[QS ? 1 : KT][4];
  if constexpr (QS) {
    for (int i = threadIdx.x; i < kTcHeads * (DT / 8); i += kThreads) {
      const int head = i / (DT / 8), c = i % (DT / 8);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (head < ng && c * 8 < D)
        val = *reinterpret_cast<const uint4*>(
            q + (static_cast<size_t>(b) * Hq + h0 + head) * D + c * 8);
      *reinterpret_cast<uint4*>(qs + head * RS + c * 8) = val;
    }
  } else {
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
  }

  const float scale = kLog2e / sqrtf(static_cast<float>(D));
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = kMasked, m_b = kMasked, l_a = 0.f, l_b = 0.f;
  const int wr = warp * 16;                  // this warp's rows of a tile

  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t ks = ring + 2 * (t % ST) * TB;
    const uint32_t vs = ks + TB;
    // tile t has landed: its stage's phase t / ST is complete
    mbar_wait(bars + 8 * (t % ST), (t / ST) & 1);
    // the last tile's rows at or past hi: V's zeroed (their p is 0, but
    // 0 x a NaN in the cache is not), K's masked below
    const int valid = hi - (lo + t * kTcRows);
    if (valid < kTcRows) {
      for (int i = threadIdx.x; i < (kTcRows - valid) * (DT / 8);
           i += kThreads) {
        const int r = valid + i / (DT / 8), dc = i % (DT / 8);
        asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(
                         vs + tc_swz(r, dc)),
                     "r"(0u)
                     : "memory");
      }
    }
    __syncthreads();                         // for every thread; and the
                                             // stage refilled below is free
    if (threadIdx.x == 0 && t + ST - 1 < n_tiles) {
      const int nt = t + ST - 1;
      const int st = nt % ST;
      tc_load_tile<DT>(&tmk, &tmv, kvh, row0 + nt * kTcRows,
                       ring + 2 * st * TB, ring + (2 * st + 1) * TB,
                       bars + 8 * st);
    }

    // S (16 heads x 16 rows) = Q K^T: two n-tiles of 8 rows
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    {
      const int r = wr + ((lane >> 4) << 3) + (lane & 7);
      const int c = (lane >> 3) & 1;         // which 8 of the k-step's 16
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(ks + tc_swz(r, kk * 2 + c), b0, b1, b2, b3);
        if constexpr (QS) {
          // rows lane % 16, columns (lane / 16) * 8: a0..a3 in order
          uint32_t a[4];
          ldmatrix_x4(smem_u32(qs + (lane & 15) * RS + kk * 16 +
                               ((lane >> 4) << 3)),
                      a[0], a[1], a[2], a[3]);
          mma_bf16(sc[0], a, b0, b1);
          mma_bf16(sc[1], a, b2, b3);
        } else {
          mma_bf16(sc[0], qa[kk], b0, b1);
          mma_bf16(sc[1], qa[kk], b2, b3);
        }
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
      const int c = lane >> 4;               // which 8 of the 16 d
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t v0, v1, v2, v3;
        ldmatrix_x4_trans(vs + tc_swz(r, n2 * 2 + c), v0, v1, v2, v3);
        mma_bf16(o[2 * n2], ph, v0, v1);
        mma_bf16(o[2 * n2], pl, v0, v1);
        mma_bf16(o[2 * n2 + 1], ph, v2, v3);
        mma_bf16(o[2 * n2 + 1], pl, v2, v3);
      }
    }
  }
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

// cuTensorMapEncodeTiled from the driver the runtime loaded (no link to
// libcuda), looked up once
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// K or V (B, S, KVH, D) bf16 as a 3-d map (D, KVH, B * S), boxes of 64
// elements x 1 head x 64 rows, 128-byte swizzled, out of bounds zero
bool kv_tensor_map(CUtensorMap* map, const void* base, int B, int S,
                   int KVH, int D) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(KVH),
                              static_cast<cuuint64_t>(B) * S};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(KVH) * D * 2};
  const cuuint32_t box[3] = {64, 1, kTcRows};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DT>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* cache_len, void* part_ml, void* part_acc,
                      void* out, void* lse, int B, int S, int Hq, int KVH,
                      int D, int splits, cudaStream_t stream) {
  const int G = Hq / KVH;
  constexpr size_t smem = tc_smem_bytes(DT);
  CUtensorMap tmk, tmv;
  if (!kv_tensor_map(&tmk, k, B, S, KVH, D) ||
      !kv_tensor_map(&tmv, v, B, S, KVH, D))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_partial_tc<DT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, KVH * ((G + kTcHeads - 1) / kTcHeads), B);
  flash_decode_partial_tc<DT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), tmk, tmv,
      static_cast<const int*>(cache_len), static_cast<float*>(part_ml),
      static_cast<float*>(part_acc), S, Hq, KVH, D, G, splits,
      lse != nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the combine as a programmatic dependent launch: its launch overlaps
  // the partial kernel's run instead of following its end
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hq, B);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, flash_decode_combine<__nv_bfloat16>,
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Hq, D,
      splits);
}

// ------------------------------------------------- CUDA-core instance -----

template <int GT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* cache_len, void* part_ml, void* part_acc,
                   void* out, void* lse, int B, int S, int Hq, int KVH,
                   int D, int splits, cudaStream_t stream) {
  using T = float;
  // rows per group per step; two steps' K/V are in registers at a time
  constexpr int TR = 1;
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

cudaError_t dispatch(int group_tile, const void* q, const void* k,
                     const void* v, const void* cache_len, void* part_ml,
                     void* part_acc, void* out, void* lse, int B, int S,
                     int Hq, int KVH, int D, int splits,
                     cudaStream_t stream) {
  switch (group_tile) {
    case 1: return launch<1>(q, k, v, cache_len, part_ml, part_acc, out,
                             lse, B, S, Hq, KVH, D, splits, stream);
    case 8: return launch<8>(q, k, v, cache_len, part_ml, part_acc, out,
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
// group_tile picks the instance: 16 the tensor-core one (bf16 only; 16
// query heads share a CTA, a group of fewer heads is zero-padded), 1 or 8
// the CUDA-core one (f32 only; a group of G < 8 heads runs in a tile of 8
// with the rest masked).  lse, when not null, receives the (B, Hq) fp32
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
    if (!is_bf16) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err =
        D <= 64    ? launch_tc<64>(q, k, v, cache_len, part_ml, part_acc, out,
                                   lse, B, S, Hq, KVH, D, splits, s)
        : D <= 128 ? launch_tc<128>(q, k, v, cache_len, part_ml, part_acc,
                                    out, lse, B, S, Hq, KVH, D, splits, s)
                   : launch_tc<256>(q, k, v, cache_len, part_ml, part_acc,
                                    out, lse, B, S, Hq, KVH, D, splits, s);
    return static_cast<int>(err);
  }
  if (is_bf16) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(group_tile, q, k, v, cache_len, part_ml,
                                   part_acc, out, lse, B, S, Hq, KVH, D,
                                   splits, s));
}

}  // extern "C"
