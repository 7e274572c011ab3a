// Destination-sorted (CSR) segment SpMM: out = A_tilde @ x for one snapshot.
//
// Replaces: src/repro/kernels/segment_spmm/segment_spmm.py,
//   bucketed_segment_sum (body _kernel), reached through
//   repro.kernels.segment_spmm.ops.segment_spmm from
//   repro.core.gcn.spatial_aggregate.  The TPU kernel turned the scatter
//   into a one-hot matmul per 128-node block because the TPU has no
//   scatter; that layout pads every block to a common edge budget and
//   the feature axis to 128 lanes.  None of it is carried over.
//
// What bounds it on an H100: bytes.  Per snapshot the kernel reads the
//   CSR (row_ptr, col, w: ~12 B per edge), gathers one x row per edge and
//   writes each output row once; it does 2 flops per edge and feature.
//   At the serving shapes (N = 755,200, ~2.85 M edges with self-loops,
//   F = 2 or 6) x is 6-18 MB and stays in the 50 MB L2, so the gathers are
//   served from L2 and device-memory traffic is the CSR stream plus x and
//   out once each.
//
// Design: the CSR is built by the wrapper (repro_torch/kernels/
//   segment_spmm/ops.py::build_csr), once per snapshot on the serving
//   path: every layer of a window aggregates over the same graph.  Zero-
//   weight lanes are sorted into a dump row N that no row reads.  A group
//   of lanes owns consecutive destination rows, so a warp takes a run of
//   rows whose edges are one contiguous run of the CSR:
//   * F = 2 (layer 1) and F = 6 (layer 2), the serving path's widths,
//     compiled for their F: edge-parallel.  A group of 4 lanes takes 2
//     rows; lane j reads the rows' edges j, j + 4, ... -- neighbouring
//     lanes on neighbouring addresses, each (col, w) read once -- 4 edges
//     at a time with their float2 gathers of whole x rows in flight
//     together, and adds each into its row's fp32 sums (the row comes
//     from the 3 row pointers in registers).  A 2-step xor-shuffle tree
//     in a fixed order sums the 4 lanes, and the lanes write the 2 rows'
//     2F consecutive floats once, as float2s.
//   * other F: feature-parallel, a group of L lanes per row -- L = 8
//     when F % 4 == 0 and x is 16-byte aligned, each lane gathering a
//     float4 of x[col]; else L = 4, each lane gathering 4 scalars at a
//     stride of 4.  The group reads L edges' (col, w) at once (one per
//     lane) and broadcasts each with __shfl_sync; all L edges' gathers
//     are in flight together, and each lane writes its slice once.  Up to
//     4 L features each (col, w) is read once; above it the row's edges
//     are walked once per 4 L features.
//   No atomics; every sum is taken in a fixed order, so the result is
//   the same from run to run.  A fully skewed row is walked by its one
//   group (correct, not tuned).  On an H100 it stays at ~1/3 of its
//   bound at F = 6.  1 to 8 rows a group, 2 or 8 lanes, and 2 to 4 edges
//   in flight a lane all took about the same time, while removing the x
//   gathers, or making them sequential, cut it by more than half or by a
//   third: the limit is the random gathers -- each edge reads one random
//   8- or 24-byte x row, one or two 32-byte sectors through L2, where the
//   bound counts x once.
//
// segment_spmm_csr_f32_rowthread is the previous design (one thread per row,
//   scalar loads, (col, w) re-read per 8 features).  No wrapper calls it;
//   chip_smoke.py times it beside the kernel above.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// lanes of this lane's group of L (L divides 32), as a shuffle mask
template <int L>
__device__ __forceinline__ unsigned group_mask(int lane) {
  return (L == 32 ? 0xffffffffu : ((1u << L) - 1u)) << (lane & ~(L - 1));
}

// the edge-parallel instances: lanes of a group, consecutive rows a group
// takes, and edges each lane has in flight per step
constexpr int kEdgeLanes = 4;
constexpr int kEdgeRows = 2;
constexpr int kEdgeUnroll = 4;

// F = 2 and 6 (compile-time F, float2 gathers): a group of L lanes takes
// R consecutive rows, whose edges are one contiguous run of the CSR; lane
// j reads its edges j, j + L, ... of the run, U at a time, with all their
// gathers in flight together; the row of an edge comes from the R + 1 row
// pointers in registers.
template <int F>
__global__ void __launch_bounds__(kThreads)
spmm_rows_edge_parallel(const float* __restrict__ x,
                        const int* __restrict__ row_ptr,
                        const int* __restrict__ col,
                        const float* __restrict__ w,
                        float* __restrict__ out, int n) {
  constexpr int L = kEdgeLanes;
  constexpr int R = kEdgeRows;
  constexpr int U = kEdgeUnroll;
  static_assert(F % 2 == 0, "float2 gathers");
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long r0 = t / L * R;
  if (r0 >= n) return;                        // whole groups leave together
  const int lane = threadIdx.x & 31;
  const int gl = lane & (L - 1);
  const unsigned mask = group_mask<L>(lane);
  int rp[R + 1];                              // rows past n are empty
#pragma unroll
  for (int k = 0; k <= R; ++k)
    rp[k] = __ldg(row_ptr + (r0 + k < n ? r0 + k : n));
  float acc[R][F];
#pragma unroll
  for (int k = 0; k < R; ++k) {
#pragma unroll
    for (int i = 0; i < F; ++i) acc[k][i] = 0.f;
  }
  for (int e0 = rp[0] + gl; e0 < rp[R]; e0 += L * U) {
    int c[U];
    float we[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * L;
      c[u] = e < rp[R] ? __ldg(col + e) : 0;
      we[u] = e < rp[R] ? __ldg(w + e) : 0.f;
    }
    float v[U][F];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = e0 + u * L < rp[R];
      const float2* xs = reinterpret_cast<const float2*>(
          x + static_cast<long long>(c[u]) * F);
#pragma unroll
      for (int i = 0; i < F / 2; ++i) {
        const float2 p = ok ? __ldg(xs + i) : make_float2(0.f, 0.f);
        v[u][2 * i] = p.x;
        v[u][2 * i + 1] = p.y;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * L;
      int k = 0;
#pragma unroll
      for (int j = 1; j < R; ++j) k += e >= rp[j];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (j == k && e < rp[R]) {
#pragma unroll
          for (int i = 0; i < F; ++i)
            acc[j][i] = fmaf(we[u], v[u][i], acc[j][i]);
        }
      }
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
#pragma unroll
      for (int i = 0; i < F; ++i)
        acc[k][i] += __shfl_xor_sync(mask, acc[k][i], off, L);
    }
  }
  // the R rows are R * F consecutive floats: lane gl writes float2s
  // gl, gl + L, ...
#pragma unroll
  for (int q = 0; q < R * F / 2; ++q) {
    const int k = 2 * q / F, i = 2 * q % F;
    if (q % L == gl && r0 + k < n)
      *reinterpret_cast<float2*>(out + (r0 + k) * F + i) =
          make_float2(acc[k][i], acc[k][i + 1]);
  }
}

// lanes of a row's group in the scalar feature-parallel instance
constexpr int kScalarLanes = 4;

// any F: a group of L lanes per row, feature-parallel
template <bool kVec4, int L>
__global__ void __launch_bounds__(kThreads)
spmm_rows_feature_parallel(const float* __restrict__ x,
                           const int* __restrict__ row_ptr,
                           const int* __restrict__ col,
                           const float* __restrict__ w,
                           float* __restrict__ out, int n, int f) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long row = t / L;
  if (row >= n) return;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (L - 1);
  const unsigned mask = group_mask<L>(lane);
  const int beg = __ldg(row_ptr + row);
  const int end = __ldg(row_ptr + row + 1);
  for (int f0 = 0; f0 < f; f0 += 4 * L) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int e0 = beg; e0 < end; e0 += L) {
      int c = 0;
      float we = 0.f;
      if (e0 + gl < end) {
        c = __ldg(col + e0 + gl);
        we = __ldg(w + e0 + gl);
      }
      const int cnt = min(L, end - e0);        // the same in the group
      // unrolled with a guard, so the group's gathers are all in flight
      // at once instead of one L2 round trip per edge
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int cj = __shfl_sync(mask, c, j, L);
        const float wj = __shfl_sync(mask, we, j, L);
        const float* xs = x + static_cast<long long>(cj) * f + f0;
        if (j < cnt && kVec4) {
          if (f0 + 4 * gl < f) {
            const float4 v =
                __ldg(reinterpret_cast<const float4*>(xs) + gl);
            acc[0] = fmaf(wj, v.x, acc[0]);
            acc[1] = fmaf(wj, v.y, acc[1]);
            acc[2] = fmaf(wj, v.z, acc[2]);
            acc[3] = fmaf(wj, v.w, acc[3]);
          }
        } else if (j < cnt) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (f0 + gl + L * i < f)
              acc[i] = fmaf(wj, __ldg(xs + gl + L * i), acc[i]);
        }
      }
    }
    float* o = out + row * f + f0;
    if (kVec4) {
      if (f0 + 4 * gl < f)
        reinterpret_cast<float4*>(o)[gl] =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (f0 + gl + L * i < f) o[gl + L * i] = acc[i];
    }
  }
}

// The previous design, kept for timing only: one thread per row.
constexpr int kFeatChunk = 8;   // features summed per pass over a row

__global__ void segment_spmm_rowthread_kernel(const float* __restrict__ x,
                                              const int* __restrict__ row_ptr,
                                              const int* __restrict__ col,
                                              const float* __restrict__ w,
                                              float* __restrict__ out,
                                              int n, int f) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int beg = row_ptr[row];
  const int end = row_ptr[row + 1];
  float* out_row = out + static_cast<long long>(row) * f;
  for (int f0 = 0; f0 < f; f0 += kFeatChunk) {
    float acc[kFeatChunk];
#pragma unroll
    for (int j = 0; j < kFeatChunk; ++j) acc[j] = 0.0f;
    for (int e = beg; e < end; ++e) {
      const float we = __ldg(w + e);
      const float* xs = x + static_cast<long long>(__ldg(col + e)) * f + f0;
#pragma unroll
      for (int j = 0; j < kFeatChunk; ++j) {
        if (f0 + j < f) acc[j] = fmaf(we, __ldg(xs + j), acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kFeatChunk; ++j) {
      if (f0 + j < f) out_row[f0 + j] = acc[j];
    }
  }
}

inline unsigned blocks_for(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (n, f) f32, row_ptr (n + 1) i32, col / w sorted by destination,
// out (n, f) f32; all contiguous on the device, out 16-byte aligned.
// Returns the cudaError_t of the launch (0 = launched).
int segment_spmm_csr_f32(const void* x, const void* row_ptr, const void* col,
                         const void* w, void* out, int n, int f,
                         void* stream) {
  if (n <= 0 || f <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* cl = static_cast<const int*>(col);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  if (!aligned(out, 16)) return static_cast<int>(cudaErrorInvalidValue);
  const long long ne =
      static_cast<long long>(kEdgeLanes) * ((n + kEdgeRows - 1) / kEdgeRows);
  const long long n8 = 8LL * n;
  const long long ns = static_cast<long long>(kScalarLanes) * n;
  if (f == 2 && aligned(x, 8)) {
    spmm_rows_edge_parallel<2><<<blocks_for(ne), kThreads, 0, s>>>(
        xf, rp, cl, wf, of, n);
  } else if (f == 6 && aligned(x, 8)) {
    spmm_rows_edge_parallel<6><<<blocks_for(ne), kThreads, 0, s>>>(
        xf, rp, cl, wf, of, n);
  } else if (f % 4 == 0 && aligned(x, 16)) {
    spmm_rows_feature_parallel<true, 8><<<blocks_for(n8), kThreads, 0, s>>>(
        xf, rp, cl, wf, of, n, f);
  } else {
    spmm_rows_feature_parallel<false, kScalarLanes>
        <<<blocks_for(ns), kThreads, 0, s>>>(xf, rp, cl, wf, of, n, f);
  }
  return static_cast<int>(cudaGetLastError());
}

// The previous design (one thread per row), same arguments; for timing.
int segment_spmm_csr_f32_rowthread(const void* x, const void* row_ptr,
                                   const void* col, const void* w,
                                   void* out, int n, int f, void* stream) {
  if (n <= 0 || f <= 0) return 0;
  segment_spmm_rowthread_kernel<<<blocks_for(n), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(row_ptr),
      static_cast<const int*>(col), static_cast<const float*>(w),
      static_cast<float*>(out), n, f);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
