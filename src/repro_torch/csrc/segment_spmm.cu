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
// Design: the wrapper (repro_torch/kernels/segment_spmm/ops.py) sorts the
//   edges by destination once per call and builds row pointers; zero-
//   weight lanes are sorted into a dump row N that no thread visits.  One
//   thread owns one destination row: it walks the row's edges, fuses the
//   gather of x[src] * w with the sum, keeps the F sums in registers in
//   fp32 and writes the row once.  No atomics, so the result is
//   deterministic.  Mean in-degree is ~4 at the serving shapes, so a warp
//   per row would leave most lanes idle; a fully skewed row is walked by
//   one thread serially (correct, slow - tested against the plain
//   version, not tuned).
#include <cuda_runtime.h>

namespace {

constexpr int kFeatChunk = 8;   // features summed per pass over a row

__global__ void segment_spmm_csr_kernel(const float* __restrict__ x,
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

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (n, f) f32, row_ptr (n + 1) i32, col / w sorted by destination,
// out (n, f) f32; all contiguous on the device.  Returns the cudaError_t
// of the launch (0 = launched).
int segment_spmm_csr_f32(const void* x, const void* row_ptr, const void* col,
                         const void* w, void* out, int n, int f,
                         void* stream) {
  if (n <= 0 || f <= 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  segment_spmm_csr_kernel<<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(row_ptr),
      static_cast<const int*>(col), static_cast<const float*>(w),
      static_cast<float*>(out), n, f);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
