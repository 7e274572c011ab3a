// Banded TTM for the TM-GCN M-product: Y = M x_1 X over X flattened to
// (T, NF), with M[t, k] = 1 / min(w, g) for max(1, g - w + 1) <= k_g <= g,
// g = t + t_offset + 1 the 1-indexed global step of output row t and
// k_g = k + t_offset + 1 that of input row k.
//
// Replaces: src/repro/kernels/mproduct/mproduct.py, banded_ttm (body
//   _kernel), reached through repro.kernels.mproduct.ops.m_product from
//   repro.core.temporal.m_product / m_product_with_prefix.  The band
//   limits and the denominator are the Pallas kernel's; input rows before
//   row 0 of the slice do not exist here (the Pallas kernel read a clamped
//   tile there, rows its callers slice off), which matches the dense
//   oracle repro.kernels.mproduct.ref.m_matrix.  t_offset is a runtime
//   argument and may be negative (m_product_with_prefix passes
//   t_offset - (w - 1)).
//
// What bounds it on an H100: bytes.  Each input element is read and each
//   output element written once from device memory: 8 * T * NF bytes for
//   at most w adds per output.  At the serving shape (T = w = 5,
//   NF = 755,200 * 6) that is 181 MB, ~54 us at 3.35 TB/s.
//
// Design: one thread per column j of the flattened (T, NF) tensor, so a
//   warp reads 32 consecutive floats of one row: every load and store is
//   coalesced.  The thread walks t = 0..T-1 and sums its band directly
//   in fp32 (no running sum that subtracts the leaving row, which would
//   drift from the reference over long T).  The w - 1 re-reads of a
//   column element hit L1/L2, not device memory.  General in T (the
//   training path calls it with T up to 512); 64-bit offsets.
//
// The backward, banded_ttm_t_f32: dX = M^T dY.  The JAX package has no
//   backward Pallas kernel (jax.grad differentiates its non-Pallas path);
//   this one serves the port's training step through
//   repro_torch.kernels.mproduct.ops.BandedTTMFn.  Input row k receives
//   dY[t] / min(w, t + t_offset + 1) from every output row t whose band
//   holds it: t in [k, min(T - 1, k + w - 1)], and only for k >= -t_offset
//   (earlier rows lie before global step 1, in no band; for the rows kept
//   every denominator is >= 1).  Same bound as the forward (8 * T * NF
//   bytes), same design: a thread per column, the band summed directly in
//   fp32, in ascending t, each term divided by its denominator, as the
//   plain version banded_ttm_t_ref does.
#include <cuda_runtime.h>

namespace {

__global__ void banded_ttm_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, int t_len,
                                  long long nf, int window, int t_offset) {
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= nf) return;
  for (int t = 0; t < t_len; ++t) {
    const int g = t + t_offset + 1;                  // global output step
    // first input row in the band that exists and has global step >= 1
    int lo = t - window + 1;
    if (lo < 0) lo = 0;
    if (lo < -t_offset) lo = -t_offset;
    float acc = 0.0f;
    for (int k = lo; k <= t; ++k) acc += __ldg(x + k * nf + j);
    const int denom = g < window ? g : window;
    // denom < 1 only when the band is empty (g < 1): the row is zero
    out[t * nf + j] = denom >= 1 ? acc / static_cast<float>(denom) : 0.0f;
  }
}

__global__ void banded_ttm_t_kernel(const float* __restrict__ dy,
                                    float* __restrict__ dx, int t_len,
                                    long long nf, int window, int t_offset) {
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= nf) return;
  for (int k = 0; k < t_len; ++k) {
    float acc = 0.0f;
    if (k >= -t_offset) {
      int hi = k + window - 1;
      if (hi > t_len - 1) hi = t_len - 1;
      for (int t = k; t <= hi; ++t) {
        const int g = t + t_offset + 1;              // >= 1 for k kept
        const int denom = g < window ? g : window;
        acc += __ldg(dy + t * nf + j) / static_cast<float>(denom);
      }
    }
    dx[k * nf + j] = acc;
  }
}

int launch(void (*kernel)(const float*, float*, int, long long, int, int),
           const void* x, void* out, int t_len, long long nf, int window,
           int t_offset, void* stream) {
  if (t_len <= 0 || nf <= 0) return 0;
  const int threads = 256;
  const long long blocks = (nf + threads - 1) / threads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), threads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), t_len, nf,
      window, t_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, out (t_len, nf) f32 contiguous on the device.  Returns the
// cudaError_t of the launch (0 = launched).
int banded_ttm_f32(const void* x, void* out, int t_len, long long nf,
                   int window, int t_offset, void* stream) {
  return launch(banded_ttm_kernel, x, out, t_len, nf, window, t_offset,
                stream);
}

// dy, dx (t_len, nf) f32 contiguous on the device: dx = M^T dy.
int banded_ttm_t_f32(const void* dy, void* dx, int t_len, long long nf,
                     int window, int t_offset, void* stream) {
  return launch(banded_ttm_t_kernel, dy, dx, t_len, nf, window, t_offset,
                stream);
}

}  // extern "C"
