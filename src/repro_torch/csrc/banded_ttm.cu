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
// The backward, banded_ttm_t_f32: the transposed band over the rows a
//   caller keeps.  The JAX package has no backward Pallas kernel (jax.grad
//   differentiates its non-Pallas path); this one stands beside
//   mproduct.py::banded_ttm as its transpose and serves the port's training
//   step through repro_torch.kernels.mproduct.ops.MProductWithPrefixFn.
//   m_product_with_prefix applies M to [prefix (lead rows), slice (t_s
//   rows)] and keeps the slice's rows, so its gradient dZ covers rows
//   lead .. lead + t_s - 1 only: the kernel reads dZ (t_s, nf) and writes
//   dX = M^T [0; dZ] for rows first .. lead + t_s - 1 (first = 0 gives the
//   prefix's gradient too, first = lead the slice's alone).  Row k of dX
//   receives dZ[t - lead] / min(w, t + t_offset + 1) from every kept row t
//   whose band holds it, t in [max(k, lead), min(lead + t_s - 1,
//   k + w - 1)], and only for k >= -t_offset (earlier rows lie before
//   global step 1, in no band, and are written as zeros).  lead = first =
//   0 is M^T dY over a whole (t_s, nf) tensor.
//
// What bounds it on an H100: bytes.  It reads each dZ row that lies in
//   some band once and writes each output row once, 2 flops per element
//   and band row: ~0.11 ms at the train path's (t_s 8, lead 4) blocks of
//   N x 6 = 4,531,200 columns, 1.41 ms at the full config's (128, lead 4).
//
// Design (window w <= 8, compiled for its w): a thread owns V = 4
//   adjacent columns (16-byte loads and stores; V = 1 when nf % 4 != 0 or
//   a pointer is not 16-byte aligned) and walks its output rows once.  It
//   keeps the last w dZ rows of its columns in registers, each divided
//   once, when it is loaded, by its row's denominator (IEEE division, as
//   the plain version divides), so each dZ element is loaded and divided
//   once instead of w times.  The next row's load is issued before the
//   current row's sum, so two loads a thread are in flight (the prologue
//   issues w at once).  Each output is its band's terms summed in
//   ascending t from 0.0f -- the fp32 operations of
//   ops.banded_ttm_t_ref in its order, so the two agree exactly.  Loads
//   and stores are streaming (__ldcs / __stcs): nothing is read twice.
//   A thread walks all its rows (cutting them into segments across
//   blocks, each re-reading the w - 1 rows before it, was no faster on an
//   H100).  A larger w takes the loop below.
//
// banded_ttm_t_loop_kernel is the previous design, general in
//   w: a thread per column that sums each output's band from dZ directly,
//   loading and dividing each element w times.  Exported as
//   banded_ttm_t_f32_v1, which no wrapper calls: chip_smoke.py times it,
//   on a zero-filled (lead + t_s, nf) gradient as the previous path
//   built it, beside the kernel above.
#include <cuda_runtime.h>
#include <stdint.h>

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

__global__ void banded_ttm_t_loop_kernel(const float* __restrict__ dz,
                                         float* __restrict__ out, int t_s,
                                         long long nf, int window,
                                         int t_offset, int lead, int first) {
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= nf) return;
  const int rows = lead + t_s;
  for (int k = first; k < rows; ++k) {
    float acc = 0.0f;
    if (k >= -t_offset) {
      int hi = k + window - 1;
      if (hi > rows - 1) hi = rows - 1;
      for (int t = k > lead ? k : lead; t <= hi; ++t) {
        const int g = t + t_offset + 1;              // >= 1 for k kept
        const int denom = g < window ? g : window;
        acc += __ldg(dz + (t - lead) * nf + j) / static_cast<float>(denom);
      }
    }
    out[(k - first) * nf + j] = acc;
  }
}

constexpr int kThreads = 256;

template <int V>
struct Cols {
  float v[V];
};

template <int V>
__device__ __forceinline__ Cols<V> load_cols(const float* p) {
  Cols<V> c;
  if constexpr (V == 4) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    c.v[0] = q.x; c.v[1] = q.y; c.v[2] = q.z; c.v[3] = q.w;
  } else {
    c.v[0] = __ldcs(p);
  }
  return c;
}

template <int V>
__device__ __forceinline__ void store_cols(float* p, const Cols<V>& c) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(p),
           make_float4(c.v[0], c.v[1], c.v[2], c.v[3]));
  } else {
    __stcs(p, c.v[0]);
  }
}

template <int V>
__device__ __forceinline__ Cols<V> zero_cols() {
  Cols<V> c;
#pragma unroll
  for (int i = 0; i < V; ++i) c.v[i] = 0.0f;
  return c;
}

// Row t = s + lead of [prefix, slice] as the window holds it: dZ[s] of
// this thread's columns, zero outside the kept rows.  The branch is the
// same for every thread of the block.
template <int V>
__device__ __forceinline__ Cols<V> load_row(const float* dz, int s, int t_s,
                                            long long nf, long long col) {
  return (s >= 0 && s < t_s) ? load_cols<V>(dz + s * nf + col)
                             : zero_cols<V>();
}

template <int W, int V>
__global__ void __launch_bounds__(kThreads)
banded_ttm_t_window_kernel(const float* __restrict__ dz,
                           float* __restrict__ out, int t_s, long long nf,
                           int t_offset, int lead, int first) {
  const long long col =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  if (col >= nf) return;
  const int rows = lead + t_s;
  // win[i]: dZ row k - lead + i of the current output row k, divided by
  // its denominator.  The prologue loads the w - 1 rows before the first
  // new one, all in flight together.
  Cols<V> win[W];
  win[0] = zero_cols<V>();
#pragma unroll
  for (int i = 1; i < W; ++i)
    win[i] = load_row<V>(dz, first - lead + i - 1, t_s, nf, col);
  Cols<V> pending = load_row<V>(dz, first - lead + W - 1, t_s, nf, col);
#pragma unroll
  for (int i = 1; i < W; ++i) {
    const int g = first + i - 1 + t_offset + 1;
    const float d = static_cast<float>(g < 1 ? 1 : (g < W ? g : W));
#pragma unroll
    for (int c = 0; c < V; ++c) win[i].v[c] /= d;
  }
  for (int k = first; k < rows; ++k) {
    const Cols<V> cur = pending;                 // dZ row k - lead + w - 1
    if (k + 1 < rows)
      pending = load_row<V>(dz, k - lead + W, t_s, nf, col);
#pragma unroll
    for (int i = 0; i + 1 < W; ++i) win[i] = win[i + 1];
    const int g = k + W - 1 + t_offset + 1;      // global step of that row
    const float d = static_cast<float>(g < 1 ? 1 : (g < W ? g : W));
#pragma unroll
    for (int c = 0; c < V; ++c) win[W - 1].v[c] = cur.v[c] / d;
    Cols<V> acc = zero_cols<V>();
    if (k >= -t_offset) {
#pragma unroll
      for (int i = 0; i < W; ++i)
#pragma unroll
        for (int c = 0; c < V; ++c) acc.v[c] += win[i].v[c];
    }
    store_cols<V>(out + (k - first) * nf + col, acc);
  }
}

template <int W>
int launch_window(const float* dz, float* out, int t_s, long long nf,
                  int t_offset, int lead, int first, cudaStream_t stream) {
  const bool vec = nf % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(dz) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long threads_x = vec ? nf / 4 : nf;
  const long long blocks = (threads_x + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const auto grid = static_cast<unsigned>(blocks);
  if (vec)
    banded_ttm_t_window_kernel<W, 4><<<grid, kThreads, 0, stream>>>(
        dz, out, t_s, nf, t_offset, lead, first);
  else
    banded_ttm_t_window_kernel<W, 1><<<grid, kThreads, 0, stream>>>(
        dz, out, t_s, nf, t_offset, lead, first);
  return static_cast<int>(cudaGetLastError());
}

int launch_loop(const float* dz, float* out, int t_s, long long nf,
                int window, int t_offset, int lead, int first,
                cudaStream_t stream) {
  const long long blocks = (nf + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  banded_ttm_t_loop_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(dz, out, t_s, nf, window, t_offset,
                                       lead, first);
  return static_cast<int>(cudaGetLastError());
}

// The checks both transposed launchers share; -1 = valid, else the code.
int check_t_args(int t_s, long long nf, int window, int lead, int first) {
  if (t_s < 0 || nf < 0 || window < 1 || lead < 0 || first < 0 ||
      first > lead + t_s)
    return static_cast<int>(cudaErrorInvalidValue);
  return -1;
}

int launch(void (*kernel)(const float*, float*, int, long long, int, int),
           const void* x, void* out, int t_len, long long nf, int window,
           int t_offset, void* stream) {
  if (t_len <= 0 || nf <= 0) return 0;
  const long long blocks = (nf + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
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

// dz (t_s, nf), out (lead + t_s - first, nf) f32 contiguous on the
// device: out = rows first .. lead + t_s - 1 of M^T [0 (lead rows); dz].
int banded_ttm_t_f32(const void* dz, void* out, int t_s, long long nf,
                     int window, int t_offset, int lead, int first,
                     void* stream) {
  const int bad = check_t_args(t_s, nf, window, lead, first);
  if (bad >= 0) return bad;
  if (first == lead + t_s || nf == 0) return 0;
  const auto* in = static_cast<const float*>(dz);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (window) {
    case 1: return launch_window<1>(in, o, t_s, nf, t_offset, lead, first, st);
    case 2: return launch_window<2>(in, o, t_s, nf, t_offset, lead, first, st);
    case 3: return launch_window<3>(in, o, t_s, nf, t_offset, lead, first, st);
    case 4: return launch_window<4>(in, o, t_s, nf, t_offset, lead, first, st);
    case 5: return launch_window<5>(in, o, t_s, nf, t_offset, lead, first, st);
    case 6: return launch_window<6>(in, o, t_s, nf, t_offset, lead, first, st);
    case 7: return launch_window<7>(in, o, t_s, nf, t_offset, lead, first, st);
    case 8: return launch_window<8>(in, o, t_s, nf, t_offset, lead, first, st);
    default:
      return launch_loop(in, o, t_s, nf, window, t_offset, lead, first, st);
  }
}

// The previous design (the loop), same arguments; no wrapper calls it.
int banded_ttm_t_f32_v1(const void* dz, void* out, int t_s, long long nf,
                        int window, int t_offset, int lead, int first,
                        void* stream) {
  const int bad = check_t_args(t_s, nf, window, lead, first);
  if (bad >= 0) return bad;
  if (first == lead + t_s || nf == 0) return 0;
  return launch_loop(static_cast<const float*>(dz), static_cast<float*>(out),
                     t_s, nf, window, t_offset, lead, first,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
