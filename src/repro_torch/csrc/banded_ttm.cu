// Banded TTM for the TM-GCN M-product: Y = M x_1 X over X flattened to
// (T, NF), with M[t, k] = 1 / min(w, g) for max(1, g - w + 1) <= k_g <= g,
// g = t + t_offset + 1 the 1-indexed global step of output row t and
// k_g = k + t_offset + 1 that of input row k.
//
// Replaces: src/repro/kernels/mproduct/mproduct.py, banded_ttm (body
//   _kernel), reached through repro.kernels.mproduct.ops.m_product from
//   repro.core.temporal.m_product / m_product_with_prefix.  The band
//   limits and the denominator are the Pallas kernel's; input rows before
//   global step 1 lie in no band (the Pallas kernel read a clamped tile
//   there, rows its callers slice off), which matches the dense oracle
//   repro.kernels.mproduct.ref.m_matrix.
//
// The forward, banded_ttm_f32, over the rows a caller keeps.
//   m_product_with_prefix applies M to [prefix (lead rows); x (t_s rows)]
//   and keeps x's rows, so the kernel reads the two inputs through two
//   pointers (no concatenated copy) and writes out (t_s, nf) = rows
//   lead .. lead + t_s - 1 of M [prefix; x].  t_offset is the global index
//   of prefix row 0 (of x row 0 when lead = 0, which is M X).  A row with
//   an empty band (g < 1) is zero; input rows before global step 1 are
//   never loaded, so the zero carry of the first block costs no reads.
//
// What bounds it on an H100: bytes.  It reads each input row that lies in
//   a kept band once -- rows max(0, lead - w + 1, -t_offset) on -- and
//   writes the t_s kept rows once, at most w adds per output: ~0.108 ms at
//   the train path's (t_s 8, lead 4) blocks of N x 6 = 4,531,200 columns,
//   0.0325 ms at serving's (t_s 1, lead 4), 1.41 ms at the full config's
//   (128, lead 4).
//
// Design (window w <= 8, compiled for its w): a thread owns V = 4
//   adjacent columns (16-byte loads and stores; V = 1 when nf % 4 != 0 or
//   one of the pointers it reads or writes is not 16-byte aligned: the
//   prefix and x are separate allocations) and walks its output rows
//   once.  It keeps the last w input rows of its columns in registers,
//   loading each input row once -- first from the prefix, then from x --
//   and issues the next row's load before the current sum (the prologue's
//   w - 1 loads and the first row's are in flight together).  Each output
//   is its band summed in ascending k from 0.0f, then divided once by its
//   denominator (IEEE division): the fp32 operations of
//   ops.banded_ttm_ref in its order, so the two agree exactly.  Loads and
//   stores are streaming (__ldcs / __stcs).  A larger w takes a loop
//   kernel over the same two pointers: a thread per column, each output's
//   band summed from device memory (w loads an element).
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
//   H100).  A larger w takes banded_ttm_t_loop_kernel: a thread per
//   column that sums each output's band from dZ directly.
//
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Input row r of [prefix (lead rows); x]: a pointer to its first column.
__device__ __forceinline__ const float* in_row(const float* prefix,
                                               const float* x, int r,
                                               int lead, long long nf) {
  return r < lead ? prefix + r * nf : x + (r - lead) * nf;
}

__global__ void banded_ttm_loop_kernel(const float* __restrict__ prefix,
                                       const float* __restrict__ x,
                                       float* __restrict__ out, int lead,
                                       int t_s, long long nf, int window,
                                       int t_offset) {
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= nf) return;
  const int first = t_offset < 0 ? -t_offset : 0;   // global step 1
  for (int t = lead; t < lead + t_s; ++t) {
    int lo = t - window + 1;
    if (lo < first) lo = first;
    float acc = 0.0f;
    for (int k = lo; k <= t; ++k)
      acc += __ldg(in_row(prefix, x, k, lead, nf) + j);
    const int g = t + t_offset + 1;
    const int denom = g < 1 ? 1 : (g < window ? g : window);
    out[(t - lead) * nf + j] = acc / static_cast<float>(denom);
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

// Input row r for the forward's window: zero before global step 1
// (row ``first``) and before row 0, else the row from the prefix or x.
// The branch is the same for every thread of the block.
template <int V>
__device__ __forceinline__ Cols<V> load_in(const float* prefix,
                                           const float* x, int r, int lead,
                                           int first, long long nf,
                                           long long col) {
  return r >= first ? load_cols<V>(in_row(prefix, x, r, lead, nf) + col)
                    : zero_cols<V>();
}

template <int W, int V>
__global__ void __launch_bounds__(kThreads)
banded_ttm_window_kernel(const float* __restrict__ prefix,
                         const float* __restrict__ x,
                         float* __restrict__ out, int lead, int t_s,
                         long long nf, int t_offset) {
  const long long col =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  if (col >= nf) return;
  const int rows = lead + t_s;
  const int first = t_offset < 0 ? -t_offset : 0;   // global step 1
  // win[i]: input row t - w + 1 + i of the current output row t.  The
  // prologue loads the w - 1 rows before the first kept row and that
  // row itself, all in flight together.
  Cols<V> win[W];
  win[0] = zero_cols<V>();
#pragma unroll
  for (int i = 1; i < W; ++i)
    win[i] = load_in<V>(prefix, x, lead - W + i, lead, first, nf, col);
  Cols<V> pending = load_in<V>(prefix, x, lead, lead, first, nf, col);
  for (int t = lead; t < rows; ++t) {
    const Cols<V> cur = pending;                 // input row t
    if (t + 1 < rows)
      pending = load_in<V>(prefix, x, t + 1, lead, first, nf, col);
#pragma unroll
    for (int i = 0; i + 1 < W; ++i) win[i] = win[i + 1];
    win[W - 1] = cur;
    const int g = t + t_offset + 1;              // its global step
    const float d = static_cast<float>(g < 1 ? 1 : (g < W ? g : W));
    Cols<V> acc = zero_cols<V>();
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int c = 0; c < V; ++c) acc.v[c] += win[i].v[c];
#pragma unroll
    for (int c = 0; c < V; ++c) acc.v[c] /= d;
    store_cols<V>(out + (t - lead) * nf + col, acc);
  }
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

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int W>
int launch_fwd_window(const float* prefix, const float* x, float* out,
                      int lead, int t_s, long long nf, int t_offset,
                      cudaStream_t stream) {
  // an empty prefix is never read, so its pointer does not matter
  const bool vec = nf % 4 == 0 && aligned16(x) && aligned16(out) &&
                   (lead == 0 || aligned16(prefix));
  const long long threads_x = vec ? nf / 4 : nf;
  const long long blocks = (threads_x + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const auto grid = static_cast<unsigned>(blocks);
  if (vec)
    banded_ttm_window_kernel<W, 4><<<grid, kThreads, 0, stream>>>(
        prefix, x, out, lead, t_s, nf, t_offset);
  else
    banded_ttm_window_kernel<W, 1><<<grid, kThreads, 0, stream>>>(
        prefix, x, out, lead, t_s, nf, t_offset);
  return static_cast<int>(cudaGetLastError());
}

int launch_fwd_loop(const float* prefix, const float* x, float* out,
                    int lead, int t_s, long long nf, int window,
                    int t_offset, cudaStream_t stream) {
  const long long blocks = (nf + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  banded_ttm_loop_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(prefix, x, out, lead, t_s, nf, window,
                                     t_offset);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_t_window(const float* dz, float* out, int t_s, long long nf,
                  int t_offset, int lead, int first, cudaStream_t stream) {
  const bool vec = nf % 4 == 0 && aligned16(dz) && aligned16(out);
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

int launch_t_loop(const float* dz, float* out, int t_s, long long nf,
                int window, int t_offset, int lead, int first,
                cudaStream_t stream) {
  const long long blocks = (nf + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  banded_ttm_t_loop_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(dz, out, t_s, nf, window, t_offset,
                                       lead, first);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// prefix (lead, nf), x (t_s, nf), out (t_s, nf) f32 contiguous on the
// device: out = rows lead .. lead + t_s - 1 of M [prefix; x], t_offset
// the global index of prefix row 0.  Returns the cudaError_t of the launch
// (0 = launched).
int banded_ttm_f32(const void* prefix, const void* x, void* out, int lead,
                   int t_s, long long nf, int window, int t_offset,
                   void* stream) {
  if (lead < 0 || t_s < 0 || nf < 0 || window < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (t_s == 0 || nf == 0) return 0;
  const auto* p = static_cast<const float*>(prefix);
  const auto* in = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (window) {
    case 1: return launch_fwd_window<1>(p, in, o, lead, t_s, nf, t_offset, st);
    case 2: return launch_fwd_window<2>(p, in, o, lead, t_s, nf, t_offset, st);
    case 3: return launch_fwd_window<3>(p, in, o, lead, t_s, nf, t_offset, st);
    case 4: return launch_fwd_window<4>(p, in, o, lead, t_s, nf, t_offset, st);
    case 5: return launch_fwd_window<5>(p, in, o, lead, t_s, nf, t_offset, st);
    case 6: return launch_fwd_window<6>(p, in, o, lead, t_s, nf, t_offset, st);
    case 7: return launch_fwd_window<7>(p, in, o, lead, t_s, nf, t_offset, st);
    case 8: return launch_fwd_window<8>(p, in, o, lead, t_s, nf, t_offset, st);
    default:
      return launch_fwd_loop(p, in, o, lead, t_s, nf, window, t_offset, st);
  }
}

// dz (t_s, nf), out (lead + t_s - first, nf) f32 contiguous on the
// device: out = rows first .. lead + t_s - 1 of M^T [0 (lead rows); dz].
int banded_ttm_t_f32(const void* dz, void* out, int t_s, long long nf,
                     int window, int t_offset, int lead, int first,
                     void* stream) {
  if (t_s < 0 || nf < 0 || window < 1 || lead < 0 || first < 0 ||
      first > lead + t_s)
    return static_cast<int>(cudaErrorInvalidValue);
  if (first == lead + t_s || nf == 0) return 0;
  const auto* in = static_cast<const float*>(dz);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (window) {
    case 1: return launch_t_window<1>(in, o, t_s, nf, t_offset, lead, first,
                                      st);
    case 2: return launch_t_window<2>(in, o, t_s, nf, t_offset, lead, first,
                                      st);
    case 3: return launch_t_window<3>(in, o, t_s, nf, t_offset, lead, first,
                                      st);
    case 4: return launch_t_window<4>(in, o, t_s, nf, t_offset, lead, first,
                                      st);
    case 5: return launch_t_window<5>(in, o, t_s, nf, t_offset, lead, first,
                                      st);
    case 6: return launch_t_window<6>(in, o, t_s, nf, t_offset, lead, first,
                                      st);
    case 7: return launch_t_window<7>(in, o, t_s, nf, t_offset, lead, first,
                                      st);
    case 8: return launch_t_window<8>(in, o, t_s, nf, t_offset, lead, first,
                                      st);
    default:
      return launch_t_loop(in, o, t_s, nf, window, t_offset, lead, first, st);
  }
}

}  // extern "C"
