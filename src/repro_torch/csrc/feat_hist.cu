// Histogram tables of the bin cache (hist mode) for Hopper (sm_90a).
//
// Replaces the TPU kernel `feat_hist_pallas` (body `_feat_hist_kernel`) of
// src/repro/kernels/feat_hist.py: for every (tree t, numeric column j,
// scatter slot s, bin b) the sum of the row stats of the in-bag rows whose
// slot is s and whose bin id in column j is b -- w * one_hot(y) for
// classification, [w, w*y, w*y*y] for regression.  Slot 0 discards a row
// (closed leaves, and under histogram subtraction the rows of leaves whose
// table is derived as parent - sibling).  Row order does not matter.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  The bin ids are read once,
// m*n*(1|2) B; the per-tree slot and bag weight, T*n*8 B, and the labels,
// n*4 B, once per row for all columns; the (T, m, W, B, S) table,
// T*m*W*B*S*4 B, is written once.  The arithmetic is one add per
// (row, column, tree).  The TPU kernel turned the scatter into one-hot
// matmuls over (slot x bin-block) lanes for the MXU; on Hopper a scatter
// is native, so one thread owns one row: it loads the row's per-tree slot
// and weight into registers once (up to MAXT trees a launch; the wrapper
// splits larger batches) and walks the columns with coalesced 1- or 2-byte
// loads (a template on the bin type), adding its stat into the table in
// device memory with an atomic.  Rows whose slot is 0 in every tree leave
// before the column loop: the counterpart of the reference's compaction of
// the build rows.  Classification adds only the one nonzero entry w; table
// entries are integers below 2^24, so float atomics are exact and the table
// is bit-equal to any summation order.  Regression adds 64-bit fixed-point
// integers (one power-of-two scale per stat channel, picked by the caller
// from the data's magnitude), which is associative, so repeated runs give
// the same bits; a last pass converts them to float32.  Known limit of this
// first design: at shallow levels every row of a column lands in one of a
// few hundred cells, so the atomics contend (PERF.md).
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int MAXT = 8;      // trees per launch

// The row's per-tree slot (0 = nothing to add) and weight; returns whether
// any tree keeps the row.
__device__ __forceinline__ bool load_row(const int* __restrict__ slot,
                                         const float* __restrict__ w, int T,
                                         int n, int W, long long r,
                                         int (&sl)[MAXT], float (&ww)[MAXT]) {
  bool any = false;
#pragma unroll
  for (int t = 0; t < MAXT; ++t) {
    const bool in = t < T;
    sl[t] = in ? slot[(size_t)t * n + r] : 0;
    ww[t] = in ? w[(size_t)t * n + r] : 0.0f;
    if (!(ww[t] > 0.0f && sl[t] > 0 && sl[t] < W)) sl[t] = 0;
    any |= sl[t] > 0;
  }
  return any;
}

template <typename BinT>
__global__ void feat_hist_cls(const BinT* __restrict__ x,
                              const int* __restrict__ slot,
                              const float* __restrict__ w,
                              const float* __restrict__ y, int T, int m,
                              int n, int W, int B, int S,
                              float* __restrict__ out) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int cls = (int)y[r];
  if (cls < 0 || cls >= S) return;   // one_hot of an out-of-range label is 0
  int sl[MAXT];
  float ww[MAXT];
  if (!load_row(slot, w, T, n, W, r, sl, ww)) return;
  for (int j = 0; j < m; ++j) {
    const int b = (int)x[(size_t)j * n + r];
    if (b >= B) continue;
#pragma unroll
    for (int t = 0; t < MAXT; ++t) {
      if (sl[t] > 0) {
        const size_t cell = (((size_t)t * m + j) * W + sl[t]) * B + b;
        atomicAdd(out + cell * S + cls, ww[t]);
      }
    }
  }
}

template <typename BinT>
__global__ void feat_hist_reg(const BinT* __restrict__ x,
                              const int* __restrict__ slot,
                              const float* __restrict__ w,
                              const float* __restrict__ y, int T, int m,
                              int n, int W, int B, double s0, double s1,
                              double s2,
                              unsigned long long* __restrict__ acc) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  int sl[MAXT];
  float ww[MAXT];
  if (!load_row(slot, w, T, n, W, r, sl, ww)) return;
  const float yr = y[r];
  long long q[MAXT][3];
#pragma unroll
  for (int t = 0; t < MAXT; ++t) {
    const float wy = ww[t] * yr;
    q[t][0] = __double2ll_rn((double)ww[t] * s0);
    q[t][1] = __double2ll_rn((double)wy * s1);
    q[t][2] = __double2ll_rn((double)(wy * yr) * s2);
  }
  for (int j = 0; j < m; ++j) {
    const int b = (int)x[(size_t)j * n + r];
    if (b >= B) continue;
#pragma unroll
    for (int t = 0; t < MAXT; ++t) {
      if (sl[t] > 0) {
        const size_t cell = (((size_t)t * m + j) * W + sl[t]) * B + b;
#pragma unroll
        for (int s = 0; s < 3; ++s)
          atomicAdd(acc + cell * 3 + s, (unsigned long long)q[t][s]);
      }
    }
  }
}

__global__ void fixed_to_float(const unsigned long long* __restrict__ acc,
                               long long cells, double i0, double i1,
                               double i2, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells * 3) return;
  const int s = (int)(i % 3);
  const double inv = s == 0 ? i0 : (s == 1 ? i1 : i2);
  out[i] = (float)((double)(long long)acc[i] * inv);
}

}  // namespace

extern "C" int feat_hist_max_trees() { return MAXT; }

// Classification: x (m, n) bin ids of `bin_bytes` (1 or 2) bytes each;
// slot/w (T, n); y (n,); out (T, m, W, B, S) float32, zeroed by the caller.
extern "C" int feat_hist_cls_launch(const void* x, int bin_bytes,
                                    const int* slot, const float* w,
                                    const float* y, int T, int m, int n,
                                    int W, int B, int S, float* out,
                                    void* stream_ptr) {
  if (T < 1 || T > MAXT) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + BLOCK - 1) / BLOCK);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (bin_bytes == 1)
    feat_hist_cls<unsigned char><<<blocks, BLOCK, 0, stream>>>(
        (const unsigned char*)x, slot, w, y, T, m, n, W, B, S, out);
  else if (bin_bytes == 2)
    feat_hist_cls<unsigned short><<<blocks, BLOCK, 0, stream>>>(
        (const unsigned short*)x, slot, w, y, T, m, n, W, B, S, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Regression: acc (T, m, W, B, 3) uint64 zeroed by the caller; scales are
// powers of two; out (T, m, W, B, 3) float32 is written in full.
extern "C" int feat_hist_reg_launch(const void* x, int bin_bytes,
                                    const int* slot, const float* w,
                                    const float* y, int T, int m, int n,
                                    int W, int B, double s0, double s1,
                                    double s2, unsigned long long* acc,
                                    float* out, void* stream_ptr) {
  if (T < 1 || T > MAXT) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const unsigned blocks = (unsigned)((n + BLOCK - 1) / BLOCK);
  if (bin_bytes == 1)
    feat_hist_reg<unsigned char><<<blocks, BLOCK, 0, stream>>>(
        (const unsigned char*)x, slot, w, y, T, m, n, W, B, s0, s1, s2, acc);
  else if (bin_bytes == 2)
    feat_hist_reg<unsigned short><<<blocks, BLOCK, 0, stream>>>(
        (const unsigned short*)x, slot, w, y, T, m, n, W, B, s0, s1, s2,
        acc);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)T * m * W * B;
  fixed_to_float<<<(unsigned)((cells * 3 + BLOCK - 1) / BLOCK), BLOCK, 0,
                   stream>>>(acc, cells, 1.0 / s0, 1.0 / s1, 1.0 / s2, out);
  return (int)cudaGetLastError();
}
