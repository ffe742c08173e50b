// Categorical count tables (paper §2.4) for Hopper (sm_90a).
//
// Replaces the TPU kernel `cat_hist_pallas` (body `_cat_hist_kernel`) of
// src/repro/kernels/cat_hist.py: for every (tree t, column j, open leaf h,
// category v) the sum of the row stats of the in-bag rows of leaf h whose
// value in column j is v — w * one_hot(y) for classification, [w, w*y,
// w*y*y] for regression.  Row order does not matter.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  The rows are read once — each
// column's int32 values and, once per row for all columns, the per-tree
// leaf id and bag weight and the label — and the (T, m, L1, V, S) table is
// written once.  The TPU kernel turned the scatter into one-hot matmuls
// over category blocks; on Hopper a scatter is native, so one thread owns
// one row: it loads the row's per-tree state into registers once and
// walks the columns (coalesced across the warp), adding its stat into the
// table in device memory with an atomic.  Classification adds only the
// one nonzero entry w; its table entries are integers below 2^24, so float
// atomics are exact and the table is bit-equal to any summation order.
// Regression sums floats, whose atomics would round differently from run
// to run: the regression kernel adds 64-bit fixed-point integers instead
// (one power-of-two scale per stat channel, picked by the caller from the
// data's magnitude), which is associative, so repeated runs give the same
// bits; a last pass converts the integers to float32.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int MAXT = 8;      // trees per launch (the wrapper splits larger batches)

__global__ void cat_hist_cls(const int* __restrict__ x,
                             const int* __restrict__ leaf,
                             const float* __restrict__ w,
                             const float* __restrict__ y, int T, int m,
                             int n, int L1, int V, int S,
                             float* __restrict__ out) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int cls = (int)y[r];
  if (cls < 0 || cls >= S) return;   // one_hot of an out-of-range label is 0
  int lf[MAXT];
  float ww[MAXT];
#pragma unroll
  for (int t = 0; t < MAXT; ++t) {
    const bool in = t < T;
    lf[t] = in ? leaf[(size_t)t * n + r] : 0;
    ww[t] = in ? w[(size_t)t * n + r] : 0.0f;
    if (!(ww[t] > 0.0f && lf[t] > 0 && lf[t] < L1)) lf[t] = 0;
  }
  for (int j = 0; j < m; ++j) {
    const int v = x[(size_t)j * n + r];
    if (v < 0 || v >= V) continue;
#pragma unroll
    for (int t = 0; t < MAXT; ++t) {
      if (lf[t] > 0) {
        const size_t cell = (((size_t)t * m + j) * L1 + lf[t]) * V + v;
        atomicAdd(out + cell * S + cls, ww[t]);
      }
    }
  }
}

__global__ void cat_hist_reg(const int* __restrict__ x,
                             const int* __restrict__ leaf,
                             const float* __restrict__ w,
                             const float* __restrict__ y, int T, int m,
                             int n, int L1, int V, double s0, double s1,
                             double s2, unsigned long long* __restrict__ acc) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float yr = y[r];
  int lf[MAXT];
  long long q[MAXT][3];
#pragma unroll
  for (int t = 0; t < MAXT; ++t) {
    const bool in = t < T;
    lf[t] = in ? leaf[(size_t)t * n + r] : 0;
    const float wt = in ? w[(size_t)t * n + r] : 0.0f;
    if (!(wt > 0.0f && lf[t] > 0 && lf[t] < L1)) lf[t] = 0;
    const float wy = wt * yr;
    q[t][0] = __double2ll_rn((double)wt * s0);
    q[t][1] = __double2ll_rn((double)wy * s1);
    q[t][2] = __double2ll_rn((double)(wy * yr) * s2);
  }
  for (int j = 0; j < m; ++j) {
    const int v = x[(size_t)j * n + r];
    if (v < 0 || v >= V) continue;
#pragma unroll
    for (int t = 0; t < MAXT; ++t) {
      if (lf[t] > 0) {
        const size_t cell = (((size_t)t * m + j) * L1 + lf[t]) * V + v;
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

extern "C" int cat_hist_max_trees() { return MAXT; }

// Classification: out (T, m, L1, V, S) float32, zeroed by the caller.
extern "C" int cat_hist_cls_launch(const int* x, const int* leaf,
                                   const float* w, const float* y, int T,
                                   int m, int n, int L1, int V, int S,
                                   float* out, void* stream_ptr) {
  if (T < 1 || T > MAXT) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + BLOCK - 1) / BLOCK);
  cat_hist_cls<<<blocks, BLOCK, 0, (cudaStream_t)stream_ptr>>>(
      x, leaf, w, y, T, m, n, L1, V, S, out);
  return (int)cudaGetLastError();
}

// Regression: acc (T, m, L1, V, 3) uint64 zeroed by the caller; scales are
// powers of two; out (T, m, L1, V, 3) float32 is written in full.
extern "C" int cat_hist_reg_launch(const int* x, const int* leaf,
                                   const float* w, const float* y, int T,
                                   int m, int n, int L1, int V, double s0,
                                   double s1, double s2,
                                   unsigned long long* acc, float* out,
                                   void* stream_ptr) {
  if (T < 1 || T > MAXT) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const unsigned blocks = (unsigned)((n + BLOCK - 1) / BLOCK);
  cat_hist_reg<<<blocks, BLOCK, 0, stream>>>(x, leaf, w, y, T, m, n, L1, V,
                                            s0, s1, s2, acc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)T * m * L1 * V;
  fixed_to_float<<<(unsigned)((cells * 3 + BLOCK - 1) / BLOCK), BLOCK, 0,
                   stream>>>(acc, cells, 1.0 / s0, 1.0 / s1, 1.0 / s2, out);
  return (int)cudaGetLastError();
}
