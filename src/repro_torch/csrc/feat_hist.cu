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
// matmuls over (slot x bin-block) lanes for the MXU; on Hopper a scatter is
// native, and what costs is where the adds land: at the shallow levels
// every row of a column falls in one of a few hundred cells, so adds into
// device memory queue at L2.
//
// Two paths, picked by the host from the shapes alone (kernels/
// feat_hist.py `hist_plan`):
//   shared (fh_pack, then fh_shared): where one column's table, slots
//   1..W-1 (slot 0 is never stored), fits a block's shared memory and the
//   device path would contend (a narrow table, many columns, regression).
//   A first pass packs each (tree, row)'s slot, label and integer weight
//   into one 4-byte word (its cell offset, or "nothing to add" for slot 0,
//   w <= 0 or a label out of range), so that the blocks of every column
//   group read 4 bytes a row, not 12, and no load waits on another.  A
//   block of 1024 threads (one per SM) owns one tree, a group of G columns
//   (as many as fit the opt-in shared memory) and a range of rows; it
//   zeroes its G tables, reads each row's word once for all its columns,
//   walks the columns with coalesced 1- or 2-byte bin loads (a template on
//   the bin type; the next column's bins load while this column adds) and
//   adds into shared memory; then it adds its nonzero cells into the
//   zeroed output with one device atomic each.  The grid's fastest axis is
//   (tree, column group), so the blocks that read the same rows run
//   together and the re-reads of the words come from L2.  Classification
//   with integer weights no larger than `wmax` (every Poisson bag, and no
//   bagging) keeps integer counts, added with native shared-memory integer
//   atomics (ATOMS.ADD; a float atomic in shared memory is a compare-and-
//   swap loop, ATOMS.CAST.SPIN, on this card, and so is the 64-bit add of
//   regression); the packing pass decides this on the card (flags), and
//   otherwise the tables are float and sum the weights read from w.
//   device (fh_device_cls / fh_device_reg): elsewhere (the deep levels'
//   wide frontiers, uint16 bins at B = 1024 past a few slots, wide tables
//   of few columns).  One thread owns one row: it loads the row's per-tree
//   slot and weight into registers once (up to MAXT trees a launch; the
//   wrapper splits larger batches) and adds its stat into the table in
//   device memory with an atomic per (column, tree).  There the adds
//   spread over many cells.
// Classification adds only the one nonzero entry w into float32 tables,
// exact while a table entry stays below 2^24: the tree drivers refuse a
// hist-mode tree whose in-bag weight reaches 2^24 (`plan.count_limit`), so
// every float add of the flush is exact and the table is bit-equal to any
// summation order.  Regression adds 64-bit
// fixed-point integers (one power-of-two scale per stat channel, picked by
// the caller from the data's magnitude) on both paths, which is
// associative, so repeated runs, and the two paths, give the same bits; a
// last pass converts them to float32.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;          // threads of the device-path kernels
constexpr int SHARED_THREADS = 1024; // threads of a shared-path block
constexpr int UNROLL = 4;           // rows in flight per thread
constexpr int MAXT = 8;             // trees per launch

enum { CLASSIFICATION = 0, REGRESSION = 1 };

// The fixed-point stats of one row: round(w*s0), round(w*y*s1),
// round(w*y*y*s2), each as the two's-complement uint64 added.
__device__ __forceinline__ void fixed_stats(float w, float y, double s0,
                                            double s1, double s2,
                                            unsigned long long (&q)[3]) {
  const float wy = w * y;
  q[0] = (unsigned long long)__double2ll_rn((double)w * s0);
  q[1] = (unsigned long long)__double2ll_rn((double)wy * s1);
  q[2] = (unsigned long long)__double2ll_rn((double)(wy * y) * s2);
}

// ---------------------------------------------------------------------------
// Device path
// ---------------------------------------------------------------------------

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
__global__ void fh_device_cls(const BinT* __restrict__ x,
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
__global__ void fh_device_reg(const BinT* __restrict__ x,
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
  unsigned long long q[MAXT][3];
#pragma unroll
  for (int t = 0; t < MAXT; ++t) fixed_stats(ww[t], yr, s0, s1, s2, q[t]);
  for (int j = 0; j < m; ++j) {
    const int b = (int)x[(size_t)j * n + r];
    if (b >= B) continue;
#pragma unroll
    for (int t = 0; t < MAXT; ++t) {
      if (sl[t] > 0) {
        const size_t cell = (((size_t)t * m + j) * W + sl[t]) * B + b;
#pragma unroll
        for (int s = 0; s < 3; ++s) atomicAdd(acc + cell * 3 + s, q[t][s]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Shared path
// ---------------------------------------------------------------------------

// The shared path's per-row state, once per (tree t, row r), so that the
// blocks of every column group read one 4-byte word: ~0 where the row adds
// nothing (slot 0 or >= W, w <= 0, a label outside [0, S)); else its cell
// offset within a column's table, bin left out -- (slot-1)*B*SW (+ class)
// -- in the low 16 bits (a table that fits a block has < 2^16 cells) and,
// for classification, the weight in the high 16 bits when it is an integer
// no larger than wmax (<= 65535), else 0 with flags[0] |= 1: the tables
// then sum float weights read from w.
template <int TASK>
__global__ void fh_pack(const int* __restrict__ slot,
                        const float* __restrict__ w,
                        const float* __restrict__ y, int T, int n, int W,
                        int B, int S, float wmax,
                        unsigned* __restrict__ packed,
                        int* __restrict__ flags) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool odd = false;
  if (i < (long long)T * n) {
    const int sl = slot[i];
    const float wv = w[i];
    unsigned word = ~0u;
    if (sl > 0 && sl < W && wv > 0.0f) {
      if (TASK == CLASSIFICATION) {
        const int cls = (int)y[i % n];
        if (cls >= 0 && cls < S) {
          const bool count = wv == rintf(wv) && wv <= wmax;
          word = (unsigned)((sl - 1) * B * S + cls)
              | (count ? (unsigned)wv << 16 : 0u);
          odd = !count;
        }
      } else {
        word = (unsigned)((sl - 1) * B * 3);
      }
    }
    packed[i] = word;
  }
  if (__syncthreads_or(odd) && threadIdx.x == 0) atomicOr(flags, 1);
}

// Block (blockIdx.x = t * nG + g, blockIdx.y = row range): tree t, columns
// [g*G, min(m, g*G + G)), rows [blockIdx.y * R, +R).  Its shared memory
// holds the columns' tables back to back, slots 1..W-1, SW cells per bin:
// uint32 counts or float (classification, SW = S), uint64 fixed point
// (regression, SW = 3).  Each table is contiguous in the output from
// (t, j, slot 1), so the flush of cell i lands at an offset + i.
template <typename BinT, int TASK>
__global__ void __launch_bounds__(SHARED_THREADS, 1)
fh_shared(const BinT* __restrict__ x, const unsigned* __restrict__ packed,
          const float* __restrict__ w, const float* __restrict__ y,
          const int* __restrict__ flags, int m, int n, int W, int B, int S,
          int G, int nG, int R, double s0, double s1, double s2,
          float* __restrict__ out, unsigned long long* __restrict__ acc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x / nG, g = blockIdx.x % nG;
  const int j0 = g * G, nj = min(m, j0 + G) - j0;
  const long long r0 = (long long)blockIdx.y * R;
  const long long r1 = min((long long)n, r0 + R);
  const int SW = TASK == CLASSIFICATION ? S : 3;
  const int span = (W - 1) * B * SW;          // cells of one column's table
  const int cells = nj * span;
  // integer counts unless a weight is fractional or too large (fh_pack)
  const bool counts = TASK == CLASSIFICATION && flags[0] == 0;
  float* tf = reinterpret_cast<float*>(smem);
  unsigned* tu = reinterpret_cast<unsigned*>(smem);
  unsigned long long* tq = reinterpret_cast<unsigned long long*>(smem);
  uint4* t4 = reinterpret_cast<uint4*>(smem);
  const int cell_bytes = TASK == CLASSIFICATION ? 4 : 8;
  const int n4 = (cells * cell_bytes + 15) / 16;
  for (int i = threadIdx.x; i < n4; i += SHARED_THREADS)
    t4[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const unsigned* pt = packed + (size_t)t * n;
  const float* wt = w + (size_t)t * n;
  // the loop is uniform over the block (the warps stay converged); thread
  // i takes rows k0 + i + u * SHARED_THREADS
  for (long long k0 = r0; k0 < r1; k0 += SHARED_THREADS * UNROLL) {
    const long long kb = k0 + threadIdx.x;
    // per row: its cell offset within a column's table without the bin
    // (-1: nothing to add), and its stat
    int base[UNROLL];
    unsigned wi[UNROLL];
    float wf[UNROLL];
    unsigned long long q[UNROLL][3];
    bool any = false;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long k = kb + (long long)u * SHARED_THREADS;
      const unsigned word = k < r1 ? pt[k] : ~0u;
      base[u] = word == ~0u ? -1 : (int)(word & 0xffffu);
      wi[u] = word >> 16;
      any |= base[u] >= 0;
    }
    if (!__any_sync(0xffffffffu, any)) continue;   // the warp has no row
    if (!counts) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long k = kb + (long long)u * SHARED_THREADS;
        wf[u] = base[u] >= 0 ? wt[k] : 0.0f;
        if (TASK == REGRESSION && base[u] >= 0)
          fixed_stats(wf[u], y[k], s0, s1, s2, q[u]);
      }
    }
    // the bins of column jj + 1 are loaded while column jj adds
    int b[UNROLL], nb[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      b[u] = base[u] >= 0 ? (int)x[(size_t)j0 * n + kb + u * SHARED_THREADS]
                          : B;
      nb[u] = B;
    }
    for (int jj = 0; jj < nj; ++jj) {
      if (jj + 1 < nj) {
        const BinT* xc = x + (size_t)(j0 + jj + 1) * n;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          nb[u] = base[u] >= 0 ? (int)xc[kb + u * SHARED_THREADS] : B;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (b[u] >= B) continue;
        const int cell = jj * span + base[u] + b[u] * SW;
        if (TASK == CLASSIFICATION) {
          if (counts) atomicAdd(tu + cell, wi[u]);
          else atomicAdd(tf + cell, wf[u]);
        } else {
#pragma unroll
          for (int s = 0; s < 3; ++s) atomicAdd(tq + cell + s, q[u][s]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) b[u] = nb[u];
    }
  }
  __syncthreads();

  // flush: cell i is column j0 + i / span, offset i % span from its slot 1
  for (int i = threadIdx.x; i < cells; i += SHARED_THREADS) {
    const int jj = i / span;
    const size_t dst = (((size_t)t * m + j0 + jj) * W + 1) * B * SW
        + (i - jj * span);
    if (TASK == CLASSIFICATION) {
      const float v = counts ? (float)tu[i] : tf[i];
      if (v != 0.0f) atomicAdd(out + dst, v);
    } else if (tq[i] != 0ull) {
      atomicAdd(acc + dst, tq[i]);
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

template <typename BinT, int TASK>
cudaError_t launch_shared(dim3 grid, size_t smem, cudaStream_t st,
                          const void* x, const unsigned* packed,
                          const float* w, const float* y, const int* flags,
                          int m, int n, int W, int B, int S, int G, int nG,
                          int R, double s0, double s1, double s2, float* out,
                          unsigned long long* acc) {
  auto fn = fh_shared<BinT, TASK>;
  static size_t allowed = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  fn<<<grid, SHARED_THREADS, smem, st>>>((const BinT*)x, packed, w, y, flags,
                                         m, n, W, B, S, G, nG, R, s0, s1, s2,
                                         out, acc);
  return cudaGetLastError();
}

template <typename BinT>
cudaError_t launch_device(int task, cudaStream_t st, const void* x,
                          const int* slot, const float* w, const float* y,
                          int T, int m, int n, int W, int B, int S, double s0,
                          double s1, double s2, float* out,
                          unsigned long long* acc) {
  const unsigned blocks = (unsigned)((n + BLOCK - 1) / BLOCK);
  if (task == CLASSIFICATION)
    fh_device_cls<BinT><<<blocks, BLOCK, 0, st>>>((const BinT*)x, slot, w, y,
                                                  T, m, n, W, B, S, out);
  else
    fh_device_reg<BinT><<<blocks, BLOCK, 0, st>>>((const BinT*)x, slot, w, y,
                                                  T, m, n, W, B, s0, s1, s2,
                                                  acc);
  return cudaGetLastError();
}

cudaError_t device_attribute(cudaDeviceAttr attr, int* value) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(value, attr, dev);
}

// Regression: acc (T, m, W, B, 3) uint64 into out (T, m, W, B, 3) float32.
int to_float(int task, int T, int m, int W, int B, double s0, double s1,
             double s2, const unsigned long long* acc, float* out,
             cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || task == CLASSIFICATION) return (int)err;
  const long long cells = (long long)T * m * W * B;
  fixed_to_float<<<(unsigned)((cells * 3 + BLOCK - 1) / BLOCK), BLOCK, 0,
                   st>>>(acc, cells, 1.0 / s0, 1.0 / s1, 1.0 / s2, out);
  return (int)cudaGetLastError();
}

bool valid(int task, int bin_bytes, int T, int W) {
  return T >= 1 && T <= MAXT && (bin_bytes == 1 || bin_bytes == 2) &&
         (task == CLASSIFICATION || task == REGRESSION) && W >= 1;
}

}  // namespace

extern "C" int feat_hist_max_trees() { return MAXT; }

// Shared memory a block may take (bytes), or -1 without a device.
extern "C" int feat_hist_smem_optin() {
  int v = 0;
  return device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin, &v) ==
                 cudaSuccess ? v : -1;
}

// Streaming multiprocessors of the device, or -1 without one.
extern "C" int feat_hist_sm_count() {
  int v = 0;
  return device_attribute(cudaDevAttrMultiProcessorCount, &v) == cudaSuccess
             ? v : -1;
}

// The tables of one tree group (T <= MAXT), two entry points, one per
// path.  x (m, n) bin ids of `bin_bytes` (1 or 2) bytes; slot/w (T, n);
// y (n,).  Classification: out (T, m, W, B, S) float32 zeroed by the
// caller.  Regression: acc (T, m, W, B, 3) uint64 zeroed by the caller;
// scales are powers of two; out (T, m, W, B, 3) float32 is written in
// full.
// The shared path: blocks (T * nG, nR) of G columns and R rows with `smem`
// bytes of tables; packed (T, n) uint32 and flags (1,) int32 scratch;
// wmax <= 65535.
extern "C" int feat_hist_shared_launch(
    int task, const void* x, int bin_bytes, const int* slot, const float* w,
    const float* y, int T, int m, int n, int W, int B, int S, int G, int nG,
    int R, int nR, int smem, float wmax, double s0, double s1, double s2,
    unsigned* packed, int* flags, float* out, unsigned long long* acc,
    void* stream_ptr) {
  const int SW = task == CLASSIFICATION ? S : 3;
  if (!valid(task, bin_bytes, T, W) || G < 1 || nG < 1 || R < 1 || nR < 1 ||
      smem < 0 || nR > 65535 || (long long)G * nG < m ||
      (long long)(W - 1) * B * SW > 0xffff || wmax > 65535.0f)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream_ptr;
  cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(((long long)T * n + BLOCK - 1) / BLOCK);
  if (task == CLASSIFICATION)
    fh_pack<CLASSIFICATION><<<blocks, BLOCK, 0, st>>>(
        slot, w, y, T, n, W, B, S, wmax, packed, flags);
  else
    fh_pack<REGRESSION><<<blocks, BLOCK, 0, st>>>(slot, w, y, T, n, W, B, S,
                                                  wmax, packed, flags);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(T * nG), (unsigned)nR);
#define FH_SHARED(BT, TK)                                                    \
  launch_shared<BT, TK>(grid, (size_t)smem, st, x, packed, w, y, flags, m,   \
                        n, W, B, S, G, nG, R, s0, s1, s2, out, acc)
  if (bin_bytes == 1)
    err = task == CLASSIFICATION ? FH_SHARED(unsigned char, CLASSIFICATION)
                                 : FH_SHARED(unsigned char, REGRESSION);
  else
    err = task == CLASSIFICATION ? FH_SHARED(unsigned short, CLASSIFICATION)
                                 : FH_SHARED(unsigned short, REGRESSION);
#undef FH_SHARED
  if (err != cudaSuccess) return (int)err;
  return to_float(task, T, m, W, B, s0, s1, s2, acc, out, st);
}

// The device path: one thread per row.
extern "C" int feat_hist_device_launch(
    int task, const void* x, int bin_bytes, const int* slot, const float* w,
    const float* y, int T, int m, int n, int W, int B, int S, double s0,
    double s1, double s2, float* out, unsigned long long* acc,
    void* stream_ptr) {
  if (!valid(task, bin_bytes, T, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const cudaError_t err = bin_bytes == 1
      ? launch_device<unsigned char>(task, st, x, slot, w, y, T, m, n, W, B,
                                     S, s0, s1, s2, out, acc)
      : launch_device<unsigned short>(task, st, x, slot, w, y, T, m, n, W, B,
                                      S, s0, s1, s2, out, acc);
  if (err != cudaSuccess) return (int)err;
  return to_float(task, T, m, W, B, s0, s1, s2, acc, out, st);
}
