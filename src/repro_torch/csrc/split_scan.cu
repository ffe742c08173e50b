// Exact numeric supersplit (paper Alg. 1) for Hopper (sm_90a).
//
// Replaces the TPU kernel `split_scan_pallas` (body `_split_scan_kernel`)
// of src/repro/kernels/split_scan.py.  For every (tree t, column j, open
// leaf h) it finds the best midpoint split over the column's presorted
// rows: left = exclusive per-leaf prefix of the row stats, right =
// totals - left, threshold = midpoint with the previous in-bag value of the
// same leaf (taken only if strictly larger), gain = imp(parent) - imp(left)
// - imp(right), both sides >= min_records, first row in scan order wins ties.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): bytes.  Each row of
// each (tree, column) reads its value and row id (8 B) and the tree's leaf
// id, bag weight and label at that row (12 B); the arithmetic per row is a
// few dozen flops.  The TPU kernel carried the scan state from one grid
// step to the next; Hopper blocks run in no order, so the scan is split in
// three phases over (tree, column, row chunk):
//   1. ss_chunk_sums  — per chunk: per-leaf stat sums and last in-bag value;
//   2. ss_carry       — exclusive scan of those over the chunks (in place);
//   3. ss_chunk_best  — rescan of each chunk from its carried prefix: the
//                       per-leaf best gain and its threshold;
//   then ss_reduce keeps, per leaf, the best over chunks (lowest chunk on
//   equal gain, so the first row in scan order wins as in Alg. 1).
// One warp per block stages TILE rows at a time: the 32 lanes load the
// rows and gather the per-row state in parallel (many gathers in flight
// hide their latency), keep the active rows (open leaf, in bag, candidate
// feature) in order via a warp ballot, and lane 0 runs the recurrence over
// them serially out of shared memory.  Serial order makes every sum
// deterministic; for classification the stats are integers below 2^24, so
// the prefixes are exact and the gains bit-equal to the plain version.
// Compiled with -fmad=false: the impurity expressions keep the reference's
// operation order and no multiply-add is fused.  The serial lane is the
// known limit of this first design (PERF.md).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int WARP = 32;
constexpr int TILE = 256;            // rows staged per step
constexpr int PER_LANE = TILE / WARP;
constexpr int MAXS = 16;             // largest stat width (classes) taken

enum { GINI = 0, ENTROPY = 1, VARIANCE = 2 };
enum { CLASSIFICATION = 0, REGRESSION = 1 };

struct Tile {
  float a[TILE];   // value
  int h[TILE];     // leaf id
  float w[TILE];   // bag weight
  float y[TILE];   // label
};

__device__ __forceinline__ float impurity(const float* h, int S, int kind) {
  if (kind == VARIANCE) {
    const float w = h[0], wy = h[1], wy2 = h[2];
    return fmaxf(wy2 - (w > 0.0f ? wy * wy / fmaxf(w, 1e-12f) : 0.0f), 0.0f);
  }
  float n = 0.0f;
#pragma unroll
  for (int s = 0; s < MAXS; ++s)
    if (s < S) n += h[s];
  if (kind == GINI) {
    float sq = 0.0f;
#pragma unroll
    for (int s = 0; s < MAXS; ++s)
      if (s < S) sq += h[s] * h[s];
    return n - (n > 0.0f ? sq / fmaxf(n, 1e-12f) : 0.0f);
  }
  const float d = fmaxf(n, 1e-12f);
  float acc = 0.0f;
#pragma unroll
  for (int s = 0; s < MAXS; ++s) {
    if (s < S) {
      const float p = h[s] / d;
      acc += h[s] > 0.0f ? p * logf(fmaxf(p, 1e-12f)) : 0.0f;
    }
  }
  return -(n * acc);
}

__device__ __forceinline__ float count(const float* h, int S, int task) {
  if (task != CLASSIFICATION) return h[0];
  float n = 0.0f;
#pragma unroll
  for (int s = 0; s < MAXS; ++s)
    if (s < S) n += h[s];
  return n;
}

// Add one row's stats to the per-leaf accumulator H[h*S : (h+1)*S].
__device__ __forceinline__ void add_row(float* H, int S, int task, float w,
                                        float y) {
  if (task == CLASSIFICATION) {
    const int cls = (int)y;            // one_hot(y) * w: one nonzero entry
    if (cls >= 0 && cls < S) H[cls] += w;
  } else {
    const float wy = w * y;
    H[0] += w;
    H[1] += wy;
    H[2] += wy * y;
  }
}

// Stage the active rows of [base, min(base + TILE, r1)) into the tile, in
// row order.  Returns how many were staged (the same in every lane).
__device__ __forceinline__ int stage_tile(
    long long base, long long r1, const float* __restrict__ vcol,
    const int* __restrict__ icol, const int* __restrict__ lt,
    const float* __restrict__ wt, const float* __restrict__ y,
    const unsigned char* __restrict__ ct, int L1, int lane, Tile& tile) {
  int idx[PER_LANE];
  float a[PER_LANE];
#pragma unroll
  for (int g = 0; g < PER_LANE; ++g) {
    const long long r = base + g * WARP + lane;
    const bool in = r < r1;
    idx[g] = in ? icol[r] : -1;
    a[g] = in ? vcol[r] : 0.0f;
  }
  int hh[PER_LANE];
  float ww[PER_LANE], yy[PER_LANE];
#pragma unroll
  for (int g = 0; g < PER_LANE; ++g) {
    const bool in = idx[g] >= 0;
    hh[g] = in ? lt[idx[g]] : 0;
    ww[g] = in ? wt[idx[g]] : 0.0f;
    yy[g] = in ? y[idx[g]] : 0.0f;
  }
  int n_act = 0;
#pragma unroll
  for (int g = 0; g < PER_LANE; ++g) {
    const bool act = hh[g] > 0 && hh[g] < L1 && ww[g] > 0.0f && ct[hh[g]];
    const unsigned bal = __ballot_sync(0xffffffffu, act);
    if (act) {
      const int p = n_act + __popc(bal & ((1u << lane) - 1u));
      tile.a[p] = a[g];
      tile.h[p] = hh[g];
      tile.w[p] = ww[g];
      tile.y[p] = yy[g];
    }
    n_act += __popc(bal);
  }
  __syncwarp();
  return n_act;
}

// Phase 1: per (tree, column, chunk) per-leaf stat sums and last value.
__global__ void ss_chunk_sums(
    const float* __restrict__ vals, const int* __restrict__ sidx,
    const int* __restrict__ leaf, const float* __restrict__ w,
    const float* __restrict__ y, const unsigned char* __restrict__ cand,
    int m, int n, int L1, int S, int task, long long chunk,
    float* __restrict__ csum, float* __restrict__ clast) {
  extern __shared__ float smem[];
  float* H = smem;                     // L1 * S
  float* V = H + (size_t)L1 * S;       // L1
  __shared__ Tile tile;
  const int c = blockIdx.x, j = blockIdx.y, t = blockIdx.z;
  const int nc = gridDim.x, lane = threadIdx.x;
  for (int i = lane; i < L1 * S; i += WARP) H[i] = 0.0f;
  for (int i = lane; i < L1; i += WARP) V[i] = -CUDART_INF_F;
  __syncwarp();

  const long long r0 = c * chunk;
  const long long r1 = min((long long)n, r0 + chunk);
  const float* vcol = vals + (size_t)j * n;
  const int* icol = sidx + (size_t)j * n;
  const int* lt = leaf + (size_t)t * n;
  const float* wt = w + (size_t)t * n;
  const unsigned char* ct = cand + ((size_t)t * m + j) * L1;
  for (long long base = r0; base < r1; base += TILE) {
    const int n_act = stage_tile(base, r1, vcol, icol, lt, wt, y, ct, L1,
                                 lane, tile);
    if (lane == 0) {
      for (int k = 0; k < n_act; ++k) {
        const int h = tile.h[k];
        add_row(H + (size_t)h * S, S, task, tile.w[k], tile.y[k]);
        V[h] = tile.a[k];
      }
    }
    __syncwarp();
  }
  const size_t blk = ((size_t)t * m + j) * nc + c;
  for (int i = lane; i < L1 * S; i += WARP) csum[blk * L1 * S + i] = H[i];
  for (int i = lane; i < L1; i += WARP) clast[blk * L1 + i] = V[i];
}

// Phase 2: exclusive scan over chunks, in place.  One thread per
// (tree, column, leaf*S + s); the s == 0 threads also carry the last value.
__global__ void ss_carry(float* __restrict__ csum, float* __restrict__ clast,
                         int TM, int nc, int L1, int S) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per = (long long)L1 * S;
  if (i >= TM * per) return;
  const long long tm = i / per, q = i % per;
  float acc = 0.0f;
  for (int c = 0; c < nc; ++c) {
    float* p = csum + ((size_t)tm * nc + c) * per + q;
    const float v = *p;
    *p = acc;
    acc += v;
  }
  if (q % S == 0) {
    const long long h = q / S;
    float last = -CUDART_INF_F;
    for (int c = 0; c < nc; ++c) {
      float* p = clast + ((size_t)tm * nc + c) * L1 + h;
      const float v = *p;
      *p = last;
      last = fmaxf(last, v);           // values ascend: max == last seen
    }
  }
}

// Phase 3: rescan each chunk from its carried prefix; per-leaf best.
__global__ void ss_chunk_best(
    const float* __restrict__ vals, const int* __restrict__ sidx,
    const int* __restrict__ leaf, const float* __restrict__ w,
    const float* __restrict__ y, const unsigned char* __restrict__ cand,
    const float* __restrict__ totals, int m, int n, int L1, int S, int kind,
    int task, float min_records, long long chunk,
    const float* __restrict__ csum, const float* __restrict__ clast,
    float* __restrict__ cgain, float* __restrict__ cthr) {
  extern __shared__ float smem[];
  float* H = smem;                     // L1 * S, carried prefix
  float* TOT = H + (size_t)L1 * S;     // L1 * S, level totals
  float* V = TOT + (size_t)L1 * S;     // L1, last in-bag value
  float* BG = V + L1;                  // L1, best gain
  float* BT = BG + L1;                 // L1, its threshold
  __shared__ Tile tile;
  const int c = blockIdx.x, j = blockIdx.y, t = blockIdx.z;
  const int nc = gridDim.x, lane = threadIdx.x;
  const size_t blk = ((size_t)t * m + j) * nc + c;
  for (int i = lane; i < L1 * S; i += WARP) {
    H[i] = csum[blk * L1 * S + i];
    TOT[i] = totals[(size_t)t * L1 * S + i];
  }
  for (int i = lane; i < L1; i += WARP) {
    V[i] = clast[blk * L1 + i];
    BG[i] = -CUDART_INF_F;
    BT[i] = 0.0f;
  }
  __syncwarp();

  const long long r0 = c * chunk;
  const long long r1 = min((long long)n, r0 + chunk);
  const float* vcol = vals + (size_t)j * n;
  const int* icol = sidx + (size_t)j * n;
  const int* lt = leaf + (size_t)t * n;
  const float* wt = w + (size_t)t * n;
  const unsigned char* ct = cand + ((size_t)t * m + j) * L1;
  for (long long base = r0; base < r1; base += TILE) {
    const int n_act = stage_tile(base, r1, vcol, icol, lt, wt, y, ct, L1,
                                 lane, tile);
    if (lane == 0) {
      for (int k = 0; k < n_act; ++k) {
        const int h = tile.h[k];
        const float a = tile.a[k];
        float* Hh = H + (size_t)h * S;
        const float vh = V[h];
        if (a > vh && isfinite(vh)) {
          float left[MAXS], right[MAXS], parent[MAXS];
#pragma unroll
          for (int s = 0; s < MAXS; ++s) {
            if (s < S) {
              left[s] = Hh[s];
              right[s] = TOT[(size_t)h * S + s] - left[s];
              parent[s] = left[s] + right[s];
            }
          }
          if (count(left, S, task) >= min_records &&
              count(right, S, task) >= min_records) {
            const float g = impurity(parent, S, kind)
                - impurity(left, S, kind) - impurity(right, S, kind);
            if (g > BG[h]) {
              BG[h] = g;
              BT[h] = (a + vh) * 0.5f;
            }
          }
        }
        add_row(Hh, S, task, tile.w[k], tile.y[k]);
        V[h] = a;
      }
    }
    __syncwarp();
  }
  for (int i = lane; i < L1; i += WARP) {
    cgain[blk * L1 + i] = BG[i];
    cthr[blk * L1 + i] = BT[i];
  }
}

// Best over chunks per (tree, column, leaf); strict > keeps the lowest
// chunk (hence the first row) on equal gain.
__global__ void ss_reduce(const float* __restrict__ cgain,
                          const float* __restrict__ cthr, int TM, int nc,
                          int L1, float* __restrict__ gain,
                          float* __restrict__ thr) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)TM * L1) return;
  const long long tm = i / L1, h = i % L1;
  float bg = -CUDART_INF_F, bt = 0.0f;
  for (int c = 0; c < nc; ++c) {
    const size_t k = ((size_t)tm * nc + c) * L1 + h;
    const float g = cgain[k];
    if (g > bg) {
      bg = g;
      bt = cthr[k];
    }
  }
  gain[i] = bg;
  thr[i] = bt;
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" int split_scan_max_stats() { return MAXS; }

// Launches the four kernels on `stream`; returns the first CUDA error.
// Shapes: vals/sidx (m, n); leaf/w (T, n); y (n,); cand (T, m, L1) bytes;
// totals (T, L1, S); csum (T, m, nc, L1, S) and clast/cgain/cthr
// (T, m, nc, L1) scratch; gain/thr (T, m, L1) outputs.
extern "C" int split_scan_launch(
    const float* vals, const int* sidx, const int* leaf, const float* w,
    const float* y, const unsigned char* cand, const float* totals, int T,
    int m, int n, int L1, int S, int kind, int task, float min_records,
    int nc, long long chunk, float* csum, float* clast, float* cgain,
    float* cthr, float* gain, float* thr, void* stream_ptr) {
  if (S < 1 || S > MAXS || (task == REGRESSION && S != 3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid(nc, m, T);
  const size_t smem1 = (size_t)L1 * (S + 1) * sizeof(float);
  const size_t smem3 = (size_t)L1 * (2 * S + 3) * sizeof(float);
  cudaError_t err = set_smem((const void*)ss_chunk_sums, smem1);
  if (err != cudaSuccess) return (int)err;
  err = set_smem((const void*)ss_chunk_best, smem3);
  if (err != cudaSuccess) return (int)err;

  ss_chunk_sums<<<grid, WARP, smem1, stream>>>(vals, sidx, leaf, w, y, cand,
                                              m, n, L1, S, task, chunk, csum,
                                              clast);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long TM = (long long)T * m;
  const long long carry_threads = TM * L1 * S;
  ss_carry<<<(unsigned)((carry_threads + 255) / 256), 256, 0, stream>>>(
      csum, clast, (int)TM, nc, L1, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ss_chunk_best<<<grid, WARP, smem3, stream>>>(
      vals, sidx, leaf, w, y, cand, totals, m, n, L1, S, kind, task,
      min_records, chunk, csum, clast, cgain, cthr);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long red_threads = TM * L1;
  ss_reduce<<<(unsigned)((red_threads + 255) / 256), 256, 0, stream>>>(
      cgain, cthr, (int)TM, nc, L1, gain, thr);
  return (int)cudaGetLastError();
}
