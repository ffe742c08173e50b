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
// Before the phases, ss_pack writes one 16-byte state word per (tree, row)
// — leaf id (0 = closed, out of the frontier or not in bag), bag weight,
// label — so each gathered row costs one sector instead of three.
// One warp per block stages TILE rows at a time: the 32 lanes load the
// rows and gather the packed state in parallel (many gathers in flight
// hide their latency) and keep the active rows (open leaf, in bag,
// candidate feature) in order via a warp ballot.  The recurrence then runs
// warp-parallel over the staged rows, 32 consecutive rows per step:
// __match_any_sync groups the lanes that share a leaf; each lane's left
// stats are the carried per-leaf sums plus the rows of the lower lanes of
// its group, added in lane (= row) order; its previous in-bag value is the
// nearest lower lane's in its group, else the carried one; all lanes score
// at once; the group's best merges into the carried best in lane order by
// strict >; the group's highest lane writes the sums and last value back.
// Only lanes whose leaf recurs within the step are ever shuffled, so at a
// wide frontier a step is nearly free of cross-lane work.  Every sum takes
// its terms in row order, as a serial scan would: the result is the same
// bits as Alg. 1's serial recurrence for every task.  Classification
// counts (prefixes, carries, the level's totals) are int32, exact to 2^31,
// and each is converted to float32 once where a gain is computed, as the
// plain version does: binary classification is bit-equal to it at any
// row count.  Regression sums are float32.  Compiled with -fmad=false: the
// impurity expressions keep the reference's operation order and no
// multiply-add is fused.
//
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

template <int SM>
__device__ __forceinline__ float impurity(const float* h, int S, int kind) {
  if (kind == VARIANCE) {
    const float w = h[0], wy = h[1], wy2 = h[2];
    return fmaxf(wy2 - (w > 0.0f ? wy * wy / fmaxf(w, 1e-12f) : 0.0f), 0.0f);
  }
  float n = 0.0f;
#pragma unroll
  for (int s = 0; s < SM; ++s)
    if (s < S) n += h[s];
  if (kind == GINI) {
    float sq = 0.0f;
#pragma unroll
    for (int s = 0; s < SM; ++s)
      if (s < S) sq += h[s] * h[s];
    return n - (n > 0.0f ? sq / fmaxf(n, 1e-12f) : 0.0f);
  }
  const float d = fmaxf(n, 1e-12f);
  float acc = 0.0f;
#pragma unroll
  for (int s = 0; s < SM; ++s) {
    if (s < S) {
      const float p = h[s] / d;
      acc += h[s] > 0.0f ? p * logf(fmaxf(p, 1e-12f)) : 0.0f;
    }
  }
  return -(n * acc);
}

// A: the stat type, int (classification counts) or float (regression).
template <int SM, class A>
__device__ __forceinline__ A count(const A* h, int S, int task) {
  if (task != CLASSIFICATION) return h[0];
  A n = 0;
#pragma unroll
  for (int s = 0; s < SM; ++s)
    if (s < S) n += h[s];
  return n;
}

// Add one row's stats to a per-leaf stat vector held in registers (the
// class index is compared, never used as an index, so `acc` stays in
// registers).  A classification row adds its integer bag weight.
template <int SM, class A>
__device__ __forceinline__ void add_row(A* acc, int S, int task, float w,
                                        float y) {
  if (task == CLASSIFICATION) {
    const int cls = (int)y;            // one_hot(y) * w: one nonzero entry
#pragma unroll
    for (int s = 0; s < SM; ++s)
      if (s < S && s == cls) acc[s] += (A)w;
  } else {
    const float wy = w * y;
    acc[0] += w;
    acc[1] += wy;
    acc[2] += wy * y;
  }
}

// One packed state word per (tree, row): {leaf id or 0, w bits, y bits, 0}.
// The leaf id is 0 unless the row is in bag and in an open leaf < L1.
__global__ void ss_pack(const int* __restrict__ leaf,
                        const float* __restrict__ w,
                        const float* __restrict__ y, int T, int n, int L1,
                        int4* __restrict__ state) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)T * n) return;
  const int r = (int)(i % n);
  const int lf = leaf[i];
  const float wt = w[i];
  const bool act = wt > 0.0f && lf > 0 && lf < L1;
  state[i] = make_int4(act ? lf : 0, __float_as_int(wt), __float_as_int(y[r]),
                       0);
}

// Stage the active rows of [base, min(base + TILE, r1)) into the tile, in
// row order.  Returns how many were staged (the same in every lane).
__device__ __forceinline__ int stage_tile(
    long long base, long long r1, const float* __restrict__ vcol,
    const int* __restrict__ icol, const int4* __restrict__ st,
    const unsigned char* __restrict__ ct, int lane, Tile& tile) {
  int idx[PER_LANE];
  float a[PER_LANE];
#pragma unroll
  for (int g = 0; g < PER_LANE; ++g) {
    const long long r = base + g * WARP + lane;
    const bool in = r < r1;
    idx[g] = in ? icol[r] : -1;
    a[g] = in ? vcol[r] : 0.0f;
  }
  int4 s[PER_LANE];
#pragma unroll
  for (int g = 0; g < PER_LANE; ++g)
    s[g] = idx[g] >= 0 ? __ldg(st + idx[g]) : make_int4(0, 0, 0, 0);
  int n_act = 0;
#pragma unroll
  for (int g = 0; g < PER_LANE; ++g) {
    const bool act = s[g].x > 0 && ct[s[g].x];
    const unsigned bal = __ballot_sync(0xffffffffu, act);
    if (act) {
      const int p = n_act + __popc(bal & ((1u << lane) - 1u));
      tile.a[p] = a[g];
      tile.h[p] = s[g].x;
      tile.w[p] = __int_as_float(s[g].y);
      tile.y[p] = __int_as_float(s[g].z);
    }
    n_act += __popc(bal);
  }
  __syncwarp();
  return n_act;
}

// One step of the warp-parallel recurrence: lane k of the step holds staged
// row k0 + k.  `grp` is the mask of lanes sharing this lane's leaf, `lower`
// its lanes below this one, `multi` the lanes whose leaf recurs in the step
// (the only lanes any other lane reads).
struct Step {
  bool valid;
  int h;
  float a, w, y;
  unsigned grp, lower, multi;
  bool last;                            // highest lane of its group
};

__device__ __forceinline__ Step load_step(const Tile& tile, int k0, int n_act,
                                          int lane) {
  Step p;
  const int k = k0 + lane;
  p.valid = k < n_act;
  p.h = p.valid ? tile.h[k] : -1;
  p.a = p.valid ? tile.a[k] : 0.0f;
  p.w = p.valid ? tile.w[k] : 0.0f;
  p.y = p.valid ? tile.y[k] : 0.0f;
  p.grp = __match_any_sync(0xffffffffu, p.h);
  p.lower = p.grp & ((1u << lane) - 1u);
  p.multi = __ballot_sync(0xffffffffu, p.valid && __popc(p.grp) > 1);
  p.last = p.valid && (p.grp >> lane) == 1u;
  return p;
}

// Phase 1: per (tree, column, chunk) per-leaf stat sums and last value.
// SM: the stat width the registers hold (>= S); A: the stat type.
template <bool SMEM, int SM, class A>
__global__ void ss_chunk_sums(
    const float* __restrict__ vals, const int* __restrict__ sidx,
    const int4* __restrict__ state, const unsigned char* __restrict__ cand,
    int m, int n, int L1, int S, int task, long long chunk,
    A* __restrict__ csum, float* __restrict__ clast) {
  extern __shared__ float smem[];
  __shared__ Tile tile;
  const int c = blockIdx.x, j = blockIdx.y, t = blockIdx.z;
  const int nc = gridDim.x, lane = threadIdx.x;
  const size_t blk = ((size_t)t * m + j) * nc + c;
  A* H = SMEM ? reinterpret_cast<A*>(smem) : csum + blk * L1 * S;  // L1 * S
  float* V = SMEM ? smem + (size_t)L1 * S : clast + blk * L1;      // L1
  for (int i = lane; i < L1 * S; i += WARP) H[i] = 0;
  for (int i = lane; i < L1; i += WARP) V[i] = -CUDART_INF_F;
  __syncwarp();

  const long long r0 = c * chunk;
  const long long r1 = min((long long)n, r0 + chunk);
  const float* vcol = vals + (size_t)j * n;
  const int* icol = sidx + (size_t)j * n;
  const int4* st = state + (size_t)t * n;
  const unsigned char* ct = cand + ((size_t)t * m + j) * L1;
  for (long long base = r0; base < r1; base += TILE) {
    const int n_act = stage_tile(base, r1, vcol, icol, st, ct, lane, tile);
    for (int k0 = 0; k0 < n_act; k0 += WARP) {
      const Step p = load_step(tile, k0, n_act, lane);
      A acc[SM];                      // only the group's last lane sums
#pragma unroll
      for (int s = 0; s < SM; ++s)
        acc[s] = p.last && s < S ? H[(size_t)p.h * S + s] : (A)0;
      for (unsigned mm = p.multi; mm; mm &= mm - 1) {
        const int i = __ffs(mm) - 1;
        const float wi = __shfl_sync(0xffffffffu, p.w, i);
        const float yi = __shfl_sync(0xffffffffu, p.y, i);
        if (p.last && ((p.lower >> i) & 1u))
          add_row<SM>(acc, S, task, wi, yi);
      }
      if (p.last) {
        add_row<SM>(acc, S, task, p.w, p.y);
#pragma unroll
        for (int s = 0; s < SM; ++s)
          if (s < S) H[(size_t)p.h * S + s] = acc[s];
        V[p.h] = p.a;
      }
      __syncwarp();
    }
  }
  if (SMEM) {
    for (int i = lane; i < L1 * S; i += WARP) csum[blk * L1 * S + i] = H[i];
    for (int i = lane; i < L1; i += WARP) clast[blk * L1 + i] = V[i];
  }
}

// Phase 2: exclusive scan over chunks, in place.  One thread per
// (tree, column, leaf*S + s); the s == 0 threads also carry the last value.
// The chunks are read CARRY_UNROLL at a time before any is written, so the
// loads overlap; the sums are still taken in chunk order.
constexpr int CARRY_UNROLL = 8;

template <class A>
__global__ void ss_carry(A* __restrict__ csum, float* __restrict__ clast,
                         int TM, int nc, int L1, int S) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per = (long long)L1 * S;
  if (i >= TM * per) return;
  const long long tm = i / per, q = i % per;
  A* base = csum + (size_t)tm * nc * per + q;
  A acc = 0;
  for (int c0 = 0; c0 < nc; c0 += CARRY_UNROLL) {
    A v[CARRY_UNROLL];
#pragma unroll
    for (int u = 0; u < CARRY_UNROLL; ++u)
      v[u] = c0 + u < nc ? base[(size_t)(c0 + u) * per] : (A)0;
#pragma unroll
    for (int u = 0; u < CARRY_UNROLL; ++u) {
      if (c0 + u < nc) {
        base[(size_t)(c0 + u) * per] = acc;
        acc += v[u];
      }
    }
  }
  if (q % S == 0) {
    float* lb = clast + (size_t)tm * nc * L1 + q / S;
    float last = -CUDART_INF_F;
    for (int c0 = 0; c0 < nc; c0 += CARRY_UNROLL) {
      float v[CARRY_UNROLL];
#pragma unroll
      for (int u = 0; u < CARRY_UNROLL; ++u)
        v[u] = c0 + u < nc ? lb[(size_t)(c0 + u) * L1] : 0.0f;
#pragma unroll
      for (int u = 0; u < CARRY_UNROLL; ++u) {
        if (c0 + u < nc) {
          lb[(size_t)(c0 + u) * L1] = last;
          last = fmaxf(last, v[u]);     // values ascend: max == last seen
        }
      }
    }
  }
}

// Phase 3: rescan each chunk from its carried prefix; per-leaf best.
template <bool SMEM, int SM, class A>
__global__ void ss_chunk_best(
    const float* __restrict__ vals, const int* __restrict__ sidx,
    const int4* __restrict__ state, const unsigned char* __restrict__ cand,
    const A* __restrict__ totals, int m, int n, int L1, int S, int kind,
    int task, float min_records, long long chunk, A* __restrict__ csum,
    float* __restrict__ clast, float* __restrict__ cgain,
    float* __restrict__ cthr) {
  extern __shared__ float smem[];
  __shared__ Tile tile;
  const int c = blockIdx.x, j = blockIdx.y, t = blockIdx.z;
  const int nc = gridDim.x, lane = threadIdx.x;
  const size_t blk = ((size_t)t * m + j) * nc + c;
  const size_t LS = (size_t)L1 * S;
  // carried prefix, level totals, last in-bag value, best gain, threshold
  A* H = SMEM ? reinterpret_cast<A*>(smem) : csum + blk * LS;
  const A* TOT = SMEM ? reinterpret_cast<const A*>(smem + LS)
                      : totals + (size_t)t * LS;
  float* V = SMEM ? smem + 2 * LS : clast + blk * L1;
  float* BG = SMEM ? V + L1 : cgain + blk * L1;
  float* BT = SMEM ? BG + L1 : cthr + blk * L1;
  if (SMEM) {
    A* tot = reinterpret_cast<A*>(smem + LS);
    for (int i = lane; i < L1 * S; i += WARP) {
      H[i] = csum[blk * LS + i];
      tot[i] = totals[(size_t)t * LS + i];
    }
    for (int i = lane; i < L1; i += WARP) V[i] = clast[blk * L1 + i];
  }
  for (int i = lane; i < L1; i += WARP) {
    BG[i] = -CUDART_INF_F;
    BT[i] = 0.0f;
  }
  __syncwarp();

  const long long r0 = c * chunk;
  const long long r1 = min((long long)n, r0 + chunk);
  const float* vcol = vals + (size_t)j * n;
  const int* icol = sidx + (size_t)j * n;
  const int4* st = state + (size_t)t * n;
  const unsigned char* ct = cand + ((size_t)t * m + j) * L1;
  for (long long base = r0; base < r1; base += TILE) {
    const int n_act = stage_tile(base, r1, vcol, icol, st, ct, lane, tile);
    for (int k0 = 0; k0 < n_act; k0 += WARP) {
      const Step p = load_step(tile, k0, n_act, lane);
      // left = carried prefix + the lower lanes of the group, in row order;
      // prev = the nearest lower lane's value, else the carried last value
      A left[SM];
#pragma unroll
      for (int s = 0; s < SM; ++s)
        left[s] = p.valid && s < S ? H[(size_t)p.h * S + s] : (A)0;
      float prev = p.valid ? V[p.h] : 0.0f;
      for (unsigned mm = p.multi; mm; mm &= mm - 1) {
        const int i = __ffs(mm) - 1;
        const float wi = __shfl_sync(0xffffffffu, p.w, i);
        const float yi = __shfl_sync(0xffffffffu, p.y, i);
        const float ai = __shfl_sync(0xffffffffu, p.a, i);
        if ((p.lower >> i) & 1u) {
          add_row<SM>(left, S, task, wi, yi);
          prev = ai;
        }
      }
      float g = -CUDART_INF_F, thr = 0.0f;
      bool scored = false;
      if (p.valid && p.a > prev && isfinite(prev)) {
        A right[SM];
        float lf[SM], rf[SM], parent[SM];   // each count rounded once
#pragma unroll
        for (int s = 0; s < SM; ++s) {
          if (s < S) {
            right[s] = TOT[(size_t)p.h * S + s] - left[s];
            lf[s] = (float)left[s];
            rf[s] = (float)right[s];
            parent[s] = lf[s] + rf[s];
          }
        }
        if ((float)count<SM>(left, S, task) >= min_records &&
            (float)count<SM>(right, S, task) >= min_records) {
          g = impurity<SM>(parent, S, kind) - impurity<SM>(lf, S, kind)
              - impurity<SM>(rf, S, kind);
          thr = (p.a + prev) * 0.5f;
          scored = true;
        }
      }
      // the group's best, merged into the carried best in row order by
      // strict > (the first row wins equal gains, as in Alg. 1)
      float bg = p.valid ? BG[p.h] : 0.0f, bt = p.valid ? BT[p.h] : 0.0f;
      const unsigned scored_lanes = __ballot_sync(0xffffffffu, scored);
      for (unsigned mm = p.multi & scored_lanes; mm; mm &= mm - 1) {
        const int i = __ffs(mm) - 1;
        const float gi = __shfl_sync(0xffffffffu, g, i);
        const float ti = __shfl_sync(0xffffffffu, thr, i);
        if (((p.grp >> i) & 1u) && gi > bg) {
          bg = gi;
          bt = ti;
        }
      }
      if (!(p.multi >> lane & 1u) && scored && g > bg) {   // a lone row
        bg = g;
        bt = thr;
      }
      if (p.last) {
        add_row<SM>(left, S, task, p.w, p.y);
#pragma unroll
        for (int s = 0; s < SM; ++s)
          if (s < S) H[(size_t)p.h * S + s] = left[s];
        V[p.h] = p.a;
        BG[p.h] = bg;
        BT[p.h] = bt;
      }
      __syncwarp();
    }
  }
  if (SMEM) {
    for (int i = lane; i < L1; i += WARP) {
      cgain[blk * L1 + i] = BG[i];
      cthr[blk * L1 + i] = BT[i];
    }
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
#pragma unroll 8
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

// Dynamic shared memory a block of these kernels may take: the device's
// opt-in limit less the static staging tile.
cudaError_t smem_limit(size_t* bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *bytes = (size_t)optin - sizeof(Tile);
  return cudaSuccess;
}

// Phases 1-3 with SM stat registers of type A (int: classification
// counts, float: regression), each phase's state where `layout` puts it;
// the first CUDA error.  A has float's width, so the layouts are the same.
template <int SM, class A>
cudaError_t launch_phases(dim3 grid, int layout, cudaStream_t stream,
                          const float* vals, const int* sidx,
                          const int4* state, const unsigned char* cand,
                          const void* totals_v, int m, int n, int L1, int S,
                          int kind, int task, float min_records, int nc,
                          long long chunk, void* csum_v, float* clast,
                          float* cgain, float* cthr) {
  static_assert(sizeof(A) == sizeof(float), "stat cells are 4 bytes");
  const A* totals = static_cast<const A*>(totals_v);
  A* csum = static_cast<A*>(csum_v);
  const size_t smem1 = (size_t)L1 * (S + 1) * sizeof(float);
  const size_t smem3 = (size_t)L1 * (2 * S + 3) * sizeof(float);
  cudaError_t err;
  if (layout & 1) {
    err = set_smem((const void*)ss_chunk_sums<true, SM, A>, smem1);
    if (err != cudaSuccess) return err;
    ss_chunk_sums<true, SM, A><<<grid, WARP, smem1, stream>>>(
        vals, sidx, state, cand, m, n, L1, S, task, chunk, csum, clast);
  } else {
    ss_chunk_sums<false, SM, A><<<grid, WARP, 0, stream>>>(
        vals, sidx, state, cand, m, n, L1, S, task, chunk, csum, clast);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long TM = (long long)grid.z * m;
  const long long carry_threads = TM * L1 * S;
  ss_carry<A><<<(unsigned)((carry_threads + 255) / 256), 256, 0, stream>>>(
      csum, clast, (int)TM, nc, L1, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (layout & 2) {
    err = set_smem((const void*)ss_chunk_best<true, SM, A>, smem3);
    if (err != cudaSuccess) return err;
    ss_chunk_best<true, SM, A><<<grid, WARP, smem3, stream>>>(
        vals, sidx, state, cand, totals, m, n, L1, S, kind, task,
        min_records, chunk, csum, clast, cgain, cthr);
  } else {
    ss_chunk_best<false, SM, A><<<grid, WARP, 0, stream>>>(
        vals, sidx, state, cand, totals, m, n, L1, S, kind, task,
        min_records, chunk, csum, clast, cgain, cthr);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int split_scan_max_stats() { return MAXS; }

// Where each phase keeps its per-leaf state for (L1, S): bit 0 set when
// ss_chunk_sums uses shared memory, bit 1 when ss_chunk_best does (clear
// bits: the block's slice of the scratch tensors).  Negative on error.
extern "C" int split_scan_layout(int L1, int S) {
  size_t limit = 0;
  if (smem_limit(&limit) != cudaSuccess) return -1;
  return ((size_t)L1 * (S + 1) * sizeof(float) <= limit ? 1 : 0)
      | ((size_t)L1 * (2 * S + 3) * sizeof(float) <= limit ? 2 : 0);
}

// Launches the five kernels on `stream`; returns the first CUDA error.
// Shapes: vals/sidx (m, n); leaf/w (T, n); y (n,); cand (T, m, L1) bytes;
// totals (T, L1, S) int32 class counts (classification) or float32 sums
// (regression); state (T, n) int4, csum (T, m, nc, L1, S) 4-byte cells of
// the totals' type and clast/cgain/cthr (T, m, nc, L1) float32 scratch;
// gain/thr (T, m, L1) outputs.
extern "C" int split_scan_launch(
    const float* vals, const int* sidx, const int* leaf, const float* w,
    const float* y, const unsigned char* cand, const void* totals, int T,
    int m, int n, int L1, int S, int kind, int task, float min_records,
    int nc, long long chunk, int4* state, void* csum, float* clast,
    float* cgain, float* cthr, float* gain, float* thr, void* stream_ptr) {
  if (S < 1 || S > MAXS || (task == REGRESSION && S != 3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid(nc, m, T);
  const int layout = split_scan_layout(L1, S);
  if (layout < 0) return (int)cudaErrorInvalidDevice;
  const long long tn = (long long)T * n;
  ss_pack<<<(unsigned)((tn + 255) / 256), 256, 0, stream>>>(leaf, w, y, T, n,
                                                           L1, state);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define SS_PHASES(SM, A)                                                    \
  launch_phases<SM, A>(grid, layout, stream, vals, sidx, state, cand,       \
                       totals, m, n, L1, S, kind, task, min_records, nc,    \
                       chunk, csum, clast, cgain, cthr)
  if (task == REGRESSION)
    err = SS_PHASES(3, float);
  else
    err = S <= 2 ? SS_PHASES(2, int) : S == 3 ? SS_PHASES(3, int)
                                              : SS_PHASES(MAXS, int);
#undef SS_PHASES
  if (err != cudaSuccess) return (int)err;
  const long long red_threads = (long long)T * m * L1;
  ss_reduce<<<(unsigned)((red_threads + 255) / 256), 256, 0, stream>>>(
      cgain, cthr, T * m, nc, L1, gain, thr);
  return (int)cudaGetLastError();
}
