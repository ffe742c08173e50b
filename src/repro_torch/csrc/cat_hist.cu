// Categorical count tables (paper §2.4) for Hopper (sm_90a).
//
// Replaces the TPU kernel `cat_hist_pallas` (body `_cat_hist_kernel`) of
// src/repro/kernels/cat_hist.py: for every (tree t, column j, open leaf h,
// category v) the sum of the row stats of the in-bag rows of leaf h whose
// value in column j is v — w * one_hot(y) for classification, [w, w*y,
// w*y*y] for regression.  Row order does not matter.
//
// Only the tables that will be read are built.  A leaf draws m' candidate
// columns (at the paper's Leo shape 10 of 82, about 9.6 of the 79
// categorical ones) and the Breiman scorer reads only their tables, so the
// caller passes a slot map (T, m, L1) int32: each candidate (tree, column,
// leaf)'s table in a compact (nslot, V, S) output, -1 for none (the map is
// an exclusive prefix over the candidate mask, made on the card;
// kernels/cat_hist.py `candidate_slots`).  The map of a mask that is all
// true, slot (t * m + j) * L1 + h, gives the full (T, m, L1, V, S) layout.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  The rows are read once — each
// column's int32 values and, once per row for all columns, the per-tree
// leaf id and bag weight and the label — and each table is written once.
// At a deep level the tables are gigabytes (V = 10,000 per column), far
// past the 50 MB L2, so a scatter with one device-memory atomic per (row,
// column, tree) pays a DRAM read-modify-write for nearly every add; and a
// table zeroed first is written twice.
//
// The design builds each table tile in shared memory and writes it once:
//   1. bucketing (cat_bucket_count, then cat_bucket_scatter): a stable
//      counting sort of each tree's in-bag, open-leaf rows by leaf id, into
//      per-tree lists of (row, w, y).  One warp owns a chunk of rows and
//      walks it in order; __match_any_sync groups the lanes of one leaf and
//      the chunk's running per-leaf offsets live in shared memory (in the
//      chunk's slice of the count table when the frontier is too wide), so
//      the order within a leaf is the row order and the lists are the same
//      on every run.
//   2. tiles (cat_tile): a block owns one work item (tree, leaf tile, row
//      range of the tile's rows), one category tile and one column.  It
//      reads its leaves' table slots into shared memory and returns at
//      once if none has a table (at Leo's shape a tile is one leaf, so
//      some 88% of the blocks return there); the rows of a leaf without
//      one are not gathered.  Its table — the leaf tile's leaves x the
//      category tile x S — lives in shared memory; the block streams its
//      rows from the lists (coalesced) and gathers each row's category
//      from the column, adding with shared-memory atomics.  A tile whose
//      rows one block takes whole is then stored once, each leaf's cells
//      at its slot, padding zeros included, with coalesced stores; a tile
//      whose rows are split over several blocks (a leaf holding many rows,
//      at the shallow levels) has its leaves' tables zeroed first
//      (cat_zero_split) and each block adds its nonzero cells with one
//      device atomic each.  Blocks of one column run together (the column
//      is the grid's slowest axis), so the gathered column stays in L2.
//      (A grid of only each item's candidate columns launches no block
//      that returns, but its rows of blocks mix columns: at Leo's shape it
//      lost more to the L2 than the returning blocks cost.)
//   When the whole table of a (tree, column) fits in one block (a small
//   frontier times a small arity), no bucketing is needed: the work items
//   are row ranges of the natural order, each block privatises the whole
//   table and flushes it with device atomics.
// The host (kernels/cat_hist.py) sizes the tiles from (L1, V, S) and the
// compact output from m'; the work items are planned on the device from
// the per-leaf row counts (cat_plan), so the host never waits for the
// card.  Classification adds only the one nonzero entry w, a bag count (an
// integer: a fraction is dropped), with integer atomics: the table is int32
// class counts, exact to 2^31 in any order.
// Regression adds 64-bit fixed-point integers (one power-of-two scale per
// stat channel, picked by the caller from the data's magnitude), which is
// associative, so repeated runs give the same bits; a last pass converts
// the integers to float32 (cat_fixed_launch).
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;       // threads of the elementwise kernels
constexpr int TILE_THREADS = 512;
constexpr int UNROLL = 4;        // rows in flight per thread
constexpr int MAXT = 8;          // trees per launch (the wrapper groups them)
constexpr int WORK = 5;          // ints per work item: t, lt, k0, k1, atomic
constexpr unsigned FULL = 0xffffffffu;
constexpr int BUCKET_STEPS = 8;  // warp steps of 32 rows loaded at once

enum { CLASSIFICATION = 0, REGRESSION = 1 };

__device__ __forceinline__ bool active(float w, int lf, int L1) {
  return w > 0.0f && lf > 0 && lf < L1;
}

// Pass 1 of the bucketing: per (tree t, chunk b) the number of active rows
// of each leaf, into cnt[(t * L1 + h) * NB + b].  One warp per chunk; the
// counts accumulate in shared memory when `smem` is set, else in the
// chunk's own slice of cnt (zeroed by the caller).
__global__ void cat_bucket_count(const int* __restrict__ leaf,
                                 const float* __restrict__ w, int n, int L1,
                                 int R, int NB, int smem,
                                 int* __restrict__ cnt) {
  extern __shared__ int sc[];
  const int b = blockIdx.x, t = blockIdx.y, lane = threadIdx.x;
  int* C = smem ? sc : cnt + (size_t)t * L1 * NB + b;
  const size_t cs = smem ? 1 : (size_t)NB;
  if (smem)
    for (int h = lane; h < L1; h += 32) sc[h] = 0;
  __syncwarp();
  const long long r0 = (long long)b * R;
  const long long r1 = min((long long)n, r0 + R);
  const int* lt = leaf + (size_t)t * n;
  const float* wt = w + (size_t)t * n;
  for (long long k0 = r0; k0 < r1; k0 += 32 * BUCKET_STEPS) {
    int hs[BUCKET_STEPS];               // the steps' loads all in flight
#pragma unroll
    for (int u = 0; u < BUCKET_STEPS; ++u) {
      const long long r = k0 + u * 32 + lane;
      hs[u] = -1;
      if (r < r1) {
        const int lf = lt[r];
        if (active(wt[r], lf, L1)) hs[u] = lf;
      }
    }
#pragma unroll
    for (int u = 0; u < BUCKET_STEPS; ++u) {
      const int h = hs[u];
      const unsigned g = __match_any_sync(FULL, h);
      if (h >= 0 && lane == __ffs(g) - 1) C[h * cs] += __popc(g);
      __syncwarp();
    }
  }
  if (smem)
    for (int h = lane; h < L1; h += 32)
      cnt[((size_t)t * L1 + h) * NB + b] = sc[h];
}

// Pass 2: each chunk writes its active rows at lstart[t][h] +
// pos[(t * L1 + h) * NB + b] (the leaf's start plus the counts of the
// leaf's earlier chunks) onward, in row order.  The running offsets live
// in shared memory, else in the chunk's slice of pos, which is then
// consumed.  With `pack` (classification, pack = S + 1) the row word
// is row * pack + class, pack - 1 for a label outside [0, S), and yl is
// not written.
__global__ void cat_bucket_scatter(const int* __restrict__ leaf,
                                   const float* __restrict__ w,
                                   const float* __restrict__ y, int n,
                                   int L1, int R, int NB, int smem, int pack,
                                   const int* __restrict__ lstart,
                                   int* __restrict__ pos,
                                   int* __restrict__ rows,
                                   float* __restrict__ wl,
                                   float* __restrict__ yl) {
  extern __shared__ int sc[];
  const int b = blockIdx.x, t = blockIdx.y, lane = threadIdx.x;
  int* C = smem ? sc : pos + (size_t)t * L1 * NB + b;
  const size_t cs = smem ? 1 : (size_t)NB;
  const int* ls = lstart + (size_t)t * (L1 + 1);
  if (smem)
    for (int h = lane; h < L1; h += 32)
      sc[h] = ls[h] + pos[((size_t)t * L1 + h) * NB + b];
  __syncwarp();
  const long long r0 = (long long)b * R;
  const long long r1 = min((long long)n, r0 + R);
  const int* lt = leaf + (size_t)t * n;
  const float* wt = w + (size_t)t * n;
  const size_t out = (size_t)t * n;
  for (long long k0 = r0; k0 < r1; k0 += 32 * BUCKET_STEPS) {
    int hs[BUCKET_STEPS];               // the steps' loads all in flight
    float ws[BUCKET_STEPS], ys[BUCKET_STEPS];
#pragma unroll
    for (int u = 0; u < BUCKET_STEPS; ++u) {
      const long long r = k0 + u * 32 + lane;
      hs[u] = -1;
      ws[u] = ys[u] = 0.0f;
      if (r < r1) {
        const int lf = lt[r];
        ws[u] = wt[r];
        if (active(ws[u], lf, L1)) {
          hs[u] = lf;
          ys[u] = y[r];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < BUCKET_STEPS; ++u) {
      const int h = hs[u];
      const unsigned g = __match_any_sync(FULL, h);
      if (h >= 0) {
        const int p = (smem ? 0 : ls[h]) + C[h * cs]
            + __popc(g & ((1u << lane) - 1u));
        const int r = (int)(k0 + u * 32 + lane);
        wl[out + p] = ws[u];
        if (pack) {                     // row and class in one word
          const int cls = (int)ys[u];
          rows[out + p] = r * pack + (cls >= 0 && cls < pack - 1 ? cls
                                                                  : pack - 1);
        } else {
          rows[out + p] = r;
          yl[out + p] = ys[u];
        }
      }
      __syncwarp();
      if (h >= 0 && lane == __ffs(g) - 1) C[h * cs] += __popc(g);
      __syncwarp();
    }
  }
}

// Between the passes: each (tree, leaf) row of the count table becomes the
// exclusive prefix of its chunks' counts, in place (cat_bucket_rows, one
// block per row), and each tree's leaf starts lstart (T, L1+1) the
// exclusive prefix of the row totals (cat_bucket_starts, one block per
// tree).  Each thread scans a run of consecutive entries; the runs' sums
// are scanned across the block.
constexpr int SCAN_THREADS = 1024;

__device__ __forceinline__ int block_exclusive_scan(int v, int* part) {
  const int tid = threadIdx.x;
  part[tid] = v;
  __syncthreads();
  for (int d = 1; d < blockDim.x; d <<= 1) {
    const int u = tid >= d ? part[tid - d] : 0;
    __syncthreads();
    part[tid] += u;
    __syncthreads();
  }
  return part[tid] - v;
}

__global__ void cat_bucket_rows(int* __restrict__ cnt, int NB,
                                int* __restrict__ total) {
  __shared__ int part[SCAN_THREADS];
  int* row = cnt + (size_t)blockIdx.x * NB;
  const int per = (NB + blockDim.x - 1) / blockDim.x;
  const int i0 = min(NB, (int)threadIdx.x * per), i1 = min(NB, i0 + per);
  int sum = 0;
  for (int i = i0; i < i1; ++i) sum += row[i];
  int off = block_exclusive_scan(sum, part);
  for (int i = i0; i < i1; ++i) {
    const int v = row[i];
    row[i] = off;
    off += v;
  }
  if (threadIdx.x == blockDim.x - 1) total[blockIdx.x] = off;
}

__global__ void cat_bucket_starts(const int* __restrict__ total, int L1,
                                  int* __restrict__ lstart) {
  __shared__ int part[SCAN_THREADS];
  const int* tot = total + (size_t)blockIdx.x * L1;
  int* ls = lstart + (size_t)blockIdx.x * (L1 + 1);
  const int per = (L1 + blockDim.x - 1) / blockDim.x;
  const int i0 = min(L1, (int)threadIdx.x * per), i1 = min(L1, i0 + per);
  int sum = 0;
  for (int i = i0; i < i1; ++i) sum += tot[i];
  int off = block_exclusive_scan(sum, part);
  for (int i = i0; i < i1; ++i) {
    ls[i] = off;
    off += tot[i];
  }
  if (threadIdx.x == blockDim.x - 1) ls[L1] = off;
}

// The work items, planned on the device from the per-leaf list offsets so
// that the host never waits for the bucketing: per (tree t, leaf tile lt)
// its rows [lo, hi) of the tree's list (natural: [0, n)), cut in
// k = max(1, ceil(rows / piece)) even pieces; item {t, lt, lo + rows*p/k,
// lo + rows*(p+1)/k, flag}, flag 0 for a tile stored whole, 1 for the first
// piece of a split tile (it zeroes the tile's region first), 2 for its
// other pieces.  Items past the last are {-1, 0, 0, 0, 0}.  One block of
// PLAN_THREADS; each thread owns consecutive tiles and an exclusive scan of
// the per-thread piece counts places them.  kernels/cat_hist.py
// `tile_work` is the plain version.
constexpr int PLAN_THREADS = 1024;

__global__ void __launch_bounds__(PLAN_THREADS)
cat_plan(const int* __restrict__ lstart, int natural, int T, int n, int L1,
         int LT, int nLT, int piece, int Wmax, int* __restrict__ work) {
  __shared__ int scan[PLAN_THREADS];
  const int tid = threadIdx.x, tiles = T * nLT;
  const int per = (tiles + PLAN_THREADS - 1) / PLAN_THREADS;
  const int i0 = min(tiles, tid * per), i1 = min(tiles, i0 + per);
  auto range = [&](int i, long long* lo, long long* rows) {
    const int t = i / nLT, lt = i % nLT;
    if (natural) {
      *lo = 0;
      *rows = n;
    } else {
      const int* ls = lstart + (size_t)t * (L1 + 1);
      *lo = ls[lt * LT];
      *rows = ls[min(L1, (lt + 1) * LT)] - *lo;
    }
  };
  int mine = 0;
  for (int i = i0; i < i1; ++i) {
    long long lo, rows;
    range(i, &lo, &rows);
    mine += (int)max(1LL, (rows + piece - 1) / piece);
  }
  scan[tid] = mine;
  __syncthreads();
  for (int d = 1; d < PLAN_THREADS; d <<= 1) {      // inclusive scan
    const int v = tid >= d ? scan[tid - d] : 0;
    __syncthreads();
    scan[tid] += v;
    __syncthreads();
  }
  int off = scan[tid] - mine;
  const int total = scan[PLAN_THREADS - 1];
  for (int i = i0; i < i1; ++i) {
    long long lo, rows;
    range(i, &lo, &rows);
    const long long k = max(1LL, (rows + piece - 1) / piece);
    for (long long p = 0; p < k && off < Wmax; ++p, ++off) {
      int* wk = work + (size_t)off * WORK;
      wk[0] = i / nLT;
      wk[1] = i % nLT;
      wk[2] = (int)(lo + rows * p / k);
      wk[3] = (int)(lo + rows * (p + 1) / k);
      wk[4] = k == 1 ? 0 : (p == 0 ? 1 : 2);
    }
  }
  for (int i = total + tid; i < Wmax; i += PLAN_THREADS) {
    int* wk = work + (size_t)i * WORK;
    wk[0] = -1;
    wk[1] = wk[2] = wk[3] = wk[4] = 0;
  }
}

// Slot of the table of (tree t, column j, leaf h) in the output, from the
// caller's slot map: -1 for none.  A slot past nslot, which the wrapper
// asserts never comes, is taken as -1 too, so no store lands outside.
__device__ __forceinline__ long long table_slot(const int* __restrict__ slot,
                                                long long nslot, int t, int m,
                                                int j, int L1, int h) {
  const int s = slot[((long long)t * m + j) * L1 + h];
  return s >= 0 && s < nslot ? s : -1;
}

// Zero the tables of the leaves h0..h0+LT-1 of column blockIdx.y of each
// split tile (flag 1), before the tile blocks add into them; a leaf with no
// table is skipped.  Grid (Wmax, m).
__global__ void cat_zero_split(const int* __restrict__ work,
                               const int* __restrict__ slot, long long nslot,
                               int m, int L1, int V, int SW, int LT,
                               unsigned* __restrict__ out) {
  const int* wk = work + (size_t)blockIdx.x * WORK;
  if (wk[0] < 0 || wk[4] != 1) return;
  const int j = blockIdx.y;
  const int h0 = wk[1] * LT, nh = min(L1, h0 + LT) - h0;
  const size_t len = (size_t)V * SW;
  for (int hh = 0; hh < nh; ++hh) {
    const long long s = table_slot(slot, nslot, wk[0], m, j, L1, h0 + hh);
    if (s < 0) continue;
    unsigned* dst = out + (size_t)s * len;
    for (size_t i = threadIdx.x; i < len; i += blockDim.x) dst[i] = 0u;
  }
}

__host__ __device__ __forceinline__ size_t pad16(size_t bytes) {
  return (bytes + 15) & ~(size_t)15;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((size_t)p & 15) == 0;
}

// Shared memory of a tile block: the leaves' table slots, the list bounds,
// then the table (16-byte padded each).
size_t tile_smem_bytes(int nh, int CT, int SW, int task) {
  return pad16((size_t)nh * 8) + pad16((size_t)(nh + 1) * 4)
      + pad16((size_t)nh * CT * SW * (task == CLASSIFICATION ? 4 : 8));
}

// Leaf of list position k in a leaf tile: the last i with bound[i] <= k.
__device__ __forceinline__ int leaf_of_pos(const int* bound, int nh, int k) {
  int lo = 0, hi = nh - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (bound[mid] <= k) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// One table tile per block: work item blockIdx.x / nCT, category tile
// blockIdx.x % nCT, column blockIdx.y.  NATURAL: the rows are a range of
// the natural row order (the tile is the whole table); else a range of the
// tree's bucketed list.  Classification: int32 count cells (S per
// category, into `out`); regression: uint64 fixed-point cells (3 per
// category, into `acc`).  Each leaf's cells go to its table slot
// (`table_slot`); a block none of whose leaves has a table returns at once,
// and rows of a leaf without one are not gathered.
template <int TASK, bool NATURAL>
__global__ void __launch_bounds__(TILE_THREADS)
cat_tile(const int* __restrict__ x, const int* __restrict__ leaf,
         const float* __restrict__ w, const float* __restrict__ y,
         const int* __restrict__ rows, const float* __restrict__ wl,
         const float* __restrict__ yl, const int* __restrict__ lstart,
         const int* __restrict__ work, const int* __restrict__ slot,
         long long nslot, int pack, int m, int n, int L1, int V, int S,
         int LT, int CT, int nCT, double s0, double s1, double s2,
         unsigned* __restrict__ out, unsigned long long* __restrict__ acc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int* wk = work + (size_t)(blockIdx.x / nCT) * WORK;
  const int ct = blockIdx.x % nCT, j = blockIdx.y;
  const int t = wk[0], lt = wk[1], k0 = wk[2], k1 = wk[3], atomic = wk[4];
  if (t < 0) return;                      // past the last work item
  const int h0 = lt * LT, nh = min(L1, h0 + LT) - h0;
  const int c0 = ct * CT, cw = min(V, c0 + CT) - c0;
  const int SW = TASK == CLASSIFICATION ? S : 3;     // cells per category
  const int cells = nh * cw * SW;
  // shared memory: the tile's table slots (nh), its list bounds (nh+1
  // ints), then the table, each padded to 16 bytes (tile_smem_bytes)
  long long* sl = reinterpret_cast<long long*>(smem);
  int* bound = reinterpret_cast<int*>(smem + pad16((size_t)nh * 8));
  unsigned char* table = smem + pad16((size_t)nh * 8)
      + pad16((size_t)(nh + 1) * 4);
  int any = 0;
  for (int i = threadIdx.x; i < nh; i += TILE_THREADS) {
    sl[i] = table_slot(slot, nslot, t, m, j, L1, h0 + i);
    any |= sl[i] >= 0;
  }
  if (!__syncthreads_or(any)) return;     // no leaf of the tile has a table
  // the leaves' tables one run of slots (every tile of an all-true map,
  // every one-leaf tile): every row's leaf has a table, so no row waits on
  // a slot read before its gather, and the tile is flushed as one span
  int run = 1;
  for (int i = threadIdx.x; i < nh; i += TILE_THREADS)
    run &= sl[i] == sl[0] + i;
  const bool whole = __syncthreads_and(run) && sl[0] >= 0;
  unsigned* tu = reinterpret_cast<unsigned*>(table);
  unsigned long long* tq = reinterpret_cast<unsigned long long*>(table);
  const size_t cell_bytes = TASK == CLASSIFICATION ? 4 : 8;
  uint4* t4 = reinterpret_cast<uint4*>(table);
  const int n4 = (int)(pad16((size_t)cells * cell_bytes) / 16);
  for (int i = threadIdx.x; i < n4; i += TILE_THREADS)
    t4[i] = make_uint4(0u, 0u, 0u, 0u);
  if (!NATURAL)
    for (int i = threadIdx.x; i <= nh; i += TILE_THREADS)
      bound[i] = lstart[(size_t)t * (L1 + 1) + h0 + i];
  __syncthreads();

  const int* xc = x + (size_t)j * n;
  const size_t tn = (size_t)t * n;
  for (int kb = k0 + threadIdx.x; kb < k1; kb += TILE_THREADS * UNROLL) {
    int r[UNROLL], hl[UNROLL], v[UNROLL];
    float ww[UNROLL], yy[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = kb + u * TILE_THREADS;
      hl[u] = -1;
      r[u] = 0;
      ww[u] = yy[u] = 0.0f;
      if (k < k1) {
        if (NATURAL) {
          const int lf = leaf[tn + k];
          ww[u] = w[tn + k];
          r[u] = k;
          if (active(ww[u], lf, L1) && (whole || sl[lf] >= 0)) {
            hl[u] = lf;                 // the tile is every leaf: h0 = 0
            yy[u] = y[k];
          }
        } else {
          r[u] = __ldcs(rows + tn + k);
          ww[u] = __ldcs(wl + tn + k);
          if (pack) {                   // class pack - 1: none (skipped)
            const int code = r[u];
            r[u] = code / pack;
            yy[u] = (float)(code - r[u] * pack);
          } else {
            yy[u] = __ldcs(yl + tn + k);
          }
          hl[u] = nh == 1 ? 0 : leaf_of_pos(bound, nh + 1, k);
          if (!whole && sl[hl[u]] < 0) hl[u] = -1;   // a leaf without one
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      v[u] = hl[u] >= 0 ? __ldg(xc + r[u]) : -1;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = v[u] - c0;
      if (hl[u] < 0 || c < 0 || c >= cw) continue;
      const int cell = (hl[u] * cw + c) * SW;
      if (TASK == CLASSIFICATION) {
        const int cls = (int)yy[u];
        if (cls < 0 || cls >= S) continue;
        atomicAdd(tu + cell + cls, (unsigned)ww[u]);
      } else {
        const float wy = ww[u] * yy[u];
        atomicAdd(tq + cell,
                  (unsigned long long)__double2ll_rn((double)ww[u] * s0));
        atomicAdd(tq + cell + 1,
                  (unsigned long long)__double2ll_rn((double)wy * s1));
        atomicAdd(tq + cell + 2,
                  (unsigned long long)__double2ll_rn((double)(wy * yy[u]) *
                                                     s2));
      }
    }
  }
  __syncthreads();

  // flush: cell i of the tile is (leaf h0 + i / span, category c0 +
  // (i % span) / SW, stat i % SW), a leaf's span = cw * SW cells
  // contiguous; they go to the leaf's table, slot sl[i / span], at
  // category c0.  Where the slots are one run the whole tile is one span
  // (a tile of several leaves has every category, c0 = 0, so its leaves'
  // tables follow each other).  A tile one block takes whole is stored (16
  // bytes a store where each span starts and ends on 16-byte words), a
  // split tile's nonzero cells are added.
  const int span = whole ? cells : cw * SW;
  const size_t tab = (size_t)V * SW;            // cells of one table
  constexpr int VW = TASK == CLASSIFICATION ? 4 : 2;   // cells a 16 bytes
  const void* dst0 = TASK == CLASSIFICATION ? (const void*)out
                                            : (const void*)acc;
  const size_t first = (size_t)sl[0] * tab + (size_t)c0 * SW;   // if whole
  if (!atomic && span % VW == 0 && aligned16(dst0) &&
      (whole ? first % VW == 0
             : tab % VW == 0 && ((size_t)c0 * SW) % VW == 0)) {
    for (int i = threadIdx.x; i < cells / VW; i += TILE_THREADS) {
      const int hh = i * VW / span;
      const long long s = sl[hh];
      if (s < 0) continue;
      const size_t dst = (size_t)s * tab + (size_t)c0 * SW
          + (size_t)(i * VW - hh * span);
      if (TASK == CLASSIFICATION)          // streaming stores keep x in L2
        __stcs(reinterpret_cast<uint4*>(out + dst), t4[i]);
      else
        __stcs(reinterpret_cast<ulonglong2*>(acc + dst),
               reinterpret_cast<const ulonglong2*>(tq)[i]);
    }
    return;
  }
  for (int i = threadIdx.x; i < cells; i += TILE_THREADS) {
    const int hh = i / span;
    const long long s = sl[hh];
    if (s < 0) continue;
    const size_t dst = (size_t)s * tab + (size_t)c0 * SW + (i - hh * span);
    if (TASK == CLASSIFICATION) {
      if (!atomic) __stcs(out + dst, tu[i]);
      else if (tu[i] != 0u) atomicAdd(out + dst, tu[i]);
    } else {
      const unsigned long long q = tq[i];
      if (!atomic) acc[dst] = q;
      else if (q != 0ull) atomicAdd(acc + dst, q);
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

cudaError_t optin_smem(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

template <int TASK, bool NATURAL>
cudaError_t launch_tile(dim3 grid, size_t smem, cudaStream_t stream,
                        const int* x, const int* leaf, const float* w,
                        const float* y, const int* rows, const float* wl,
                        const float* yl, const int* lstart, const int* work,
                        const int* slot, long long nslot, int pack, int m,
                        int n, int L1, int V, int S, int LT, int CT, int nCT,
                        double s0, double s1, double s2, unsigned* out,
                        unsigned long long* acc) {
  auto fn = cat_tile<TASK, NATURAL>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  fn<<<grid, TILE_THREADS, smem, stream>>>(x, leaf, w, y, rows, wl, yl,
                                           lstart, work, slot, nslot, pack,
                                           m, n, L1, V, S, LT, CT, nCT, s0,
                                           s1, s2, out, acc);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cat_hist_max_trees() { return MAXT; }

// Shared memory a tile block may take (bytes), or -1 without a device.
extern "C" int cat_hist_smem_optin() {
  int bytes = 0;
  return optin_smem(&bytes) == cudaSuccess ? bytes : -1;
}

// The bucketing: scratch cnt (T, L1, NB) and total (T, L1) int32; out:
// lstart (T, L1+1) and the lists rows/wl/yl (T, n) (each tree's first
// lstart[t][L1] entries).  Chunk b covers rows [b*R, (b+1)*R).
extern "C" int cat_bucket_launch(const int* leaf, const float* w,
                                 const float* y, int T, int n, int L1, int R,
                                 int NB, int pack, int* cnt, int* total,
                                 int* lstart, int* rows, float* wl, float* yl,
                                 void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int smem = (size_t)L1 * sizeof(int) <= 48 * 1024;
  cudaError_t err = cudaSuccess;
  if (!smem)
    err = cudaMemsetAsync(cnt, 0, (size_t)T * L1 * NB * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const size_t sm = smem ? L1 * sizeof(int) : 0;
  cat_bucket_count<<<dim3(NB, T), 32, sm, st>>>(leaf, w, n, L1, R, NB, smem,
                                               cnt);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  cat_bucket_rows<<<T * L1, NB < SCAN_THREADS ? 128 : SCAN_THREADS, 0, st>>>(
      cnt, NB, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  cat_bucket_starts<<<T, SCAN_THREADS, 0, st>>>(total, L1, lstart);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  cat_bucket_scatter<<<dim3(NB, T), 32, sm, st>>>(leaf, w, y, n, L1, R, NB,
                                                 smem, pack, lstart, cnt,
                                                 rows, wl, yl);
  return (int)cudaGetLastError();
}

// The tables of one tree group: plans the work items into `work` (Wmax, 5)
// int32 scratch (cat_plan; lstart (T, L1+1) list offsets, unused when
// natural), then builds the tiles.  slot (T, m, L1) int32: each (tree,
// column, leaf)'s table in out / acc, -1 for none, nslot tables in all.
// Classification: out int32 counts, split tiles' tables zeroed first
// (cat_zero_split).
// Regression: the tiles store or add uint64 cells into acc (3 a category),
// zeroed by the caller, which converts them (cat_fixed_launch).
static int cat_tables_launch(
    int task, int natural, const int* x, const int* leaf, const float* w,
    const float* y, const int* rows, const float* wl, const float* yl,
    const int* lstart, int* work, const int* slot, long long nslot, int pack,
    int Wmax, int m, int n, int T, int L1, int V, int S, int LT, int nLT,
    int CT, int nCT, int piece, double s0, double s1, double s2, float* out,
    unsigned long long* acc, void* stream_ptr) {
  if (Wmax < 1 || nCT < 1 || m < 1 || m > 65535 || piece < 1 ||
      (long long)Wmax * nCT > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream_ptr;
  cat_plan<<<1, PLAN_THREADS, 0, st>>>(lstart, natural, T, n, L1, LT, nLT,
                                       piece, Wmax, work);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int SW = task == CLASSIFICATION ? S : 3;
  if (task == CLASSIFICATION) {
    cat_zero_split<<<dim3(Wmax, m), BLOCK, 0, st>>>(
        work, slot, nslot, m, L1, V, SW, LT, reinterpret_cast<unsigned*>(out));
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const size_t smem = tile_smem_bytes(LT < L1 ? LT : L1, CT, SW, task);
  const dim3 grid((unsigned)(Wmax * nCT), (unsigned)m);
#define CAT_TILE(TK, NAT)                                                  \
  launch_tile<TK, NAT>(grid, smem, st, x, leaf, w, y, rows, wl, yl, lstart, \
                       work, slot, nslot, pack, m, n, L1, V, S, LT, CT, nCT, \
                       s0, s1, s2, reinterpret_cast<unsigned*>(out), acc)
  if (task == CLASSIFICATION)
    err = natural ? CAT_TILE(CLASSIFICATION, true)
                  : CAT_TILE(CLASSIFICATION, false);
  else
    err = natural ? CAT_TILE(REGRESSION, true) : CAT_TILE(REGRESSION, false);
#undef CAT_TILE
  return (int)err;
}

// The whole of one tree group in one call: bucketing (unless natural),
// then the tables.  ints: int32 scratch laid out as cnt (T, L1, NB), total
// (T, L1), lstart (T, L1+1), work (Wmax, 5) — natural: work only; lists:
// float32 scratch (3, T, n) for rows, wl, yl (null when natural), (2, T, n)
// when `pack` (classification: row * pack + class in `rows`, no yl;
// pack = S + 1).  slot, nslot: as for cat_tables_launch.  out:
// classification's int32 cells; regression's go to acc.
extern "C" int cat_hist_launch(
    int task, int natural, const int* x, const int* leaf, const float* w,
    const float* y, const int* slot, long long nslot, int T, int m, int n,
    int L1, int V, int S, int LT, int nLT, int CT, int nCT, int R, int NB,
    int piece, int Wmax, int pack, double s0, double s1, double s2, int* ints,
    float* lists, float* out, unsigned long long* acc, void* stream_ptr) {
  int *lstart = nullptr, *rows = nullptr;
  float *wl = nullptr, *yl = nullptr;
  int* work = ints;
  if (!natural) {
    int* cnt = ints;
    int* total = cnt + (size_t)T * L1 * NB;
    lstart = total + (size_t)T * L1;
    work = lstart + (size_t)T * (L1 + 1);
    rows = reinterpret_cast<int*>(lists);
    wl = lists + (size_t)T * n;
    yl = pack ? nullptr : lists + 2 * (size_t)T * n;
    const int err = cat_bucket_launch(leaf, w, y, T, n, L1, R, NB, pack, cnt,
                                      total, lstart, rows, wl, yl,
                                      stream_ptr);
    if (err != 0) return err;
  }
  return cat_tables_launch(task, natural, x, leaf, w, y, rows, wl, yl, lstart,
                           work, slot, nslot, pack, Wmax, m, n, T, L1, V, S,
                           LT, nLT, CT, nCT, piece, s0, s1, s2, out, acc,
                           stream_ptr);
}

// Regression's last pass: the uint64 fixed-point sums of `tables` tables
// (V categories x 3 stats each) to float32, times 1/scale per stat.
extern "C" int cat_fixed_launch(const unsigned long long* acc,
                                long long tables, int V, double s0, double s1,
                                double s2, float* out, void* stream_ptr) {
  const long long cells = tables * V;
  if (cells < 1) return 0;
  fixed_to_float<<<(unsigned)((cells * 3 + BLOCK - 1) / BLOCK), BLOCK, 0,
                   (cudaStream_t)stream_ptr>>>(acc, cells, 1.0 / s0, 1.0 / s1,
                                               1.0 / s2, out);
  return (int)cudaGetLastError();
}

// The plan alone (for checking cat_plan against its plain version).
extern "C" int cat_plan_launch(const int* lstart, int natural, int T, int n,
                               int L1, int LT, int nLT, int piece, int Wmax,
                               int* work, void* stream_ptr) {
  cat_plan<<<1, PLAN_THREADS, 0, (cudaStream_t)stream_ptr>>>(
      lstart, natural, T, n, L1, LT, nLT, piece, Wmax, work);
  return (int)cudaGetLastError();
}
