// Breiman scoring of categorical count tables (paper §2.4) for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the reference scores its count tables with plain
// jnp (`best_categorical_split_from_table` in src/repro/core/splits.py),
// and so did the port, as torch ops over the whole padded table.  For every
// (tree t, column j, leaf h) segment of a (T, m, L1, V, S) classification
// table of int32 class counts it orders the categories by P(last class |
// v) (empty ones last, a stable order: equal metrics keep category
// order), scores the V - 1
// ordered prefix cuts (both sides >= min_records) and keeps the first best
// cut: the gain, and the row of V flags of the categories left of it.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  A candidate segment's V·S
// counts are read once, every segment's mask row (V bytes) and gain are
// written once; the sort and the scan are a few dozen operations per
// category that holds rows.  The plain version sorted, gathered and
// scanned every padded slot of every segment: at the paper's shape (79
// columns padded to V = 10,000, about 10 of 82 columns candidates at a
// leaf) some 1.5% of that work is needed — candidate segments only, and in
// them only the categories that hold rows.  The design does just that:
//   - a block walks SEGS consecutive segments, so the ~88% that are not
//     candidates cost little: such a segment gets gain -inf and an
//     all-False row at once;
//   - a candidate segment's counts are read with coalesced loads, a few in
//     flight per thread, and the k categories that hold rows are compacted
//     into V slots of shared memory as 64-bit keys (metric bits << 32 |
//     category), a warp ballot and one shared atomic per warp placing them;
//   - only those k keys are sorted: a bitonic network whose comparators
//     all put the smaller key first, so the slots past k act as +inf and
//     are neither stored nor compared; the category in the low bits makes
//     the order total, so the result is the stable order whatever order
//     the keys were placed in;
//   - each thread owns a run of sorted positions: it sums its run's counts
//     (gathered again from the segment's row, which the block just read),
//     a block scan gives each run its prefix, and the thread scores its
//     cuts; a block reduction keeps the first best cut;
//   - the row of flags is built in shared memory and stored whole.
// Class counts are int32 and every count sum is taken in int32, exact in
// any order up to 2^31; a sum is converted to float32 once, where the
// metric or a gain is computed (the plain version converts the same
// sums), so below 2^24 the gains are those of float32 counts.  The empty
// categories sort last, in category order, so the
// cuts in that tail all score as the cut after the last category that
// holds rows: only the first max(k, 1) - 1 cuts and that one are scored
// (never past V - 1).  The gains are the plain version's bits: the
// impurity expressions keep its operation order (-fmad=false), and the
// squares or entropy terms of the S classes are added in the order of
// torch's CUDA sum over a contiguous last dimension (`tsum`, read off
// torch 2.11 on an H100: exact for S < 128 wherever a chunk's cuts number
// 16 or more, which at leaf_pad 8 means V >= 3 or two trees, and for S <
// 66 always; from 128 classes torch loads vectors of 4 and the gains
// may differ in the last bits).  A segment with no valid cut (not a
// candidate, no cut passing min_records) gets -inf and an all-False row
// where the plain version flags its first category; the level plan never
// reads a row whose gain is -inf.
//
// Three class layouts: S = 2 (float2 loads), 3 <= S <= 16 (a thread's
// class vectors in registers) and S > 16 (in a workspace in device memory,
// scanned 16 classes at a time).  Where V keys and V flags outgrow one
// block's shared memory (V above about 25,000), the keys live in the
// workspace and the flags go straight to the output row.  A launch that
// needs a workspace runs as many blocks as are resident at once, each
// walking its share of the segments in its own slice.
//
// Regression tables (GBT) stay with the plain version: their prefix sums
// are float64 in a fixed sequential order (`splits._prefix_cuts`), which a
// parallel scan would not reproduce.
//
// One candidate block adds 1 to a device counter (`scored`), so a caller
// can read how many segments were scored.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SEGS = 8;              // segments a block walks in turn
constexpr int UNROLL = 4;            // categories in flight per thread
constexpr int CH = 16;               // classes a thread holds in registers
constexpr unsigned FULL = 0xffffffffu;

enum { GINI = 0, ENTROPY = 1 };

// f(0) + ... + f(S - 1) as torch's CUDA sum (at::native's Reduce.cuh)
// adds a contiguous row of S floats: lane x of bw = min(largest power of
// two <= S, 32) lanes adds element x + j bw into accumulator j % 4, then
// the four in turn; lanes then fold at distance bw / 2, bw / 4, ..., 1.
// That is its order for S < 128 where the sum has 16 rows or more (S < 66:
// any number of rows); past 127 classes it loads vectors of 4 and the
// order is another.  Here BW = bw, S in [BW, 2 BW), S <= C and the terms
// in v.
template <int BW, int C>
__device__ __forceinline__ float tsum_bw(const float (&v)[C], int S) {
  float lane[BW];
#pragma unroll
  for (int x = 0; x < BW; ++x) {
    lane[x] = v[x];
    if (x + BW < C && x + BW < S) lane[x] += v[x + BW];
  }
#pragma unroll
  for (int w = BW / 2; w > 0; w >>= 1)
#pragma unroll
    for (int x = 0; x < w; ++x) lane[x] += lane[x + w];
  return lane[0];
}

// The same for any S > 16 (bw 16 or 32), in loops that are not unrolled
// (the lanes in local memory): a short body for a rare path.
template <class F>
__device__ __forceinline__ float tsum_wide(F f, int S) {
  const int bw = S >= 32 ? 32 : 16;
  float lane[32];
#pragma unroll 1
  for (int x = 0; x < bw; ++x) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 1
    for (int e = x; e < S; e += 4 * bw) {
      a0 += f(e);
      if (e + bw < S) a1 += f(e + bw);
      if (e + 2 * bw < S) a2 += f(e + 2 * bw);
      if (e + 3 * bw < S) a3 += f(e + 3 * bw);
    }
    lane[x] = ((a0 + a1) + a2) + a3;
  }
#pragma unroll 1
  for (int w = bw / 2; w > 0; w >>= 1) {
#pragma unroll 1
    for (int x = 0; x < w; ++x) lane[x] += lane[x + w];
  }
  return lane[0];
}

// C: 2 (S == 2), 16 (S <= 16) or 0 (any S).  The terms are taken once
// each (into registers for C > 0), then added.
template <int C, class F>
__device__ __forceinline__ float tsum(F f, int S) {
  if constexpr (C == 0) {
    return tsum_wide(f, S);
  } else {
    float v[C];
#pragma unroll
    for (int s = 0; s < C; ++s) v[s] = s < S ? f(s) : 0.0f;
    if constexpr (C == 2) return tsum_bw<2, 2>(v, S);
    if (S < 2) return tsum_bw<1, C>(v, S);
    if (S < 4) return tsum_bw<2, C>(v, S);
    if (S < 8) return tsum_bw<4, C>(v, S);
    if (S < 16) return tsum_bw<8, C>(v, S);
    return tsum_bw<16, C>(v, S);
  }
}

// f(0) + ... + f(S - 1) in class order (class counts: exact in any order).
template <int C, class F>
__device__ __forceinline__ auto count(F f, int S) {
  decltype(f(0)) n = 0;
  if constexpr (C > 0) {
#pragma unroll
    for (int s = 0; s < C; ++s)
      if (s < S) n += f(s);
  } else {
    for (int s = 0; s < S; ++s) n += f(s);
  }
  return n;
}

// N * impurity of the class counts f(0 .. S-1), in the plain version's
// order (`splits.weighted_impurity`).
template <int C, class F>
__device__ __forceinline__ float impurity(F f, int S, int kind) {
  const float n = count<C>(f, S);
  if (kind == GINI) {
    const float sq = tsum<C>([&](int s) {
      const float h = f(s);
      return h * h;
    }, S);
    return n - (n > 0.0f ? sq / fmaxf(n, 1e-12f) : 0.0f);
  }
  const float d = fmaxf(n, 1e-12f);
  const float acc = tsum<C>([&](int s) {
    const float h = f(s);
    const float p = h / d;
    return h > 0.0f ? p * logf(fmaxf(p, 1e-12f)) : 0.0f;
  }, S);
  return -(n * acc);
}

// A thread's class vectors (int32 counts): the left side of its current
// cut and the segment's totals.  C > 0: registers.  C == 0: the block's
// workspace, left class s at l[s * THREADS], total s at t[s].
template <int C>
struct Cls {
  int l[C], t[C];
  __device__ __forceinline__ int& left(int s) { return l[s]; }
  __device__ __forceinline__ int tot(int s) const { return t[s]; }
};
template <>
struct Cls<0> {
  int* l;
  const int* t;
  __device__ __forceinline__ int& left(int s) {
    return l[(size_t)s * THREADS];
  }
  __device__ __forceinline__ int tot(int s) const { return t[s]; }
};

// The gain of the cut whose left side is `v`'s left, or -inf where a
// side holds fewer than min_records rows (`split_gain`'s operations on
// the left and right counts, each converted to float32 once).
template <int C, class V>
__device__ __forceinline__ float cut_gain(V& v, int S, int kind,
                                          float min_records) {
  auto L = [&](int s) { return (float)v.left(s); };
  auto R = [&](int s) { return (float)(v.tot(s) - v.left(s)); };
  auto P = [&](int s) { return L(s) + R(s); };
  auto Li = [&](int s) { return v.left(s); };
  auto Ri = [&](int s) { return v.tot(s) - v.left(s); };
  if (!((float)count<C>(Li, S) >= min_records &&
        (float)count<C>(Ri, S) >= min_records))
    return -CUDART_INF_F;
  return impurity<C>(P, S, kind) - impurity<C>(L, S, kind)
      - impurity<C>(R, S, kind);
}

// Category v's counts of the segment's row `tab` (V x S ints): their
// total and the last class's.
template <int C>
__device__ __forceinline__ void held(const int* __restrict__ tab, int v,
                                     int S, int& total, int& last) {
  if constexpr (C == 2) {
    const int2 c = reinterpret_cast<const int2*>(tab)[v];
    total = c.x + c.y;
    last = c.y;
  } else {
    const int* r = tab + (size_t)v * S;
    total = 0;
    for (int s = 0; s < S; ++s) total += r[s];
    last = r[S - 1];
  }
}

// Add category v's counts to the thread's left vector.
template <int C, class V>
__device__ __forceinline__ void add_counts(const int* __restrict__ tab,
                                           int v, int S, V& cv) {
  if constexpr (C == 2) {
    const int2 c = reinterpret_cast<const int2*>(tab)[v];
    cv.left(0) += c.x;
    cv.left(1) += c.y;
  } else {
    const int* r = tab + (size_t)v * S;
    if constexpr (C > 0) {
#pragma unroll
      for (int s = 0; s < C; ++s)
        if (s < S) cv.left(s) += r[s];
    } else {
      for (int s = 0; s < S; ++s) cv.left(s) += r[s];
    }
  }
}

// Sort key of a metric >= 0 or +inf: its bits order as the floats do.
__device__ __forceinline__ unsigned order_bits(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Store V bytes of `flags` (shared memory; all zero when null) to `dst`,
// 16 bytes a store where the row is aligned.
__device__ __forceinline__ void store_row(unsigned char* __restrict__ dst,
                                         const unsigned char* flags, int V) {
  if (V % 16 == 0 && (reinterpret_cast<size_t>(dst) & 15) == 0) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* f = reinterpret_cast<const uint4*>(flags);
    for (int i = threadIdx.x; i < V / 16; i += THREADS)
      d[i] = flags ? f[i] : make_uint4(0, 0, 0, 0);
  } else {
    for (int v = threadIdx.x; v < V; v += THREADS)
      dst[v] = flags ? flags[v] : 0;
  }
}

// The better of two cuts: the larger gain, the lower position on equal
// gains (the plain version's argmax takes the first maximum).
__device__ __forceinline__ void better(float& g, int& p, float g2, int p2) {
  if (g2 > g || (g2 == g && p2 < p)) {
    g = g2;
    p = p2;
  }
}

struct Scratch {
  int part[WARPS][CH];       // per-warp count sums, then their prefixes
  float best_g[WARPS];
  int best_p[WARPS];
  int k;                     // categories holding rows
};

// The block's exclusive scan of the threads' run sums run[0 .. N) (class
// by class, threads in order): each thread's prefix in `left`, the
// block's totals in `tot`.
template <int N>
__device__ __forceinline__ void block_scan(const int* run, int* left,
                                           int* tot, Scratch& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl[N];
#pragma unroll
  for (int s = 0; s < N; ++s) {
    int x = run[s];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, x, off);
      if (lane >= off) x += y;
    }
    incl[s] = x;
  }
  if (lane == 31) {
#pragma unroll
    for (int s = 0; s < N; ++s) sh.part[warp][s] = incl[s];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int s = 0; s < N; ++s) {
      int x = lane < WARPS ? sh.part[lane][s] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL, x, off);
        if (lane >= off) x += y;
      }
      if (lane < WARPS) sh.part[lane][s] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < N; ++s) {
    left[s] = incl[s] - run[s] + (warp > 0 ? sh.part[warp - 1][s] : 0);
    tot[s] = sh.part[WARPS - 1][s];
  }
  __syncthreads();           // sh.part is reused
}

// Blocks walk groups of SEGS consecutive segments (seg = (t * m + j) * L1
// + h), gridDim.x groups apart.  GK = false: dynamic shared memory holds V
// keys, then V flags (rounded to 16).  GK = true: each block's keys take V
// slots of its workspace slice and the flags are set in the output row.
// C == 0: the slice (after any keys) holds S totals, then S x THREADS
// left counts.
template <int C, bool GK>
__global__ void __launch_bounds__(THREADS)
brm_score(const int* __restrict__ tables,
          const unsigned char* __restrict__ cand, long long nseg, int V,
          int S_arg, int kind, float min_records,
          unsigned long long* __restrict__ scored,
          float* __restrict__ gains, unsigned char* __restrict__ masks,
          unsigned char* ws, long long ws_stride) {
  extern __shared__ unsigned long long smem[];
  __shared__ Scratch sh;
  const int S = C == 2 ? 2 : S_arg;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned char* slice = ws + (GK || C == 0 ? blockIdx.x * ws_stride : 0);
  unsigned long long* keys =
      GK ? reinterpret_cast<unsigned long long*>(slice) : smem;
  unsigned char* sflags = reinterpret_cast<unsigned char*>(smem + V);
  int* wcls = reinterpret_cast<int*>(slice + (GK ? (size_t)V * 8 : 0));
  const long long ngroup = (nseg + SEGS - 1) / SEGS;
  for (long long grp = blockIdx.x; grp < ngroup; grp += gridDim.x) {
    const long long seg1 = min(nseg, (grp + 1) * SEGS);
    for (long long seg = grp * SEGS; seg < seg1; ++seg) {
      unsigned char* row = masks + seg * (long long)V;
      if (!cand[seg]) {
        if (tid == 0) gains[seg] = -CUDART_INF_F;
        store_row(row, nullptr, V);
        continue;
      }
      const int* tab = tables + seg * (long long)V * S;
      unsigned char* flags = GK ? row : sflags;
      if (tid == 0) {
        sh.k = 0;
        atomicAdd(scored, 1ull);
      }
      __syncthreads();

      // 1. compact the categories that hold rows into sort keys
      constexpr int U = C == 2 ? UNROLL : 1;
      for (int base = 0; base < V; base += THREADS * U) {
        int tc[U], lc[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int v = base + u * THREADS + tid;
          tc[u] = 0;
          lc[u] = 0;
          if (v < V) held<C>(tab, v, S, tc[u], lc[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int v = base + u * THREADS + tid;
          const bool hold = tc[u] > 0;
          const unsigned ballot = __ballot_sync(FULL, hold);
          int at = 0;
          if (lane == 0 && ballot) at = atomicAdd(&sh.k, __popc(ballot));
          at = __shfl_sync(FULL, at, 0);
          if (hold) {
            const float metric = (float)lc[u] / fmaxf((float)tc[u], 1e-12f);
            keys[at + __popc(ballot & ((1u << lane) - 1u))] =
                ((unsigned long long)order_bits(metric) << 32) |
                (unsigned)v;
          }
        }
      }
      if constexpr (GK) {
        store_row(row, nullptr, V);
      } else {
        for (int v = tid; v < V; v += THREADS) flags[v] = 0;
      }
      __syncthreads();
      const int k = sh.k;
      const int P = max(k, 1);              // positions walked
      const int ncut = min(P, V - 1);       // cuts scored: [0, ncut)

      // 2. bitonic sort of the k keys; every comparator puts the smaller
      // key first, so slots past k would hold +inf and are skipped
      int np = 1;
      while (np < k) np <<= 1;
      for (int size = 2; size <= np; size <<= 1) {
        const int half = size >> 1;
        for (int i = tid; i < (np >> 1); i += THREADS) {
          const int off = i & (half - 1), blk = (i - off) * 2;
          const int lo = blk + off, hi = blk + size - 1 - off;
          if (hi < k) {
            const unsigned long long a = keys[lo], b = keys[hi];
            if (a > b) {
              keys[lo] = b;
              keys[hi] = a;
            }
          }
        }
        __syncthreads();
        for (int stride = half >> 1; stride > 0; stride >>= 1) {
          for (int i = tid; i < (np >> 1); i += THREADS) {
            const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
            if (hi < k) {
              const unsigned long long a = keys[lo], b = keys[hi];
              if (a > b) {
                keys[lo] = b;
                keys[hi] = a;
              }
            }
          }
          __syncthreads();
        }
      }

      // 3. each thread's run of sorted positions: its count sums, then a
      // block scan gives every run its prefix and the segment's totals
      const int per = (P + THREADS - 1) / THREADS;
      const int p0 = min(P, tid * per), p1 = min(P, p0 + per);
      Cls<C> cv;
      if constexpr (C > 0) {
        Cls<C> run;
#pragma unroll
        for (int s = 0; s < C; ++s) run.l[s] = 0;
        for (int p = p0; p < min(p1, k); ++p)
          add_counts<C>(tab, (int)(keys[p] & 0xffffffffu), S, run);
        block_scan<C>(run.l, cv.l, cv.t, sh);
      } else {
        cv.t = wcls;
        cv.l = wcls + S + tid;
        for (int c0 = 0; c0 < S; c0 += CH) {
          int run[CH], left[CH], tot[CH];
#pragma unroll
          for (int c = 0; c < CH; ++c) run[c] = 0;
          for (int p = p0; p < min(p1, k); ++p) {
            const int* r = tab + (size_t)(keys[p] & 0xffffffffu) * S + c0;
#pragma unroll
            for (int c = 0; c < CH; ++c)
              if (c0 + c < S) run[c] += r[c];
          }
          block_scan<CH>(run, left, tot, sh);
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            if (c0 + c < S) {
              cv.left(c0 + c) = left[c];
              if (tid == 0) wcls[c0 + c] = tot[c];
            }
          }
        }
        __syncthreads();     // the totals, for every thread
      }

      // 4. score the run's cuts (left = sorted positions <= p)
      float bg = -CUDART_INF_F;
      int bp = 0x7fffffff;
      for (int p = p0; p < min(p1, ncut); ++p) {
        if (p < k) add_counts<C>(tab, (int)(keys[p] & 0xffffffffu), S, cv);
        const float g = cut_gain<C>(cv, S, kind, min_records);
        if (g > bg) {
          bg = g;
          bp = p;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        better(bg, bp, __shfl_down_sync(FULL, bg, off),
               __shfl_down_sync(FULL, bp, off));
      if (lane == 0) {
        sh.best_g[warp] = bg;
        sh.best_p[warp] = bp;
      }
      __syncthreads();
      bg = sh.best_g[0];
      bp = sh.best_p[0];
      for (int w = 1; w < WARPS; ++w)
        better(bg, bp, sh.best_g[w], sh.best_p[w]);

      // 5. the gain and the row: sorted positions 0..bp go left (with no
      // category holding rows, position 0 is category 0)
      if (bg > -CUDART_INF_F) {
        for (int p = tid; p <= bp; p += THREADS)
          flags[p < k ? (int)(keys[p] & 0xffffffffu) : 0] = 1;
      }
      if (tid == 0) gains[seg] = bg;
      __syncthreads();
      if (!GK) store_row(row, flags, V);
      __syncthreads();        // the next segment reuses keys, flags, sh
    }
  }
}

size_t smem_bytes(int V) {
  return (size_t)V * sizeof(unsigned long long) + (((size_t)V + 15) / 16) * 16;
}

// Dynamic shared memory a block may take on the current card (bytes), or
// -1 without a device.
long long smem_limit() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return (long long)optin - (long long)sizeof(Scratch);
}

struct Plan {
  int C;                // class layout: 2, 16 or 0
  bool gk;              // keys in the workspace
  size_t smem;          // dynamic shared memory a block
  long long stride;     // workspace bytes a block (0: none)
  long long grid;       // blocks
};

template <int C, bool GK>
cudaError_t size_grid(Plan& p, long long groups) {
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)brm_score<C, GK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
  }
  p.grid = groups;
  if (p.stride > 0) {   // as many blocks as are resident at once
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, brm_score<C, GK>, THREADS, p.smem);
    if (err != cudaSuccess) return err;
    if (GK) per_sm = 1;   // a slice of V keys a block: keep the workspace small
    const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
    if (resident < p.grid) p.grid = resident;
  }
  return cudaSuccess;
}

cudaError_t make_plan(Plan& p, long long nseg, int V, int S) {
  const long long limit = smem_limit();
  if (limit < 0) return cudaErrorNoDevice;
  p.C = S == 2 ? 2 : (S <= CH ? 16 : 0);
  p.gk = (long long)smem_bytes(V) > limit;
  p.smem = p.gk ? 0 : smem_bytes(V);
  long long bytes = p.gk ? (long long)V * 8 : 0;
  if (p.C == 0) bytes += ((long long)S + (long long)THREADS * S) * 4;
  p.stride = (bytes + 255) / 256 * 256;
  const long long groups = (nseg + SEGS - 1) / SEGS;
  switch (p.C * 2 + p.gk) {
    case 4: return size_grid<2, false>(p, groups);
    case 5: return size_grid<2, true>(p, groups);
    case 32: return size_grid<16, false>(p, groups);
    case 33: return size_grid<16, true>(p, groups);
    case 0: return size_grid<0, false>(p, groups);
    default: return size_grid<0, true>(p, groups);
  }
}

template <int C, bool GK>
void launch(const Plan& p, const int* tables, const unsigned char* cand,
            long long nseg, int V, int S, int kind, float min_records,
            unsigned long long* scored, float* gains, unsigned char* masks,
            unsigned char* ws, cudaStream_t stream) {
  brm_score<C, GK><<<(unsigned)p.grid, THREADS, p.smem, stream>>>(
      tables, cand, nseg, V, S, kind, min_records, scored, gains, masks, ws,
      p.stride);
}

}  // namespace

// Workspace bytes a launch over (nseg, V, S) needs (0: none), or -1 on a
// CUDA error.
extern "C" long long brm_workspace_bytes(long long nseg, int V, int S) {
  Plan p;
  if (S < 1 || V < 1 || nseg < 1 || make_plan(p, nseg, V, S) != cudaSuccess)
    return -1;
  return p.stride * p.grid;
}

// tables (nseg, V, S) int32 (nseg = T * m * L1), cand (nseg) bytes;
// out: gains (nseg) float32, masks (nseg, V) bytes; scored (1) uint64 is
// added to; ws: brm_workspace_bytes(nseg, V, S) bytes of device memory
// (null when that is 0).  Returns the first CUDA error.
extern "C" int brm_launch(const int* tables, const unsigned char* cand,
                          long long nseg, int V, int S, int kind,
                          float min_records, unsigned long long* scored,
                          float* gains, unsigned char* masks, void* ws,
                          long long ws_bytes, void* stream_ptr) {
  Plan p;
  if (S < 1 || V < 1 || nseg < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = make_plan(p, nseg, V, S);
  if (err != cudaSuccess) return (int)err;
  if (p.grid > 0x7fffffffLL || ws_bytes < p.stride * p.grid ||
      (p.stride > 0 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  unsigned char* w = (unsigned char*)ws;
  switch (p.C * 2 + p.gk) {
    case 4: launch<2, false>(p, tables, cand, nseg, V, S, kind, min_records,
                             scored, gains, masks, w, stream); break;
    case 5: launch<2, true>(p, tables, cand, nseg, V, S, kind, min_records,
                            scored, gains, masks, w, stream); break;
    case 32: launch<16, false>(p, tables, cand, nseg, V, S, kind,
                               min_records, scored, gains, masks, w, stream);
      break;
    case 33: launch<16, true>(p, tables, cand, nseg, V, S, kind, min_records,
                              scored, gains, masks, w, stream); break;
    case 0: launch<0, false>(p, tables, cand, nseg, V, S, kind, min_records,
                             scored, gains, masks, w, stream); break;
    default: launch<0, true>(p, tables, cand, nseg, V, S, kind, min_records,
                             scored, gains, masks, w, stream); break;
  }
  return (int)cudaGetLastError();
}
