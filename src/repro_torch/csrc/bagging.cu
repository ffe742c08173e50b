// Poisson(1) bag counts (paper §2.2) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference draws its bags with
// `jax.random.poisson` (plain XLA, `bag_counts_forest` in
// src/repro/core/bagging.py), and so did the port, as a batched torch loop
// (`prng.poisson_knuth`): Knuth's loop in passes over all n rows of every
// tree, each pass a fresh uniform for every row, each uniform a
// Threefry-2x32 in int64 torch ops (~180 launches), and a host sync at the
// end of every pass.
//
// What it computes, for a batch of T trees of one forest key: the (T, n)
// float32 counts, row r of tree t being Knuth's count for that element
// alone.  The tree's key is fold_in(key, tree) = threefry(key, (0, tree));
// pass i splits the chain, rng_{i+1} = threefry(rng_i, (0, 0)) and sub_i =
// threefry(rng_i, (0, 1)), and draws u_i(r) from threefry(sub_i, (0, r))
// as `prng.uniform` does (y0 ^ y1, >> 9, | 0x3F800000, as a float, - 1).
// The element counts the passes it is live in: while log_prod > -1, add 1
// and log_prod += log(u_i(r)); the count is k - 1.  The chain is the same
// for every row of a tree, and the batched loop leaves a finished
// element's count unchanged, so the per-element loop draws exactly the
// bits of the batched one and the counts are bit-equal.  The log is the
// CUDA math library's logf, as torch's CUDA log calls it (held against
// torch.log over all 2^23 uniforms on the card: `bag_uniform_log`), and
// log_prod += is one round-to-nearest float32 add (`__fadd_rn`, which no
// flag fuses with the log's last product).
//
// Bound on an H100 SXM: integer operations.  The kernel writes 4·T·n bytes
// (0.20 GB at 3·2^24 rows: 0.06 ms at 3.35 TB/s) and draws about two
// uniforms a row (a Poisson(1) count plus the pass that ends it), each a
// 20-round Threefry of about 80 32-bit integer operations: ~160 a row,
// 8·10^9 at 3·2^24 rows, ~0.5 ms at 16.7·10^12 a second (64 INT32 lanes an
// SM).  The design does only that work:
//   - a block draws ROWS_PER_THREAD rows a thread of one tree, one after
//     the other: every turn of a thread's loop draws one uniform for its
//     current row, and a row that ends stores its count and starts the
//     next, so a warp's lanes stay busy whatever their rows' counts (a
//     loop per row would hold a warp to its largest count);
//   - the chain's first TABLE subkeys are computed once a block, by one
//     thread, into shared memory; a row past TABLE passes (a count of
//     TABLE or more, about 1 in 10^5 at TABLE = 8) continues the chain
//     from rng_TABLE in registers, so no row is cut off;
//   - 32-bit words stay in uint32_t registers, rotations are funnel
//     shifts, and the output offset is 64-bit.
// The wrapper refuses 2^32 or more rows a tree (the row is the counter's
// 32-bit word, as `prng.random_bits` refuses such draws).  Tree indices
// travel in the launch's parameters, MAX_TREES a launch, so the launch
// waits on no copy.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = 32;
constexpr long long ROWS_PER_BLOCK = (long long)THREADS * ROWS_PER_THREAD;
constexpr int TABLE = 8;             // chain subkeys a block keeps
constexpr int MAX_TREES = 256;       // trees a launch (1 KB of parameters)

struct Trees {
  uint32_t word[MAX_TREES];          // each tree index's low 32 bits
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, as `prng.threefry2x32`.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t x0, uint32_t x1,
                                         uint32_t& y0, uint32_t& y1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define TF_ROUND(r) x0 += x1; x1 = rotl(x1, r) ^ x0;
#define TF_EVEN TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ODD TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k0; x1 += k1;
  TF_EVEN x0 += k1; x1 += k2 + 1u;
  TF_ODD  x0 += k2; x1 += k0 + 2u;
  TF_EVEN x0 += k0; x1 += k1 + 3u;
  TF_ODD  x0 += k1; x1 += k2 + 4u;
  TF_EVEN x0 += k2; x1 += k0 + 5u;
#undef TF_ODD
#undef TF_EVEN
#undef TF_ROUND
  y0 = x0;
  y1 = x1;
}

// log of the float32 uniform that 32 random bits give (`prng.uniform`).
__device__ __forceinline__ float uniform_log(uint32_t bits) {
  return logf(__uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f);
}

__global__ void __launch_bounds__(THREADS)
bag_poisson(uint32_t key0, uint32_t key1, Trees trees, long long n,
            long long blocks_per_tree, float* __restrict__ out) {
  __shared__ uint32_t chain[TABLE + 1][2];   // sub_0 .. sub_{TABLE-1}, rng
  const long long b = blockIdx.x;
  const int t = (int)(b / blocks_per_tree);
  const long long first = (b - t * blocks_per_tree) * ROWS_PER_BLOCK;
  if (threadIdx.x == 0) {
    uint32_t r0, r1;
    threefry(key0, key1, 0u, trees.word[t], r0, r1);       // fold_in
    for (int i = 0; i < TABLE; ++i) {
      uint32_t s0, s1;
      threefry(r0, r1, 0u, 1u, s0, s1);
      threefry(r0, r1, 0u, 0u, r0, r1);
      chain[i][0] = s0;
      chain[i][1] = s1;
    }
    chain[TABLE][0] = r0;
    chain[TABLE][1] = r1;
  }
  __syncthreads();
  const long long end = min(n, first + ROWS_PER_BLOCK);
  long long row = first + threadIdx.x;
  if (row >= end) return;
  float* o = out + (long long)t * n;
  int pass = 0;                      // passes drawn for this row
  float log_prod = 0.0f;
  uint32_t c0 = 0u, c1 = 0u;         // the chain past the table
  for (;;) {
    uint32_t s0, s1;
    if (pass < TABLE) {
      s0 = chain[pass][0];
      s1 = chain[pass][1];
    } else {
      if (pass == TABLE) {
        c0 = chain[TABLE][0];
        c1 = chain[TABLE][1];
      }
      threefry(c0, c1, 0u, 1u, s0, s1);
      threefry(c0, c1, 0u, 0u, c0, c1);
    }
    uint32_t y0, y1;
    threefry(s0, s1, 0u, (uint32_t)row, y0, y1);
    log_prod = __fadd_rn(log_prod, uniform_log(y0 ^ y1));
    ++pass;
    if (!(log_prod > -1.0f)) {       // the row is done: k - 1 = pass - 1
      o[row] = (float)(pass - 1);
      row += THREADS;
      if (row >= end) break;
      pass = 0;
      log_prod = 0.0f;
    }
  }
}

constexpr int UNIFORMS = 1 << 23;

__global__ void bag_log_all(float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < UNIFORMS) out[k] = uniform_log((uint32_t)k << 9);
}

}  // namespace

// key0, key1: the forest key's words; trees: T tree indices' low words on
// the host; out: (T, n) float32 on the device, n in [1, 2^32).  One launch
// a MAX_TREES trees.  Returns the first CUDA error.
extern "C" int bag_poisson_launch(unsigned int key0, unsigned int key1,
                                  const unsigned int* trees, int T,
                                  long long n, float* out, void* stream_ptr) {
  if (T < 1 || n < 1 || n >= (1LL << 32) || trees == nullptr ||
      out == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long bpt = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  for (int t0 = 0; t0 < T; t0 += MAX_TREES) {
    const int tc = T - t0 < MAX_TREES ? T - t0 : MAX_TREES;
    const long long grid = bpt * tc;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    Trees tr = {};
    for (int i = 0; i < tc; ++i) tr.word[i] = trees[t0 + i];
    bag_poisson<<<(unsigned)grid, THREADS, 0, stream>>>(
        key0, key1, tr, n, bpt, out + (long long)t0 * n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// out: 2^23 float32 on the device, out[k] = the draw's log of the uniform
// k·2^-23 (its random bits k << 9): the kernel's log over every uniform
// it can draw, for a check against torch.log.
extern "C" int bag_uniform_log(float* out, void* stream_ptr) {
  if (out == nullptr) return (int)cudaErrorInvalidValue;
  bag_log_all<<<UNIFORMS / 256, 256, 0, (cudaStream_t)stream_ptr>>>(out);
  return (int)cudaGetLastError();
}
