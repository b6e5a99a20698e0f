// The swap phase of a parallel-tempering ladder: every replica's energy,
// the swap decisions and the new betas, on the card, in one host call.
//
// Replaces no TPU kernel: the reference's swap phase is jnp
// (src/repro/core/tempering.py: swap_phase).  The plain PyTorch version is
// src/repro_torch/kernels/ref.py: pt_swap_ref (core/tempering.py's
// lane_energy and _swap_decide on the ladder's rows of the block); the two
// agree bit for bit for every exp flavour ("fast", "accurate", "exact": a
// template parameter of the decision kernel, picked by the entry's
// flavour code).
//
// Layout.  The ladder's R replicas lie at rows[0..R) of a (B, rows, V)
// block of spins (a server's carry, or one device's block of a mesh); they
// are read there, not gathered.  Two kernels back to back on one stream:
//   1. pt_energy_kernel, one CTA a replica.  The replica's N = rows * V
//      terms, in the flat (rows, V) order, fall into tasks of 128: a warp
//      takes a task, each thread 4 neighbouring terms, which it sums as
//      (t0 + t1) + (t2 + t3); five shuffle levels sum the warp's 32 values
//      pairwise, so each task is the perfect pairwise tree of its 128
//      terms.  The task sums go to shared memory, zero-filled to the next
//      power of two P2, and a tree of P2 / 2, P2 / 4, ... adds sums two by
//      two in place.  That is _pairwise_sum's tree exactly: its padded tree
//      (pair (2i, 2i+1) at every level, an odd length padded with +0) is
//      the perfect tree over the terms zero-extended to the next power of
//      two, since a pad of zeros sums to +0 and x + 0 is the pad's add; a
//      replica of 64 terms or fewer stops its task's tree at that width
//      (held by tests/test_torch_tempering.py on a torch model of this
//      blocking).
//      The spins are read in place through the L1 cache (a replica's 98 KB
//      at the paper's shape; no tile to size, so any rows the sweep
//      kernels take), the model's tables through the read-only path.
//      Where V % 4 == 0 and the block starts on a 16-byte boundary (every
//      carry the kernels write) a thread's 4 terms share a row: their
//      index arithmetic and tables are taken once and each row they read
//      is one 16-byte load; otherwise each term is taken alone.
//   2. pt_decide_kernel, one CTA: twists the ladder's scalar MT19937 once
//      per 624 uniforms drawn (ceil(R / 2) of them, the rest of the block
//      thrown away), in its three dependence phases on shared memory, a
//      thread a word; the thread of word k decides candidate pair k
//      (replicas 2k + parity and 2k + parity + 1), swaps the pair's betas
//      at its rows when u < p, and __syncthreads_count counts the accepted
//      pairs.  The block's betas are copied to the output first; the
//      generator and the two counters are written to new buffers.
//
// What bounds it.  Per call it must read the ladder's spins, 4 * R * N
// bytes: 11.3 MB at R = 115, N = 24,576, 3.4 us at the HBM rate.  Its
// float64 operations, ~13 a term at the paper's 4 space neighbours, are
// ~37 MFLOP, under 1 us at the card's float64 rate.  With one CTA a
// replica only R of the 132 SMs work; each walks its 192 tasks in 32
// warps, so the kernel is bound by the latency of its loads and shuffles.
//
// Numerics.  Each spin's term is core/tempering.py's lane_energy in
// float64 in its order: h, then + (0.5 J_d) s_nbr(d) for each neighbour d,
// then + tau up (the next layer block, or for the last block the first
// block one lane over, lane V-1 wrapping to 0), then -(s local); every
// product is exact and --fmad=false keeps each add a separate rounding.
// The sum is rounded once to float32.  No atomics: the bits do not depend
// on the device or the launch (ROADMAP §3o).  The decision is _swap_decide's
// float32 arithmetic: (b_i - b_j) (e_i - e_j), clamped to [-20, 0] by
// compares that keep a NaN, sweep_exp<F>, u < p, u the word's 24 high bits
// times 2^-24 (uniform_of).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fastexp.cuh"
#include "mt19937.cuh"

namespace {

constexpr int E_THREADS = 1024;  // an energy CTA: 32 warps
constexpr int RUN = 4;  // neighbouring terms a thread sums
constexpr int TASK = 32 * RUN;  // terms a warp sums at once
constexpr int D_THREADS = 640;  // the decision CTA: at least a thread a generator word
constexpr int MAX_SMEM = 232448;  // a CTA's shared memory on Hopper (ops.MAX_SMEM)

// The replicas' lattice: the block of spins and the model's energy tables.
struct Lattice {
  const float* spins;  // (B, rows, V)
  const float* h;  // (n,)
  const long long* nbr;  // (n, sd) in-layer neighbour sites
  const float* J;  // (n, sd), not doubled
  const float* tau;  // (n,), not doubled
  int rows, V, n, sd;
};

// The term of flat spin f = row * V + v of replica s: lane_energy's
// -(s * local) in float64.
__device__ __forceinline__ double spin_term(const float* s, const Lattice& g, int f) {
  const int row = f / g.V, v = f - row * g.V;
  const int blk = row / g.n, i = row - blk * g.n;
  double local = (double)__ldg(g.h + i);
  for (int d = 0; d < g.sd; ++d) {
    const int j = (int)__ldg(g.nbr + i * g.sd + d);
    const double half_J = 0.5 * (double)__ldg(g.J + i * g.sd + d);
    local = local + half_J * (double)s[(blk * g.n + j) * g.V + v];
  }
  const float up =
      row + g.n < g.rows ? s[f + g.n * g.V] : s[i * g.V + (v + 1 == g.V ? 0 : v + 1)];
  local = local + (double)__ldg(g.tau + i) * (double)up;
  return -((double)s[f] * local);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The RUN = 4 terms from flat spin f0 (a multiple of 4), zero past N.
// ROW4 (V % 4 == 0, the block 16-byte aligned): the 4 share a row, so the
// index arithmetic and the model's tables are taken once, and every row
// they read is one 16-byte word; each term's arithmetic is spin_term's.
template <bool ROW4>
__device__ __forceinline__ void run_terms(const float* s, const Lattice& g, int f0, int N,
                                          double (&x)[RUN]) {
  if (!ROW4) {
#pragma unroll
    for (int k = 0; k < RUN; ++k) x[k] = f0 + k < N ? spin_term(s, g, f0 + k) : 0.0;
    return;
  }
  if (f0 >= N) {  // N is a multiple of 4: the 4 lie all inside or all past it
#pragma unroll
    for (int k = 0; k < RUN; ++k) x[k] = 0.0;
    return;
  }
  const int row = f0 / g.V, v = f0 - row * g.V;
  const int blk = row / g.n, i = row - blk * g.n;
  const double h = (double)__ldg(g.h + i);
  double local[RUN] = {h, h, h, h};
  for (int d = 0; d < g.sd; ++d) {
    const int j = (int)__ldg(g.nbr + i * g.sd + d);
    const double half_J = 0.5 * (double)__ldg(g.J + i * g.sd + d);
    const float4 t = ld4(s + (blk * g.n + j) * g.V + v);
    local[0] = local[0] + half_J * (double)t.x;
    local[1] = local[1] + half_J * (double)t.y;
    local[2] = local[2] + half_J * (double)t.z;
    local[3] = local[3] + half_J * (double)t.w;
  }
  float4 up;
  if (row + g.n < g.rows) {
    up = ld4(s + f0 + g.n * g.V);
  } else {  // the first block one lane over: lanes v+1 .. v+4, v+4 wrapping to 0
    const float4 a = ld4(s + i * g.V + v);
    up = make_float4(a.y, a.z, a.w, s[i * g.V + (v + RUN == g.V ? 0 : v + RUN)]);
  }
  const double tau = (double)__ldg(g.tau + i);
  local[0] = local[0] + tau * (double)up.x;
  local[1] = local[1] + tau * (double)up.y;
  local[2] = local[2] + tau * (double)up.z;
  local[3] = local[3] + tau * (double)up.w;
  const float4 own = ld4(s + f0);
  x[0] = -((double)own.x * local[0]);
  x[1] = -((double)own.y * local[1]);
  x[2] = -((double)own.z * local[2]);
  x[3] = -((double)own.w * local[3]);
}

template <bool ROW4>
__global__ void __launch_bounds__(E_THREADS)
    pt_energy_kernel(Lattice g, const int* __restrict__ rows_idx, float* __restrict__ energies,
                     int P2) {
  extern __shared__ double part[];  // (P2,) task sums, zero past the last task
  const float* s = g.spins + (size_t)rows_idx[blockIdx.x] * g.rows * g.V;
  const int N = g.rows * g.V, P = (N + TASK - 1) / TASK;
  int span = 1;  // N rounded up to a power of two: the width of the padded tree
  while (span < N) span *= 2;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int t = warp; t < P; t += E_THREADS / 32) {
    double x[RUN];
    run_terms<ROW4>(s, g, t * TASK + lane * RUN, N, x);
    // The task's tree, cut at the padded tree's width when that is under
    // 128 terms (no add of a pad past it: an all -0 sum keeps its sign).
    double a = x[0];
    if (span > 1) a = a + x[1];
    if (span > 2) a = a + (x[2] + x[3]);
    for (int o = 1; o < 32 && RUN * o < span; o *= 2)
      a = a + __shfl_down_sync(0xffffffffu, a, o);
    if (lane == 0) part[t] = a;  // lane 0: the tree of the task's 128 terms
  }
  for (int t = P + threadIdx.x; t < P2; t += E_THREADS) part[t] = 0.0;
  __syncthreads();
  for (int o = 1; o < P2; o *= 2) {  // level o: part[p] += part[p + o], p a multiple of 2o
    for (int p = 2 * o * threadIdx.x; p < P2; p += 2 * o * E_THREADS)
      part[p] = part[p] + part[p + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) energies[blockIdx.x] = __double2float_rn(part[0]);
}

template <bool ROW4>
int launch_energy(const Lattice& g, const int* rows_idx, float* energies, int R, size_t smem,
                  cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pt_energy_kernel<ROW4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pt_energy_kernel<ROW4><<<R, E_THREADS, smem, stream>>>(g, rows_idx, energies,
                                                         (int)(smem / sizeof(double)));
  return (int)cudaGetLastError();
}

template <int F>
__global__ void __launch_bounds__(D_THREADS)
    pt_decide_kernel(const float* __restrict__ energies, const int* __restrict__ rows_idx, int R,
                     const float* betas_in, float* betas_out, int B, const uint32_t* rng_in,
                     uint32_t* rng_out, const int* acc_in, int* acc_out, const int* prop_in,
                     int* prop_out, int parity, ExpConsts ec) {
  __shared__ uint32_t mt[2][MT_N];  // the generator, old and new block
  const int tid = threadIdx.x;
  for (int i = tid; i < B; i += D_THREADS) betas_out[i] = betas_in[i];
  for (int i = tid; i < MT_N; i += D_THREADS) mt[0][i] = rng_in[i];
  __syncthreads();
  const int U = (R + 1) / 2;  // uniforms drawn: one a candidate pair
  int cur = 0, accepted = 0;
  for (int base = 0; base < U; base += MT_N, cur ^= 1) {
    const uint32_t* a = mt[cur];
    uint32_t* b = mt[cur ^ 1];
    if (tid < MT_SPAN) b[tid] = twist_word(a[tid], a[tid + 1], a[tid + MT_M]);
    __syncthreads();
    if (tid < MT_SPAN) {
      const int i = tid + MT_SPAN;
      b[i] = twist_word(a[i], a[i + 1], b[i - MT_SPAN]);
    }
    __syncthreads();
    if (tid < MT_N - 2 * MT_SPAN) {
      const int i = tid + 2 * MT_SPAN;
      b[i] = twist_word(a[i], i + 1 < MT_N ? a[i + 1] : b[0], b[i - MT_SPAN]);
    }
    __syncthreads();
    bool accept = false;
    const int k = base + tid, i = 2 * k + parity;  // pair k: replicas i, i + 1
    if (tid < MT_N && k < U && i + 1 < R) {
      const int ri = rows_idx[i], rj = rows_idx[i + 1];
      const float bi = betas_in[ri], bj = betas_in[rj];
      float x = (bi - bj) * (energies[i] - energies[i + 1]);
      x = x < -20.0f ? -20.0f : x;  // a NaN compares false and stays NaN
      x = x > 0.0f ? 0.0f : x;
      accept = uniform_of(b[tid]) < sweep_exp<F>(x, ec);
      if (accept) {
        betas_out[ri] = bj;
        betas_out[rj] = bi;
      }
    }
    accepted += __syncthreads_count(accept);
  }
  for (int i = tid; i < MT_N; i += D_THREADS) rng_out[i] = mt[cur][i];
  if (tid == 0) {
    const int proposed = parity == 0 ? R / 2 : (R - 1) / 2;
    acc_out[0] = (int)((uint32_t)acc_in[0] + (uint32_t)accepted);  // int32 wraps, as torch's
    prop_out[0] = (int)((uint32_t)prop_in[0] + (uint32_t)proposed);
  }
}

template <int F>
int launch_decide(const float* energies, const int* rows_idx, int R, const float* betas_in,
                  float* betas_out, int B, const uint32_t* rng_in, uint32_t* rng_out,
                  const int* acc_in, int* acc_out, const int* prop_in, int* prop_out, int parity,
                  const ExpConsts& ec, cudaStream_t stream) {
  pt_decide_kernel<F><<<1, D_THREADS, 0, stream>>>(energies, rows_idx, R, betas_in, betas_out, B,
                                                   rng_in, rng_out, acc_in, acc_out, prop_in,
                                                   prop_out, parity, ec);
  return (int)cudaGetLastError();
}

// The energy kernel's shared memory: its task sums, zero-padded to a power
// of two (kernels/ops.py: pt_swap_smem_bytes).
size_t energy_smem_bytes(int rows, int V) {
  const long long P = ((long long)rows * V + TASK - 1) / TASK;
  long long P2 = 1;
  while (P2 < P) P2 *= 2;
  return (size_t)P2 * sizeof(double);
}

}  // namespace

// One round's swap phase of the ladder at rows_idx[0..R) (int32, distinct,
// each in [0, B)) of the (B, rows, V) float32 block `spins`, pairs of
// parity `parity` (0 or 1).  Writes the R energies (float32), the block's
// new betas (B,), the scalar generator's new (624,) state and the new
// accept and propose counters; reads nothing it writes.  `flavour` is the
// exp (EXP_FAST, EXP_ACCURATE or EXP_EXACT) and the five bit patterns are
// its constants (fastexp.cuh: ExpConsts).  Two kernels on `stream`.
// Returns cudaGetLastError() (or the first check's error).
extern "C" int pt_swap(const float* spins, const float* betas_in, const int* rows_idx,
                       const uint32_t* rng_in, const int* acc_in, const int* prop_in,
                       const float* h, const long long* nbr, const float* J, const float* tau,
                       float* energies, float* betas_out, uint32_t* rng_out, int* acc_out,
                       int* prop_out, int B, int R, int rows, int V, int n, int sd, int parity,
                       int flavour, uint32_t scale_bits, uint32_t centre_bits,
                       uint32_t scale4_bits, uint32_t lo_bits, uint32_t clip_hi_bits,
                       void* stream) {
  if (B < 1 || R < 1 || R > B || V < 1 || n < 1 || sd < 0 || rows < n || rows % n != 0 ||
      (parity != 0 && parity != 1) || (long long)rows * V >= (1LL << 31) ||
      (flavour != EXP_FAST && flavour != EXP_ACCURATE && flavour != EXP_EXACT))
    return (int)cudaErrorInvalidValue;
  const size_t smem = energy_smem_bytes(rows, V);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Lattice g{spins, h, nbr, J, tau, rows, V, n, sd};
  const int err = V % RUN == 0 && (uintptr_t)spins % 16 == 0
                      ? launch_energy<true>(g, rows_idx, energies, R, smem, s)
                      : launch_energy<false>(g, rows_idx, energies, R, smem, s);
  if (err != 0) return err;
  const ExpConsts ec = exp_consts(scale_bits, centre_bits, scale4_bits, lo_bits, clip_hi_bits);
#define DECIDE_CALL(F)                                                                         \
  launch_decide<F>(energies, rows_idx, R, betas_in, betas_out, B, rng_in, rng_out, acc_in,     \
                   acc_out, prop_in, prop_out, parity, ec, s)
  return SWEEP_EXP_DISPATCH(flavour, DECIDE_CALL);
#undef DECIDE_CALL
}
