// One block advance of an interlaced MT19937 state, with tempered or
// uniform output.
//
// Replaces the TPU kernel src/repro/kernels/mt19937_kernel.py:_block_call
// (mt_next_block_kernel: twist then temper, uint32 out; mt_uniforms_kernel:
// twist, temper and the 24-bit float conversion, float32 out).  The plain
// PyTorch versions are src/repro_torch/kernels/ref.py:mt_next_block_ref
// and mt_uniforms_ref; the kernel agrees with them bit for bit.
//
// Layout.  A CTA owns a tile of T = 16 neighbouring generator columns,
// all 624 rows of it, in shared memory (40 KB; the last tile may be
// partial: any V >= 1, its columns past V dropped).  128 threads, in 32
// groups of 4 that each span the tile's columns, 4 a thread.  (1) The
// tile's old rows are copied in by cp.async, every copy issued before
// any is waited for.  (2) twist_block (mt19937.cuh) advances the tile in
// place in MT19937's three dependence phases: each group twists a run of
// each phase's rows, a CTA barrier between phases, each run's first row
// past its end loaded before the first barrier (the in-place guard,
// ROADMAP §3i).  (3) As a new row is stored in shared memory, its thread
// writes it and its tempered word or uniform (uniform_of) to device
// memory: 16 bytes a copy and a store when V % 4 == 0 and the pointers
// are 16-byte aligned, word by word otherwise.
//
// What bounds it.  Per launch the function must move 3*624*V*4 bytes
// (state in, state out, output): 7.7 MB at V=1024, 2.3 us at the HBM
// rate.  Its operations, 8 int ops per word twisted and 10 (uint32 out) or
// 12 (float out) per word tempered, take 0.8 us at the card's int32 rate,
// so bytes bound it.  What the design does about it: each word is read
// once and written once to each output; a CTA's loads are all in flight
// at once (one round of memory latency, where a thread walking its column
// in order waited once per few rows), and the words the recurrence reads
// back come from shared memory.  Tiles of 16 columns give 64 CTAs at
// V=1024, so more SMs pull bytes than with 32 or 64 (1.3x and 2x faster
// there; within 6% of them at V=14720, PERF.md); cp.async beat one bulk
// copy a row on an mbarrier by 3-4x, and takes any V.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt19937.cuh"

namespace {

constexpr int T = 16;  // generator columns a CTA
constexpr int GROUPS = 32;  // runs of each twist phase a CTA, one thread group each
constexpr int THREADS = GROUPS * T / 4;  // 4 columns a thread

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Writes new row i of the thread's 4 columns (col...col+3) and its
// output, tempered words or uniforms.  VEC: 16-byte stores (V % 4 == 0,
// so the 4 columns all lie in the state or all past it).
template <bool VEC, bool UNIFORMS>
struct EmitRow {
  uint32_t* state;  // the new state
  uint32_t* out;
  unsigned V, col;
  __device__ void operator()(int i, uint4 w) const {
    const uint4 o = UNIFORMS ? make_uint4(__float_as_uint(uniform_of(w.x)),
                                          __float_as_uint(uniform_of(w.y)),
                                          __float_as_uint(uniform_of(w.z)),
                                          __float_as_uint(uniform_of(w.w)))
                             : make_uint4(temper(w.x), temper(w.y), temper(w.z), temper(w.w));
    const size_t at = (size_t)i * V + col;
    if (VEC) {
      if (col < V) {
        *reinterpret_cast<uint4*>(state + at) = w;
        *reinterpret_cast<uint4*>(out + at) = o;
      }
    } else {
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w}, os[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (col + k < V) {
          state[at + k] = ws[k];
          out[at + k] = os[k];
        }
    }
  }
};

// The tile's (624, T) old words into shared memory by cp.async, 16 bytes
// (VEC) or 4 a copy, every copy issued before the wait; columns past V
// are zero-filled.  Ends with a CTA barrier.
template <bool VEC>
__device__ void load_tile(const uint32_t* g, uint32_t* tile, unsigned V, unsigned c0) {
  constexpr int W = VEC ? 4 : 1;  // words a copy
  const uint32_t base = smem_addr(tile);
  for (int k = threadIdx.x; k < MT_N * T / W; k += THREADS) {
    const int r = k / (T / W), j = W * (k % (T / W));
    const unsigned c = c0 + j;
    const uint32_t* src = c < V ? g + (size_t)r * V + c : g;
    const uint32_t dst = base + 4 * (r * T + j);
    if (VEC)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
                   "r"(c < V ? 16 : 0) : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
                   "r"(c < V ? 4 : 0) : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
}

template <bool VEC, bool UNIFORMS>
__global__ void __launch_bounds__(THREADS)
    mt_next_block_kernel(const uint32_t* state, uint32_t* new_state, uint32_t* out, unsigned V) {
  __shared__ __align__(16) uint32_t tile[MT_N * T];  // twisted in place
  constexpr int Q = T / 4;  // threads of a group
  const unsigned c0 = blockIdx.x * T;
  load_tile<VEC>(state, tile, V, c0);
  const int q = threadIdx.x % Q;
  uint4* col = reinterpret_cast<uint4*>(tile) + q;
  twist_block(col, col, Q, threadIdx.x / Q, GROUPS,
              EmitRow<VEC, UNIFORMS>{new_state, out, V, c0 + 4 * q});
}

template <bool VEC, bool UNIFORMS>
int launch(const uint32_t* state, uint32_t* new_state, uint32_t* out, unsigned V,
           cudaStream_t stream) {
  mt_next_block_kernel<VEC, UNIFORMS><<<(V + T - 1) / T, THREADS, 0, stream>>>(state, new_state,
                                                                            out, V);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches ceil(V / 16) CTAs on `stream` over the (624, V) state, V >= 1
// and 624 * V < 2^31; `uniforms` picks float32 uniforms over tempered
// uint32 words.  Returns cudaGetLastError().
extern "C" int mt_next_block(const uint32_t* state, uint32_t* new_state, void* out, int V,
                             int uniforms, void* stream) {
  if (V <= 0 || (long long)MT_N * V >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const bool vec =
      V % 4 == 0 && ((uintptr_t)state | (uintptr_t)new_state | (uintptr_t)out) % 16 == 0;
  uint32_t* o = static_cast<uint32_t*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    return uniforms ? launch<true, true>(state, new_state, o, V, s)
                    : launch<true, false>(state, new_state, o, V, s);
  return uniforms ? launch<false, true>(state, new_state, o, V, s)
                  : launch<false, false>(state, new_state, o, V, s);
}
