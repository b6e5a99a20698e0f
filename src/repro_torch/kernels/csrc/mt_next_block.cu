// One block advance of an interlaced MT19937 state, with tempered or
// uniform output.
//
// Replaces the TPU kernel src/repro/kernels/mt19937_kernel.py:_block_call
// (mt_next_block_kernel: twist then temper, uint32 out; mt_uniforms_kernel:
// twist, temper and the 24-bit float conversion, float32 out).  The plain
// PyTorch versions are src/repro_torch/kernels/ref.py:mt_next_block_ref
// and mt_uniforms_ref; the kernel agrees with them bit for bit.
//
// Layout.  One thread per generator column, 128 columns per CTA, V/128
// CTAs.  A thread twists its column of the (624, V) state (int32 storage
// of uint32 bits) from the input into the output state with the same
// twist_column / temper / uniform24 device code as the fused sweep kernels
// (mt19937.cuh), and writes each fresh word's tempered output as the twist
// stores it.  Every row access of a warp is 32 neighbouring words.
//
// What bounds it.  Per launch the function must move 3*624*V*4 bytes
// (state in, state out, output): 7.7 MB at V=1024, 2.3 us at the HBM
// rate.  Its operations, 8 int ops per word twisted and 10 (uint32 out) or
// 13 (float out) per word tempered, take 0.8 us at the card's int32 rate,
// so bytes bound it.  What the design does about it: each word is read
// once from the input and written once to each output; the twist's loads
// run 8 rows ahead of its stores, and the words that the recurrence reads
// back (rows 0..396 for i >= 227) are read from the thread's own new column,
// which L2 still holds.  The output is written from registers as each word
// is made: a second pass that read the column back would be a chain of 624
// dependent L2 round trips (it took 8x the twist's time).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt19937.cuh"

namespace {

constexpr int COLUMNS = 128;  // generator columns per CTA

struct EmitUniforms {  // the 24-bit float uniform of each new word
  float* out;
  size_t ld;
  __device__ void operator()(int i, uint32_t w) const { out[i * ld] = uniform24(w); }
};

struct EmitWords {  // the tempered word
  uint32_t* out;
  size_t ld;
  __device__ void operator()(int i, uint32_t w) const { out[i * ld] = temper(w); }
};

__global__ void __launch_bounds__(COLUMNS) mt_next_block_kernel(const uint32_t* state,
                                                                uint32_t* new_state, void* out,
                                                                int V, bool uniforms) {
  const size_t c = (size_t)blockIdx.x * COLUMNS + threadIdx.x;
  if (uniforms)
    twist_column(state + c, new_state + c, V, EmitUniforms{static_cast<float*>(out) + c, (size_t)V});
  else
    twist_column(state + c, new_state + c, V, EmitWords{static_cast<uint32_t*>(out) + c, (size_t)V});
}

}  // namespace

// Launches V/128 CTAs on `stream` (V a multiple of 128); `uniforms` picks
// float32 uniforms over tempered uint32 words.  Returns cudaGetLastError().
extern "C" int mt_next_block(const uint32_t* state, uint32_t* new_state, void* out, int V,
                             int uniforms, void* stream) {
  if (V <= 0 || V % COLUMNS) return (int)cudaErrorInvalidValue;
  mt_next_block_kernel<<<V / COLUMNS, COLUMNS, 0, (cudaStream_t)stream>>>(state, new_state, out, V,
                                                                         uniforms != 0);
  return (int)cudaGetLastError();
}
