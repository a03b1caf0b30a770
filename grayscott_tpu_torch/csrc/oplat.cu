// K8, the dependent-op chain microbenchmark, written by hand for Hopper
// (sm_90a).
//
// Replaces scripts/oplat.py:_kernel (the TPU kernel that oplat.run drives).
// One launch runs `steps` x a chain of `n_ops` dependent operations on a
// whole float32 array:
//
//   - op j of a step is x * C + B with C = float32(1.0000001) and
//     B = float32(1e-7), rounded once: the TPU kernel's interpret run
//     contracts it to a fused multiply-add, so here it is __fmaf_rn, never
//     the two roundings that -fmad=false would give a written `x * C + B`;
//   - with `rolls`, every op with j % 3 == 2 is instead roll(x, 1, axis)
//     with axis = (j / 3) % 2: cell (i, j) moves to row i + 1 (axis 0) or
//     column j + 1 (axis 1), wrapping, as jnp.roll.
//
// Without rolls the whole chain runs in registers: each thread walks its
// cells in a grid-stride loop, one read and one write a cell, and the
// steps x n_ops FMAs of a cell one after another. That is what the TPU
// kernel measures: the float32 pipe's cost of a dependent chain per cell.
//
// With rolls every roll is a real whole-array data movement; the rolls are
// not folded into one permutation at the end (the map is the same for every
// cell, so folding would give the same numbers and measure nothing). One
// persistent cooperative launch on two buffers: a pass loads its cells,
// applies the FMAs since the last roll, and stores each cell at its rolled
// place in the other buffer; a grid barrier (gs_tile.cuh: grid_barrier)
// precedes every pass but the first. The arrays are 8.4-33 MB, so the pair
// fits or nearly fits the 50 MB L2: a roll costs a barrier and an L2 round
// trip of the array, the fixed cost that K3 and K5 pay every step.
//
// Why reads come after writes: pass p reads only buffer (p - 1) % 2 (the
// input x for p = 0, which nothing writes) and writes only buffer p % 2,
// so within a pass no block reads what another writes. The barrier before
// pass p + 1 orders every write of pass p before every read of pass p + 1,
// and every read of pass p (of buffer (p - 1) % 2) before pass p + 1 writes
// that buffer again. Reads go through __ldcg, never the non-coherent path,
// so no block sees a stale line after the barrier.
//
// What bounds it on the card: operations, 2 flops an FMA over the 67
// TFLOP/s float32 peak; the array's 8 B a cell (read once, written once)
// are a few microseconds. The rolls add no operations; they add a barrier
// and the array's L2 round trip each, which is what the roll form measures.

#include "gs_tile.cuh"

namespace {

constexpr float MUL = 1.0000001f;
constexpr float ADD = 1e-7f;

// One pass: every cell of `src` through `fmas` FMAs, stored at its place in
// `dst` after a roll on `axis` (0 or 1; -1: no roll).
__device__ __forceinline__ void pass(const float* src, float* dst, int fmas,
                                     int axis, int rows, int cols) {
  const long long n = static_cast<long long>(rows) * cols;
  const long long stride =
      static_cast<long long>(gridDim.x) * gs::BLOCK_X * gs::BLOCK_Y;
  long long i = static_cast<long long>(blockIdx.x) * gs::BLOCK_X *
                    gs::BLOCK_Y + threadIdx.y * gs::BLOCK_X + threadIdx.x;
  // (r, c) of cell i, stepped by the stride's rows and columns: no division
  // per cell
  const int dr = static_cast<int>(stride / cols);
  const int dc = static_cast<int>(stride % cols);
  int r = static_cast<int>(i / cols), c = static_cast<int>(i % cols);
  for (; i < n; i += stride) {
    float x = __ldcg(src + i);
#pragma unroll 16
    for (int f = 0; f < fmas; ++f) x = __fmaf_rn(x, MUL, ADD);
    long long to = i;
    if (axis == 0) {
      to = static_cast<long long>(r + 1 == rows ? 0 : r + 1) * cols + c;
    } else if (axis == 1) {
      to = static_cast<long long>(r) * cols + (c + 1 == cols ? 0 : c + 1);
    }
    dst[to] = x;
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// Pass p writes buf0 when p is even, buf1 when odd; the host gives the
// output as the buffer of the last pass. A step's rolls are its ops
// j = 3r + 2 for r < n_ops / 3, on axis r % 2, each after two FMAs; its last
// n_ops % 3 FMAs (all n_ops of them when n_ops < 3) carry over to the next
// pass. Without rolls the whole chain is one pass.
__global__ void __launch_bounds__(gs::BLOCK_X * gs::BLOCK_Y)
oplat_kernel(const float* x, float* buf0, float* buf1, int rows, int cols,
             int steps, int n_ops, int rolls, unsigned long long* barrier) {
  if (!rolls) {
    pass(x, buf0, steps * n_ops, -1, rows, cols);
    return;
  }
  const float* src = x;
  int p = 0, carry = 0;
  for (int s = 0; s < steps; ++s) {
    for (int r = 0; r < n_ops / 3; ++r) {
      if (p > 0) gs::grid_barrier(barrier, p);
      float* dst = (p & 1) ? buf1 : buf0;
      pass(src, dst, carry + 2, r % 2, rows, cols);
      src = dst;
      carry = 0;
      ++p;
    }
    carry += n_ops % 3;
  }
  if (carry > 0) {  // the FMAs after the last roll
    if (p > 0) gs::grid_barrier(barrier, p);
    pass(src, (p & 1) ? buf1 : buf0, carry, -1, rows, cols);
  }
}

int max_blocks_cache[gs::MAX_DEVICES];  // 0 = not known yet

}  // namespace

extern "C" {

// The most blocks one cooperative launch of the kernel may have on
// `device` (negative: minus the CUDA error).
int gs_oplat_max_blocks(int device) {
  return gs::max_blocks_or_error(oplat_kernel, device, max_blocks_cache);
}

// Enqueues one cooperative launch on `stream`: `out` gets x after `steps`
// chains of `n_ops` ops (with rolls when `rolls` is nonzero); `tmp` is
// scratch of x's shape, and out, tmp and x lie apart. `barrier` is one
// zeroed 64-bit device word. `grid_blocks` <= 0 takes the co-resident
// maximum; a larger grid than the card can hold is refused with
// cudaErrorCooperativeLaunchTooLarge. Returns the CUDA error (0 when the
// launch was accepted).
int gs_oplat_chain(const float* x, float* out, float* tmp, int rows, int cols,
                   int steps, int n_ops, int rolls, int device,
                   int grid_blocks, void* barrier, void* stream) {
  if (rows < 1 || cols < 1 || steps < 1 || n_ops < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the kernel's passes: one per roll, and one for the FMAs after the last
  // roll (n_ops % 3 of them, or the whole chain when there is no roll)
  const long long n_rolls = rolls ? static_cast<long long>(steps) * (n_ops / 3)
                                  : 0;
  const long long tail = n_rolls > 0 ? n_ops % 3
                                     : static_cast<long long>(steps) * n_ops;
  if (tail > 0x7fffffffLL || n_rolls > 0x7ffffff0LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long passes = n_rolls + (tail > 0);
  float* buf0 = (passes % 2 == 1) ? out : tmp;  // the last pass writes `out`
  float* buf1 = (passes % 2 == 1) ? tmp : out;
  unsigned long long* counter = static_cast<unsigned long long*>(barrier);
  void* args[] = {&x, &buf0, &buf1, &rows, &cols, &steps, &n_ops, &rolls,
                  &counter};
  return static_cast<int>(gs::launch_persistent(
      oplat_kernel, args, rows, cols, grid_blocks, device, max_blocks_cache,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
