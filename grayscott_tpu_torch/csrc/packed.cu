// K4, the species-packed windowed multistep, written by hand for Hopper
// (sm_90a).
//
// Replaces grayscott_tpu/ops/pallas_stencil.py:_packed_kernel (the TPU
// kernel that packed_multistep_impl and packed_run_blocks drive). One
// launch advances the packed (rows, 2*cols) state [U | V] by `steps` <=
// HALO zero-boundary steps of the separable stencil:
//
//   - a 2-D grid of TILE x TILE output tiles; each block loads the
//     (TILE + 2*HALO)^2 window of U and V around its tile into shared
//     memory, cells outside the domain as 0.0;
//   - each step is a row pass and a column pass with the reaction, the
//     valid region shrinking by one cell a step, as in K1;
//   - the tile interior, masked to the domain, is written to x_out.
//
// The tile stepper, its numerics and its boundary handling are the first
// packed stepper's (gs_packed.cuh: step_packed_tile), which K5 and K6 left
// for gs_packed_sm90.cuh.
//
// What bounds it on the card: each launch reads and writes the state once,
// 16 B per cell per HALO steps, far below what HBM feeds. The separable
// step is 30 float32 operations a cell-step for both species (16 in the two
// passes, 2 for uv^2, 6 in each update) against 63 for K1's zero tree; the
// limit is the 1.5x recompute of the 48^2 window's halo ring, the
// shared-memory traffic of the two passes (14 loads and 4 stores a
// cell-step) and the two __syncthreads() a step. Staging with TMA or
// cp.async, and larger tiles in dynamic shared memory, are later work.

#include "gs_packed.cuh"

namespace {

constexpr int HALO = 8;  // most steps per launch (K)

__global__ void __launch_bounds__(gs::BLOCK_X * gs::BLOCK_Y)
packed_kernel(const float* x, float* x_out, int rows, int cols, int steps,
              gs::PackedConstants k) {
  __shared__ gs::PackedWindow<HALO> s;
  gs::step_packed_tile<HALO>(x, x_out, blockIdx.y, blockIdx.x, rows, cols,
                             steps, k, s);
}

}  // namespace

extern "C" {

int gs_packed_max_steps() { return HALO; }

// Enqueues one launch on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted). `cols` is the width of one species; x and x_out
// are rows x 2*cols, and x_out must not overlap x.
int gs_packed_multistep(const float* x, float* x_out, int rows, int cols,
                        int steps, int device, float h0, float h1, float cu,
                        float cv, float e, float au, float bv, float qu,
                        float qv, void* stream) {
  if (rows < 1 || cols < 1 || steps < 1 || steps > HALO) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((cols + gs::TILE - 1) / gs::TILE,
                  (rows + gs::TILE - 1) / gs::TILE);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const gs::PackedConstants k = {h0, h1, cu, cv, e, au, bv, qu, qv};
  packed_kernel<<<grid, dim3(gs::BLOCK_X, gs::BLOCK_Y), 0,
                  static_cast<cudaStream_t>(stream)>>>(x, x_out, rows, cols,
                                                       steps, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
