// K1, the windowed Gray-Scott multistep, written by hand for Hopper (sm_90a).
//
// Replaces grayscott_tpu/ops/pallas_stencil.py:_kernel (the TPU kernel that
// multistep_impl and run_blocks drive). One launch advances the (rows, cols)
// domain by `steps` <= HALO Gray-Scott steps:
//
//   - a 2-D grid of TILE x TILE output tiles; each block loads the
//     (TILE + 2*HALO)^2 window of U and V around its tile into shared memory,
//     cells outside the domain as 0.0;
//   - step s computes window cells [s+1, WIN-s-1) from one shared buffer into
//     the other (the valid region shrinks by one cell a step, so after
//     `steps` <= HALO steps the tile interior is still exact);
//   - cells outside the domain are written as exactly 0.0 every step (the
//     role of `dommask` in pallas_stencil.py): the zero boundary reads them;
//   - the tile interior, masked to the domain, is written to u_out / v_out.
//
// The tile stepper, its numerics and its boundary handling are shared with
// K2 and K3 (gs_tile.cuh: step_tile).
//
// What bounds it on the card: each launch reads and writes U and V once,
// 16 B per cell per HALO steps, about 2 B per cell-step at HALO = 8, far
// below what HBM at 3.35 TB/s feeds. The limit is the redundant compute on
// the halo ring (a 48^2 window for a 32^2 tile: about 1.5x the useful
// cell-steps over 8 steps), the shared-memory traffic of the 9-tap reads,
// the per-cell boundary arithmetic and one __syncthreads() a step. wgmma
// does not apply (no matrix product); staging the window with TMA or
// cp.async and larger tiles in dynamic shared memory are later work.

#include "gs_tile.cuh"

namespace {

constexpr int HALO = 8;  // most steps per launch (K)

__global__ void __launch_bounds__(gs::BLOCK_X * gs::BLOCK_Y)
windowed_kernel(const float* u, const float* v, float* u_out, float* v_out,
                int rows, int cols, int steps, int naive, gs::Constants k) {
  __shared__ gs::Window<HALO> s;
  gs::step_tile<HALO>(u, v, u_out, v_out, blockIdx.y, blockIdx.x, rows, cols,
                      steps, naive, k, s);
}

}  // namespace

extern "C" {

int gs_windowed_max_steps() { return HALO; }

const char* gs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues one launch on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted). u_out / v_out must not overlap u / v.
int gs_windowed_multistep(const float* u, const float* v, float* u_out,
                          float* v_out, int rows, int cols, int steps,
                          int naive, int device, float w0, float w1, float w2,
                          float w3, float w4, float w5, float w6, float w7,
                          float w8, float du, float dv, float feed,
                          float min_feed_kill, float dt, void* stream) {
  if (rows < 1 || cols < 1 || steps < 1 || steps > HALO) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((cols + gs::TILE - 1) / gs::TILE,
                  (rows + gs::TILE - 1) / gs::TILE);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const gs::Constants k = {{w0, w1, w2, w3, w4, w5, w6, w7, w8},
                           du, dv, feed, min_feed_kill, dt};
  windowed_kernel<<<grid, dim3(gs::BLOCK_X, gs::BLOCK_Y), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      u, v, u_out, v_out, rows, cols, steps, naive, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
