// K5, the species-packed resident multistep, written by hand for Hopper
// (sm_90a).
//
// Replaces grayscott_tpu/ops/pallas_stencil.py:_packed_resident_kernel (the
// TPU kernel that packed_resident_multistep_impl drives): the packed state
// [U | V] advanced by a run-time number of zero-boundary steps of the
// separable stencil in one launch. On the TPU the whole domain sits in
// VMEM; here, as in K3, the state stays in the 50 MB L2 where it fits, and
// one persistent cooperative launch runs every step.
//
//   - The grid is at most the co-resident block count (occupancy x SMs), so
//     every block is on the card at once and a grid-wide barrier is safe;
//     cudaLaunchCooperativeKernel refuses the launch otherwise.
//   - Step s reads buffer s % 2 and writes buffer 1 - s % 2. Each block
//     walks its share of the 32x32 tiles: it loads both species of the tile
//     with a one-cell ring (a 34^2 window, gs_packed.cuh:
//     step_packed_tile<1>), computes one step and writes the tile.
//   - A grid barrier follows every step but the last.
//
// Why reads come after writes: step s reads only buffer s % 2 and writes
// only buffer 1 - s % 2, so within a step no block reads what another
// writes. The barrier after step s orders every write of step s before
// every read of step s + 1 (which reads the buffer step s wrote), and every
// read of step s before step s + 1 writes buffer s % 2 again. Reads go
// through __ldcg, never the non-coherent path, so a block cannot see a
// stale line after the barrier.
//
// What bounds it on the card: the 30 float32 operations a cell-step of the
// packed step, the 34^2 reload of a 32^2 tile (13 % more reads, from L2
// while the state fits there) and a grid barrier a step. Clusters with
// DSMEM for the one-cell halo, or an L2 persisting window, are later work.

#include "gs_packed.cuh"

namespace {

constexpr int HALO = 1;  // one step per barrier

__global__ void __launch_bounds__(gs::BLOCK_X * gs::BLOCK_Y)
packed_resident_kernel(float* x0, float* x1, int rows, int cols,
                       int n_steps, gs::PackedConstants k,
                       unsigned long long* barrier) {
  __shared__ gs::PackedWindow<HALO> s;
  const int tiles_x = (cols + gs::TILE - 1) / gs::TILE;
  const int n_tiles = tiles_x * ((rows + gs::TILE - 1) / gs::TILE);
  for (int st = 0; st < n_steps; ++st) {
    const float* in = (st & 1) ? x1 : x0;
    float* out = (st & 1) ? x0 : x1;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      gs::step_packed_tile<HALO>(in, out, t / tiles_x, t % tiles_x, rows,
                                 cols, 1, k, s);
    }
    if (st + 1 < n_steps) gs::grid_barrier(barrier, st + 1);
  }
}

int max_blocks_cache[gs::MAX_DEVICES];  // 0 = not known yet

}  // namespace

extern "C" {

// The most blocks one cooperative launch of the kernel may have on
// `device` (negative: minus the CUDA error).
int gs_packed_resident_max_blocks(int device) {
  return gs::max_blocks_or_error(packed_resident_kernel, device,
                                 max_blocks_cache);
}

// Enqueues one cooperative launch of `n_steps` steps on `stream`, from x0;
// the result is in x0 when n_steps is even, else in x1. `cols` is the width
// of one species; x0 and x1 are rows x 2*cols. `barrier` is one zeroed
// 64-bit device word. `grid_blocks` <= 0 takes the co-resident maximum
// (capped at the tile count); a larger grid than the card can hold is
// refused with cudaErrorCooperativeLaunchTooLarge. Returns the CUDA error
// (0 when the launch was accepted).
int gs_packed_resident_multistep(float* x0, float* x1, int rows, int cols,
                                 int n_steps, int device, float h0, float h1,
                                 float cu, float cv, float e, float au,
                                 float bv, float qu, float qv,
                                 int grid_blocks, void* barrier,
                                 void* stream) {
  if (rows < 1 || cols < 1 || n_steps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gs::PackedConstants k = {h0, h1, cu, cv, e, au, bv, qu, qv};
  unsigned long long* counter = static_cast<unsigned long long*>(barrier);
  void* args[] = {&x0, &x1, &rows, &cols, &n_steps, &k, &counter};
  return static_cast<int>(gs::launch_persistent(
      packed_resident_kernel, args, rows, cols, grid_blocks, device,
      max_blocks_cache, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
