// K6, the species-packed single-card megakernel, written by hand for Hopper
// (sm_90a).
//
// Replaces grayscott_tpu/ops/megakernel.py:_mega_kernel with pack=True (the
// TPU kernel that packed_megastep_impl drives): a whole run of `n_blocks`
// time blocks of `steps` <= HALO zero-boundary steps of the separable
// stencil, in one launch, on one packed pair (2, rows, 2*cols) updated in
// place. Slot 0 holds the state [U | V] at the launch and at its end.
//
//   - One persistent cooperative launch: the grid is at most the
//     co-resident block count (occupancy x SMs), so a grid-wide barrier is
//     safe; cudaLaunchCooperativeKernel refuses the launch otherwise.
//   - Time block t reads slot t % 2 and writes slot 1 - t % 2. Each block
//     walks its share of the 32x32 tiles; for each it stages the 48^2
//     window of both species in shared memory, runs `steps` steps and
//     writes the tile interior, exactly as K4 does (gs_packed.cuh:
//     step_packed_tile<8>).
//   - A grid barrier ends each time block.
//   - When n_blocks is odd the state ends in slot 1, and a last pass copies
//     slot 1 to slot 0 (megakernel.py:24-31).
//
// Why reads come after writes: time block t reads only slot t % 2 and
// writes only slot 1 - t % 2, so within a block no tile reads what another
// writes. The barrier at the end of block t orders every write of t before
// every read of t + 1 (which reads the slot t wrote), and every read of t
// before block t + 1 writes slot t % 2 again. The final copy runs after the
// barrier of the last block, so it reads slot 1 complete, and each thread
// copies cells no other thread touches. Reads go through __ldcg, never the
// non-coherent path, so a block cannot see a stale line after the barrier.
//
// What bounds it on the card: K4's per-cell work (30 float32 operations a
// cell-step, the 1.5x halo recompute, two __syncthreads() a step); the
// launches and pair swaps of the windowed engine are paid once a run,
// against one grid barrier per time block.

#include "gs_packed.cuh"

namespace {

constexpr int HALO = 8;  // most steps per time block (MEGA_STEPS)

__global__ void __launch_bounds__(gs::BLOCK_X * gs::BLOCK_Y)
packed_mega_kernel(float* x_pair, int rows, int cols, int n_blocks, int steps,
                   gs::PackedConstants k, unsigned long long* barrier) {
  __shared__ gs::PackedWindow<HALO> s;
  const size_t plane = static_cast<size_t>(rows) * 2 * cols;
  const int tiles_x = (cols + gs::TILE - 1) / gs::TILE;
  const int n_tiles = tiles_x * ((rows + gs::TILE - 1) / gs::TILE);
  for (int t = 0; t < n_blocks; ++t) {
    const size_t src = (t & 1) ? plane : 0, dst = (t & 1) ? 0 : plane;
    for (int i = blockIdx.x; i < n_tiles; i += gridDim.x) {
      gs::step_packed_tile<HALO>(x_pair + src, x_pair + dst, i / tiles_x,
                                 i % tiles_x, rows, cols, steps, k, s);
    }
    if (t + 1 < n_blocks || (n_blocks & 1)) gs::grid_barrier(barrier, t + 1);
  }
  if (n_blocks & 1) {
    const size_t stride =
        static_cast<size_t>(gridDim.x) * gs::BLOCK_X * gs::BLOCK_Y;
    for (size_t i = static_cast<size_t>(blockIdx.x) * gs::BLOCK_X *
                        gs::BLOCK_Y +
                    threadIdx.y * gs::BLOCK_X + threadIdx.x;
         i < plane; i += stride) {
      x_pair[i] = __ldcg(x_pair + plane + i);
    }
  }
}

int max_blocks_cache[gs::MAX_DEVICES];  // 0 = not known yet

}  // namespace

extern "C" {

int gs_packed_mega_max_steps() { return HALO; }

// The most blocks one cooperative launch of the kernel may have on
// `device` (negative: minus the CUDA error).
int gs_packed_mega_max_blocks(int device) {
  return gs::max_blocks_or_error(packed_mega_kernel, device,
                                 max_blocks_cache);
}

// Enqueues one cooperative launch of `n_blocks` time blocks of `steps`
// steps on `stream`, on the pair x_pair (2 x rows x 2*cols, slot 0
// current; `cols` is the width of one species). `barrier` is one zeroed
// 64-bit device word. `grid_blocks` <= 0 takes the co-resident maximum
// (capped at the tile count); a larger grid than the card can hold is
// refused with cudaErrorCooperativeLaunchTooLarge. Returns the CUDA error
// (0 when the launch was accepted).
int gs_packed_mega_multistep(float* x_pair, int rows, int cols, int n_blocks,
                             int steps, int device, float h0, float h1,
                             float cu, float cv, float e, float au, float bv,
                             float qu, float qv, int grid_blocks,
                             void* barrier, void* stream) {
  if (rows < 1 || cols < 1 || n_blocks < 1 || steps < 1 || steps > HALO) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gs::PackedConstants k = {h0, h1, cu, cv, e, au, bv, qu, qv};
  unsigned long long* counter = static_cast<unsigned long long*>(barrier);
  void* args[] = {&x_pair, &rows, &cols, &n_blocks, &steps, &k, &counter};
  return static_cast<int>(gs::launch_persistent(
      packed_mega_kernel, args, rows, cols, grid_blocks, device,
      max_blocks_cache, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
