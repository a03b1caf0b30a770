// K2, the single-card Gray-Scott megakernel, written by hand for Hopper
// (sm_90a).
//
// Replaces grayscott_tpu/ops/megakernel.py:_mega_kernel in single-chip mode
// (the TPU kernel that megastep_impl drives): a whole run of `n_blocks`
// time blocks of `steps` <= HALO steps, in one launch, on a pair
// (2, rows, cols) per species updated in place. Slot 0 holds the state at
// the launch and at its end.
//
//   - One persistent cooperative launch: the grid is at most the co-resident
//     block count (occupancy x SMs), so a grid-wide barrier is safe;
//     cudaLaunchCooperativeKernel refuses the launch otherwise.
//   - Time block t reads slot t % 2 and writes slot 1 - t % 2. Each block
//     walks its share of the 32x32 tiles; for each it stages the 48^2 window
//     in shared memory, runs `steps` steps and writes the tile interior,
//     exactly as K1 does (gs_tile.cuh: step_tile<8>).
//   - A grid barrier ends each time block.
//   - When n_blocks is odd the state ends in slot 1, and a last pass copies
//     slot 1 to slot 0 (megakernel.py:24-31).
//
// Why reads come after writes: time block t reads only slot t % 2 and
// writes only slot 1 - t % 2, so within a block no tile reads what another
// writes. The barrier at the end of block t orders every write of t before
// every read of t + 1 (which reads the slot t wrote), and every read of t
// before block t + 1 writes slot t % 2 again. The final copy runs after the
// barrier of the last block, so it reads slot 1 complete. Reads go through
// __ldcg, never the non-coherent path, so a block cannot see a stale line
// after the barrier.
//
// What bounds it on the card: the per-cell arithmetic and the 1.5x halo
// recompute of a 48^2 window, as in K1; the launch and the write-back of
// the windowed engine's pair swap are paid once a run instead of once per
// 8 steps, against one grid barrier per time block. A cp.async or TMA ring
// that prefetches the next window across tiles and time blocks is later
// work.

#include "gs_tile.cuh"

namespace {

constexpr int HALO = 8;  // most steps per time block (MEGA_STEPS)

__global__ void __launch_bounds__(gs::BLOCK_X * gs::BLOCK_Y)
mega_kernel(float* u_pair, float* v_pair, int rows, int cols, int n_blocks,
            int steps, int naive, gs::Constants k,
            unsigned long long* barrier) {
  __shared__ gs::Window<HALO> s;
  const size_t plane = static_cast<size_t>(rows) * cols;
  const int tiles_x = (cols + gs::TILE - 1) / gs::TILE;
  const int n_tiles = tiles_x * ((rows + gs::TILE - 1) / gs::TILE);
  for (int t = 0; t < n_blocks; ++t) {
    const size_t src = (t & 1) ? plane : 0, dst = (t & 1) ? 0 : plane;
    for (int i = blockIdx.x; i < n_tiles; i += gridDim.x) {
      gs::step_tile<HALO>(u_pair + src, v_pair + src, u_pair + dst,
                          v_pair + dst, i / tiles_x, i % tiles_x, rows, cols,
                          steps, naive, k, s);
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
      u_pair[i] = __ldcg(u_pair + plane + i);
      v_pair[i] = __ldcg(v_pair + plane + i);
    }
  }
}

int max_blocks_cache[gs::MAX_DEVICES];  // 0 = not known yet

}  // namespace

extern "C" {

int gs_mega_max_steps() { return HALO; }

// The most blocks one cooperative launch of the kernel may have on
// `device` (negative: minus the CUDA error).
int gs_mega_max_blocks(int device) {
  return gs::max_blocks_or_error(mega_kernel, device, max_blocks_cache);
}

// Enqueues one cooperative launch of `n_blocks` time blocks of `steps`
// steps on `stream`, on the pairs u_pair / v_pair (each 2 x rows x cols,
// slot 0 current). `barrier` is one zeroed 64-bit device word.
// `grid_blocks` <= 0 takes the co-resident maximum (capped at the tile
// count); a larger grid than the card can hold is refused with
// cudaErrorCooperativeLaunchTooLarge. Returns the CUDA error (0 when the
// launch was accepted).
int gs_mega_multistep(float* u_pair, float* v_pair, int rows, int cols,
                      int n_blocks, int steps, int naive, int device,
                      float w0, float w1, float w2, float w3, float w4,
                      float w5, float w6, float w7, float w8, float du,
                      float dv, float feed, float min_feed_kill, float dt,
                      int grid_blocks, void* barrier, void* stream) {
  if (rows < 1 || cols < 1 || n_blocks < 1 || steps < 1 || steps > HALO) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gs::Constants k = {{w0, w1, w2, w3, w4, w5, w6, w7, w8},
                     du, dv, feed, min_feed_kill, dt};
  unsigned long long* counter = static_cast<unsigned long long*>(barrier);
  void* args[] = {&u_pair, &v_pair, &rows, &cols, &n_blocks, &steps, &naive,
                  &k, &counter};
  return static_cast<int>(gs::launch_persistent(
      mega_kernel, args, rows, cols, grid_blocks, device, max_blocks_cache,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
