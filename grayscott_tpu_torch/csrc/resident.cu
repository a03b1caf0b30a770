// K3, the resident Gray-Scott multistep, written by hand for Hopper (sm_90a).
//
// Replaces grayscott_tpu/ops/pallas_stencil.py:_resident_kernel (the TPU
// kernel that resident_multistep_impl drives). On the TPU the whole domain
// sits in VMEM for a run of `n_steps` steps, a run-time count, in one
// launch. No SM holds a 1080x1920 state (16.6 MB for U and V), but the
// card's 50 MB L2 holds both buffer pairs (33.2 MB), so here the state stays
// in L2 instead: one persistent cooperative launch runs every step.
//
//   - The grid is at most the co-resident block count (occupancy x SMs), so
//     every block is on the card at once and a grid-wide barrier is safe;
//     cudaLaunchCooperativeKernel refuses the launch otherwise.
//   - Step s reads buffer pair s % 2 and writes pair 1 - s % 2. Each block
//     walks its share of the 32x32 tiles: it loads the tile with a one-cell
//     ring (a 34^2 window, gs_tile.cuh: step_tile<1>) into shared memory,
//     computes one step and writes the tile. No halo is carried across steps
//     and nothing is computed twice.
//   - A grid barrier follows every step but the last.
//
// Why reads come after writes: step s reads only pair s % 2 and writes only
// pair 1 - s % 2, so within a step no block reads what another writes. The
// barrier after step s orders every write of step s before every read of
// step s + 1 (which reads the pair step s wrote), and every read of step s
// before step s + 1 writes pair s % 2 again. Reads go through __ldcg, never
// the non-coherent path, so a block cannot see a stale line after the
// barrier.
//
// What bounds it on the card: the per-cell arithmetic, as in K1, plus a
// grid barrier a step; the 34^2 load of a 32^2 tile adds 13 % of reads,
// which hit L2 while the state fits there. Speed (TMA, clusters with DSMEM,
// an L2 persisting window) is later work.

#include "gs_tile.cuh"

namespace {

constexpr int HALO = 1;  // one step per barrier

__global__ void __launch_bounds__(gs::BLOCK_X * gs::BLOCK_Y)
resident_kernel(float* u0, float* v0, float* u1, float* v1, int rows,
                int cols, int n_steps, int naive, gs::Constants k,
                unsigned long long* barrier) {
  __shared__ gs::Window<HALO> s;
  const int tiles_x = (cols + gs::TILE - 1) / gs::TILE;
  const int n_tiles = tiles_x * ((rows + gs::TILE - 1) / gs::TILE);
  for (int st = 0; st < n_steps; ++st) {
    const bool odd = st & 1;
    const float* in_u = odd ? u1 : u0;
    const float* in_v = odd ? v1 : v0;
    float* out_u = odd ? u0 : u1;
    float* out_v = odd ? v0 : v1;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      gs::step_tile<HALO>(in_u, in_v, out_u, out_v, t / tiles_x, t % tiles_x,
                          rows, cols, 1, naive, k, s);
    }
    if (st + 1 < n_steps) gs::grid_barrier(barrier, st + 1);
  }
}

int max_blocks_cache[gs::MAX_DEVICES];  // 0 = not known yet

}  // namespace

extern "C" {

// The most blocks one cooperative launch of the kernel may have on
// `device` (negative: minus the CUDA error).
int gs_resident_max_blocks(int device) {
  return gs::max_blocks_or_error(resident_kernel, device, max_blocks_cache);
}

// Enqueues one cooperative launch of `n_steps` steps on `stream`, from pair
// (u0, v0); the result is in (u0, v0) when n_steps is even, else in
// (u1, v1). `barrier` is one zeroed 64-bit device word. `grid_blocks` <= 0
// takes the co-resident maximum (capped at the tile count); a larger grid
// than the card can hold is refused with cudaErrorCooperativeLaunchTooLarge.
// Returns the CUDA error (0 when the launch was accepted).
int gs_resident_multistep(float* u0, float* v0, float* u1, float* v1,
                          int rows, int cols, int n_steps, int naive,
                          int device, float w0, float w1, float w2, float w3,
                          float w4, float w5, float w6, float w7, float w8,
                          float du, float dv, float feed, float min_feed_kill,
                          float dt, int grid_blocks, void* barrier,
                          void* stream) {
  if (rows < 1 || cols < 1 || n_steps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gs::Constants k = {{w0, w1, w2, w3, w4, w5, w6, w7, w8},
                     du, dv, feed, min_feed_kill, dt};
  unsigned long long* counter = static_cast<unsigned long long*>(barrier);
  void* args[] = {&u0, &v0, &u1, &v1, &rows, &cols, &n_steps, &naive, &k,
                  &counter};
  return static_cast<int>(gs::launch_persistent(
      resident_kernel, args, rows, cols, grid_blocks, device, max_blocks_cache,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
