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
//     walks its share of the 64x64 tiles on the packed Hopper stepper
//     (gs_packed_sm90.cuh: packed_time_block): the tile's 80^2 window of
//     both species in dynamic shared memory (two buffers, 102,400 B, 512
//     threads, two blocks an SM), register strips of 4 cells that keep the
//     row pass out of shared memory, one __syncthreads() a step, and no
//     domain test on tiles whose window lies inside the domain (82 % of the
//     tiles at 1080x1920, 94 % at 4096^2).
//   - Windows load with cp.async.cg (16 B) and __ldcg for ragged cells:
//     coherent, since in block t a tile reads what other blocks wrote in
//     t - 1. Once a tile's last step is done, the buffer that held that
//     step's input is free, and the next tile's window starts loading into
//     it before the finished tile is written out. A time block's first tile
//     loads after the grid barrier.
//   - A grid barrier ends each time block.
//   - When n_blocks is odd the state ends in slot 1, and a last pass copies
//     slot 1 to slot 0 (megakernel.py:24-31).
//
// Why reads come after writes: time block t reads only slot t % 2 and
// writes only slot 1 - t % 2, so within a block no tile reads what another
// writes. The barrier at the end of block t orders every write of t before
// every read of t + 1 (which reads the slot t wrote), and every read of t
// before block t + 1 writes slot t % 2 again; no window load is issued
// before the barrier that precedes its time block. The final copy runs
// after the barrier of the last block, so it reads slot 1 complete. Reads
// bypass L1, so a block cannot see a stale line after the barrier.
//
// What bounds it on the card: instruction issue for the packed step's 34
// float32 operations a cell-step (30, and the strips' recompute of their
// neighbours' row pass) and the halo recompute (1.24x the useful
// cell-steps over 8 steps); each time block's state passes through L2 (or
// HBM beyond L2) once. gs_packed_mega_ablation runs the kernel with one
// part of the design taken out, or the first form (part 0: gs_packed.cuh's
// step_packed_tile<8> on 32x32 tiles, kept unchanged as the in-call
// yardstick of the old code), for chip_smoke.py to time what each part
// buys.

#include "gs_packed_sm90.cuh"

namespace {

namespace sm90 = gs::sm90;

constexpr int HALO = sm90::HALO;  // most steps per time block (MEGA_STEPS)

// SPECIALIZE = false takes every tile as an edge tile, PREFETCH = false
// loads each window only when its tile is due (ablations).
template <typename G, bool SPECIALIZE, bool PREFETCH>
__global__ void __launch_bounds__(G::NT, G::BLOCKS_AT_64_REGS)
packed_mega_kernel(float* x_pair, int rows, int cols, int n_blocks,
                   int steps, gs::PackedConstants k, int aligned,
                   unsigned long long* barrier) {
  extern __shared__ float4 window[];  // buffers [2] x species [2]
  sm90::packed_mega_run<SPECIALIZE, PREFETCH>(
      sm90::FixedShape<G>{}, x_pair, rows, cols, n_blocks, steps, k, aligned,
      barrier, reinterpret_cast<float*>(window));
}

// The first form (gs_packed.cuh: step_packed_tile<8>, 32x32 tiles in 48^2
// windows of static shared memory, 256 threads, two passes a step), as K6
// ran before the packed Hopper stepper: gs_packed_mega_ablation's part 0.
__global__ void __launch_bounds__(gs::BLOCK_X * gs::BLOCK_Y)
first_form_kernel(float* x_pair, int rows, int cols, int n_blocks,
                  int steps, gs::PackedConstants k,
                  unsigned long long* barrier) {
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
    sm90::packed_copy_slot(x_pair, plane, gs::BLOCK_X * gs::BLOCK_Y,
                           threadIdx.y * gs::BLOCK_X + threadIdx.x);
  }
}

int first_form_cache[gs::MAX_DEVICES];  // 0 = not known yet

struct Call {
  float* x_pair;
  int rows, cols, n_blocks, steps, device;
  gs::PackedConstants k;
  int grid_blocks;
  unsigned long long* barrier;
  cudaStream_t stream;
};

// One instantiation of packed_mega_kernel: its co-resident blocks (cached
// per device; the first query also allows it its dynamic shared memory) and
// its launch. `grid_blocks` <= 0 takes the co-resident maximum (capped at
// the tile count); a larger grid than the card can hold is refused with
// cudaErrorCooperativeLaunchTooLarge, and nothing falls back.
template <typename G, bool SPECIALIZE = true, bool PREFETCH = true>
struct Mega {
  static int* cache() {
    static int blocks[gs::MAX_DEVICES];  // 0 = not known yet
    return blocks;
  }

  static int max_blocks(int device) {
    return gs::max_blocks_or_error(packed_mega_kernel<G, SPECIALIZE, PREFETCH>,
                                   device, cache(), G::NT, G::BYTES);
  }

  static cudaError_t launch(const Call& c) {
    Call a = c;
    const size_t plane = static_cast<size_t>(c.rows) * 2 * c.cols;
    int aligned =
        sm90::packed_aligned(c.cols, c.x_pair, c.x_pair + plane);
    void* args[] = {&a.x_pair, &a.rows, &a.cols,  &a.n_blocks,
                    &a.steps,  &a.k,    &aligned, &a.barrier};
    return gs::launch_persistent(
        packed_mega_kernel<G, SPECIALIZE, PREFETCH>, args, c.rows, c.cols,
        c.grid_blocks, c.device, cache(), c.stream, dim3(G::NT), G::BYTES,
        G::TR);
  }
};

// The C interface's checks; the call, or an error in `err`.
Call make_call(float* x_pair, int rows, int cols, int n_blocks, int steps,
               int device, const gs::PackedConstants& k, int grid_blocks,
               void* barrier, void* stream, cudaError_t* err) {
  *err = cudaSuccess;
  if (rows < 1 || cols < 1 || n_blocks < 1 || steps < 1 || steps > HALO) {
    *err = cudaErrorInvalidValue;
  }
  return {x_pair, rows, cols, n_blocks, steps, device, k, grid_blocks,
          static_cast<unsigned long long*>(barrier),
          static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

int gs_packed_mega_max_steps() { return HALO; }

// The most blocks one cooperative launch of the kernel may have on
// `device` (negative: minus the CUDA error).
int gs_packed_mega_max_blocks(int device) {
  return Mega<sm90::Main>::max_blocks(device);
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
  cudaError_t err;
  const Call c = make_call(x_pair, rows, cols, n_blocks, steps, device,
                           {h0, h1, cu, cv, e, au, bv, qu, qv}, grid_blocks,
                           barrier, stream, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(Mega<sm90::Main>::launch(c));
}

// gs_packed_mega_multistep with one part of the design taken out, for
// timing what it buys: 0 the first form's kernel, 1 no interior tiles, 2 no
// prefetch of the next tile's window, 3 32x32 tiles in 48x48 windows. The
// result is the same.
int gs_packed_mega_ablation(float* x_pair, int rows, int cols, int n_blocks,
                            int steps, int device, float h0, float h1,
                            float cu, float cv, float e, float au, float bv,
                            float qu, float qv, int grid_blocks,
                            void* barrier, void* stream, int part) {
  cudaError_t err;
  Call c = make_call(x_pair, rows, cols, n_blocks, steps, device,
                     {h0, h1, cu, cv, e, au, bv, qu, qv}, grid_blocks,
                     barrier, stream, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (part) {
    case 0: {
      void* args[] = {&c.x_pair, &c.rows,  &c.cols,   &c.n_blocks,
                      &c.steps,  &c.k,     &c.barrier};
      err = gs::launch_persistent(first_form_kernel, args, c.rows, c.cols,
                                  c.grid_blocks, c.device, first_form_cache,
                                  c.stream);
      break;
    }
    case 1: err = Mega<sm90::Main, false>::launch(c); break;
    case 2: err = Mega<sm90::Main, true, false>::launch(c); break;
    case 3: err = Mega<sm90::Small>::launch(c); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
