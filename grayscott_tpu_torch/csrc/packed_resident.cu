// K5, the species-packed resident multistep, written by hand for Hopper
// (sm_90a).
//
// Replaces grayscott_tpu/ops/pallas_stencil.py:_packed_resident_kernel (the
// TPU kernel that packed_resident_multistep_impl drives): the packed state
// [U | V] advanced by a run-time number of zero-boundary steps of the
// separable stencil in one launch. On the TPU the whole domain sits in
// VMEM; here, as in K3, the state stays in the 50 MB L2 where it fits, and
// one persistent cooperative launch runs every step. It has K3's code shape
// (resident.cu) on the packed Hopper stepper (gs_packed_sm90.cuh):
//
//   - The grid is at most the co-resident block count (occupancy x SMs), so
//     every block is on the card at once and a grid-wide barrier is safe;
//     cudaLaunchCooperativeKernel refuses the launch otherwise.
//   - Step s reads buffer s % 2 and writes buffer 1 - s % 2. Each block
//     walks its share of the 32x32 tiles. A tile's 34^2 window of both
//     species (its one-cell ring) sits in shared memory; while the block
//     steps it, the window of its next tile is already loading into a
//     second buffer with cp.async (gs_tile_sm90.cuh: load_window). Each
//     thread steps a strip of R cells of one column with the row pass in
//     registers (step_packed_strip: no domain test on interior tiles, the
//     domain's zeros written on edge tiles) and writes the new values
//     straight to global memory. No halo is carried across steps and
//     nothing is computed twice but the strips' shared row-pass rows.
//   - A grid barrier follows every step but the last.
//   - The block's walk (tiles a row, tile count) lives in shared memory and
//     is read there once a tile: K9's code shape (ilpsplit.cu).
//
// Why reads come after writes: step s reads only buffer s % 2 and writes
// only buffer 1 - s % 2, so within a step no block reads what another
// writes. The barrier after step s orders every write of step s before
// every read of step s + 1 (which reads the buffer step s wrote), and every
// read of step s before step s + 1 writes buffer s % 2 again; the prefetch
// of a step's first tile is issued only after that barrier. Window loads
// bypass L1 (16-byte cp.async.cg, and __ldcg for the ragged cells), so a
// block cannot see a stale line after the barrier.
//
// What bounds it on the card: instruction issue for the packed step's
// float32 operations, plus a grid barrier a step, while the state fits L2;
// beyond it (4096^2), the state's pass through HBM every step (16 B a cell,
// and the 34^2 window of a 32^2 tile adds 13 % of reads): about 2.6 ms per
// 32 steps at 3.35 TB/s, whatever the stepper. gs_packed_resident_ablation
// runs the kernel with one part of the design taken out, or the first form
// (part 0), for chip_smoke.py to time what each part buys.

#include "gs_packed_sm90.cuh"

namespace {

namespace sm90 = gs::sm90;

constexpr int TILE = gs::TILE;  // 32: the tile edge
constexpr int WR = TILE + 2;    // window rows: the tile and its ring
// Window columns in shared memory: the 16-byte span [32j - 4, 32j + 36)
// around the ring [32j - 1, 32j + 33), so that rows load as 16-byte copies;
// window column lc (0..33) lies at shared column lc + LEFT.
constexpr int PITCH = TILE + 8;
constexpr int LEFT = 3;
constexpr int CELLS = WR * PITCH;  // of one buffer of one species
// One strip of R rows of one column a thread: the block is the tile.
constexpr int R = 4;
constexpr int NT = TILE * (TILE / R);

// The block's walk over the tiles, in shared memory.
struct Walk {
  int tiles_x, n_tiles;
};

// Start loading the window of tile t of the packed state x into (su, sv).
__device__ __forceinline__ void load_tile(const float* x, float* su,
                                          float* sv, int t, const Walk& w,
                                          int rows, int cols, bool aligned) {
  const int ti = t / w.tiles_x, tj = t - ti * w.tiles_x;
  sm90::load_window<NT, true>(gs::FlatLayout{2 * cols}, x, x + cols, su, sv,
                              gs::Fixed<WR>{}, gs::Fixed<PITCH>{},
                              ti * TILE - 1, tj * TILE - 4, rows, cols,
                              aligned);
  sm90::cp_async_commit();
}

// Step tile t from its window (su, sv) into the packed state `out`.
template <bool SPECIALIZE>
__device__ __forceinline__ void step_tile(const float* su, const float* sv,
                                          float* out, int t, const Walk& w,
                                          int rows, int cols,
                                          const gs::PackedConstants& k) {
  const int ti = t / w.tiles_x, tj = t - ti * w.tiles_x;
  const int lane = threadIdx.x % TILE, strip = threadIdx.x / TILE;
  const int gr0 = ti * TILE + strip * R, gc = tj * TILE + lane;
  const int lr0 = 1 + strip * R, lc = 1 + lane;  // window cell
  const sm90::StripAt at = {gr0, gc, rows, cols};
  const size_t pitch = 2 * static_cast<size_t>(cols);
  float* pu = out + static_cast<size_t>(gr0) * pitch + gc;
  float* pv = pu + cols;
  if (SPECIALIZE && ti > 0 && tj > 0 && (ti + 1) * TILE + 1 <= rows &&
      (tj + 1) * TILE + 1 <= cols) {  // the window lies inside the domain
    sm90::step_packed_strip<R, false>(
        su + LEFT, sv + LEFT, gs::Fixed<PITCH>{}, lr0, lc, R, at, k,
        [&](int i, float un, float vn) {
          pu[i * pitch] = un;
          pv[i * pitch] = vn;
        });
  } else {
    sm90::step_packed_strip<R, true>(
        su + LEFT, sv + LEFT, gs::Fixed<PITCH>{}, lr0, lc, R, at, k,
        [&](int i, float un, float vn) {
          if (gr0 + i < rows && gc < cols) {  // the domain's cells only
            pu[i * pitch] = un;
            pv[i * pitch] = vn;
          }
        });
  }
}

// SPECIALIZE = false takes every tile as an edge tile, PREFETCH = false
// loads each window only when its tile is due (ablations).
template <bool SPECIALIZE, bool PREFETCH>
__global__ void __launch_bounds__(NT)
packed_resident_kernel(float* x0, float* x1, int rows, int cols,
                       int n_steps, gs::PackedConstants k, int aligned,
                       unsigned long long* barrier) {
  // window buffers [2] x species [2], 16-byte rows
  __shared__ __align__(16) float window[2][2][CELLS];
  __shared__ Walk w;
  if (threadIdx.x == 0) {
    w.tiles_x = (cols + TILE - 1) / TILE;
    w.n_tiles = w.tiles_x * ((rows + TILE - 1) / TILE);
  }
  __syncthreads();

  for (int st = 0; st < n_steps; ++st) {
    const float* in = (st & 1) ? x1 : x0;
    float* out = (st & 1) ? x0 : x1;
    int t = blockIdx.x, b = 0;
    if (PREFETCH && t < w.n_tiles) {
      load_tile(in, window[0][0], window[0][1], t, w, rows, cols, aligned);
    }
    for (; t < w.n_tiles; t += gridDim.x) {
      const int next = t + gridDim.x;
      if (!PREFETCH) {
        load_tile(in, window[0][0], window[0][1], t, w, rows, cols, aligned);
        sm90::cp_async_wait<0>();
      } else if (next < w.n_tiles) {
        load_tile(in, window[b ^ 1][0], window[b ^ 1][1], next, w, rows,
                  cols, aligned);
        sm90::cp_async_wait<1>();
      } else {
        sm90::cp_async_wait<0>();
      }
      __syncthreads();  // the window of tile t is in place
      step_tile<SPECIALIZE>(window[b][0], window[b][1], out, t, w, rows,
                            cols, k);
      __syncthreads();  // and free for the window after next
      if (PREFETCH) b ^= 1;
    }
    if (st + 1 < n_steps) gs::grid_barrier(barrier, st + 1);
  }
}

// The first form (gs_packed.cuh: step_packed_tile<1>, a 34^2 window of a
// 32x32 tile loaded with __ldcg, two passes through shared memory),
// as K5 ran before the packed Hopper stepper: gs_packed_resident_ablation's
// part 0.
__global__ void __launch_bounds__(gs::BLOCK_X * gs::BLOCK_Y)
first_form_kernel(float* x0, float* x1, int rows, int cols, int n_steps,
                  gs::PackedConstants k, unsigned long long* barrier) {
  __shared__ gs::PackedWindow<1> s;
  const int tiles_x = (cols + gs::TILE - 1) / gs::TILE;
  const int n_tiles = tiles_x * ((rows + gs::TILE - 1) / gs::TILE);
  for (int st = 0; st < n_steps; ++st) {
    const float* in = (st & 1) ? x1 : x0;
    float* out = (st & 1) ? x0 : x1;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      gs::step_packed_tile<1>(in, out, t / tiles_x, t % tiles_x, rows, cols,
                              1, k, s);
    }
    if (st + 1 < n_steps) gs::grid_barrier(barrier, st + 1);
  }
}

int first_form_cache[gs::MAX_DEVICES];  // 0 = not known yet

struct Call {
  float *x0, *x1;
  int rows, cols, n_steps, device;
  gs::PackedConstants k;
  int grid_blocks;
  unsigned long long* barrier;
  cudaStream_t stream;
};

// One instantiation of packed_resident_kernel: its co-resident blocks
// (cached per device) and its launch. `grid_blocks` <= 0 takes the
// co-resident maximum (capped at the tile count); a larger grid than the
// card can hold is refused with cudaErrorCooperativeLaunchTooLarge, and
// nothing falls back.
template <bool SPECIALIZE = true, bool PREFETCH = true>
struct Resident {
  static int* cache() {
    static int blocks[gs::MAX_DEVICES];  // 0 = not known yet
    return blocks;
  }

  static int max_blocks(int device) {
    return gs::max_blocks_or_error(
        packed_resident_kernel<SPECIALIZE, PREFETCH>, device, cache(), NT);
  }

  static cudaError_t launch(const Call& c) {
    Call a = c;
    int aligned = sm90::packed_aligned(c.cols, c.x0, c.x1);
    void* args[] = {&a.x0,      &a.x1, &a.rows,   &a.cols,
                    &a.n_steps, &a.k,  &aligned, &a.barrier};
    return gs::launch_persistent(
        packed_resident_kernel<SPECIALIZE, PREFETCH>, args, c.rows, c.cols,
        c.grid_blocks, c.device, cache(), c.stream, dim3(NT), 0, TILE);
  }
};

// The C interface's checks; the call, or an error in `err`.
Call make_call(float* x0, float* x1, int rows, int cols, int n_steps,
               int device, const gs::PackedConstants& k, int grid_blocks,
               void* barrier, void* stream, cudaError_t* err) {
  *err = cudaSuccess;
  if (rows < 1 || cols < 1 || n_steps < 1) *err = cudaErrorInvalidValue;
  return {x0, x1, rows, cols, n_steps, device, k, grid_blocks,
          static_cast<unsigned long long*>(barrier),
          static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

// The most blocks one cooperative launch of the kernel may have on
// `device` (negative: minus the CUDA error).
int gs_packed_resident_max_blocks(int device) {
  return Resident<>::max_blocks(device);
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
  cudaError_t err;
  const Call c = make_call(x0, x1, rows, cols, n_steps, device,
                           {h0, h1, cu, cv, e, au, bv, qu, qv}, grid_blocks,
                           barrier, stream, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(Resident<>::launch(c));
}

// gs_packed_resident_multistep with one part of the design taken out, for
// timing what it buys: 0 the first form's kernel, 1 no interior tiles, 2 no
// prefetch of the next tile's window. The result is the same.
int gs_packed_resident_ablation(float* x0, float* x1, int rows, int cols,
                                int n_steps, int device, float h0, float h1,
                                float cu, float cv, float e, float au,
                                float bv, float qu, float qv,
                                int grid_blocks, void* barrier, void* stream,
                                int part) {
  cudaError_t err;
  Call c = make_call(x0, x1, rows, cols, n_steps, device,
                     {h0, h1, cu, cv, e, au, bv, qu, qv}, grid_blocks,
                     barrier, stream, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (part) {
    case 0: {
      void* args[] = {&c.x0, &c.x1, &c.rows,   &c.cols,
                      &c.n_steps, &c.k, &c.barrier};
      err = gs::launch_persistent(first_form_kernel, args, c.rows, c.cols,
                                  c.grid_blocks, c.device, first_form_cache,
                                  c.stream);
      break;
    }
    case 1: err = Resident<false>::launch(c); break;
    case 2: err = Resident<true, false>::launch(c); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
