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
//     walks its share of the 32x32 tiles. A tile's 34^2 window (its
//     one-cell ring) sits in shared memory; while the block steps it, the
//     window of its next tile is already loading into a second buffer with
//     cp.async (gs_tile_sm90.cuh: load_window), which hides the reload from
//     L2 where the state fits it. Each thread steps a strip of R cells of
//     one column in registers (step_strip: the fixed term list on interior
//     tiles, per-cell tests on edge tiles) and writes the new values
//     straight to global memory. No halo is carried across steps and
//     nothing is computed twice.
//   - A grid barrier follows every step but the last.
//   - The block's walk (tiles a row, tile count) lives in shared memory and
//     is read there once a tile: K9's code shape (ilpsplit.cu), which ran
//     K3's steps bitwise 4.7-5.7 % faster than K3 in that form.
//
// Why reads come after writes: step s reads only pair s % 2 and writes only
// pair 1 - s % 2, so within a step no block reads what another writes. The
// barrier after step s orders every write of step s before every read of
// step s + 1 (which reads the pair step s wrote), and every read of step s
// before step s + 1 writes pair s % 2 again; the prefetch of a step's first
// tile is issued only after that barrier. Window loads bypass L1 (16-byte
// cp.async.cg, and __ldcg for the ragged cells), so a block cannot see a
// stale line after the barrier.
//
// What bounds it on the card: instruction issue for the float32 operations
// of the tree, plus a grid barrier a step, while the state fits L2; beyond
// it (4096^2), the state's pass through HBM every step (16 B a cell, and the
// 34^2 window of a 32^2 tile adds 13 % of reads). Strip length and threads
// were chosen on the card (PERF.md §6). gs_resident_ablation runs the
// kernel with one part of the design taken out, for chip_smoke.py to time
// what each part buys.

#include "gs_tile_sm90.cuh"

namespace {

namespace sm90 = gs::sm90;
namespace ring = sm90::ring;  // the tile: 32^2 in a 34^2 window

// The block's walk over the tiles, in shared memory.
struct Walk {
  int tiles_x, n_tiles;
};

// SPECIALIZE = false takes every tile as an edge tile, PREFETCH = false
// loads each window only when its tile is due (ablations).
template <int TAPS, bool NAIVE, bool SPECIALIZE = true, bool PREFETCH = true>
__global__ void __launch_bounds__(ring::NT)
resident_kernel(float* u0, float* v0, float* u1, float* v1, int rows,
                int cols, int n_steps, gs::Constants k, int aligned,
                unsigned long long* barrier) {
  // window buffers [2] x species [2], 16-byte rows
  __shared__ __align__(16) float window[2][2][ring::CELLS];
  __shared__ Walk w;
  if (threadIdx.x == 0) {
    w.tiles_x = (cols + ring::TILE - 1) / ring::TILE;
    w.n_tiles = w.tiles_x * ((rows + ring::TILE - 1) / ring::TILE);
  }
  __syncthreads();

  for (int st = 0; st < n_steps; ++st) {
    const bool odd = st & 1;
    const float* in_u = odd ? u1 : u0;
    const float* in_v = odd ? v1 : v0;
    float* out_u = odd ? u0 : u1;
    float* out_v = odd ? v0 : v1;
    int t = blockIdx.x, b = 0;
    if (PREFETCH && t < w.n_tiles) {
      ring::load_tile(in_u, in_v, window[0][0], window[0][1], t, w, rows,
                      cols, aligned);
    }
    for (; t < w.n_tiles; t += gridDim.x) {
      const int next = t + gridDim.x;
      if (!PREFETCH) {
        ring::load_tile(in_u, in_v, window[0][0], window[0][1], t, w, rows,
                        cols, aligned);
        sm90::cp_async_wait<0>();
      } else if (next < w.n_tiles) {
        ring::load_tile(in_u, in_v, window[b ^ 1][0], window[b ^ 1][1], next,
                        w, rows, cols, aligned);
        sm90::cp_async_wait<1>();
      } else {
        sm90::cp_async_wait<0>();
      }
      __syncthreads();  // the window of tile t is in place
      ring::step_tile<TAPS, NAIVE, SPECIALIZE>(window[b][0], window[b][1],
                                               out_u, out_v, t, w, rows,
                                               cols, k);
      __syncthreads();  // and free for the window after next
      if (PREFETCH) b ^= 1;
    }
    if (st + 1 < n_steps) gs::grid_barrier(barrier, st + 1);
  }
}

// Co-resident blocks of resident_kernel<TAPS, NAIVE, SPECIALIZE, PREFETCH>
// on `device` (occupancy x SMs), cached per device.
template <int TAPS, bool NAIVE, bool SPECIALIZE = true, bool PREFETCH = true>
cudaError_t max_blocks(int device, int* out) {
  static int cache[gs::MAX_DEVICES];  // 0 = not known yet
  if (cache[device] == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, resident_kernel<TAPS, NAIVE, SPECIALIZE, PREFETCH>,
        ring::NT, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    cache[device] = per_sm * sms;
  }
  *out = cache[device];
  return cudaSuccess;
}

struct Call {
  float *u0, *v0, *u1, *v1;
  int rows, cols, n_steps, naive, device;
  gs::Constants k;
  int grid_blocks;
  unsigned long long* barrier;
  cudaStream_t stream;
};

// One cooperative launch: `grid_blocks` <= 0 takes the co-resident maximum
// (capped at the tile count); a larger grid than the card can hold is
// refused with cudaErrorCooperativeLaunchTooLarge, and nothing falls back.
template <int TAPS, bool NAIVE, bool SPECIALIZE, bool PREFETCH>
cudaError_t launch_one(const Call& c) {
  int grid = c.grid_blocks;
  if (grid <= 0) {
    const cudaError_t err =
        max_blocks<TAPS, NAIVE, SPECIALIZE, PREFETCH>(c.device, &grid);
    if (err != cudaSuccess) return err;
    const long long tiles =
        static_cast<long long>((c.cols + ring::TILE - 1) / ring::TILE) *
        ((c.rows + ring::TILE - 1) / ring::TILE);
    if (tiles < grid) grid = static_cast<int>(tiles);
  }
  Call a = c;
  int aligned = sm90::rows_aligned(c.cols, c.u0, c.v0, c.u1, c.v1);
  void* args[] = {&a.u0, &a.v0, &a.u1, &a.v1, &a.rows, &a.cols,
                  &a.n_steps, &a.k, &aligned, &a.barrier};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(
          resident_kernel<TAPS, NAIVE, SPECIALIZE, PREFETCH>),
      dim3(grid), dim3(ring::NT), args, 0, c.stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not report it
    return err;
  }
  return cudaGetLastError();
}

template <int TAPS, bool SPECIALIZE = true, bool PREFETCH = true>
cudaError_t launch(const Call& c) {
  return c.naive ? launch_one<TAPS, true, SPECIALIZE, PREFETCH>(c)
                 : launch_one<TAPS, false, SPECIALIZE, PREFETCH>(c);
}

template <int TAPS>
struct Launch {
  static cudaError_t run(const Call& c) { return launch<TAPS>(c); }
};

// The fewer of *least and the co-resident blocks of TAPS's instantiations.
template <int TAPS>
cudaError_t fewest_blocks(int device, int* least) {
  int naive = 0, zero = 0;
  cudaError_t err = max_blocks<TAPS, true>(device, &naive);
  if (err == cudaSuccess) err = max_blocks<TAPS, false>(device, &zero);
  const int fewer = naive < zero ? naive : zero;
  if (fewer < *least) *least = fewer;
  return err;
}

// The C interface's checks; the call, or an error in `err`.
Call make_call(float* u0, float* v0, float* u1, float* v1, int rows,
               int cols, int n_steps, int naive, int device, const float* w,
               float du, float dv, float feed, float min_feed_kill, float dt,
               int grid_blocks, void* barrier, void* stream,
               cudaError_t* err) {
  *err = cudaSuccess;
  if (rows < 1 || cols < 1 || n_steps < 1 || device < 0 ||
      device >= gs::MAX_DEVICES) {
    *err = cudaErrorInvalidValue;
  } else {
    *err = cudaSetDevice(device);
  }
  return {u0, v0, u1, v1, rows, cols, n_steps, naive, device,
          {{w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8]},
           du, dv, feed, min_feed_kill, dt},
          grid_blocks, static_cast<unsigned long long*>(barrier),
          static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

// The most blocks one cooperative launch of the kernel may have on
// `device`, whatever its weights and boundary (negative: minus the CUDA
// error).
int gs_resident_max_blocks(int device) {
  if (device < 0 || device >= gs::MAX_DEVICES) {
    return -static_cast<int>(cudaErrorInvalidDevice);
  }
  cudaError_t err = cudaSetDevice(device);
  int n = 1 << 30;
  if (err == cudaSuccess) err = fewest_blocks<sm90::TAPS_RING>(device, &n);
  if (err == cudaSuccess) err = fewest_blocks<sm90::TAPS_ALL>(device, &n);
  if (err == cudaSuccess) err = fewest_blocks<sm90::TAPS_CROSS>(device, &n);
  if (err == cudaSuccess) err = fewest_blocks<sm90::TAPS_ANY>(device, &n);
  return err == cudaSuccess ? n : -static_cast<int>(err);
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
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  cudaError_t err;
  const Call c = make_call(u0, v0, u1, v1, rows, cols, n_steps, naive, device,
                           w, du, dv, feed, min_feed_kill, dt, grid_blocks,
                           barrier, stream, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sm90::dispatch_taps<Launch>(c.k, c));
}

// gs_resident_multistep with one part of the design taken out, for timing
// what it buys (weights of the default stencil's tap set only): 1 no
// interior tiles, 2 the tap set tested at run time, 3 no prefetch of the
// next tile's window. The result is the same.
int gs_resident_ablation(float* u0, float* v0, float* u1, float* v1,
                         int rows, int cols, int n_steps, int naive,
                         int device, float w0, float w1, float w2, float w3,
                         float w4, float w5, float w6, float w7, float w8,
                         float du, float dv, float feed, float min_feed_kill,
                         float dt, int grid_blocks, void* barrier,
                         void* stream, int part) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  cudaError_t err;
  const Call c = make_call(u0, v0, u1, v1, rows, cols, n_steps, naive, device,
                           w, du, dv, feed, min_feed_kill, dt, grid_blocks,
                           barrier, stream, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sm90::tap_mask(c.k) != sm90::TAPS_RING) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (part) {
    case 1: err = launch<sm90::TAPS_RING, false>(c); break;
    case 2: err = launch<sm90::TAPS_ANY>(c); break;
    case 3: err = launch<sm90::TAPS_RING, true, false>(c); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
