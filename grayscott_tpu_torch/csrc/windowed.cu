// K1, the windowed Gray-Scott multistep, written by hand for Hopper (sm_90a).
//
// Replaces grayscott_tpu/ops/pallas_stencil.py:_kernel (the TPU kernel that
// multistep_impl and run_blocks drive). One launch advances the (rows, cols)
// domain by `steps` <= HALO Gray-Scott steps:
//
//   - a 2-D grid of TR x TC output tiles; each block loads the
//     (TR + 2*HALO) x (TC + 2*HALO) window of U and V around its tile into
//     dynamic shared memory with cp.async, cells outside the domain as 0.0;
//   - step s computes window cells [s+1, W-s-1) from one shared buffer into
//     the other (the valid region shrinks by one cell a step, so after
//     `steps` <= HALO steps the tile is still exact), in register strips of
//     R cells of one column (gs_tile_sm90.cuh: step_strip);
//   - a tile whose window lies inside the domain steps the fixed term list
//     with no boundary arithmetic; the others test each cell, run the
//     naive boundary's clamped per-cell code of gs_tile.cuh on the domain's
//     edge, and write cells outside the domain as exactly 0.0 every step
//     (the role of `dommask` in pallas_stencil.py): the zero boundary reads
//     them;
//   - the tile, masked to the domain, is written to u_out / v_out.
//
// What bounds it on the card: each launch reads and writes U and V once,
// 16 B per cell per HALO steps, about 2 B per cell-step at HALO = 8, far
// below what HBM at 3.35 TB/s feeds. The limit is instruction issue: the
// float32 operations of the tree, the shared-memory traffic, and the halo
// recompute. The design: 64^2 tiles in 80^2 windows (102,400 B of dynamic
// shared memory for two buffers of two species, two blocks of 512 threads
// an SM), which recompute 1.24x the useful cell-steps over 8 steps where
// 32^2 tiles in 48^2 windows recomputed 1.51x; strips of 4 cells (3 shared
// loads a species a new row instead of 9); the tap set fixed at compile
// time; and no boundary arithmetic on interior tiles (82 % of the tiles at
// 1080x1920, 94 % at 4096^2). Tile shape, threads and strip length were
// chosen on the card (PERF.md §6). wgmma does not apply (no matrix
// product). gs_windowed_ablation runs the kernel with one part of the
// design taken out, for chip_smoke.py to time what each part buys.

#include "gs_tile_sm90.cuh"

namespace {

namespace sm90 = gs::sm90;

constexpr int HALO = sm90::HALO;  // most steps per launch (K)

using sm90::Geometry;
using sm90::Main;

// SPECIALIZE = false takes every tile as an edge tile (an ablation).
template <typename G, int TAPS, bool NAIVE, bool SPECIALIZE = true>
__global__ void __launch_bounds__(G::NT, G::MIN_BLOCKS)
windowed_kernel(const float* u, const float* v, float* u_out, float* v_out,
                int rows, int cols, int steps, gs::Constants k, int aligned) {
  extern __shared__ float4 window[];  // buffers [2] x species [2]
  float* const base = reinterpret_cast<float*>(window);
  const int r0 = blockIdx.y * G::TR - HALO, c0 = blockIdx.x * G::TC - HALO;

  sm90::load_window<G::WR, G::WC / 4, G::WC, G::NT, false>(
      gs::FlatLayout{cols}, u, v, base, base + G::CELLS, r0, c0, rows, cols,
      aligned);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncthreads();

  const bool interior =
      SPECIALIZE && sm90::window_inside<G>(r0, c0, rows, cols);
  int cur = 0;
  for (int st = 0; st < steps; ++st) {
    const float* in_u = base + 2 * cur * G::CELLS;
    float* out_u = base + 2 * (cur ^ 1) * G::CELLS;
    if (interior) {
      sm90::step_window<G, TAPS, NAIVE, true>(in_u, in_u + G::CELLS, out_u,
                                              out_u + G::CELLS, st + 1, r0,
                                              c0, rows, cols, k);
    } else {
      sm90::step_window<G, TAPS, NAIVE, false>(in_u, in_u + G::CELLS, out_u,
                                               out_u + G::CELLS, st + 1, r0,
                                               c0, rows, cols, k);
    }
    __syncthreads();
    cur ^= 1;
  }

  const float* fu = base + 2 * cur * G::CELLS;
  const float* fv = fu + G::CELLS;
  for (int idx = threadIdx.x; idx < G::TR * G::TC; idx += G::NT) {
    const int lr = HALO + idx / G::TC, lc = HALO + idx % G::TC;
    const int gr = r0 + lr, gc = c0 + lc;
    if (gr < rows && gc < cols) {
      const size_t g = static_cast<size_t>(gr) * cols + gc;
      u_out[g] = fu[lr * G::WC + lc];
      v_out[g] = fv[lr * G::WC + lc];
    }
  }
}

struct Call {
  const float *u, *v;
  float *u_out, *v_out;
  int rows, cols, steps, naive, device;
  gs::Constants k;
  cudaStream_t stream;
};

// One launch of windowed_kernel<G, TAPS, NAIVE, SPECIALIZE>, after allowing
// it the dynamic shared memory it needs (once per device): a launch that
// asks for more than 48 KB without that is refused, and the refusal is
// returned.
template <typename G, int TAPS, bool NAIVE, bool SPECIALIZE = true>
cudaError_t launch_one(const Call& c) {
  static bool allowed[gs::MAX_DEVICES];
  auto kernel = windowed_kernel<G, TAPS, NAIVE, SPECIALIZE>;
  if (!allowed[c.device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(G::BYTES));
    if (err != cudaSuccess) return err;
    allowed[c.device] = true;
  }
  const dim3 grid((c.cols + G::TC - 1) / G::TC, (c.rows + G::TR - 1) / G::TR);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const int aligned = sm90::rows_aligned(c.cols, c.u, c.v, c.u_out, c.v_out);
  kernel<<<grid, G::NT, G::BYTES, c.stream>>>(c.u, c.v, c.u_out, c.v_out,
                                              c.rows, c.cols, c.steps, c.k,
                                              aligned);
  return cudaGetLastError();
}

template <typename G, int TAPS, bool SPECIALIZE = true>
cudaError_t launch(const Call& c) {
  return c.naive ? launch_one<G, TAPS, true, SPECIALIZE>(c)
                 : launch_one<G, TAPS, false, SPECIALIZE>(c);
}

template <int TAPS>
struct Launch {
  static cudaError_t run(const Call& c) { return launch<Main, TAPS>(c); }
};

// The C interface's checks; the call, or an invalid-value error in `err`.
Call make_call(const float* u, const float* v, float* u_out, float* v_out,
               int rows, int cols, int steps, int naive, int device,
               const float* w, float du, float dv, float feed,
               float min_feed_kill, float dt, void* stream,
               cudaError_t* err) {
  *err = cudaSuccess;
  if (rows < 1 || cols < 1 || steps < 1 || steps > HALO || device < 0 ||
      device >= gs::MAX_DEVICES) {
    *err = cudaErrorInvalidValue;
  } else {
    *err = cudaSetDevice(device);
  }
  return {u, v, u_out, v_out, rows, cols, steps, naive, device,
          {{w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8]},
           du, dv, feed, min_feed_kill, dt},
          static_cast<cudaStream_t>(stream)};
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
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  cudaError_t err;
  const Call c = make_call(u, v, u_out, v_out, rows, cols, steps, naive,
                           device, w, du, dv, feed, min_feed_kill, dt, stream,
                           &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sm90::dispatch_taps<Launch>(c.k, c));
}

// gs_windowed_multistep with one part of the design taken out, for timing
// what it buys (weights of the default stencil's tap set only): 1 no
// interior tiles, 2 the tap set tested at run time, 3 32x32 tiles in 48x48
// windows (the former tile shape), 4 32x128 tiles. The result is the same.
int gs_windowed_ablation(const float* u, const float* v, float* u_out,
                         float* v_out, int rows, int cols, int steps,
                         int naive, int device, float w0, float w1, float w2,
                         float w3, float w4, float w5, float w6, float w7,
                         float w8, float du, float dv, float feed,
                         float min_feed_kill, float dt, void* stream,
                         int part) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  cudaError_t err;
  const Call c = make_call(u, v, u_out, v_out, rows, cols, steps, naive,
                           device, w, du, dv, feed, min_feed_kill, dt, stream,
                           &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sm90::tap_mask(c.k) != sm90::TAPS_RING) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (part) {
    case 1: err = launch<Main, sm90::TAPS_RING, false>(c); break;
    case 2: err = launch<Main, sm90::TAPS_ANY>(c); break;
    case 3: err = launch<sm90::Small, sm90::TAPS_RING>(c); break;
    case 4: err = launch<Geometry<32, 128, 512, 4>, sm90::TAPS_RING>(c); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
