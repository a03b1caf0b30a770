// K4, the species-packed windowed multistep, written by hand for Hopper
// (sm_90a).
//
// Replaces grayscott_tpu/ops/pallas_stencil.py:_packed_kernel (the TPU
// kernel that packed_multistep_impl and packed_run_blocks drive). One
// launch advances the packed (rows, 2*cols) state [U | V] by `steps` <=
// HALO zero-boundary steps of the separable stencil, in K1's code shape
// (windowed.cu) on the packed Hopper stepper (gs_packed_sm90.cuh):
//
//   - a 2-D grid of 64x64 output tiles (Main); each block loads the 80^2
//     window of U and V around its tile into dynamic shared memory with
//     cp.async (16-byte copies where the rows allow them), through
//     gs::FlatLayout{2*cols} with U at x, V at x + cols and a domain `cols`
//     wide, so a cell past U's last column loads as 0.0, never as V's
//     first. The copy may go through L1: nothing writes x in the launch;
//   - step s computes window cells [s+1, W-s-1) from one shared buffer into
//     the other (the valid region shrinks by one cell a step, as in K1), in
//     register strips of 4 cells that keep the row pass in registers
//     (step_packed_window), one __syncthreads() a step;
//   - a tile whose window lies inside the domain steps with no domain test;
//     the others write cells outside the domain as exactly 0.0 every step,
//     so the next step's row pass reads the zero boundary (and h0 > 0 keeps
//     a row outside the domain at t = +0.0, as packed_step's padding does);
//   - the tile, masked to the domain, is written to x_out: U at g, V at
//     g + cols.
//
// What bounds it on the card: each launch reads and writes the state once,
// 16 B a cell per HALO steps, far below what HBM feeds. The limit is
// instruction issue: 34 float32 operations a cell-step (the packed step's
// 30, and the strips' recompute of their neighbours' row pass), the halo
// recompute (1.24x the useful cell-steps over 8 steps with 64^2 tiles,
// where the first form's 32^2 tiles recomputed 1.51x) and the shared-memory
// traffic. gs_packed_ablation runs the kernel with one part of the design
// taken out, or the first form (part 0: gs_packed.cuh's step_packed_tile<8>
// on 32x32 tiles, kept unchanged as the in-call yardstick of the old code),
// for chip_smoke.py to time what each part buys.
//
// The pinned entry (gs_packed_pinned_multistep) is K4 under JAX's
// block_rows and steps_per_call pins on the packed layout
// (grayscott_tpu/backends/pallas.py:554-583; _packed_kernel's `tr`, `halo`
// and `steps`): the same kernel on tr x tc tiles in windows of `halo` (8,
// 16, 24 or 32) cells more on every side, known at run time
// (gs_tile_sm90.cuh: PinGeometry; the compiled kernel's
// packed_window_multistep on its int sizes), up to 32 steps a launch.
// JAX's packed kernel takes no column tile (pallas.py:507-519), so tc is
// the port's 64, or narrower where a deep halo leaves no room
// (grayscott_tpu_torch/ops/geometry.py).

#include "gs_packed_sm90.cuh"

namespace {

namespace sm90 = gs::sm90;

constexpr int HALO = sm90::HALO;  // most steps per launch (K)

using sm90::Main;

// SPECIALIZE = false takes every tile as an edge tile (an ablation).
template <typename G, bool SPECIALIZE = true>
__global__ void __launch_bounds__(G::NT, G::MIN_BLOCKS)
packed_kernel(const float* x, float* x_out, int rows, int cols, int steps,
              gs::PackedConstants k, int aligned) {
  extern __shared__ float4 window[];  // buffers [2] x species [2]
  sm90::packed_window_multistep<SPECIALIZE>(
      sm90::FixedShape<G>{}, x, x_out, rows, cols, steps, k, aligned,
      reinterpret_cast<float*>(window));
}

// packed_kernel on a pinned geometry (bound to 64 registers, as Main's).
__global__ void __launch_bounds__(sm90::PinGeometry::NT, 2)
packed_pinned_kernel(const float* x, float* x_out, int rows, int cols,
                     int steps, gs::PackedConstants k, sm90::PinGeometry g,
                     int aligned) {
  extern __shared__ float4 window[];  // buffers [2] x species [2]
  sm90::packed_window_multistep<true>(g, x, x_out, rows, cols, steps, k,
                                      aligned,
                                      reinterpret_cast<float*>(window));
}

// The first form (gs_packed.cuh: step_packed_tile<8>, 32x32 tiles in 48^2
// windows of static shared memory, 256 threads, two passes a step), as K4
// ran before the packed Hopper stepper: gs_packed_ablation's part 0.
__global__ void __launch_bounds__(gs::BLOCK_X * gs::BLOCK_Y)
first_form_kernel(const float* x, float* x_out, int rows, int cols,
                  int steps, gs::PackedConstants k) {
  __shared__ gs::PackedWindow<HALO> s;
  gs::step_packed_tile<HALO>(x, x_out, blockIdx.y, blockIdx.x, rows, cols,
                             steps, k, s);
}

struct Call {
  const float* x;
  float* x_out;
  int rows, cols, steps, device;
  gs::PackedConstants k;
  cudaStream_t stream;
};

// One launch of packed_kernel<G, SPECIALIZE>, after allowing it the dynamic
// shared memory it needs (once per device): a launch that asks for more
// than 48 KB without that is refused, and the refusal is returned.
template <typename G, bool SPECIALIZE = true>
cudaError_t launch(const Call& c) {
  static bool allowed[gs::MAX_DEVICES];
  auto kernel = packed_kernel<G, SPECIALIZE>;
  if (!allowed[c.device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(G::BYTES));
    if (err != cudaSuccess) return err;
    allowed[c.device] = true;
  }
  const dim3 grid((c.cols + G::TC - 1) / G::TC, (c.rows + G::TR - 1) / G::TR);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const int aligned = sm90::packed_aligned(c.cols, c.x, c.x_out);
  kernel<<<grid, G::NT, G::BYTES, c.stream>>>(c.x, c.x_out, c.rows, c.cols,
                                              c.steps, c.k, aligned);
  return cudaGetLastError();
}

// One launch of the first form.
cudaError_t launch_first_form(const Call& c) {
  const dim3 grid((c.cols + gs::TILE - 1) / gs::TILE,
                  (c.rows + gs::TILE - 1) / gs::TILE);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  first_form_kernel<<<grid, dim3(gs::BLOCK_X, gs::BLOCK_Y), 0, c.stream>>>(
      c.x, c.x_out, c.rows, c.cols, c.steps, c.k);
  return cudaGetLastError();
}

// The C interface's checks; the call, or an error in `err`.
Call make_call(const float* x, float* x_out, int rows, int cols, int steps,
               int device, const gs::PackedConstants& k, void* stream,
               cudaError_t* err) {
  *err = cudaSuccess;
  if (rows < 1 || cols < 1 || steps < 1 || steps > HALO || device < 0 ||
      device >= gs::MAX_DEVICES) {
    *err = cudaErrorInvalidValue;
  } else {
    *err = cudaSetDevice(device);
  }
  return {x, x_out, rows, cols, steps, device, k,
          static_cast<cudaStream_t>(stream)};
}

// One launch of packed_pinned_kernel on tr x tc tiles with a halo of
// `halo`, after allowing it the most dynamic shared memory a block may use
// (once per device).
cudaError_t launch_pinned(const Call& c, const sm90::PinGeometry& g) {
  static bool allowed[gs::MAX_DEVICES];
  if (!allowed[c.device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        packed_pinned_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sm90::SMEM_OPTIN));
    if (err != cudaSuccess) return err;
    allowed[c.device] = true;
  }
  const dim3 grid((c.cols + g.tc - 1) / g.tc, (c.rows + g.tr - 1) / g.tr);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const int aligned =
      sm90::packed_aligned(c.cols, c.x, c.x_out) && g.tc % 4 == 0;
  packed_pinned_kernel<<<grid, sm90::PinGeometry::NT, sm90::pin_bytes(g),
                         c.stream>>>(c.x, c.x_out, c.rows, c.cols, c.steps,
                                     c.k, g, aligned);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gs_packed_max_steps() { return HALO; }

// gs_packed_multistep on tr x tc tiles in windows of `halo` (8, 16, 24 or
// 32) cells more on every side, `steps` (1..halo) steps a launch. Returns
// cudaGetLastError() (0 when the launch was accepted), or
// cudaErrorInvalidValue for a geometry the entry does not take
// (gs_tile_sm90.cuh: pin_ok).
int gs_packed_pinned_multistep(const float* x, float* x_out, int rows,
                               int cols, int steps, int tr, int tc,
                               int halo, int device, float h0, float h1,
                               float cu, float cv, float e, float au,
                               float bv, float qu, float qv, void* stream) {
  if (!sm90::pin_ok(tr, tc, halo, steps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  // (make_call checks steps against HALO: it is checked against halo here)
  const Call c = make_call(x, x_out, rows, cols, 1, device,
                           {h0, h1, cu, cv, e, au, bv, qu, qv}, stream, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  Call call = c;
  call.steps = steps;
  return static_cast<int>(
      launch_pinned(call, sm90::pin_geometry(tr, tc, halo)));
}

// Enqueues one launch on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted). `cols` is the width of one species; x and x_out
// are rows x 2*cols, and x_out must not overlap x.
int gs_packed_multistep(const float* x, float* x_out, int rows, int cols,
                        int steps, int device, float h0, float h1, float cu,
                        float cv, float e, float au, float bv, float qu,
                        float qv, void* stream) {
  cudaError_t err;
  const Call c = make_call(x, x_out, rows, cols, steps, device,
                           {h0, h1, cu, cv, e, au, bv, qu, qv}, stream, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch<Main>(c));
}

// gs_packed_multistep with one part of the design taken out, for timing
// what it buys: 0 the first form's kernel, 1 no interior tiles, 2 32x32
// tiles in 48x48 windows. The result is the same.
int gs_packed_ablation(const float* x, float* x_out, int rows, int cols,
                       int steps, int device, float h0, float h1, float cu,
                       float cv, float e, float au, float bv, float qu,
                       float qv, void* stream, int part) {
  cudaError_t err;
  const Call c = make_call(x, x_out, rows, cols, steps, device,
                           {h0, h1, cu, cv, e, au, bv, qu, qv}, stream, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (part) {
    case 0: err = launch_first_form(c); break;
    case 1: err = launch<Main, false>(c); break;
    case 2: err = launch<sm90::Small>(c); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
