// K2 and K6 on a pinned geometry: the megakernels' tile pins
// (--pallas-engine mega with --pallas-block-rows and/or --pallas-block-cols;
// K6, the packed megakernel, the row tile alone), written by hand for
// Hopper (sm_90a).
//
// Replaces grayscott_tpu/ops/megakernel.py:_mega_kernel with the `tr` and
// `tc` that PallasSimulation._mega_tiles passes it under those pins
// (grayscott_tpu/backends/pallas.py:384-411), and the packed megakernel
// with its `tr` (:554-576). One persistent cooperative launch advances the
// state by `n_blocks` time blocks of `steps` <= HALO steps, exactly as
// mega.cu's double buffer and packed_mega.cu do, on tr x tc tiles in
// windows of HALO (8) cells more on every side. The block body is the
// compiled kernels' own: mega_run (mega.cuh) and packed_mega_run
// (gs_packed_sm90.cuh) walk the block's tiles with time_block_on and
// packed_time_block_on, which mega.cu and packed_mega.cu run on
// FixedShape<Main>.
//
// K2's pinned entry has two forms, and the host picks one a launch
// (ops/geometry.py:mega_pin_launch). The pins users and the tuner name
// most (16x64, 32x64, 32x128 and 64x128, the default stencils' tap set,
// naive and zero) run their sizes compiled in, the threads a block fitted
// to the window's bytes where the split measured that it pays:
// mega_pins_fixed.cu's gs_mega_pinned_fixed_multistep (its split:
// splits/mega_pins_ablation.cu, PERF.md §6, PR 26). Every other pin, any
// other tap set and the fold entries run this unit's first form, its
// tile, halo, window and pitch known at run time (gs_tile_sm90.cuh:
// PinGeometry) on 512 threads a block; so does K6's pinned entry.
//
// The grid is the co-resident block count of the launched instantiation at
// the pinned geometry's dynamic shared memory (its two window buffers,
// gs_tile_sm90.cuh: pin_bytes) and its registers (bound to 64 a thread, as
// Main's), capped at the tile count: a grid sized for Main would
// over-subscribe the card where the pinned window is larger, and deadlock
// at the grid barrier. gs_mega_pinned_max_blocks and
// gs_packed_mega_pinned_max_blocks report a floor of that count for a
// geometry (gs_mega_pinned_fixed_blocks: the compiled form's).
//
// The pins change how the state is cut into tiles, not what a step
// computes: every geometry gives the compiled kernel's result bit for bit.
// The default stencils' tap set has an instantiation of its own, any other
// runs with its weights tested at run time (gs_tile_sm90.cuh:
// dispatch_taps_lean), which adds the same terms in the same order.
// A taller or wider tile recomputes fewer halo cells per output cell-step
// and leaves fewer blocks on an SM; a thin one the opposite, which the card
// measures (PERF.md §6).
//
// The pinned ring entries (gs_mega_pinned_ring_multistep and its twins)
// are mega_pins_ring.cu's.

#include "gs_packed_sm90.cuh"
#include "mega.cuh"

namespace {

using sm90::PinGeometry;

// blocks an SM the register budget allows (__launch_bounds__): Main's
constexpr int MIN_BLOCKS = 2;

template <int TAPS, int MODE, typename T, typename K>
__global__ void __launch_bounds__(PinGeometry::NT, MIN_BLOCKS)
mega_pinned_kernel(T* u_pair, T* v_pair, int rows, int cols, int n_blocks,
                   int steps, K k, int aligned, PinGeometry g,
                   unsigned long long* barrier) {
  extern __shared__ float4 window[];  // buffers [2] x species [2]
  mega_run<TAPS, MODE, true, true>(g, u_pair, v_pair, rows, cols, n_blocks,
                                   steps, k, aligned, barrier,
                                   reinterpret_cast<float*>(window));
}

__global__ void __launch_bounds__(PinGeometry::NT, MIN_BLOCKS)
packed_mega_pinned_kernel(float* x_pair, int rows, int cols, int n_blocks,
                          int steps, gs::PackedConstants k, int aligned,
                          PinGeometry g, unsigned long long* barrier) {
  extern __shared__ float4 window[];  // buffers [2] x species [2]
  sm90::packed_mega_run<true, true>(g, x_pair, rows, cols, n_blocks, steps,
                                    k, aligned, barrier,
                                    reinterpret_cast<float*>(window));
}

// One instantiation of mega_pinned_kernel: its co-resident blocks at a
// geometry and its launch.
template <int TAPS, int MODE, typename T, typename K = gs::Constants>
struct MegaPinned {
  static bool* allowed() {
    static bool done[gs::MAX_DEVICES];
    return done;
  }

  static cudaError_t max_blocks(int device, const PinGeometry& g, int* out) {
    return sm90::pinned_coresident(mega_pinned_kernel<TAPS, MODE, T, K>,
                                   allowed(), device, g, out);
  }

  static cudaError_t launch(const Call<T, K>& c, const PinGeometry& g) {
    Call<T, K> a = c;
    PinGeometry geo = g;
    const size_t plane = static_cast<size_t>(c.rows) * c.cols;
    int aligned = sm90::rows_aligned<T>(c.cols, c.u_pair, c.v_pair,
                                        c.u_pair + plane, c.v_pair + plane) &&
                  g.tc % sm90::vec_cells<T>() == 0;
    void* args[] = {&a.u_pair, &a.v_pair, &a.rows, &a.cols, &a.n_blocks,
                    &a.steps,  &a.k,      &aligned, &geo,   &a.barrier};
    return launch_pinned(mega_pinned_kernel<TAPS, MODE, T, K>, allowed(),
                         args, c.rows, c.cols, g, sm90::pin_bytes(g),
                         c.grid_blocks, c.device, c.stream);
  }
};

// The double buffer of the call's boundary (MegaPinned).
template <int TAPS>
struct Launch {
  template <typename T>
  static cudaError_t run(const Call<T>& c, const PinGeometry& g) {
    return c.naive ? MegaPinned<TAPS, sm90::MODE_NAIVE, T>::launch(c, g)
                   : MegaPinned<TAPS, sm90::MODE_ZERO, T>::launch(c, g);
  }
};

template <int TAPS>
struct LaunchFold {
  template <typename T>
  static cudaError_t run(const Call<T, sm90::FoldConstants>& c,
                         const PinGeometry& g) {
    return MegaPinned<TAPS, sm90::MODE_FOLD, T, sm90::FoldConstants>::launch(
        c, g);
  }
};

// *least becomes the fewer of itself and M's co-resident blocks
// (M::max_blocks(device, args..., &n)); a failed query is kept in *err,
// and later calls do nothing.
template <typename M, typename... Args>
void take_fewer(int device, int* least, cudaError_t* err,
                const Args&... args) {
  if (*err != cudaSuccess) return;
  int n = 0;
  *err = M::max_blocks(device, args..., &n);
  if (*err == cudaSuccess && n < *least) *least = n;
}

// The fewer of *least and the co-resident blocks at g of every
// instantiation of the double buffer (Entry = MegaPinned) on T.
template <template <int, int, typename, typename> class Entry, typename T,
          typename... Args>
void fewest_of(int device, const PinGeometry& g, int* least,
               cudaError_t* err, const Args&... args) {
  using Fold = sm90::FoldConstants;
  using Plain = gs::Constants;
  constexpr int NAIVE = sm90::MODE_NAIVE, ZERO = sm90::MODE_ZERO;
  constexpr int FOLD = sm90::MODE_FOLD;
  constexpr int RING = sm90::TAPS_RING, ANY = sm90::TAPS_ANY;
  take_fewer<Entry<RING, NAIVE, T, Plain>>(device, least, err, g, args...);
  take_fewer<Entry<RING, ZERO, T, Plain>>(device, least, err, g, args...);
  take_fewer<Entry<ANY, NAIVE, T, Plain>>(device, least, err, g, args...);
  take_fewer<Entry<ANY, ZERO, T, Plain>>(device, least, err, g, args...);
  take_fewer<Entry<sm90::TAPS_SEPARABLE, FOLD, T, Fold>>(device, least, err,
                                                         g, args...);
  take_fewer<Entry<ANY, FOLD, T, Fold>>(device, least, err, g, args...);
}

// Whether tr x tc tiles at the megakernels' halo are a geometry the pinned
// entries take, and the device one they may use.
bool geometry_ok(int tr, int tc, int device) {
  return sm90::pin_ok(tr, tc, HALO, 1) && device >= 0 &&
         device < gs::MAX_DEVICES;
}

template <typename T>
int multistep(T* u_pair, T* v_pair, int rows, int cols, int n_blocks,
              int steps, int naive, int device, const float* w, float du,
              float dv, float feed, float min_feed_kill, float dt,
              int grid_blocks, void* barrier, void* stream, int tr,
              int tc) {
  if (!geometry_ok(tr, tc, device)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  const Call<T> c = make_call(u_pair, v_pair, rows, cols, n_blocks, steps,
                              naive, device, w, du, dv, feed, min_feed_kill,
                              dt, grid_blocks, barrier, stream, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sm90::dispatch_taps_lean<Launch>(
      c.k, c, sm90::pin_geometry(tr, tc, HALO)));
}

template <typename T>
int fold_multistep(T* u_pair, T* v_pair, int rows, int cols, int n_blocks,
                   int steps, int device, const float* fold, int separable,
                   int dt_is_one, int grid_blocks, void* barrier,
                   void* stream, int tr, int tc) {
  if (!geometry_ok(tr, tc, device)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  const Call<T, sm90::FoldConstants> c =
      make_fold_call(u_pair, v_pair, rows, cols, n_blocks, steps, device,
                     fold, dt_is_one, grid_blocks, barrier, stream, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sm90::dispatch_fold_lean<LaunchFold>(
      c.k, separable, c, sm90::pin_geometry(tr, tc, HALO)));
}

bool packed_allowed[gs::MAX_DEVICES];

}  // namespace

extern "C" {

// The most blocks one cooperative launch of this unit's pinned K2 entries
// (the first form) may have on `device` on tr x tc tiles, whatever their
// weights, boundary, mode and storage type: the fewest over their
// instantiations, a floor of what a launch takes (negative: minus the CUDA
// error; 0: the window does not fit a block). The compiled form's count is
// gs_mega_pinned_fixed_blocks's.
int gs_mega_pinned_max_blocks(int device, int tr, int tc) {
  if (device < 0 || device >= gs::MAX_DEVICES) {
    return -static_cast<int>(cudaErrorInvalidDevice);
  }
  if (!geometry_ok(tr, tc, device)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const PinGeometry g = sm90::pin_geometry(tr, tc, HALO);
  cudaError_t err = cudaSetDevice(device);
  int n = 1 << 30;
  fewest_of<MegaPinned, float>(device, g, &n, &err);
  fewest_of<MegaPinned, sm90::bf16>(device, g, &n, &err);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// gs_mega_multistep on tr x tc tiles (a multiple of 8 rows; any width up
// to the shared memory a block may use), its arguments then tr and tc.
// Returns the CUDA error (0 when the launch was accepted), or
// cudaErrorInvalidValue for a geometry the entry does not take.
int gs_mega_pinned_multistep(float* u_pair, float* v_pair, int rows,
                             int cols, int n_blocks, int steps, int naive,
                             int device, float w0, float w1, float w2,
                             float w3, float w4, float w5, float w6,
                             float w7, float w8, float du, float dv,
                             float feed, float min_feed_kill, float dt,
                             int grid_blocks, void* barrier, void* stream,
                             int tr, int tc) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return multistep(u_pair, v_pair, rows, cols, n_blocks, steps, naive,
                   device, w, du, dv, feed, min_feed_kill, dt, grid_blocks,
                   barrier, stream, tr, tc);
}

// gs_mega_pinned_multistep on bfloat16 pairs (widened on load, rounded on
// store, once a time block).
int gs_mega_pinned_multistep_bf16(void* u_pair, void* v_pair, int rows,
                                  int cols, int n_blocks, int steps,
                                  int naive, int device, float w0, float w1,
                                  float w2, float w3, float w4, float w5,
                                  float w6, float w7, float w8, float du,
                                  float dv, float feed, float min_feed_kill,
                                  float dt, int grid_blocks, void* barrier,
                                  void* stream, int tr, int tc) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return multistep(static_cast<sm90::bf16*>(u_pair),
                   static_cast<sm90::bf16*>(v_pair), rows, cols, n_blocks,
                   steps, naive, device, w, du, dv, feed, min_feed_kill, dt,
                   grid_blocks, barrier, stream, tr, tc);
}

// gs_mega_multistep_fold on tr x tc tiles.
int gs_mega_pinned_multistep_fold(float* u_pair, float* v_pair, int rows,
                                  int cols, int n_blocks, int steps,
                                  int device, const float* fold,
                                  int separable, int dt_is_one,
                                  int grid_blocks, void* barrier,
                                  void* stream, int tr, int tc) {
  return fold_multistep(u_pair, v_pair, rows, cols, n_blocks, steps, device,
                        fold, separable, dt_is_one, grid_blocks, barrier,
                        stream, tr, tc);
}

// gs_mega_multistep_fold_bf16 on tr x tc tiles.
int gs_mega_pinned_multistep_fold_bf16(void* u_pair, void* v_pair, int rows,
                                       int cols, int n_blocks, int steps,
                                       int device, const float* fold,
                                       int separable, int dt_is_one,
                                       int grid_blocks, void* barrier,
                                       void* stream, int tr, int tc) {
  return fold_multistep(static_cast<sm90::bf16*>(u_pair),
                        static_cast<sm90::bf16*>(v_pair), rows, cols,
                        n_blocks, steps, device, fold, separable, dt_is_one,
                        grid_blocks, barrier, stream, tr, tc);
}

// The most blocks one cooperative launch of the pinned K6 entry may have
// on `device` on tr x tc tiles (negative: minus the CUDA error).
int gs_packed_mega_pinned_max_blocks(int device, int tr, int tc) {
  if (device < 0 || device >= gs::MAX_DEVICES) {
    return -static_cast<int>(cudaErrorInvalidDevice);
  }
  if (!geometry_ok(tr, tc, device)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  int n = 0;
  if (err == cudaSuccess) {
    err = sm90::pinned_coresident(packed_mega_pinned_kernel,
                                  packed_allowed, device,
                                  sm90::pin_geometry(tr, tc, HALO), &n);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// gs_packed_mega_multistep on tr x tc tiles of the packed pair (x_pair: 2
// x rows x 2*cols, `cols` the width of one species), its arguments then tr
// and tc. Returns the CUDA error (0 when the launch was accepted), or
// cudaErrorInvalidValue for a geometry the entry does not take.
int gs_packed_mega_pinned_multistep(float* x_pair, int rows, int cols,
                                    int n_blocks, int steps, int device,
                                    float h0, float h1, float cu, float cv,
                                    float e, float au, float bv, float qu,
                                    float qv, int grid_blocks, void* barrier,
                                    void* stream, int tr, int tc) {
  if (!geometry_ok(tr, tc, device)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (!call_ok(rows, cols, n_blocks, steps, device, &err)) {
    return static_cast<int>(err);
  }
  const PinGeometry g = sm90::pin_geometry(tr, tc, HALO);
  gs::PackedConstants k = {h0, h1, cu, cv, e, au, bv, qu, qv};
  const size_t plane = static_cast<size_t>(rows) * 2 * cols;
  int aligned =
      sm90::packed_aligned(cols, x_pair, x_pair + plane) && tc % 4 == 0;
  PinGeometry geo = g;
  unsigned long long* bar = static_cast<unsigned long long*>(barrier);
  void* args[] = {&x_pair, &rows, &cols, &n_blocks, &steps,
                  &k,      &aligned, &geo, &bar};
  return static_cast<int>(launch_pinned(
      packed_mega_pinned_kernel, packed_allowed, args, rows, cols, g,
      sm90::pin_bytes(g), grid_blocks, device,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
