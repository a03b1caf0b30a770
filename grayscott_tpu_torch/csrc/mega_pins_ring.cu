// K2's window ring on a pinned geometry (mega_depth D in 3..8 with the tile
// pins, --pallas-engine mega --pallas-block-rows/--pallas-block-cols),
// written by hand for Hopper (sm_90a).
//
// Replaces grayscott_tpu/ops/megakernel.py:_mega_kernel(depth=D) with the
// `tr` and `tc` of the tile pins (grayscott_tpu/backends/pallas.py:384-411;
// the ring :562-630): mega_ring.cu's ring (mega.cuh: ring_run, whose walk
// is gs_tile_sm90.cuh's ring_walk, RING_SCRATCH) on the tile pins'
// geometry, D + 1 buffers of the pinned window pair. The ring changes when
// a window loads, not what a step computes: mega_pins.cu's double buffer's
// result bit for bit. Which depth runs is JAX's clamp on the pinned tiles'
// windows (ops/megakernel.py:ring_geometry); a ring past the 227 KB a block
// may use is refused before the launch.
//
// The threads and the register bound follow the ring's bytes, so that the
// SM keeps the double buffer's 32 warps at 64 registers a thread: a ring
// that leaves room for two blocks an SM (two of its bytes and the 1 KB the
// runtime keeps a block within the SM's 228 KB) runs Main's 512 threads
// bound to two blocks (PinGeometry), any other 1024 threads bound to one
// (PinGeometryWide). The host picks them by the geometry's bytes
// (two_blocks), never on an error. The first form bound every pinned ring
// to one block of 512 threads (128 registers): the ring's ablation part 0
// (splits/mega_ring_ablation.cu). The grid is the occupancy API's count at the
// ring's bytes (gs_mega_pinned_ring_max_blocks).

#include "mega.cuh"

namespace {

using sm90::PinGeometry;

// the SM's shared memory and what the runtime keeps of it a block
constexpr size_t SMEM_SM = 233472;
constexpr size_t SMEM_RESERVED = 1024;

// Dynamic shared memory of a ring of `nbuf` window pairs of g.
inline size_t ring_bytes(const PinGeometry& g, int nbuf) {
  return static_cast<size_t>(nbuf) * sm90::pin_bytes(g) / 2;
}

// Whether a ring of `nbuf` buffers of g runs the kernels bound to two blocks
// an SM: its bytes leave room for two.
inline bool two_blocks(const PinGeometry& g, int nbuf) {
  return 2 * (ring_bytes(g, nbuf) + SMEM_RESERVED) <= SMEM_SM;
}

// S: PinGeometry (two blocks an SM) or PinGeometryWide (one).
template <int TAPS, int MODE, typename T, typename K, typename S>
__global__ void __launch_bounds__(S::NT, (S::NT == PinGeometry::NT ? 2 : 1))
ring_pinned_kernel(T* u_pair, T* v_pair, int rows, int cols, int n_blocks,
                   int steps, K k, int aligned, S g, int nbuf,
                   unsigned long long* barrier) {
  extern __shared__ float4 window[];  // buffers [nbuf] x species [2]
  ring_run<TAPS, MODE, sm90::RING_SCRATCH, 1>(
      g, u_pair, v_pair, rows, cols, n_blocks, steps, k, aligned, nbuf,
      barrier, reinterpret_cast<float*>(window));
}

// One instantiation of ring_pinned_kernel: its co-resident blocks at a
// geometry and buffer count, and its launch.
template <int TAPS, int MODE, typename T, typename K, typename S>
struct RingPinned {
  static bool* allowed() {
    static bool done[gs::MAX_DEVICES];
    return done;
  }

  static cudaError_t max_blocks(int device, const PinGeometry& g, int nbuf,
                                int* out) {
    return sm90::pinned_coresident(ring_pinned_kernel<TAPS, MODE, T, K, S>,
                                   allowed(), device, ring_bytes(g, nbuf),
                                   out, S::NT);
  }

  static cudaError_t launch(const Call<T, K>& c, const PinGeometry& g,
                            int nbuf) {
    Call<T, K> a = c;
    S geo = {g.tr, g.tc, g.halo, g.wr, g.wc, g.pitch, g.cells};
    const size_t plane = static_cast<size_t>(c.rows) * c.cols;
    int aligned = sm90::rows_aligned<T>(c.cols, c.u_pair, c.v_pair,
                                        c.u_pair + plane, c.v_pair + plane) &&
                  g.tc % sm90::vec_cells<T>() == 0;
    void* args[] = {&a.u_pair, &a.v_pair, &a.rows,  &a.cols, &a.n_blocks,
                    &a.steps,  &a.k,      &aligned, &geo,    &nbuf,
                    &a.barrier};
    return launch_pinned(ring_pinned_kernel<TAPS, MODE, T, K, S>, allowed(),
                         args, c.rows, c.cols, geo, ring_bytes(g, nbuf),
                         c.grid_blocks, c.device, c.stream);
  }
};

template <int TAPS, int MODE, typename T, typename K>
cudaError_t launch_ring(const Call<T, K>& c, const PinGeometry& g,
                        int nbuf) {
  using Wide = sm90::PinGeometryWide;
  return two_blocks(g, nbuf)
             ? RingPinned<TAPS, MODE, T, K, PinGeometry>::launch(c, g, nbuf)
             : RingPinned<TAPS, MODE, T, K, Wide>::launch(c, g, nbuf);
}

// The ring of the call's boundary.
template <int TAPS>
struct Launch {
  template <typename T>
  static cudaError_t run(const Call<T>& c, const PinGeometry& g, int nbuf) {
    return c.naive ? launch_ring<TAPS, sm90::MODE_NAIVE>(c, g, nbuf)
                   : launch_ring<TAPS, sm90::MODE_ZERO>(c, g, nbuf);
  }
};

template <int TAPS>
struct LaunchFold {
  template <typename T>
  static cudaError_t run(const Call<T, sm90::FoldConstants>& c,
                         const PinGeometry& g, int nbuf) {
    return launch_ring<TAPS, sm90::MODE_FOLD>(c, g, nbuf);
  }
};

// *least becomes the fewer of itself and M's co-resident blocks at g and
// `nbuf` buffers; a failed query is kept in *err, and later calls do
// nothing.
template <typename M>
void take_fewer(int device, const PinGeometry& g, int nbuf, int* least,
                cudaError_t* err) {
  if (*err != cudaSuccess) return;
  int n = 0;
  *err = M::max_blocks(device, g, nbuf, &n);
  if (*err == cudaSuccess && n < *least) *least = n;
}

// The fewer of *least and the co-resident blocks at g and `nbuf` buffers of
// every instantiation on T of the geometry S that the ring runs.
template <typename T, typename S>
void fewest_of(int device, const PinGeometry& g, int nbuf, int* least,
               cudaError_t* err) {
  using Fold = sm90::FoldConstants;
  using Plain = gs::Constants;
  constexpr int NAIVE = sm90::MODE_NAIVE, ZERO = sm90::MODE_ZERO;
  constexpr int FOLD = sm90::MODE_FOLD;
  constexpr int RING = sm90::TAPS_RING, ANY = sm90::TAPS_ANY;
  take_fewer<RingPinned<RING, NAIVE, T, Plain, S>>(device, g, nbuf, least,
                                                   err);
  take_fewer<RingPinned<RING, ZERO, T, Plain, S>>(device, g, nbuf, least,
                                                  err);
  take_fewer<RingPinned<ANY, NAIVE, T, Plain, S>>(device, g, nbuf, least,
                                                  err);
  take_fewer<RingPinned<ANY, ZERO, T, Plain, S>>(device, g, nbuf, least,
                                                 err);
  take_fewer<RingPinned<sm90::TAPS_SEPARABLE, FOLD, T, Fold, S>>(
      device, g, nbuf, least, err);
  take_fewer<RingPinned<ANY, FOLD, T, Fold, S>>(device, g, nbuf, least, err);
}

// Whether `nbuf` buffers of tr x tc tiles at the megakernels' halo are a
// ring the pinned ring entries take on `device`: 3 .. RING_MAX_BUFFERS
// buffers within the shared memory a block may use.
bool ring_ok(int tr, int tc, int nbuf, int device) {
  if (!sm90::pin_ok(tr, tc, HALO, 1) || device < 0 ||
      device >= gs::MAX_DEVICES || nbuf < 3 ||
      nbuf > sm90::RING_MAX_BUFFERS) {
    return false;
  }
  return ring_bytes(sm90::pin_geometry(tr, tc, HALO), nbuf) <=
         sm90::SMEM_OPTIN;
}

template <typename T>
int multistep(T* u_pair, T* v_pair, int rows, int cols, int n_blocks,
              int steps, int naive, int device, const float* w, float du,
              float dv, float feed, float min_feed_kill, float dt,
              int grid_blocks, void* barrier, void* stream, int tr, int tc,
              int nbuf) {
  if (!ring_ok(tr, tc, nbuf, device)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  const Call<T> c = make_call(u_pair, v_pair, rows, cols, n_blocks, steps,
                              naive, device, w, du, dv, feed, min_feed_kill,
                              dt, grid_blocks, barrier, stream, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sm90::dispatch_taps_lean<Launch>(
      c.k, c, sm90::pin_geometry(tr, tc, HALO), nbuf));
}

template <typename T>
int fold_multistep(T* u_pair, T* v_pair, int rows, int cols, int n_blocks,
                   int steps, int device, const float* fold, int separable,
                   int dt_is_one, int grid_blocks, void* barrier,
                   void* stream, int tr, int tc, int nbuf) {
  if (!ring_ok(tr, tc, nbuf, device)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  const Call<T, sm90::FoldConstants> c =
      make_fold_call(u_pair, v_pair, rows, cols, n_blocks, steps, device,
                     fold, dt_is_one, grid_blocks, barrier, stream, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sm90::dispatch_fold_lean<LaunchFold>(
      c.k, separable, c, sm90::pin_geometry(tr, tc, HALO), nbuf));
}

}  // namespace

extern "C" {

// The most blocks one cooperative launch of the pinned ring entries may
// have on `device` on tr x tc tiles with `nbuf` (3..9) window buffers,
// whatever their weights, boundary, mode and storage type (negative:
// minus the CUDA error; 0: the ring does not fit a block).
int gs_mega_pinned_ring_max_blocks(int device, int tr, int tc, int nbuf) {
  if (device < 0 || device >= gs::MAX_DEVICES) {
    return -static_cast<int>(cudaErrorInvalidDevice);
  }
  if (!ring_ok(tr, tc, nbuf, device)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const PinGeometry g = sm90::pin_geometry(tr, tc, HALO);
  cudaError_t err = cudaSetDevice(device);
  int n = 1 << 30;
  if (two_blocks(g, nbuf)) {
    fewest_of<float, PinGeometry>(device, g, nbuf, &n, &err);
    fewest_of<sm90::bf16, PinGeometry>(device, g, nbuf, &n, &err);
  } else {
    fewest_of<float, sm90::PinGeometryWide>(device, g, nbuf, &n, &err);
    fewest_of<sm90::bf16, sm90::PinGeometryWide>(device, g, nbuf, &n, &err);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// gs_mega_pinned_multistep (mega_pins.cu) on a ring of `nbuf` (3..9)
// window buffers of tr x tc tiles (mega_depth D: D + 1 buffers; ops/
// megakernel.py:ring_geometry); the same result, bit for bit.
// cudaErrorInvalidValue for a ring past the shared memory a block may use.
int gs_mega_pinned_ring_multistep(float* u_pair, float* v_pair, int rows,
                                  int cols, int n_blocks, int steps,
                                  int naive, int device, float w0, float w1,
                                  float w2, float w3, float w4, float w5,
                                  float w6, float w7, float w8, float du,
                                  float dv, float feed, float min_feed_kill,
                                  float dt, int grid_blocks, void* barrier,
                                  void* stream, int tr, int tc, int nbuf) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return multistep(u_pair, v_pair, rows, cols, n_blocks, steps, naive,
                   device, w, du, dv, feed, min_feed_kill, dt, grid_blocks,
                   barrier, stream, tr, tc, nbuf);
}

// gs_mega_pinned_ring_multistep on bfloat16 pairs.
int gs_mega_pinned_ring_multistep_bf16(
    void* u_pair, void* v_pair, int rows, int cols, int n_blocks, int steps,
    int naive, int device, float w0, float w1, float w2, float w3, float w4,
    float w5, float w6, float w7, float w8, float du, float dv, float feed,
    float min_feed_kill, float dt, int grid_blocks, void* barrier,
    void* stream, int tr, int tc, int nbuf) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return multistep(static_cast<sm90::bf16*>(u_pair),
                   static_cast<sm90::bf16*>(v_pair), rows, cols, n_blocks,
                   steps, naive, device, w, du, dv, feed, min_feed_kill, dt,
                   grid_blocks, barrier, stream, tr, tc, nbuf);
}

// gs_mega_pinned_multistep_fold on a ring of `nbuf` buffers.
int gs_mega_pinned_ring_multistep_fold(float* u_pair, float* v_pair,
                                       int rows, int cols, int n_blocks,
                                       int steps, int device,
                                       const float* fold, int separable,
                                       int dt_is_one, int grid_blocks,
                                       void* barrier, void* stream, int tr,
                                       int tc, int nbuf) {
  return fold_multistep(u_pair, v_pair, rows, cols, n_blocks, steps, device,
                        fold, separable, dt_is_one, grid_blocks, barrier,
                        stream, tr, tc, nbuf);
}

// gs_mega_pinned_multistep_fold_bf16 on a ring of `nbuf` buffers.
int gs_mega_pinned_ring_multistep_fold_bf16(
    void* u_pair, void* v_pair, int rows, int cols, int n_blocks, int steps,
    int device, const float* fold, int separable, int dt_is_one,
    int grid_blocks, void* barrier, void* stream, int tr, int tc,
    int nbuf) {
  return fold_multistep(static_cast<sm90::bf16*>(u_pair),
                        static_cast<sm90::bf16*>(v_pair), rows, cols,
                        n_blocks, steps, device, fold, separable, dt_is_one,
                        grid_blocks, barrier, stream, tr, tc, nbuf);
}

}  // extern "C"
