// The window ring's ablation parts (K2 ring and K2 ring pinned; mega_ring.cu,
// mega_pins_ring.cu): the ring with one part of its design taken out or
// changed, for timing what each part costs. Every part gives the whole
// kernel's result but part 2, which steps nothing (its result is its input).
// Default stencil's tap set, naive boundary, float32 pairs only.
//
//   0  the first form: the entries' walk (D + 1 buffers, each step writing
//      the step's scratch: RING_SCRATCH) on Main's 512 threads (Small's
//      256), bound to 128 registers a thread (one block an SM at 512
//      threads, two at 256)
//   1  the first form bound to 64 registers a thread
//   2  the first form's window loads and stores alone, no step
//   3  the first form waiting for every window in flight before each tile's
//      steps (cp.async.wait_group 0): no load in flight while a tile steps
//   4  the double buffer (time_block_on) on the first form's tile, grid and
//      register bound
//   5  each tile stepped in place (RING_IN_PLACE, D buffers) on the first
//      form's tile, grid and register bound
//   6  in place on twice the threads, 64 registers a thread, on the tile
//      that D buffers allow (64x64 up to D = 4)
//   7  in place bound to 64 registers a thread, on that tile
//   8  the first form on twice the threads, 64 registers a thread, one
//      block an SM (the compiled entries' form; the pinned entries' where
//      the ring's bytes leave room for one block)
//
// The host (ops/megakernel.py:ring_ablation) gives each part its tile,
// buffers and the buffers whose bytes set the grid, so that a part runs on
// the tile and grid it is compared on. The launches are not the main path's
// and are not counted.

#include <type_traits>

#include "../mega.cuh"

namespace {

using sm90::PinGeometry;
using sm90::PinGeometryWide;

// the geometry of twice the threads (parts 6 and 8)
template <typename G>
struct Wide;
template <>
struct Wide<sm90::Main> {
  using type = sm90::MainWide;
};
template <>
struct Wide<sm90::Small> {
  using type = sm90::SmallWide;
};

constexpr int PARTS = 9;
constexpr int TAPS = sm90::TAPS_RING;
constexpr int MODE = sm90::MODE_NAIVE;

// The ring walk of PART on g (S: its shape type, ITEMS: in-place strips a
// thread).
template <int PART, int ITEMS, typename S>
__device__ __forceinline__ void ablation_run(const S& g, float* u_pair,
                                             float* v_pair, int rows,
                                             int cols, int n_blocks,
                                             int steps,
                                             const gs::Constants& k,
                                             int aligned, int nbuf,
                                             unsigned long long* barrier,
                                             float* base) {
  if constexpr (PART == 4) {
    mega_run<TAPS, MODE, true, true>(g, u_pair, v_pair, rows, cols,
                                     n_blocks, steps, k, aligned, barrier,
                                     base);
  } else {
    constexpr int FORM = PART == 2   ? sm90::RING_LOAD_STORE
                         : PART == 3 ? sm90::RING_WAIT_ALL
                         : (PART >= 5 && PART <= 7) ? sm90::RING_IN_PLACE
                                                    : sm90::RING_SCRATCH;
    ring_run<TAPS, MODE, FORM, ITEMS>(g, u_pair, v_pair, rows, cols,
                                      n_blocks, steps, k, aligned, nbuf,
                                      barrier, base);
  }
}

// The blocks an SM of a part's register bound on geometry G (the compiled
// kernels).
template <typename G, int PART>
__host__ __device__ constexpr int compiled_bound() {
  return (PART == 1 || PART >= 6) ? G::BLOCKS_AT_64_REGS
                                  : G::BLOCKS_AT_128_REGS;
}

template <typename G, int PART>
__global__ void __launch_bounds__(G::NT, (compiled_bound<G, PART>()))
ring_ablation_kernel(float* u_pair, float* v_pair, int rows, int cols,
                     int n_blocks, int steps, gs::Constants k, int aligned,
                     int nbuf, unsigned long long* barrier) {
  extern __shared__ float4 window[];
  ablation_run<PART, G::RING_ITEMS>(sm90::FixedShape<G>{}, u_pair, v_pair,
                                    rows, cols, n_blocks, steps, k, aligned,
                                    nbuf, barrier,
                                    reinterpret_cast<float*>(window));
}

// The pinned kernels: S PinGeometry (PinGeometryWide for parts 6 and 8);
// bound to two blocks an SM (parts 1 and 7: 64 registers a thread) or one
// (parts 6 and 8: 1024 threads at 64 registers; the others at 128).
template <int PART>
using PinShape =
    typename std::conditional<PART == 6 || PART == 8, PinGeometryWide,
                              PinGeometry>::type;

template <int PART>
__host__ __device__ constexpr int pinned_bound() {
  return (PART == 1 || PART == 7) ? 2 : 1;
}

template <int PART>
__host__ __device__ constexpr int pinned_items() {
  return PART == 5 ? sm90::PIN_RING_ITEMS : sm90::PIN_RING_ITEMS_2;
}

template <int PART>
__global__ void __launch_bounds__(PinShape<PART>::NT, (pinned_bound<PART>()))
ring_pinned_ablation_kernel(float* u_pair, float* v_pair, int rows, int cols,
                            int n_blocks, int steps, gs::Constants k,
                            int aligned, PinShape<PART> g, int nbuf,
                            unsigned long long* barrier) {
  extern __shared__ float4 window[];
  ablation_run<PART, pinned_items<PART>()>(
      g, u_pair, v_pair, rows, cols, n_blocks, steps, k, aligned, nbuf,
      barrier, reinterpret_cast<float*>(window));
}

// One compiled part's launch at `bytes` of dynamic shared memory, its grid
// cached per size.
template <typename G, int PART>
cudaError_t launch_compiled(const Call<float>& c, int nbuf, size_t bytes) {
  static int blocks[sm90::RING_MAX_BUFFERS + 1][gs::MAX_DEVICES];
  if constexpr (PART >= 5 && PART <= 7) {
    static_assert(G::RING_ITEMS * G::NT >=
                      (G::WC - 2) * ((G::WR - 2 + G::R - 1) / G::R),
                  "the in-place step's strips");
  }
  Call<float> a = c;
  const size_t plane = static_cast<size_t>(c.rows) * c.cols;
  int aligned = sm90::rows_aligned<float>(c.cols, c.u_pair, c.v_pair,
                                          c.u_pair + plane, c.v_pair + plane);
  void* args[] = {&a.u_pair, &a.v_pair, &a.rows,    &a.cols, &a.n_blocks,
                  &a.steps,  &a.k,      &aligned, &nbuf,   &a.barrier};
  const int slot = static_cast<int>(bytes / G::PAIR_BYTES);
  if (slot < 2 || slot > sm90::RING_MAX_BUFFERS ||
      bytes > sm90::SMEM_OPTIN) {
    return cudaErrorInvalidValue;
  }
  return gs::launch_persistent(ring_ablation_kernel<G, PART>, args, c.rows,
                               c.cols, c.grid_blocks, c.device, blocks[slot],
                               c.stream, dim3(G::NT), bytes, G::TR,
                               sm90::SMEM_OPTIN);
}

template <typename G>
cudaError_t dispatch_compiled(const Call<float>& c, int part, int nbuf,
                              size_t bytes) {
  using W = typename Wide<G>::type;
  switch (part) {
    case 0: return launch_compiled<G, 0>(c, nbuf, bytes);
    case 1: return launch_compiled<G, 1>(c, nbuf, bytes);
    case 2: return launch_compiled<G, 2>(c, nbuf, bytes);
    case 3: return launch_compiled<G, 3>(c, nbuf, bytes);
    case 4: return launch_compiled<G, 4>(c, nbuf, bytes);
    case 5: return launch_compiled<G, 5>(c, nbuf, bytes);
    case 6: return launch_compiled<W, 6>(c, nbuf, bytes);
    case 7: return launch_compiled<G, 7>(c, nbuf, bytes);
    case 8: return launch_compiled<W, 8>(c, nbuf, bytes);
    default: return cudaErrorInvalidValue;
  }
}

// One pinned part's launch at `bytes` of dynamic shared memory.
template <int PART>
cudaError_t launch_pinned_part(const Call<float>& c, int tr, int tc, int nbuf,
                               size_t bytes) {
  static bool allowed[gs::MAX_DEVICES];
  const PinGeometry p = sm90::pin_geometry(tr, tc, HALO);
  const PinShape<PART> g = {p.tr, p.tc, p.halo, p.wr, p.wc, p.pitch,
                            p.cells};
  if (PART >= 5 && PART <= 7 &&
      sm90::ring_items(g) > pinned_items<PART>() * PinShape<PART>::NT) {
    return cudaErrorInvalidValue;
  }
  Call<float> a = c;
  PinShape<PART> geo = g;
  const size_t plane = static_cast<size_t>(c.rows) * c.cols;
  int aligned = sm90::rows_aligned<float>(c.cols, c.u_pair, c.v_pair,
                                          c.u_pair + plane,
                                          c.v_pair + plane) &&
                tc % 4 == 0;
  void* args[] = {&a.u_pair, &a.v_pair, &a.rows,  &a.cols, &a.n_blocks,
                  &a.steps,  &a.k,      &aligned, &geo,    &nbuf,
                  &a.barrier};
  return launch_pinned(ring_pinned_ablation_kernel<PART>, allowed, args,
                       c.rows, c.cols, g, bytes, c.grid_blocks, c.device,
                       c.stream);
}

cudaError_t dispatch_pinned(const Call<float>& c, int part, int tr, int tc,
                            int nbuf, size_t bytes) {
  switch (part) {
    case 0: return launch_pinned_part<0>(c, tr, tc, nbuf, bytes);
    case 1: return launch_pinned_part<1>(c, tr, tc, nbuf, bytes);
    case 2: return launch_pinned_part<2>(c, tr, tc, nbuf, bytes);
    case 3: return launch_pinned_part<3>(c, tr, tc, nbuf, bytes);
    case 4: return launch_pinned_part<4>(c, tr, tc, nbuf, bytes);
    case 5: return launch_pinned_part<5>(c, tr, tc, nbuf, bytes);
    case 6: return launch_pinned_part<6>(c, tr, tc, nbuf, bytes);
    case 7: return launch_pinned_part<7>(c, tr, tc, nbuf, bytes);
    case 8: return launch_pinned_part<8>(c, tr, tc, nbuf, bytes);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The ring's ablation parts.
int gs_mega_ring_ablation_parts() { return PARTS; }

// gs_mega_ring_multistep (pinned 0: tr == tc, 64 or 32, the compiled
// geometries) or gs_mega_pinned_ring_multistep (pinned 1: tr x tc tiles) in
// the form of `part`, on `nbuf` window buffers (2 for part 4) and dynamic
// shared memory of `grid_nbuf` window pairs, which sets the grid (0 for
// the co-resident maximum, or `grid_blocks`). Default stencil's tap set,
// naive boundary only (cudaErrorInvalidValue otherwise).
int gs_mega_ring_ablation(float* u_pair, float* v_pair, int rows, int cols,
                          int n_blocks, int steps, int naive, int device,
                          float w0, float w1, float w2, float w3, float w4,
                          float w5, float w6, float w7, float w8, float du,
                          float dv, float feed, float min_feed_kill,
                          float dt, int grid_blocks, void* barrier,
                          void* stream, int tr, int tc, int pinned, int nbuf,
                          int grid_nbuf, int part) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  cudaError_t err;
  const Call<float> c = make_call(u_pair, v_pair, rows, cols, n_blocks,
                                  steps, naive, device, w, du, dv, feed,
                                  min_feed_kill, dt, grid_blocks, barrier,
                                  stream, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!naive || sm90::tap_mask(c.k) != TAPS || nbuf < 2 ||
      nbuf > sm90::RING_MAX_BUFFERS || grid_nbuf < nbuf ||
      grid_nbuf > sm90::RING_MAX_BUFFERS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pinned) {
    if (!sm90::pin_ok(tr, tc, HALO, 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t bytes = static_cast<size_t>(grid_nbuf) *
                         sm90::pin_bytes(sm90::pin_geometry(tr, tc, HALO)) /
                         2;
    if (bytes > sm90::SMEM_OPTIN) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(dispatch_pinned(c, part, tr, tc, nbuf, bytes));
  }
  if (tr != tc) return static_cast<int>(cudaErrorInvalidValue);
  if (tr == sm90::Main::TR) {
    return static_cast<int>(dispatch_compiled<sm90::Main>(
        c, part, nbuf, grid_nbuf * sm90::Main::PAIR_BYTES));
  }
  if (tr == sm90::Small::TR) {
    return static_cast<int>(dispatch_compiled<sm90::Small>(
        c, part, nbuf, grid_nbuf * sm90::Small::PAIR_BYTES));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
