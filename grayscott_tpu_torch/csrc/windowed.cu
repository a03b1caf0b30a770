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
//
// The shard entry (gs_windowed_shard_multistep) is K1 as
// grayscott_tpu/parallel/halo.py:sharded_run_blocks calls it per shard
// (ps.multistep_impl, :314-316), for every shard of a mesh on one card in
// one launch. Each shard holds a pair per species, (2, HALO + r_loc + HALO,
// chalo + c_loc + chalo) (grayscott_tpu_torch/parallel/halo.py; K7's
// layout): a launch reads slot `src` of every shard, its halos filled by the
// exchange, and writes the interior of slot 1 - src.
//
//   - The grid is (tile columns, tile rows, shards): blockIdx.z is the
//     shard, row-major in the mesh; its global origin is (i * r_loc,
//     j * c_loc). Tiles are Main's 64^2 in 80^2 windows, anchored at the
//     shard's origin; r_loc and c_loc are multiples of 8, so a shard's last
//     tiles are partial.
//   - The window loads through gs::ShardLayout: cells the shard's buffer
//     does not hold load as 0.0, and with steps <= HALO they cannot reach
//     a stored cell. The tile steps at its global position: the interior
//     test (the window inside the domain), the domain mask and the naive
//     window are taken against the global (rows, cols), so a shard seam is
//     no domain edge and a tile along a seam is a domain-interior tile.
//   - The store goes through ShardLayout::stores (the shard's interior
//     cells only) and the domain mask: cells past the domain are written
//     as 0.0.
//   - `part`: 0 every tile; 1 the overlap-interior tiles, the rectangle
//     [ti0, ti1) x [tj0, tj1) of tiles whose window lies in the shard's
//     interior rows (and columns on a 2-D mesh) and so reads no halo cell
//     (halo.overlap_tiles decides it); 2 every other tile. Parts 1 and 2
//     write disjoint cells, so the two launches of an overlapped block
//     equal one launch of part 0 bit for bit. Part 1 is not the domain
//     sense of interior: a tile along a seam is interior to the domain but
//     an overlap-edge tile, since its window reads the neighbour's halo.
//   - Loads are coherent (L2 only) though no block reads what another
//     writes: part 1 runs beside the copies that fill the halos of `src`.
//
// What bounds it is K1's: instruction issue. Each shard rounds its tiles
// up on its own (2x2 at 1080x1920: 540 tiles of 64^2 against K1's 510).
//
// bf16 storage (gs_windowed_multistep_bf16, gs_windowed_shard_multistep_bf16;
// pallas_stencil.py:_kernel with a bfloat16 dtype, :970-971 and :992-993):
// the same kernels on bfloat16 buffers. The window widens each cell to
// float32 as it loads (gs_tile_sm90.cuh: the bf16 load_window, through
// registers), the `steps` steps run in float32 as above, and the store
// rounds each cell to bfloat16, to nearest even, once a launch. A launch
// moves half the bytes of the float32 one; the bound stays instruction
// issue, so it runs at about the float32 kernel's speed.

#include "gs_tile_sm90.cuh"

namespace {

namespace sm90 = gs::sm90;

constexpr int HALO = sm90::HALO;  // most steps per launch (K)

using sm90::Geometry;
using sm90::Main;

// MODE: sm90::MODE_ZERO, MODE_NAIVE (K = gs::Constants) or MODE_FOLD (K =
// sm90::FoldConstants). SPECIALIZE = false takes every tile as an edge tile
// (an ablation). T: the state's element type (float, or sm90::bf16).
template <typename G, int TAPS, int MODE, bool SPECIALIZE = true,
          typename T = float, typename K = gs::Constants>
__global__ void __launch_bounds__(G::NT, G::MIN_BLOCKS)
windowed_kernel(const T* u, const T* v, T* u_out, T* v_out, int rows,
                int cols, int steps, K k, int aligned) {
  extern __shared__ float4 window[];  // buffers [2] x species [2]
  sm90::window_multistep<TAPS, MODE, SPECIALIZE>(
      sm90::FixedShape<G>{}, u, v, u_out, v_out, rows, cols, steps, k,
      aligned, reinterpret_cast<float*>(window));
}

using sm90::Shards;

template <typename G, int TAPS, int MODE, typename T>
__global__ void __launch_bounds__(G::NT, G::MIN_BLOCKS)
windowed_shard_kernel(Shards<T> s, int rows, int cols, int steps,
                      gs::Constants k) {
  extern __shared__ float4 window[];  // buffers [2] x species [2]
  sm90::shard_window_multistep<TAPS, MODE>(sm90::FixedShape<G>{}, s, rows,
                                           cols, steps, k,
                                           reinterpret_cast<float*>(window));
}

template <typename T, typename K = gs::Constants>
struct Call {
  const T *u, *v;
  T *u_out, *v_out;
  int rows, cols, steps, naive, device;
  K k;
  cudaStream_t stream;
};

// One launch of windowed_kernel<G, TAPS, MODE, SPECIALIZE>, after allowing
// it the dynamic shared memory it needs (once per device): a launch that
// asks for more than 48 KB without that is refused, and the refusal is
// returned.
template <typename G, int TAPS, int MODE, bool SPECIALIZE, typename T,
          typename K>
cudaError_t launch_one(const Call<T, K>& c) {
  static bool allowed[gs::MAX_DEVICES];
  auto kernel = windowed_kernel<G, TAPS, MODE, SPECIALIZE, T, K>;
  if (!allowed[c.device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(G::BYTES));
    if (err != cudaSuccess) return err;
    allowed[c.device] = true;
  }
  const dim3 grid((c.cols + G::TC - 1) / G::TC, (c.rows + G::TR - 1) / G::TR);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const int aligned =
      sm90::rows_aligned<T>(c.cols, c.u, c.v, c.u_out, c.v_out);
  kernel<<<grid, G::NT, G::BYTES, c.stream>>>(c.u, c.v, c.u_out, c.v_out,
                                              c.rows, c.cols, c.steps, c.k,
                                              aligned);
  return cudaGetLastError();
}

template <typename G, int TAPS, bool SPECIALIZE = true, typename T>
cudaError_t launch(const Call<T>& c) {
  return c.naive
             ? launch_one<G, TAPS, sm90::MODE_NAIVE, SPECIALIZE>(c)
             : launch_one<G, TAPS, sm90::MODE_ZERO, SPECIALIZE>(c);
}

template <int TAPS>
struct Launch {
  template <typename T>
  static cudaError_t run(const Call<T>& c) {
    return launch<Main, TAPS>(c);
  }
};

// The fold entries' launch (TAPS: the fold's sum, sm90::dispatch_fold).
template <int TAPS>
struct LaunchFold {
  template <typename T>
  static cudaError_t run(const Call<T, sm90::FoldConstants>& c) {
    return launch_one<Main, TAPS, sm90::MODE_FOLD, true>(c);
  }
};

template <typename T>
struct ShardCall {
  Shards<T> s;
  int n_shards, rows, cols, steps, naive, device;
  gs::Constants k;
  cudaStream_t stream;
};

template <int MODE, int TAPS, typename T>
cudaError_t launch_shards_one(const ShardCall<T>& c) {
  using G = Main;
  static bool allowed[gs::MAX_DEVICES];
  auto kernel = windowed_shard_kernel<G, TAPS, MODE, T>;
  if (!allowed[c.device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(G::BYTES));
    if (err != cudaSuccess) return err;
    allowed[c.device] = true;
  }
  const Shards<T>& s = c.s;
  const dim3 grid =
      s.part == 1 ? dim3(s.tj1 - s.tj0, s.ti1 - s.ti0, c.n_shards)
                  : dim3((s.c_loc + G::TC - 1) / G::TC,
                         (s.r_loc + G::TR - 1) / G::TR, c.n_shards);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;  // an empty part
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, G::NT, G::BYTES, c.stream>>>(s, c.rows, c.cols, c.steps,
                                              c.k);
  return cudaGetLastError();
}

template <int TAPS>
struct LaunchShards {
  template <typename T>
  static cudaError_t run(const ShardCall<T>& c) {
    return c.naive ? launch_shards_one<sm90::MODE_NAIVE, TAPS>(c)
                   : launch_shards_one<sm90::MODE_ZERO, TAPS>(c);
  }
};

// The C interface's checks; the call, or an invalid-value error in `err`.
template <typename T>
Call<T> make_call(const T* u, const T* v, T* u_out, T* v_out, int rows,
                  int cols, int steps, int naive, int device, const float* w,
                  float du, float dv, float feed, float min_feed_kill,
                  float dt, void* stream, cudaError_t* err) {
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

// gs_windowed_multistep and its bf16 twin.
template <typename T>
int multistep(const T* u, const T* v, T* u_out, T* v_out, int rows, int cols,
              int steps, int naive, int device, const float* w, float du,
              float dv, float feed, float min_feed_kill, float dt,
              void* stream) {
  cudaError_t err;
  const Call<T> c = make_call(u, v, u_out, v_out, rows, cols, steps, naive,
                              device, w, du, dv, feed, min_feed_kill, dt,
                              stream, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sm90::dispatch_taps<Launch>(c.k, c));
}

// gs_windowed_multistep_fold and its bf16 twin.
template <typename T>
int fold_multistep(const T* u, const T* v, T* u_out, T* v_out, int rows,
                   int cols, int steps, int device, const float* fold,
                   int separable, int dt_is_one, void* stream) {
  if (rows < 1 || cols < 1 || steps < 1 || steps > HALO || device < 0 ||
      device >= gs::MAX_DEVICES) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Call<T, sm90::FoldConstants> c = {
      u, v, u_out, v_out, rows, cols, steps, 1, device,
      sm90::fold_constants(fold, dt_is_one),
      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(
      sm90::dispatch_fold<LaunchFold>(c.k, separable, c));
}

// gs_windowed_shard_multistep and its bf16 twin.
template <typename T>
int shard_multistep(T* u_pairs, T* v_pairs, int n_rows, int n_cols,
                    int r_loc, int c_loc, int chalo, int src, int rows,
                    int cols, int steps, int part, int ti0, int ti1, int tj0,
                    int tj1, int naive, int device, const float* w, float du,
                    float dv, float feed, float min_feed_kill, float dt,
                    void* stream) {
  const int tiles_y = (r_loc + Main::TR - 1) / Main::TR;
  const int tiles_x = (c_loc + Main::TC - 1) / Main::TC;
  if (n_rows < 1 || n_cols < 1 || r_loc < 1 || c_loc < 1 || chalo < 0 ||
      chalo > HALO || (src != 0 && src != 1) || rows < 1 || cols < 1 ||
      steps < 1 || steps > HALO || part < 0 || part > 2 || ti0 < 0 ||
      ti0 > ti1 || ti1 > tiles_y || tj0 < 0 || tj0 > tj1 ||
      tj1 > tiles_x || device < 0 || device >= gs::MAX_DEVICES) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ShardCall<T> c = {
      {u_pairs, v_pairs, n_cols, r_loc, c_loc, chalo, src, part, ti0, ti1,
       tj0, tj1},
      n_rows * n_cols,
      rows,
      cols,
      steps,
      naive,
      device,
      {{w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8]},
       du, dv, feed, min_feed_kill, dt},
      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(sm90::dispatch_taps<LaunchShards>(c.k, c));
}

}  // namespace

extern "C" {

int gs_windowed_max_steps() { return HALO; }

int gs_fold_floats() { return sm90::FOLD_FLOATS; }

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
  return multistep(u, v, u_out, v_out, rows, cols, steps, naive, device, w,
                   du, dv, feed, min_feed_kill, dt, stream);
}

// gs_windowed_multistep on bfloat16 buffers: each cell widened to float32
// on load, `steps` float32 steps, each cell rounded to bfloat16 (to nearest
// even) on store.
int gs_windowed_multistep_bf16(const void* u, const void* v, void* u_out,
                               void* v_out, int rows, int cols, int steps,
                               int naive, int device, float w0, float w1,
                               float w2, float w3, float w4, float w5,
                               float w6, float w7, float w8, float du,
                               float dv, float feed, float min_feed_kill,
                               float dt, void* stream) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return multistep(static_cast<const sm90::bf16*>(u),
                   static_cast<const sm90::bf16*>(v),
                   static_cast<sm90::bf16*>(u_out),
                   static_cast<sm90::bf16*>(v_out), rows, cols, steps, naive,
                   device, w, du, dv, feed, min_feed_kill, dt, stream);
}

// The folded naive reaction (pallas_stencil.py:_kernel with fast_fold;
// stencil.step_naive_fold): one launch of `steps` (1..HALO) folded steps of
// the naive boundary, as gs_windowed_multistep enqueues. `fold` holds
// gs_fold_floats() floats (sm90::FoldConstants' order); `separable`: the
// stencil's separable plan runs (else the direct sum); `dt_is_one`: the
// quadratic term is uv^2. Returns cudaGetLastError() (0 when the launch was
// accepted).
int gs_windowed_multistep_fold(const float* u, const float* v, float* u_out,
                               float* v_out, int rows, int cols, int steps,
                               int device, const float* fold, int separable,
                               int dt_is_one, void* stream) {
  return fold_multistep(u, v, u_out, v_out, rows, cols, steps, device, fold,
                        separable, dt_is_one, stream);
}

// gs_windowed_multistep_fold on bfloat16 buffers (widened on load, rounded
// on store, once a launch).
int gs_windowed_multistep_fold_bf16(const void* u, const void* v,
                                    void* u_out, void* v_out, int rows,
                                    int cols, int steps, int device,
                                    const float* fold, int separable,
                                    int dt_is_one, void* stream) {
  return fold_multistep(static_cast<const sm90::bf16*>(u),
                        static_cast<const sm90::bf16*>(v),
                        static_cast<sm90::bf16*>(u_out),
                        static_cast<sm90::bf16*>(v_out), rows, cols, steps,
                        device, fold, separable, dt_is_one, stream);
}

// Enqueues one launch on `stream` that advances every shard of an
// n_rows x n_cols mesh by `steps` (1..HALO) steps of the rows x cols domain,
// from slot `src` of each shard's pairs (u_pairs, v_pairs: (n_rows, n_cols,
// 2, HALO + r_loc + HALO, chalo + c_loc + chalo), its halos filled) into the
// interior of slot 1 - src; `part` 0 steps every tile, 1 the tiles of the
// rectangle [ti0, ti1) x [tj0, tj1), 2 the others (see the note at the
// top). Returns cudaGetLastError() (0 when the launch was accepted, or
// when part 1 has no tile), or cudaErrorInvalidValue for a geometry the
// kernel does not take.
int gs_windowed_shard_multistep(
    float* u_pairs, float* v_pairs, int n_rows, int n_cols, int r_loc,
    int c_loc, int chalo, int src, int rows, int cols, int steps, int part,
    int ti0, int ti1, int tj0, int tj1, int naive, int device, float w0,
    float w1, float w2, float w3, float w4, float w5, float w6, float w7,
    float w8, float du, float dv, float feed, float min_feed_kill, float dt,
    void* stream) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return shard_multistep(u_pairs, v_pairs, n_rows, n_cols, r_loc, c_loc,
                         chalo, src, rows, cols, steps, part, ti0, ti1, tj0,
                         tj1, naive, device, w, du, dv, feed, min_feed_kill,
                         dt, stream);
}

// gs_windowed_shard_multistep on bfloat16 pairs (widened on load, rounded
// on store).
int gs_windowed_shard_multistep_bf16(
    void* u_pairs, void* v_pairs, int n_rows, int n_cols, int r_loc,
    int c_loc, int chalo, int src, int rows, int cols, int steps, int part,
    int ti0, int ti1, int tj0, int tj1, int naive, int device, float w0,
    float w1, float w2, float w3, float w4, float w5, float w6, float w7,
    float w8, float du, float dv, float feed, float min_feed_kill, float dt,
    void* stream) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return shard_multistep(static_cast<sm90::bf16*>(u_pairs),
                         static_cast<sm90::bf16*>(v_pairs), n_rows, n_cols,
                         r_loc, c_loc, chalo, src, rows, cols, steps, part,
                         ti0, ti1, tj0, tj1, naive, device, w, du, dv, feed,
                         min_feed_kill, dt, stream);
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
  const Call<float> c = make_call(u, v, u_out, v_out, rows, cols, steps,
                                  naive, device, w, du, dv, feed,
                                  min_feed_kill, dt, stream, &err);
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
