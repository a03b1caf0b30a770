// K1 on a pinned geometry: the tile and depth pins of the windowed kernel
// (--pallas-block-rows, --pallas-block-cols, --pallas-steps-per-call),
// written by hand for Hopper (sm_90a).
//
// Replaces grayscott_tpu/ops/pallas_stencil.py:_kernel with its `tr`, `tc`,
// `chalo`, `steps` and `halo` (:929-999), as PallasSimulation runs it under
// those pins (grayscott_tpu/backends/pallas.py:84-99, :270-313). One launch
// advances the (rows, cols) domain by `steps` <= halo steps, as windowed.cu's
// windowed_kernel does, on tr x tc tiles in windows of `halo` cells more on
// every side (halo = halo_for_steps(K): 8, 16, 24 or 32), all known at run
// time (gs_tile_sm90.cuh: PinGeometry; windowed.cu's window_multistep on its
// int sizes):
//
//   - each block loads its window of U and V into dynamic shared memory
//     (16-byte cp.async copies where the rows and the tile width allow
//     them, 4-byte copies elsewhere; bf16 storage widened through
//     registers), cells outside the domain as 0.0;
//   - step s computes window cells [s+1, W-s-1) from one buffer into the
//     other in register strips of 4 cells, the tiles whose window lies
//     inside the domain with the fixed term list and no boundary
//     arithmetic, the others cell by cell at the domain's edge;
//   - the tile, masked to the domain, is written out (bf16: rounded to
//     nearest even once a launch, as pallas_stencil.py:970-993 rounds once
//     a K-step block).
//
// The four entries (float32, bf16, the folded naive reaction on either
// storage) are those of windowed.cu on this geometry; windowed.cu keeps the
// compiled geometry (Main: 64x64 tiles, halo 8), which an unpinned run and
// a pin equal to it launch. A deeper halo recomputes more cells per output
// cell-step (1.24x at K = 8 on 64x64 tiles, 1.54x at K = 16) and a larger
// window leaves one block on an SM (147,456 B at K = 16): the pins trade
// the HBM passes that a deeper K saves against both, which the card
// measures (PERF.md §6). The kernels are bound to 64 registers a thread,
// as Main's are.
//
// The shard entries (gs_windowed_shard_pinned_multistep and its bf16 twin)
// are windowed.cu's shard entry under the sharded windowed engine's K and
// row tile (--backend sharded --sharded-engine windowed
// --pallas-steps-per-call K --pallas-block-rows N;
// grayscott_tpu/backends/sharded.py:86-139, :263-279): every shard of a
// mesh in one launch, each shard's pairs holding `halo` = halo_for_steps(K)
// rows (and, on a 2-D mesh, as many columns) of its neighbours' cells
// (grayscott_tpu_torch/parallel/halo.py), on tr x tc tiles in windows of
// `halo` cells more on every side, through the compiled entry's block body
// (gs_tile_sm90.cuh: shard_window_multistep). bf16 storage rounds once a
// launch, a block of K steps, as JAX's sharded engine rounds once a
// K-step block. The default stencils' tap set has an instantiation of its
// own, any other runs with its weights tested at run time
// (gs_tile_sm90.cuh: dispatch_taps_lean).

#include "gs_tile_sm90.cuh"

namespace {

namespace sm90 = gs::sm90;

using sm90::PinGeometry;

// blocks an SM the register budget allows (__launch_bounds__): Main's
constexpr int MIN_BLOCKS = 2;

template <int TAPS, int MODE, typename T, typename K>
__global__ void __launch_bounds__(PinGeometry::NT, MIN_BLOCKS)
pinned_kernel(const T* u, const T* v, T* u_out, T* v_out, int rows,
              int cols, int steps, K k, PinGeometry g, int aligned) {
  extern __shared__ float4 window[];  // buffers [2] x species [2]
  sm90::window_multistep<TAPS, MODE, true>(g, u, v, u_out, v_out, rows,
                                           cols, steps, k, aligned,
                                           reinterpret_cast<float*>(window));
}

template <typename T, typename K>
struct Call {
  const T *u, *v;
  T *u_out, *v_out;
  int rows, cols, steps, naive, device;
  K k;
  PinGeometry g;
  cudaStream_t stream;
};

// One launch of pinned_kernel<TAPS, MODE, T, K>, after allowing it the most
// dynamic shared memory a block may use (once per device).
template <int TAPS, int MODE, typename T, typename K>
cudaError_t launch_one(const Call<T, K>& c) {
  static bool allowed[gs::MAX_DEVICES];
  auto kernel = pinned_kernel<TAPS, MODE, T, K>;
  if (!allowed[c.device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sm90::SMEM_OPTIN));
    if (err != cudaSuccess) return err;
    allowed[c.device] = true;
  }
  const dim3 grid((c.cols + c.g.tc - 1) / c.g.tc,
                  (c.rows + c.g.tr - 1) / c.g.tr);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const int aligned =
      sm90::rows_aligned<T>(c.cols, c.u, c.v, c.u_out, c.v_out) &&
      c.g.tc % sm90::vec_cells<T>() == 0;
  kernel<<<grid, PinGeometry::NT, sm90::pin_bytes(c.g), c.stream>>>(
      c.u, c.v, c.u_out, c.v_out, c.rows, c.cols, c.steps, c.k, c.g,
      aligned);
  return cudaGetLastError();
}

template <int TAPS>
struct Launch {
  template <typename T>
  static cudaError_t run(const Call<T, gs::Constants>& c) {
    return c.naive ? launch_one<TAPS, sm90::MODE_NAIVE>(c)
                   : launch_one<TAPS, sm90::MODE_ZERO>(c);
  }
};

template <int TAPS>
struct LaunchFold {
  template <typename T>
  static cudaError_t run(const Call<T, sm90::FoldConstants>& c) {
    return launch_one<TAPS, sm90::MODE_FOLD>(c);
  }
};

template <int TAPS, int MODE, typename T>
__global__ void __launch_bounds__(PinGeometry::NT, MIN_BLOCKS)
shard_pinned_kernel(sm90::Shards<T> s, int rows, int cols, int steps,
                    gs::Constants k, PinGeometry g) {
  extern __shared__ float4 window[];  // buffers [2] x species [2]
  sm90::shard_window_multistep<TAPS, MODE>(g, s, rows, cols, steps, k,
                                           reinterpret_cast<float*>(window));
}

template <typename T>
struct ShardCall {
  sm90::Shards<T> s;
  int n_shards, rows, cols, steps, naive, device;
  gs::Constants k;
  PinGeometry g;
  cudaStream_t stream;
};

// One launch of shard_pinned_kernel<TAPS, MODE, T>, after allowing it the
// most dynamic shared memory a block may use (once per device).
template <int MODE, int TAPS, typename T>
cudaError_t launch_shards_one(const ShardCall<T>& c) {
  static bool allowed[gs::MAX_DEVICES];
  auto kernel = shard_pinned_kernel<TAPS, MODE, T>;
  if (!allowed[c.device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sm90::SMEM_OPTIN));
    if (err != cudaSuccess) return err;
    allowed[c.device] = true;
  }
  const sm90::Shards<T>& s = c.s;
  const dim3 grid =
      s.part == 1 ? dim3(s.tj1 - s.tj0, s.ti1 - s.ti0, c.n_shards)
                  : dim3((s.c_loc + c.g.tc - 1) / c.g.tc,
                         (s.r_loc + c.g.tr - 1) / c.g.tr, c.n_shards);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;  // an empty part
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, PinGeometry::NT, sm90::pin_bytes(c.g), c.stream>>>(
      s, c.rows, c.cols, c.steps, c.k, c.g);
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

// The C interface's checks: the geometry (sm90::pin_ok) and the device.
cudaError_t check(int rows, int cols, int steps, int tr, int tc, int halo,
                  int device) {
  if (rows < 1 || cols < 1 || !sm90::pin_ok(tr, tc, halo, steps) ||
      device < 0 || device >= gs::MAX_DEVICES) {
    return cudaErrorInvalidValue;
  }
  return cudaSetDevice(device);
}

template <typename T>
int multistep(const T* u, const T* v, T* u_out, T* v_out, int rows, int cols,
              int steps, int tr, int tc, int halo, int naive, int device,
              const float* w, float du, float dv, float feed,
              float min_feed_kill, float dt, void* stream) {
  const cudaError_t err = check(rows, cols, steps, tr, tc, halo, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Call<T, gs::Constants> c = {
      u, v, u_out, v_out, rows, cols, steps, naive, device,
      {{w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8]},
       du, dv, feed, min_feed_kill, dt},
      sm90::pin_geometry(tr, tc, halo), static_cast<cudaStream_t>(stream)};
  return static_cast<int>(sm90::dispatch_taps<Launch>(c.k, c));
}

template <typename T>
int fold_multistep(const T* u, const T* v, T* u_out, T* v_out, int rows,
                   int cols, int steps, int tr, int tc, int halo, int device,
                   const float* fold, int separable, int dt_is_one,
                   void* stream) {
  const cudaError_t err = check(rows, cols, steps, tr, tc, halo, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Call<T, sm90::FoldConstants> c = {
      u, v, u_out, v_out, rows, cols, steps, 1, device,
      sm90::fold_constants(fold, dt_is_one),
      sm90::pin_geometry(tr, tc, halo), static_cast<cudaStream_t>(stream)};
  return static_cast<int>(
      sm90::dispatch_fold<LaunchFold>(c.k, separable, c));
}

// gs_windowed_shard_pinned_multistep and its bf16 twin.
template <typename T>
int shard_multistep(T* u_pairs, T* v_pairs, int n_rows, int n_cols,
                    int r_loc, int c_loc, int chalo, int src, int rows,
                    int cols, int steps, int part, int ti0, int ti1, int tj0,
                    int tj1, int tr, int tc, int halo, int naive, int device,
                    const float* w, float du, float dv, float feed,
                    float min_feed_kill, float dt, void* stream) {
  if (!sm90::pin_ok(tr, tc, halo, steps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_y = (r_loc + tr - 1) / tr;
  const int tiles_x = (c_loc + tc - 1) / tc;
  if (n_rows < 1 || n_cols < 1 || r_loc < 1 || c_loc < 1 || chalo < 0 ||
      chalo > halo || (src != 0 && src != 1) || rows < 1 || cols < 1 ||
      part < 0 || part > 2 || ti0 < 0 || ti0 > ti1 || ti1 > tiles_y ||
      tj0 < 0 || tj0 > tj1 || tj1 > tiles_x || device < 0 ||
      device >= gs::MAX_DEVICES) {
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
      sm90::pin_geometry(tr, tc, halo),
      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(sm90::dispatch_taps_lean<LaunchShards>(c.k, c));
}

}  // namespace

extern "C" {

int gs_windowed_pinned_max_steps() { return sm90::PIN_MAX_STEPS; }

// gs_windowed_multistep on tr x tc tiles in windows of `halo` (8, 16, 24 or
// 32) cells more on every side, `steps` (1..halo) steps a launch. Returns
// cudaGetLastError() (0 when the launch was accepted), or
// cudaErrorInvalidValue for a geometry the entry does not take (the
// windows past the shared memory a block may use among them).
int gs_windowed_pinned_multistep(const float* u, const float* v,
                                 float* u_out, float* v_out, int rows,
                                 int cols, int steps, int tr, int tc,
                                 int halo, int naive, int device, float w0,
                                 float w1, float w2, float w3, float w4,
                                 float w5, float w6, float w7, float w8,
                                 float du, float dv, float feed,
                                 float min_feed_kill, float dt,
                                 void* stream) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return multistep(u, v, u_out, v_out, rows, cols, steps, tr, tc, halo,
                   naive, device, w, du, dv, feed, min_feed_kill, dt, stream);
}

// gs_windowed_pinned_multistep on bfloat16 buffers (widened on load,
// rounded on store, once a launch).
int gs_windowed_pinned_multistep_bf16(const void* u, const void* v,
                                      void* u_out, void* v_out, int rows,
                                      int cols, int steps, int tr, int tc,
                                      int halo, int naive, int device,
                                      float w0, float w1, float w2, float w3,
                                      float w4, float w5, float w6, float w7,
                                      float w8, float du, float dv,
                                      float feed, float min_feed_kill,
                                      float dt, void* stream) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return multistep(static_cast<const sm90::bf16*>(u),
                   static_cast<const sm90::bf16*>(v),
                   static_cast<sm90::bf16*>(u_out),
                   static_cast<sm90::bf16*>(v_out), rows, cols, steps, tr,
                   tc, halo, naive, device, w, du, dv, feed, min_feed_kill,
                   dt, stream);
}

// gs_windowed_multistep_fold on a pinned geometry.
int gs_windowed_pinned_multistep_fold(const float* u, const float* v,
                                      float* u_out, float* v_out, int rows,
                                      int cols, int steps, int tr, int tc,
                                      int halo, int device,
                                      const float* fold, int separable,
                                      int dt_is_one, void* stream) {
  return fold_multistep(u, v, u_out, v_out, rows, cols, steps, tr, tc, halo,
                        device, fold, separable, dt_is_one, stream);
}

// gs_windowed_multistep_fold_bf16 on a pinned geometry.
int gs_windowed_pinned_multistep_fold_bf16(const void* u, const void* v,
                                           void* u_out, void* v_out,
                                           int rows, int cols, int steps,
                                           int tr, int tc, int halo,
                                           int device, const float* fold,
                                           int separable, int dt_is_one,
                                           void* stream) {
  return fold_multistep(static_cast<const sm90::bf16*>(u),
                        static_cast<const sm90::bf16*>(v),
                        static_cast<sm90::bf16*>(u_out),
                        static_cast<sm90::bf16*>(v_out), rows, cols, steps,
                        tr, tc, halo, device, fold, separable, dt_is_one,
                        stream);
}

// gs_windowed_shard_multistep on tr x tc tiles in windows of `halo` (8,
// 16, 24 or 32) cells more on every side, `steps` (1..halo) steps a launch,
// on pairs (n_rows, n_cols, 2, halo + r_loc + halo, chalo + c_loc + chalo)
// whose halos are `halo` rows deep (chalo: 0, or `halo` on a 2-D mesh);
// `part` and the rectangle [ti0, ti1) x [tj0, tj1) count tr x tc tiles.
// Returns cudaGetLastError() (0 when the launch was accepted, or when part
// 1 has no tile), or cudaErrorInvalidValue for a geometry the entry does
// not take.
int gs_windowed_shard_pinned_multistep(
    float* u_pairs, float* v_pairs, int n_rows, int n_cols, int r_loc,
    int c_loc, int chalo, int src, int rows, int cols, int steps, int part,
    int ti0, int ti1, int tj0, int tj1, int tr, int tc, int halo, int naive,
    int device, float w0, float w1, float w2, float w3, float w4, float w5,
    float w6, float w7, float w8, float du, float dv, float feed,
    float min_feed_kill, float dt, void* stream) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return shard_multistep(u_pairs, v_pairs, n_rows, n_cols, r_loc, c_loc,
                         chalo, src, rows, cols, steps, part, ti0, ti1, tj0,
                         tj1, tr, tc, halo, naive, device, w, du, dv, feed,
                         min_feed_kill, dt, stream);
}

// gs_windowed_shard_pinned_multistep on bfloat16 pairs (widened on load,
// rounded on store, once a launch).
int gs_windowed_shard_pinned_multistep_bf16(
    void* u_pairs, void* v_pairs, int n_rows, int n_cols, int r_loc,
    int c_loc, int chalo, int src, int rows, int cols, int steps, int part,
    int ti0, int ti1, int tj0, int tj1, int tr, int tc, int halo, int naive,
    int device, float w0, float w1, float w2, float w3, float w4, float w5,
    float w6, float w7, float w8, float du, float dv, float feed,
    float min_feed_kill, float dt, void* stream) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return shard_multistep(static_cast<sm90::bf16*>(u_pairs),
                         static_cast<sm90::bf16*>(v_pairs), n_rows, n_cols,
                         r_loc, c_loc, chalo, src, rows, cols, steps, part,
                         ti0, ti1, tj0, tj1, tr, tc, halo, naive, device, w,
                         du, dv, feed, min_feed_kill, dt, stream);
}

}  // extern "C"
