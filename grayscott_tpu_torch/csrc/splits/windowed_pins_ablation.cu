// The split of K1's pinned entries (windowed_pins.cu: the pinned entry and
// the pinned shard entry): each entry with one part of its design taken
// out or changed, for timing what each part costs. Every part gives the
// whole kernel's result but part 2, which steps nothing (its result is its
// input). The default stencil's tap set, naive boundary, float32 only.
//
//   0  the first form: window_multistep / shard_window_multistep on
//      PinGeometry's run-time sizes, 512 threads bound to two blocks an SM
//      (64 registers a thread)
//   1  the first form on 1024 threads at 64 registers (PinGeometryWide),
//      one block an SM
//   2  the first form's window load and store alone, no step
//   3  the first form with every tile an edge tile (SPECIALIZE = false)
//   4  the first form on the tile's sizes compiled in (FixedPin: 64x64 and
//      32x64 tiles at a halo of 16, those two only)
//   5  4 x 4 register blocks with 16-byte shared loads on interior tiles
//      (gs_pin_sm90.cuh: pin_step_blocks), edge tiles on the strips
//   6  clusters of 2 x 2 blocks over 2 x 2 tiles, each block's inner edges
//      read from its neighbours through distributed shared memory
//      (gs_pin_sm90.cuh: cluster_window_multistep_on); the shard entry's
//      part 6 takes every tile of the shards (tile set 0) only
//
// and on the pinned entry alone (the shard entry's parts 0-6 showed the
// same ranking; the library's units build side by side within 75 s):
//
//   7  part 5 walked without a division an item (walk_items)
//   8  part 7 on the tile's sizes compiled in (part 4's two geometries)
//   9  part 7 on 1024 threads at 64 registers
//  10  part 8 on 1024 threads at 64 registers
//  11  part 6 with the inner edges sent in a pass of their own after the
//      step (a __syncthreads, then the edge cells from the new buffer)
//  12  the first form's strips walked without a division an item
//  13  part 11 with the cluster barrier split: a block steps the cells
//      that read no ghost cell before it waits for its neighbours' edges
//
// The launches are not the main path's and are not counted.

#include "../gs_pin_sm90.cuh"

namespace {

namespace sm90 = gs::sm90;

using sm90::PinGeometry;
using sm90::PinGeometryWide;

constexpr int PARTS = 14;
constexpr int SHARD_PARTS = 7;
constexpr int TAPS = sm90::TAPS_RING;
constexpr int MODE = sm90::MODE_NAIVE;
constexpr int THREADS = PinGeometry::NT;

using Cluster = sm90::ClusterShape<THREADS>;
using Fixed64 = sm90::FixedPin<64, 64, 16>;
using Fixed32 = sm90::FixedPin<32, 64, 16>;
using Fixed64Wide = sm90::FixedPin<64, 64, 16, 2 * THREADS>;
using Fixed32Wide = sm90::FixedPin<32, 64, 16, 2 * THREADS>;

// The step loop of a part that runs pin_window_multistep_on (parts 5, 7-10
// and 12).
template <int PART>
__host__ __device__ constexpr int form_of() {
  return PART == 5 ? sm90::PIN_BLOCKS
                   : (PART == 12 ? sm90::PIN_STRIPS_WALK
                                 : sm90::PIN_BLOCKS_WALK);
}

__host__ __device__ constexpr bool cluster_part(int part) {
  return part == 6 || part == 11 || part == 13;
}

// The cluster form of a cluster part.
__host__ __device__ constexpr int cluster_form(int part) {
  return part == 6 ? sm90::CLUSTER_PUSH_CELLS
                   : (part == 11 ? sm90::CLUSTER_PUSH_PASS
                                 : sm90::CLUSTER_SPLIT);
}

__host__ __device__ constexpr bool walked_part(int part) {
  return part == 5 || (part >= 7 && part <= 10) || part == 12;
}

template <typename S>
__host__ __device__ constexpr int min_blocks() {
  return S::NT > THREADS ? 1 : 2;
}

template <int PART, typename S>
__global__ void __launch_bounds__(S::NT, (min_blocks<S>()))
pinned_ablation_kernel(const float* u, const float* v, float* u_out,
                       float* v_out, int rows, int cols, int steps,
                       gs::Constants k, S g, int aligned) {
  extern __shared__ float4 window[];
  float* base = reinterpret_cast<float*>(window);
  if constexpr (cluster_part(PART)) {
    sm90::cluster_window_multistep<TAPS, MODE, cluster_form(PART)>(
        g, u, v, u_out, v_out, rows, cols, steps, k, aligned, base);
  } else if constexpr (walked_part(PART)) {
    sm90::pin_window_multistep_on<TAPS, MODE, form_of<PART>(), true, false,
                                  false>(
        g, gs::FlatLayout{cols}, u, v, u_out, v_out,
        blockIdx.y * g.tr - g.halo, blockIdx.x * g.tc - g.halo, rows, cols,
        steps, k, aligned, base);
  } else {
    sm90::window_multistep<TAPS, MODE, PART != 3>(
        g, u, v, u_out, v_out, rows, cols, steps, k, aligned, base);
  }
}

template <int PART, typename S>
__global__ void __launch_bounds__(S::NT, (min_blocks<S>()))
shard_ablation_kernel(sm90::Shards<float> s, int rows, int cols, int steps,
                      gs::Constants k, S g) {
  extern __shared__ float4 window[];
  float* base = reinterpret_cast<float*>(window);
  if constexpr (cluster_part(PART)) {
    sm90::cluster_shard_multistep<TAPS, MODE, cluster_form(PART)>(
        g, s, rows, cols, steps, k, base);
  } else if constexpr (walked_part(PART)) {
    sm90::pin_shard_multistep<TAPS, MODE, form_of<PART>(), true>(
        g, s, rows, cols, steps, k, base);
  } else if constexpr (PART == 3) {
    sm90::pin_shard_multistep<TAPS, MODE, sm90::PIN_STRIPS, false>(
        g, s, rows, cols, steps, k, base);
  } else {
    sm90::shard_window_multistep<TAPS, MODE>(g, s, rows, cols, steps, k,
                                             base);
  }
}

// A part's geometry of the pinned sizes.
template <typename S>
S shape_of(const PinGeometry& p) {
  return {p.tr, p.tc, p.halo, p.wr, p.wc, p.pitch, p.cells};
}

// Dynamic shared memory of a part on p.
size_t part_bytes(int part, const PinGeometry& p) {
  if (cluster_part(part)) {
    return sm90::cluster_bytes(
        sm90::cluster_geometry<THREADS>(p.tr, p.tc, p.halo));
  }
  return sm90::pin_bytes(p);
}

// Allow `kernel` the most dynamic shared memory a block may use, once per
// device.
template <typename Kernel>
cudaError_t allow(Kernel kernel, bool* allowed, int device) {
  if (allowed[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sm90::SMEM_OPTIN));
  if (err == cudaSuccess) allowed[device] = true;
  return err;
}

struct Call {
  const float *u, *v;
  float *u_out, *v_out;
  int rows, cols, steps, device;
  gs::Constants k;
  PinGeometry p;
  cudaStream_t stream;
};

template <int PART, typename S>
cudaError_t launch_pinned(const Call& c, S g) {
  static bool allowed[gs::MAX_DEVICES];
  auto kernel = pinned_ablation_kernel<PART, S>;
  cudaError_t err = allow(kernel, allowed, c.device);
  if (err != cudaSuccess) return err;
  const int aligned =
      sm90::rows_aligned<float>(c.cols, c.u, c.v, c.u_out, c.v_out) &&
      c.p.tc % (cluster_part(PART) ? 8 : 4) == 0;
  const int tiles_x = (c.cols + c.p.tc - 1) / c.p.tc;
  const int tiles_y = (c.rows + c.p.tr - 1) / c.p.tr;
  const size_t bytes = part_bytes(PART, c.p);
  if constexpr (cluster_part(PART)) {
    const dim3 grid = sm90::cluster_grid(tiles_x, tiles_y, 1);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    return sm90::launch_clustered(kernel, grid, S::NT, bytes, c.stream,
                                  c.u, c.v, c.u_out, c.v_out, c.rows,
                                  c.cols, c.steps, c.k, g, aligned);
  } else {
    const dim3 grid(tiles_x, tiles_y);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    kernel<<<grid, S::NT, bytes, c.stream>>>(c.u, c.v, c.u_out, c.v_out,
                                             c.rows, c.cols, c.steps, c.k,
                                             g, aligned);
    return cudaGetLastError();
  }
}

cudaError_t dispatch_pinned(const Call& c, int part) {
  const PinGeometry& p = c.p;
  switch (part) {
    case 0:
      return launch_pinned<0>(c, p);
    case 1:
      return launch_pinned<1>(c, shape_of<PinGeometryWide>(p));
    case 2: {  // part 0's kernel, no step
      Call a = c;
      a.steps = 0;
      return launch_pinned<0>(a, p);
    }
    case 3:
      return launch_pinned<3>(c, p);
    case 4:
      if (p.tr == 64 && p.tc == 64 && p.halo == 16) {
        return launch_pinned<4>(c, Fixed64{});
      }
      if (p.tr == 32 && p.tc == 64 && p.halo == 16) {
        return launch_pinned<4>(c, Fixed32{});
      }
      return cudaErrorInvalidValue;
    case 5:
      return launch_pinned<5>(c, p);
    case 6:
      return launch_pinned<6>(
          c, sm90::cluster_geometry<THREADS>(p.tr, p.tc, p.halo));
    case 7:
      return launch_pinned<7>(c, p);
    case 8:
      if (p.tr == 64 && p.tc == 64 && p.halo == 16) {
        return launch_pinned<8>(c, Fixed64{});
      }
      if (p.tr == 32 && p.tc == 64 && p.halo == 16) {
        return launch_pinned<8>(c, Fixed32{});
      }
      return cudaErrorInvalidValue;
    case 9:
      return launch_pinned<9>(c, shape_of<PinGeometryWide>(p));
    case 10:
      if (p.tr == 64 && p.tc == 64 && p.halo == 16) {
        return launch_pinned<10>(c, Fixed64Wide{});
      }
      if (p.tr == 32 && p.tc == 64 && p.halo == 16) {
        return launch_pinned<10>(c, Fixed32Wide{});
      }
      return cudaErrorInvalidValue;
    case 11:
      return launch_pinned<11>(
          c, sm90::cluster_geometry<THREADS>(p.tr, p.tc, p.halo));
    case 12:
      return launch_pinned<12>(c, p);
    case 13:
      return launch_pinned<13>(
          c, sm90::cluster_geometry<THREADS>(p.tr, p.tc, p.halo));
    default:
      return cudaErrorInvalidValue;
  }
}

struct ShardCall {
  sm90::Shards<float> s;
  int n_shards, rows, cols, steps, device;
  gs::Constants k;
  PinGeometry p;
  cudaStream_t stream;
};

template <int PART, typename S>
cudaError_t launch_shards(const ShardCall& c, S g) {
  static bool allowed[gs::MAX_DEVICES];
  auto kernel = shard_ablation_kernel<PART, S>;
  cudaError_t err = allow(kernel, allowed, c.device);
  if (err != cudaSuccess) return err;
  const sm90::Shards<float>& s = c.s;
  const int tiles_x = (s.c_loc + c.p.tc - 1) / c.p.tc;
  const int tiles_y = (s.r_loc + c.p.tr - 1) / c.p.tr;
  const size_t bytes = part_bytes(PART, c.p);
  if constexpr (cluster_part(PART)) {
    if (s.part != 0) return cudaErrorInvalidValue;
    const dim3 grid = sm90::cluster_grid(tiles_x, tiles_y, c.n_shards);
    if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
    return sm90::launch_clustered(kernel, grid, S::NT, bytes, c.stream, s,
                                  c.rows, c.cols, c.steps, c.k, g);
  } else {
    const dim3 grid = s.part == 1
                          ? dim3(s.tj1 - s.tj0, s.ti1 - s.ti0, c.n_shards)
                          : dim3(tiles_x, tiles_y, c.n_shards);
    if (grid.x == 0 || grid.y == 0) return cudaSuccess;  // an empty part
    if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
    kernel<<<grid, S::NT, bytes, c.stream>>>(s, c.rows, c.cols, c.steps,
                                             c.k, g);
    return cudaGetLastError();
  }
}

cudaError_t dispatch_shards(const ShardCall& c, int part) {
  const PinGeometry& p = c.p;
  switch (part) {
    case 0:
      return launch_shards<0>(c, p);
    case 1:
      return launch_shards<1>(c, shape_of<PinGeometryWide>(p));
    case 2: {
      ShardCall a = c;
      a.steps = 0;
      return launch_shards<0>(a, p);
    }
    case 3:
      return launch_shards<3>(c, p);
    case 4:
      if (p.tr == 64 && p.tc == 64 && p.halo == 16) {
        return launch_shards<4>(c, Fixed64{});
      }
      if (p.tr == 32 && p.tc == 64 && p.halo == 16) {
        return launch_shards<4>(c, Fixed32{});
      }
      return cudaErrorInvalidValue;
    case 5:
      return launch_shards<5>(c, p);
    case 6:
      return launch_shards<6>(
          c, sm90::cluster_geometry<THREADS>(p.tr, p.tc, p.halo));
    default:
      return cudaErrorInvalidValue;
  }
}

// The checks both entries share: the geometry, the part's bytes, the
// naive boundary's default tap set, the device.
cudaError_t check(int tr, int tc, int halo, int steps, int part, int naive,
                  const gs::Constants& k, int device) {
  if (!sm90::pin_ok(tr, tc, halo, steps) || part < 0 || part >= PARTS ||
      !naive || sm90::tap_mask(k) != TAPS || device < 0 ||
      device >= gs::MAX_DEVICES ||
      part_bytes(part, sm90::pin_geometry(tr, tc, halo)) > sm90::SMEM_OPTIN) {
    return cudaErrorInvalidValue;
  }
  return cudaSetDevice(device);
}

gs::Constants constants(const float* w, float du, float dv, float feed,
                        float min_feed_kill, float dt) {
  return {{w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8]},
          du, dv, feed, min_feed_kill, dt};
}

}  // namespace

extern "C" {

// The parts of the split (the shard entry's: SHARD_PARTS).
int gs_windowed_pinned_ablation_parts() { return PARTS; }

// gs_windowed_pinned_multistep (naive, the default stencil's tap set,
// float32) in the form of `part`. Returns cudaGetLastError() (0 when the
// launch was accepted) or cudaErrorInvalidValue for a call the part does
// not take.
int gs_windowed_pinned_ablation(const float* u, const float* v, float* u_out,
                                float* v_out, int rows, int cols, int steps,
                                int tr, int tc, int halo, int naive,
                                int device, float w0, float w1, float w2,
                                float w3, float w4, float w5, float w6,
                                float w7, float w8, float du, float dv,
                                float feed, float min_feed_kill, float dt,
                                void* stream, int part) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  const gs::Constants k = constants(w, du, dv, feed, min_feed_kill, dt);
  if (rows < 1 || cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = check(tr, tc, halo, steps, part, naive, k, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Call c = {u,     v,      u_out, v_out, rows, cols, steps, device, k,
                  sm90::pin_geometry(tr, tc, halo),
                  static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_pinned(c, part));
}

// gs_windowed_shard_pinned_multistep (naive, the default stencil's tap set,
// float32 pairs) in the form of `part` (0-6); `tile_part` is the entry's
// tile set (0 every tile, 1 the overlap-interior rectangle, 2 the rest;
// part 6 takes 0 only).
int gs_windowed_shard_pinned_ablation(
    float* u_pairs, float* v_pairs, int n_rows, int n_cols, int row0,
    int col0, int r_loc, int c_loc, int chalo, int src, int rows, int cols,
    int steps, int tile_part, int ti0, int ti1, int tj0, int tj1, int tr,
    int tc, int halo, int naive, int device, float w0, float w1, float w2,
    float w3, float w4, float w5, float w6, float w7, float w8, float du,
    float dv, float feed, float min_feed_kill, float dt, void* stream,
    int part) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  const gs::Constants k = constants(w, du, dv, feed, min_feed_kill, dt);
  const int tiles_y = tr > 0 ? (r_loc + tr - 1) / tr : 0;
  const int tiles_x = tc > 0 ? (c_loc + tc - 1) / tc : 0;
  if (n_rows < 1 || n_cols < 1 || row0 < 0 || col0 < 0 || r_loc < 1 ||
      c_loc < 1 || chalo < 0 || chalo > halo || (src != 0 && src != 1) ||
      rows < 1 || cols < 1 || tile_part < 0 || tile_part > 2 || ti0 < 0 ||
      ti0 > ti1 || ti1 > tiles_y || tj0 < 0 || tj0 > tj1 || tj1 > tiles_x) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (part >= SHARD_PARTS) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = check(tr, tc, halo, steps, part, naive, k, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ShardCall c = {{u_pairs, v_pairs, n_cols, r_loc, c_loc, chalo, src,
                        tile_part, ti0, ti1, tj0, tj1, row0, col0},
                       n_rows * n_cols,
                       rows,
                       cols,
                       steps,
                       device,
                       k,
                       sm90::pin_geometry(tr, tc, halo),
                       static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_shards(c, part));
}

// The blocks of part 6's kernel (the pinned entry's, `shard` 0, or the
// shard entry's) that an SM holds at tr x tc tiles and `halo`, by its
// registers and shared memory (*per_sm), and the clusters of 2 x 2 blocks
// the device holds at once (*clusters).
int gs_windowed_pinned_ablation_occupancy(int tr, int tc, int halo,
                                          int shard, int device,
                                          int* per_sm, int* clusters) {
  if (!sm90::pin_ok(tr, tc, halo, 1) || device < 0 ||
      device >= gs::MAX_DEVICES) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = part_bytes(6, sm90::pin_geometry(tr, tc, halo));
  if (bytes > sm90::SMEM_OPTIN) return static_cast<int>(cudaErrorInvalidValue);
  err = shard ? sm90::cluster_occupancy(shard_ablation_kernel<6, Cluster>,
                                        THREADS, bytes, clusters, per_sm)
              : sm90::cluster_occupancy(pinned_ablation_kernel<6, Cluster>,
                                        THREADS, bytes, clusters, per_sm);
  return static_cast<int>(err);
}

}  // extern "C"
