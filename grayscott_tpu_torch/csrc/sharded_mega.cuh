// What K7's translation units share (sharded_mega.cu: the compiled 64^2
// and 32^2 tiles; sharded_mega_pins.cu: the tile pins' geometry): the shard
// descriptor, the counters and their waits, the pushes, the read-site gate
// and a launch's time blocks (sharded_mega_run). See sharded_mega.cu for
// the design.

#pragma once

#include "gs_tile_sm90.cuh"

namespace {

namespace sm90 = gs::sm90;

constexpr int HALO = sm90::HALO;  // most steps per time block, the halo rows
constexpr int N_DIRS = 8;
// a shard's 64-bit counters: arrivals [slot][direction], its group's
// barrier and its group's push gather
constexpr int ARRIVALS = 0;
constexpr int BARRIER = 2 * N_DIRS;
constexpr int GATHER = BARRIER + 1;
constexpr int COUNTER_WORDS = GATHER + 1;

// Push direction d: the receiver's (row, column) offset in the mesh, in the
// order of megakernel.py:324-353: down, up, right, left, down-right,
// down-left, up-right, up-left.
__host__ __device__ constexpr int dir_row(int d) {
  return (d == 0 || d == 4 || d == 5) ? 1 : (d == 1 || d == 6 || d == 7) ? -1
                                                                          : 0;
}
__host__ __device__ constexpr int dir_col(int d) {
  return (d == 2 || d == 4 || d == 6) ? 1 : (d == 3 || d == 5 || d == 7) ? -1
                                                                          : 0;
}
// The direction whose pushes come from the neighbour in direction d.
__host__ __device__ constexpr int opposite(int d) {
  return d < 4 ? d ^ 1 : d ^ 3;
}

// T: the state's element type (float, or sm90::bf16).
template <typename T>
struct ShardDesc {
  T* pair[2];                      // its (U, V) pairs
  unsigned long long* counters;    // its COUNTER_WORDS counters
  int row0, col0;                  // global (row, col) of interior (0, 0)
  int aligned;                     // its rows 16-byte aligned
  T* nbr_pair[N_DIRS][2];          // the neighbour in direction d, or null
  unsigned long long* nbr_counters[N_DIRS];
};
static_assert(sizeof(ShardDesc<float>) == sizeof(ShardDesc<sm90::bf16>),
              "one descriptor size for both storage types");

__device__ __forceinline__ bool first_thread() { return threadIdx.x == 0; }

// The arrivals a shard waits for: every direction (the entry gate), or on a
// row mesh those that fill its top halo rows (pushed down by the neighbour
// above) and its bottom halo rows (pushed up by the neighbour below).
constexpr unsigned ALL_DIRS = (1u << N_DIRS) - 1;
constexpr unsigned TOP_ROWS = 1u << 0;
constexpr unsigned BOTTOM_ROWS = 1u << 1;

// Wait until the counter of `slot` shows `count` pushes from every present
// neighbour whose direction is in `dirs`, then make what they pushed
// visible to the whole block.
template <typename T>
__device__ __forceinline__ void wait_arrivals(const ShardDesc<T>& me, int slot,
                                              unsigned long long count,
                                              unsigned dirs = ALL_DIRS) {
  if (first_thread()) {
    const volatile unsigned long long* a =
        me.counters + ARRIVALS + slot * N_DIRS;
    for (int d = 0; d < N_DIRS; ++d) {
      if (!((dirs >> d) & 1) || me.nbr_pair[opposite(d)][0] == nullptr) {
        continue;
      }
      while (a[d] < count) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// The block's share of the pushes of `slot` into every present neighbour,
// in 16-byte copies: float4s, or 8 bfloat16 cells (pitch, chalo and c_loc
// are multiples of a copy's cells and the pairs 16-byte aligned:
// gs_sharded_mega_describe).
template <typename T>
__device__ __forceinline__ void push(const ShardDesc<T>& me, int slot,
                                     int r_loc, int c_loc, int chalo,
                                     size_t pitch, size_t plane, int rank,
                                     unsigned int size) {
  using V = typename sm90::Vec16<T>::type;
  constexpr int E = sm90::vec_cells<T>();
  const int first = rank * blockDim.x + threadIdx.x;
  const int stride = size * blockDim.x;
  const T* u = me.pair[0] + slot * plane;
  const T* v = me.pair[1] + slot * plane;
  for (int d = 0; d < N_DIRS; ++d) {
    if (me.nbr_pair[d][0] == nullptr) continue;
    T* nu = me.nbr_pair[d][0] + slot * plane;
    T* nv = me.nbr_pair[d][1] + slot * plane;
    const int dr = dir_row(d), dc = dir_col(d);
    // the band: HALO rows / chalo columns on the side of the push, else the
    // whole interior; into the receiver's opposite halo
    const int n_rows = dr ? HALO : r_loc, n_cols = dc ? chalo : c_loc;
    const int from_r = dr > 0 ? r_loc : HALO;
    const int to_r = dr > 0 ? 0 : dr < 0 ? HALO + r_loc : HALO;
    const int from_c = dc > 0 ? c_loc : chalo;
    const int to_c = dc > 0 ? 0 : dc < 0 ? chalo + c_loc : chalo;
    const int quads = n_cols / E;  // 16-byte copies a band row
    const int n = n_rows * quads;
    for (int i = first; i < n; i += stride) {
      const int r = i / quads, c = E * (i - r * quads);
      const size_t from = (from_r + r) * pitch + from_c + c;
      const size_t to = (to_r + r) * pitch + to_c + c;
      *reinterpret_cast<V*>(nu + to) =
          __ldcg(reinterpret_cast<const V*>(u + from));
      *reinterpret_cast<V*>(nv + to) =
          __ldcg(reinterpret_cast<const V*>(v + from));
    }
  }
}

// After the block's pushes of `slot` (the n-th time, n = 1, 2, ...): its
// arrival on the group's gather; the group's first block waits for all
// `size` of them and bumps each neighbour's counter of (slot, direction).
template <typename T>
__device__ __forceinline__ void arrive(const ShardDesc<T>& me, int slot,
                                       unsigned long long n,
                                       unsigned int size, bool leader) {
  __syncthreads();
  if (first_thread()) {
    __threadfence();
    atomicAdd(me.counters + GATHER, 1ULL);
    if (leader) {
      const volatile unsigned long long* gather = me.counters + GATHER;
      while (*gather < n * size) __nanosleep(32);
      __threadfence();
      for (int d = 0; d < N_DIRS; ++d) {
        if (me.nbr_counters[d] == nullptr) continue;
        atomicAdd(me.nbr_counters[d] + ARRIVALS + slot * N_DIRS + d, 1ULL);
      }
    }
  }
}

// The read-site wait's gate (READ_SITE; time_block calls it before each
// window load): in time block t > 0, before the block loads its first tile
// whose window reaches the bottom halo rows, the pushes from below. Tile row
// r's window ends at (r + 1) * tr + HALO, so those are the tiles from
// `split` = (r_loc - HALO) / tr rows of tiles_x on (tr a Fixed tile height,
// or an int: the tile pins); a block's tiles lie
// `stride` apart, so its first one there is the one in [split, split +
// stride). One wait a block and a time block, from values the kernel holds
// anyway (a second walk of time_block, or a flag, cost the naive
// instantiations, at the 64 registers they are bound to, a spill).
template <typename P, typename T>
struct BottomGate {
  const ShardDesc<T>& me;
  int t, r_loc, tiles_x;
  P tr;

  __device__ __forceinline__ void operator()(int i, int stride) const {
    const int split = (r_loc - HALO) / tr * tiles_x;
    if (t > 0 && i >= split && i - split < stride) {
      wait_arrivals(me, t & 1, (t + 1) / 2, BOTTOM_ROWS);
    }
  }
};

// One launch of K7 on the tiles of geo (FixedShape<Main> or <Small> in
// sharded_mega.cu, the PinGeometry of the tile pins in
// sharded_mega_pins.cu), for the block's shard (see sharded_mega.cu's
// note); `base` is the block's two window buffers. READ_SITE: the shards
// form a row mesh (the read-site wait: BottomGate), else each time block's
// entry is gated on every direction.
template <int TAPS, bool NAIVE, typename T, bool READ_SITE, typename S>
__device__ __forceinline__ void sharded_mega_run(
    const S& geo, const ShardDesc<T>* shards, int n_shards, int rows,
    int cols, int r_loc, int c_loc, int chalo, int n_blocks, int steps,
    const gs::Constants& k, float* base) {
  // the block's shard g and its rank among the shard's `size` blocks
  const int per = gridDim.x / n_shards, extra = gridDim.x % n_shards;
  const int b = blockIdx.x, big = extra * (per + 1);
  const int g = b < big ? b / (per + 1) : extra + (b - big) / per;
  const int rank = b - (b < big ? g * (per + 1) : big + (g - extra) * per);
  const unsigned int size = per + (g < extra ? 1 : 0);
  const ShardDesc<T>& me = shards[g];

  const size_t pitch = static_cast<size_t>(c_loc) + 2 * chalo;
  const size_t plane = (static_cast<size_t>(r_loc) + 2 * HALO) * pitch;
  const gs::ShardLayout mem = {me.row0, me.col0, r_loc, c_loc,
                               HALO,    chalo,   pitch};
  T* const u = me.pair[0];
  T* const v = me.pair[1];
  const int tiles_x = (c_loc + geo.tc - 1) / geo.tc;
  const int n_tiles = tiles_x * ((r_loc + geo.tr - 1) / geo.tr);
  for (int t = 0; t < n_blocks; ++t) {
    const size_t src = (t & 1) ? plane : 0, dst = (t & 1) ? 0 : plane;
    if (!READ_SITE) {
      if (t > 0) wait_arrivals(me, t & 1, (t + 1) / 2);
      sm90::time_block_on<TAPS, NAIVE, true, true>(
          geo, mem, u + src, v + src, u + dst, v + dst, rank, size, n_tiles,
          tiles_x, me.row0, me.col0, rows, cols, steps, k, me.aligned, base);
    } else {
      if (t > 0) wait_arrivals(me, t & 1, (t + 1) / 2, TOP_ROWS);
      sm90::time_block_on<TAPS, NAIVE, true, true>(
          geo, mem, u + src, v + src, u + dst, v + dst, rank, size, n_tiles,
          tiles_x, me.row0, me.col0, rows, cols, steps, k, me.aligned, base,
          BottomGate<decltype(geo.tr), T>{me, t, r_loc, tiles_x, geo.tr});
    }
    gs::group_barrier(me.counters + BARRIER, t + 1, size);
    push(me, 1 - (t & 1), r_loc, c_loc, chalo, pitch, plane, rank, size);
    arrive(me, 1 - (t & 1), t + 1, size, rank == 0);
  }
  wait_arrivals(me, n_blocks & 1, (n_blocks + 1) / 2);
  if (n_blocks & 1) {  // slot 1 to slot 0, halos included, 16 B a copy
    using V = typename sm90::Vec16<T>::type;
    const size_t stride = static_cast<size_t>(size) * blockDim.x;
    for (size_t i = static_cast<size_t>(rank) * blockDim.x + threadIdx.x;
         i < plane / sm90::vec_cells<T>(); i += stride) {
      reinterpret_cast<V*>(u)[i] =
          __ldcg(reinterpret_cast<const V*>(u + plane) + i);
      reinterpret_cast<V*>(v)[i] =
          __ldcg(reinterpret_cast<const V*>(v + plane) + i);
    }
  }
}

}  // namespace
