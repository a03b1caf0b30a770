// The first stepper: the per-cell and per-tile device code of the port's
// unpacked kernels before the Hopper stepper (gs_tile_sm90.cuh), which keeps
// its per-cell naive code, its layouts and its grid barrier. The ablation
// part 0 of K2 (mega.cu) and K9 (ilpsplit.cu), their first forms, still
// step on it; the host side of every persistent kernel lives here.
//
// step_tile<HALO> advances one TILE x TILE output tile by `steps` <= HALO
// Gray-Scott steps (step_tile_at does the same through a memory layout: a
// row-major domain, or one shard's padded block):
//
//   - the block loads the (TILE + 2*HALO)^2 window of U and V around its tile
//     into shared memory, cells outside the domain as 0.0;
//   - step s computes window cells [s+1, WIN-s-1) from one shared buffer into
//     the other (the valid region shrinks by one cell a step, so after
//     `steps` <= HALO steps the tile interior is still exact);
//   - cells outside the domain are written as exactly 0.0 every step (the
//     role of `dommask` in pallas_stencil.py): the zero boundary reads them;
//   - the tile interior, masked to the domain, is written to u_out / v_out.
//
// Numerics: the oracle's expression tree and term order
// (grayscott_tpu/oracle.py:84-129), built with -fmad=false and without
// -ftz, so every kernel equals the plain PyTorch step
// (grayscott_tpu_torch/ops/stencil.py) bit for bit. The naive boundary's
// clamped, top-left-anchored window is computed per cell from its global
// (row, col); every tap it reads is within one cell of the centre, so it
// always lies inside the window.
//
// Loads of the state go through __ldcg (cached in L2 only, never the
// non-coherent read-only path): K2's and K9's part 0 read, after a grid
// barrier, what other blocks wrote earlier in the same launch, and a stale
// L1 or LDG.NC line would hand them old values. For this reason no state
// pointer here is `const __restrict__`.

#pragma once

#include <cuda_runtime.h>

namespace gs {

constexpr int TILE = 32;     // output tile edge
constexpr int BLOCK_X = 32;  // threads of a block: BLOCK_X x BLOCK_Y
constexpr int BLOCK_Y = 8;

struct Constants {
  float w[9];  // stencil weights, row-major
  float du, dv, feed, min_feed_kill, dt;
};

// oracle.laplacian, naive boundary: tap i reads row max(gr-1, 0) + i and is
// valid iff that row <= min(gr+1, rows-1) (the same for columns), with
// weight row i: the window is clamped and stays anchored at its top-left.
template <int WIN>
__device__ __forceinline__ float naive_laplacian(
    const float* win, int lr, int lc, float x, int gr, int gc, int rows,
    int cols, const Constants& k) {
  const int r_start = max(gr - 1, 0), r_end = min(gr + 1, rows - 1);
  const int c_start = max(gc - 1, 0), c_end = min(gc + 1, cols - 1);
  float full = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int sr = r_start + i;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float w = k.w[3 * i + j];
      if (w == 0.0f && !(i == 1 && j == 1)) continue;
      const int sc = c_start + j;
      float term = 0.0f;
      if (sr <= r_end && sc <= c_end) {
        term = w * (win[(lr + sr - gr) * WIN + (lc + sc - gc)] - x);
      }
      full = full + term;
    }
  }
  return full;
}

// oracle.laplacian, zero boundary: centred weights; cells outside the
// domain hold 0.0 in the window.
template <int WIN>
__device__ __forceinline__ float zero_laplacian(
    const float* win, int lr, int lc, float x, const Constants& k) {
  float full = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float w = k.w[3 * i + j];
      if (w == 0.0f) continue;
      full = full + w * (win[(lr + i - 1) * WIN + (lc + j - 1)] - x);
    }
  }
  return full;
}

template <int HALO>
struct Window {
  static constexpr int WIN = TILE + 2 * HALO;
  float u[2][WIN * WIN];
  float v[2][WIN * WIN];
};

// Where the state of a domain lies in memory, for step_tile_at: whether a
// buffer holds the cell at global (row, col) (`holds`), whether the tile may
// store it (`stores`), and its offset (`at`). Only in-domain cells are asked.
//
// FlatLayout: the whole rows x cols domain, row-major (K1-K6, K9).
struct FlatLayout {
  int cols;
  __device__ __forceinline__ bool holds(int, int) const { return true; }
  __device__ __forceinline__ bool stores(int, int) const { return true; }
  __device__ __forceinline__ size_t at(int gr, int gc) const {
    return static_cast<size_t>(gr) * cols + gc;
  }
};

// ShardLayout: one shard's padded block of a sharded domain (K7, through
// gs_tile_sm90.cuh: load_window and time_block): interior
// cells [0, r_loc) x [0, c_loc) at global (row0, col0), inside `halo` rows
// and `chalo` columns of its neighbours' cells, row stride `pitch`.
struct ShardLayout {
  int row0, col0, r_loc, c_loc, halo, chalo;
  size_t pitch;
  __device__ __forceinline__ bool holds(int gr, int gc) const {
    const int lr = gr - row0, lc = gc - col0;
    return lr >= -halo && lr < r_loc + halo && lc >= -chalo &&
           lc < c_loc + chalo;
  }
  __device__ __forceinline__ bool stores(int gr, int gc) const {
    return gr - row0 < r_loc && gc - col0 < c_loc;
  }
  __device__ __forceinline__ size_t at(int gr, int gc) const {
    return static_cast<size_t>(gr - row0 + halo) * pitch + (gc - col0 + chalo);
  }
};

// Advance the TILE x TILE tile whose window cell (0, 0) lies at global
// (r0, c0) by `steps` (1..HALO) steps from (u, v) into (u_out, v_out), both
// laid out as `mem` says, through the block's shared window `s`. Cells the
// buffer does not hold load as 0.0: with `steps` <= HALO they cannot reach
// the tile. Ends in a __syncthreads(), so the block may call it again for its
// next tile.
template <int HALO, typename Layout>
__device__ __forceinline__ void step_tile_at(
    const Layout& mem, const float* u, const float* v, float* u_out,
    float* v_out, int r0, int c0, int rows, int cols, int steps, int naive,
    const Constants& k, Window<HALO>& s) {
  constexpr int WIN = Window<HALO>::WIN;
  const int tx = threadIdx.x, ty = threadIdx.y;

  for (int lr = ty; lr < WIN; lr += BLOCK_Y) {
    const int gr = r0 + lr;
    for (int lc = tx; lc < WIN; lc += BLOCK_X) {
      const int gc = c0 + lc;
      float uc = 0.0f, vc = 0.0f;
      if (gr >= 0 && gr < rows && gc >= 0 && gc < cols && mem.holds(gr, gc)) {
        const size_t g = mem.at(gr, gc);
        uc = __ldcg(u + g);
        vc = __ldcg(v + g);
      }
      s.u[0][lr * WIN + lc] = uc;
      s.v[0][lr * WIN + lc] = vc;
    }
  }
  __syncthreads();

  int cur = 0;
  for (int st = 0; st < steps; ++st) {
    const float* in_u = s.u[cur];
    const float* in_v = s.v[cur];
    float* out_u = s.u[cur ^ 1];
    float* out_v = s.v[cur ^ 1];
    const int lo = st + 1, hi = WIN - st - 1;
    for (int lr = lo + ty; lr < hi; lr += BLOCK_Y) {
      const int gr = r0 + lr;
      for (int lc = lo + tx; lc < hi; lc += BLOCK_X) {
        const int gc = c0 + lc;
        const int at = lr * WIN + lc;
        float un = 0.0f, vn = 0.0f;  // outside the domain: exactly 0.0
        if (gr >= 0 && gr < rows && gc >= 0 && gc < cols) {
          const float uc = in_u[at], vc = in_v[at];
          float full_u, full_v;
          if (naive) {
            full_u = naive_laplacian<WIN>(in_u, lr, lc, uc, gr, gc, rows,
                                          cols, k);
            full_v = naive_laplacian<WIN>(in_v, lr, lc, vc, gr, gc, rows,
                                          cols, k);
          } else {
            full_u = zero_laplacian<WIN>(in_u, lr, lc, uc, k);
            full_v = zero_laplacian<WIN>(in_v, lr, lc, vc, k);
          }
          const float uv_square = (uc * vc) * vc;
          const float du =
              ((k.du * full_u) - uv_square) + (k.feed * (1.0f - uc));
          const float dv =
              ((k.dv * full_v) + uv_square) + (k.min_feed_kill * vc);
          un = uc + du * k.dt;
          vn = vc + dv * k.dt;
        }
        out_u[at] = un;
        out_v[at] = vn;
      }
    }
    __syncthreads();
    cur ^= 1;
  }

  for (int lr = HALO + ty; lr < HALO + TILE; lr += BLOCK_Y) {
    const int gr = r0 + lr;
    for (int lc = HALO + tx; lc < HALO + TILE; lc += BLOCK_X) {
      const int gc = c0 + lc;
      if (gr < rows && gc < cols && mem.stores(gr, gc)) {
        const size_t g = mem.at(gr, gc);
        u_out[g] = s.u[cur][lr * WIN + lc];
        v_out[g] = s.v[cur][lr * WIN + lc];
      }
    }
  }
  __syncthreads();  // the window is free for the block's next tile
}

// Advance tile (tile_row, tile_col) of a rows x cols domain by `steps`
// (1..HALO) steps from (u, v) into (u_out, v_out), row-major arrays.
template <int HALO>
__device__ __forceinline__ void step_tile(
    const float* u, const float* v, float* u_out, float* v_out, int tile_row,
    int tile_col, int rows, int cols, int steps, int naive,
    const Constants& k, Window<HALO>& s) {
  step_tile_at<HALO>(FlatLayout{cols}, u, v, u_out, v_out,
                     tile_row * TILE - HALO, tile_col * TILE - HALO, rows,
                     cols, steps, naive, k, s);
}

// A barrier across `blocks` blocks of a cooperative launch (all blocks are
// co-resident, or the launch is refused) that share `counter`, zero at the
// launch; the n-th barrier (n = 1, 2, ...) returns once n * blocks arrivals
// are counted. Every thread's writes before the barrier are visible to every
// thread's __ldcg reads after it: __syncthreads() orders the block's writes
// before thread 0's __threadfence() and arrival; thread 0's fence after it
// sees the count orders the other blocks' writes before the block's later
// reads, and the closing __syncthreads() extends that to the whole block.
// (The protocol of cooperative_groups' grid sync, written out so that the
// library stays a plain whole-program build.)
__device__ __forceinline__ void group_barrier(unsigned long long* counter,
                                              unsigned long long n,
                                              unsigned int blocks) {
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    const unsigned long long target = n * blocks;
    __threadfence();
    atomicAdd(counter, 1ULL);
    while (*static_cast<volatile unsigned long long*>(counter) < target) {
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// group_barrier over every block of the launch.
__device__ __forceinline__ void grid_barrier(
    unsigned long long* counter, unsigned long long n) {
  group_barrier(counter, n, gridDim.x);
}

// Host side of a persistent kernel (K2, K3, K5-K9): the most blocks of
// `kernel` that are co-resident on `device` (occupancy x SMs, at `threads`
// threads a block and `bytes` of dynamic shared memory), cached per device
// in `cache`. A kernel that asks for dynamic shared memory is first allowed
// `allow` bytes of it on `device` (default: `bytes`; a launch above 48 KB is
// refused without that); a refusal is returned. A kernel whose launches take
// different sizes (the megakernels' window rings) is allowed the largest,
// since the attribute caps every later launch, and keeps a cache per size.
constexpr int MAX_DEVICES = 64;

template <typename Kernel>
cudaError_t coresident_blocks(Kernel kernel, int device, int* cache,
                              int* out, int threads = BLOCK_X * BLOCK_Y,
                              size_t bytes = 0, size_t allow = 0) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cache[device] == 0) {
    cudaError_t err;
    if (bytes > 0) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(allow > 0 ? allow : bytes));
      if (err != cudaSuccess) return err;
    }
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, bytes);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    cache[device] = per_sm * sms;
  }
  *out = cache[device];
  return cudaSuccess;
}

// One cooperative launch of `kernel` with `args` on `stream` over the
// tile x tile tiles of a rows x cols domain, `block` threads a block and
// `bytes` of dynamic shared memory (`allow`: coresident_blocks). `grid_blocks`
// <= 0 takes the co-resident maximum (capped at the tile count); a larger
// grid than the card can hold is refused with
// cudaErrorCooperativeLaunchTooLarge, and nothing falls back.
template <typename Kernel>
cudaError_t launch_persistent(Kernel kernel, void** args, int rows, int cols,
                              int grid_blocks, int device, int* cache,
                              cudaStream_t stream,
                              dim3 block = dim3(BLOCK_X, BLOCK_Y),
                              size_t bytes = 0, int tile = TILE,
                              size_t allow = 0) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int most = 0;  // also allows the dynamic shared memory on first use
  err = coresident_blocks(kernel, device, cache, &most,
                          block.x * block.y * block.z, bytes, allow);
  if (err != cudaSuccess) return err;
  int grid = grid_blocks;
  if (grid <= 0) {
    grid = most;
    const long long tiles =
        static_cast<long long>((cols + tile - 1) / tile) *
        ((rows + tile - 1) / tile);
    if (tiles < grid) grid = static_cast<int>(tiles);
  }
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(grid), block, args, bytes, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not report it
    return err;
  }
  return cudaGetLastError();
}

// The C interface's report of coresident_blocks: the count, or minus the
// CUDA error.
template <typename Kernel>
int max_blocks_or_error(Kernel kernel, int device, int* cache,
                        int threads = BLOCK_X * BLOCK_Y, size_t bytes = 0,
                        size_t allow = 0) {
  if (device < 0 || device >= MAX_DEVICES) {
    return -static_cast<int>(cudaErrorInvalidDevice);
  }
  cudaError_t err = cudaSetDevice(device);
  int n = 0;
  if (err == cudaSuccess) {
    err = coresident_blocks(kernel, device, cache, &n, threads, bytes, allow);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace gs
