// K1, the windowed Gray-Scott multistep, written by hand for Hopper (sm_90a).
//
// Replaces grayscott_tpu/ops/pallas_stencil.py:_kernel (the TPU kernel that
// multistep_impl and run_blocks drive). One launch advances the (rows, cols)
// domain by `steps` <= HALO Gray-Scott steps:
//
//   - a 2-D grid of TILE x TILE output tiles; each block loads the
//     (TILE + 2*HALO)^2 window of U and V around its tile into shared memory,
//     cells outside the domain as 0.0;
//   - step s computes window cells [s+1, WIN-s-1) from one shared buffer into
//     the other (the valid region shrinks by one cell a step, so after
//     `steps` <= HALO steps the tile interior is still exact);
//   - cells outside the domain are written as exactly 0.0 every step (the
//     role of `dommask` in pallas_stencil.py): the zero boundary reads them;
//   - the tile interior, masked to the domain, is written to u_out / v_out.
//
// Numerics: the oracle's expression tree and term order
// (grayscott_tpu/oracle.py:84-129), built with -fmad=false and without
// -ftz, so the kernel equals the plain PyTorch step
// (grayscott_tpu_torch/ops/stencil.py) bit for bit. The naive boundary's
// clamped, top-left-anchored window is computed per cell from its global
// (row, col); every tap it reads is within one cell of the centre, so it
// always lies inside the window.
//
// Run-time parameters: the 9 weights and the reaction scalars are by-value
// kernel arguments (the analog of the TPU kernel's runtime-parameter mode):
// changing f, k, Du, Dv, dt or the stencil rebuilds nothing.
//
// What bounds it on the card: each launch reads and writes U and V once,
// 16 B per cell per HALO steps, about 2 B per cell-step at HALO = 8, far
// below what HBM at 3.35 TB/s feeds. The limit is the redundant compute on
// the halo ring (a 48^2 window for a 32^2 tile: about 1.5x the useful
// cell-steps over 8 steps), the shared-memory traffic of the 9-tap reads,
// the per-cell boundary arithmetic and one __syncthreads() a step. wgmma
// does not apply (no matrix product); staging the window with TMA or
// cp.async and larger tiles in dynamic shared memory are later work.

#include <cuda_runtime.h>

namespace {

constexpr int HALO = 8;                  // most steps per launch (K)
constexpr int TILE = 32;                 // output tile edge
constexpr int WIN = TILE + 2 * HALO;     // window edge
constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;

struct Constants {
  float w[9];  // stencil weights, row-major
  float du, dv, feed, min_feed_kill, dt;
};

// oracle.laplacian, naive boundary: tap i reads row max(gr-1, 0) + i and is
// valid iff that row <= min(gr+1, rows-1) (the same for columns), with
// weight row i: the window is clamped and stays anchored at its top-left.
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

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
windowed_kernel(const float* __restrict__ u, const float* __restrict__ v,
                float* __restrict__ u_out, float* __restrict__ v_out,
                int rows, int cols, int steps, int naive, Constants k) {
  __shared__ float su[2][WIN * WIN];
  __shared__ float sv[2][WIN * WIN];
  const int tx = threadIdx.x, ty = threadIdx.y;
  // global (row, col) of window cell (0, 0)
  const int r0 = blockIdx.y * TILE - HALO;
  const int c0 = blockIdx.x * TILE - HALO;

  for (int lr = ty; lr < WIN; lr += BLOCK_Y) {
    const int gr = r0 + lr;
    for (int lc = tx; lc < WIN; lc += BLOCK_X) {
      const int gc = c0 + lc;
      float uc = 0.0f, vc = 0.0f;
      if (gr >= 0 && gr < rows && gc >= 0 && gc < cols) {
        const size_t g = static_cast<size_t>(gr) * cols + gc;
        uc = u[g];
        vc = v[g];
      }
      su[0][lr * WIN + lc] = uc;
      sv[0][lr * WIN + lc] = vc;
    }
  }
  __syncthreads();

  int cur = 0;
  for (int s = 0; s < steps; ++s) {
    const float* in_u = su[cur];
    const float* in_v = sv[cur];
    float* out_u = su[cur ^ 1];
    float* out_v = sv[cur ^ 1];
    const int lo = s + 1, hi = WIN - s - 1;
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
            full_u = naive_laplacian(in_u, lr, lc, uc, gr, gc, rows, cols, k);
            full_v = naive_laplacian(in_v, lr, lc, vc, gr, gc, rows, cols, k);
          } else {
            full_u = zero_laplacian(in_u, lr, lc, uc, k);
            full_v = zero_laplacian(in_v, lr, lc, vc, k);
          }
          const float uv_square = (uc * vc) * vc;
          const float du = ((k.du * full_u) - uv_square) + (k.feed * (1.0f - uc));
          const float dv = ((k.dv * full_v) + uv_square) + (k.min_feed_kill * vc);
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
      if (gr < rows && gc < cols) {
        const size_t g = static_cast<size_t>(gr) * cols + gc;
        u_out[g] = su[cur][lr * WIN + lc];
        v_out[g] = sv[cur][lr * WIN + lc];
      }
    }
  }
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
  if (rows < 1 || cols < 1 || steps < 1 || steps > HALO) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((cols + TILE - 1) / TILE, (rows + TILE - 1) / TILE);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Constants k = {{w0, w1, w2, w3, w4, w5, w6, w7, w8},
                       du, dv, feed, min_feed_kill, dt};
  windowed_kernel<<<grid, dim3(BLOCK_X, BLOCK_Y), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      u, v, u_out, v_out, rows, cols, steps, naive, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
