// Prism-gz sensitivity matrix for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel _gz_tile_kernel of
// gravinv3dhmc_tpu/ops/prism_pallas.py (:57, built by
// gz_kernel_matrix_pallas :93): the (D, M) f32 matrix whose entry (o, m)
// is the gz of a unit-density prism m at observation point o (Nagy et al.
// 2000), times G * SI2MGAL. Each entry sums 8 signed corner terms
//   -(dx log(dy + r) + dy log(dx + r) - dz atan2'(dx dy, dz r))
// with the reference's guarded primitives: log(0) -> 0, and the shifted
// atan2' equal to atan(y / x) for x != 0, sign(y) pi/2 for x == 0 and 0
// for y == 0 (gravinv3dhmc_tpu/ops/prism.py:45-58, prism_pallas.py:48-54).
//
// One departure from the TPU kernel, for f32: where the offset a in
// log(a + r) is negative and large against the other two, a + r cancels
// (at ratiogrid, top-layer cells 5.6 km away along one axis lose 1e-3 of
// max|A|). It is evaluated as (b^2 + c^2) / (r - a), equal in exact
// arithmetic and free of the cancellation: the worst entry then misses
// the f64 matrix by ~1e-4 of max|A|.
//
// What bounds it: per entry 8 x (2 logf, 1 atanf, 1 sqrtf, <= 3 divisions)
// and ~30 multiply-adds; at ratiogrid (900 x 17,100 = 15.4 M entries) that
// is ~120 M special-function evaluations against 61.6 MB of output, so
// the special-function units and the FP32 pipes bound it, not memory.
// Design: one thread per cell column and GZ_ROWS observation rows, so a
// thread loads its cell's 6 bounds once (coalesced along M from a (6, M)
// layout) and reuses them for GZ_ROWS rows; observation coordinates are
// the same for the whole block (a broadcast load). Edges are bounds-
// checked instead of padded with far-away cells. The TPU kernel's
// polynomial atan (Pallas has no atan lowering) is atanf here.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_cuda.py), so each
// product and sum rounds on its own, as the plain PyTorch version's do.
// The entry point launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int GZ_THREADS = 128;  // cell columns per block
constexpr int GZ_ROWS = 4;       // observation rows per thread
// pi / 2 rounded to float, as np.pi / 2 in the f32 reference kernel
constexpr float HALF_PI = 1.57079632679489661923f;

// log(a + r) with r^2 = a^2 + b2c2, and the reference's log(0) -> 0
__device__ __forceinline__ float log_a_plus_r(float a, float b2c2, float r) {
  const float arg = a < 0.0f ? b2c2 / (r - a) : a + r;
  return arg == 0.0f ? 0.0f : logf(arg);
}

__device__ __forceinline__ float safe_atan2(float y, float x) {
  if (y == 0.0f) return 0.0f;
  if (x == 0.0f) return y > 0.0f ? HALF_PI : -HALF_PI;
  return atanf(y / x);
}

// obs (D, 3) [x, y, z]; cells (6, M) rows x1, x2, y1, y2, z1, z2; out (D, M)
__global__ void __launch_bounds__(GZ_THREADS)
gz_kernel(const float* __restrict__ obs, const float* __restrict__ cells,
          float* __restrict__ out, int D, int M, float scale) {
  const int m = blockIdx.x * GZ_THREADS + threadIdx.x;
  if (m >= M) return;
  // index 0 is the upper bound, as the reference's x = [x2, x1] ordering,
  // so corner (i, j, k) has sign (-1)^(i + j + k)
  const float xs[2] = {cells[1 * (size_t)M + m], cells[m]};
  const float ys[2] = {cells[3 * (size_t)M + m], cells[2 * (size_t)M + m]};
  const float zs[2] = {cells[5 * (size_t)M + m], cells[4 * (size_t)M + m]};
  const int o_end = min(D, (int)(blockIdx.y + 1) * GZ_ROWS);
  for (int o = blockIdx.y * GZ_ROWS; o < o_end; ++o) {
    const float xo = obs[3 * o], yo = obs[3 * o + 1], zo = obs[3 * o + 2];
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float dx = xs[i] - xo;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float dy = ys[j] - yo;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float dz = zs[k] - zo;
          const float dx2 = dx * dx, dy2 = dy * dy, dz2 = dz * dz;
          const float r = sqrtf(dx2 + dy2 + dz2);
          const float term = -(dx * log_a_plus_r(dy, dx2 + dz2, r)
                               + dy * log_a_plus_r(dx, dy2 + dz2, r)
                               - dz * safe_atan2(dx * dy, dz * r));
          acc = ((i + j + k) & 1) ? acc - term : acc + term;
        }
      }
    }
    out[(size_t)o * M + m] = acc * scale;
  }
}

}  // namespace

extern "C" {

int gz_matrix(const float* obs, const float* cells, float* out, int D, int M,
              float scale, cudaStream_t stream) {
  if (D == 0 || M == 0) return 0;
  const dim3 grid((M + GZ_THREADS - 1) / GZ_THREADS,
                  (D + GZ_ROWS - 1) / GZ_ROWS);
  gz_kernel<<<grid, GZ_THREADS, 0, stream>>>(obs, cells, out, D, M, scale);
  return (int)cudaGetLastError();
}

const char* gz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
