// Prism-gz sensitivity matrix for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel _gz_tile_kernel of
// gravinv3dhmc_tpu/ops/prism_pallas.py (:57, built by
// gz_kernel_matrix_pallas :93): the (D, M) f32 matrix whose entry (o, m)
// is the gz of a unit-density prism m at observation point o (Nagy et al.
// 2000), times G * SI2MGAL. Each entry sums 8 signed corner terms
//   F(dx, dy, dz) = -(dx log(dy + r) + dy log(dx + r) - dz atan2'(dx dy, dz r))
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
// Two kernels compute the same matrix; ops/prism_gz.py picks one on the
// host from the cells alone, before the launch.
//
// gz_nodes_kernel (cells that share nodes: a rectilinear mesh). A corner
// term depends only on the corner's f32 coordinates minus the
// observation's, and neighbouring cells share corners: ratiogrid's 17,100
// cells have 136,800 corners but 31 x 31 x 20 = 19,220 distinct nodes, so
// evaluating F once per node and observation does 7.1x fewer evaluations.
// The host builds the node tables from the f32 bounds exactly as the
// corner kernel receives them (the ratio mesh's layer faces differ in f64
// and coincide only after the cast): the sorted distinct values of each
// axis, each cell's six node indices, and the cells grouped by the node
// of their upper z bound, in a stable order. A block takes one
// observation and walks the z nodes in order, one barrier a step: step
// k evaluates F on plane k (nx * ny nodes) into a shared-memory ring of
// planes and gathers the cells of plane k - 1 (the group whose upper z
// node is k - 1; its lower one is at most `span` planes back, so a ring
// of span + 2 planes still holds it), each thread summing its cells' 8
// node values and storing the entries with streaming stores, coalesced
// along M. A thread loads its first cell's index word before it computes
// its node values, which hides that load's latency (more words loaded
// ahead measured no faster on an H100, and 4 spilled); the axes and
// group offsets sit in shared memory. One observation a block (900
// blocks at ratiogrid): blocks of 2 or 4 observations that shared each
// index word measured slower on an H100 (PERF.md), though the 274 KB
// table is then re-read from L2 by every block; more, smaller blocks
// keep more warps issuing through the steps' barriers. At ratiogrid a
// ring is 3 planes x 3.8 KB.
// Why its matrix equals gz_kernel's bit for bit: each node value is the
// same nagy_term of the same f32 differences (the table holds the very
// f32 values of the bounds), compiled with -fmad=false, and the 8 values
// are summed in the same (i, j, k) order from the same zero.
// What bounds it: issuing the node evaluations (at ratiogrid 900 x 19,220
// = 17.3 M, each ~112 arithmetic instructions of nagy_term, ~164 issue
// slots with its branches, as gravinv3dhmc_tpu_torch/sass.py counts them)
// against the 61.6 MB written (0.0184 ms at 3.35 TB/s): the instructions;
// the gather adds 8 shared loads and 8 adds an entry.
//
// gz_kernel (any cell set, such as cells that share no node): one thread
// per cell column and GZ_ROWS observation rows, so a thread loads its
// cell's 6 bounds once (coalesced along M from a (6, M) layout) and
// reuses them for GZ_ROWS rows; observation coordinates are the same for
// the whole block (a broadcast load). 8 corner evaluations an entry, so
// it issues 8x the node kernel's work at ratiogrid, near the issue rate.
// Edges are bounds-checked instead of padded with far-away cells. The
// TPU kernel's polynomial atan (Pallas has no atan lowering) is atanf
// here.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_cuda.py), so each
// product and sum rounds on its own, as the plain PyTorch version's do.
// The entry points launch on the given stream and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int GZ_THREADS = 128;  // cell columns per block
constexpr int GZ_ROWS = 4;       // observation rows per thread
// the node kernel: threads a block, and index words of a plane's cells a
// thread loads ahead of its node values (gz_tune.py sweeps both)
constexpr int GZN_THREADS = 256;
constexpr int GZN_PREFETCH = 1;
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

// the corner term F of a node at offsets (dx, dy, dz) from the observation
__device__ __forceinline__ float nagy_term(float dx, float dy, float dz) {
  const float dx2 = dx * dx, dy2 = dy * dy, dz2 = dz * dz;
  const float r = sqrtf(dx2 + dy2 + dz2);
  return -(dx * log_a_plus_r(dy, dx2 + dz2, r)
           + dy * log_a_plus_r(dx, dy2 + dz2, r)
           - dz * safe_atan2(dx * dy, dz * r));
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
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float term = nagy_term(xs[i] - xo, ys[j] - yo, zs[k] - zo);
          acc = ((i + j + k) & 1) ? acc - term : acc + term;
        }
      }
    }
    out[(size_t)o * M + m] = acc * scale;
  }
}

// the cell of index words w (gz_nodes_kernel's table): its 8 node values
// from the plane ring (its upper z node's plane in slot `slot`, the lower
// one k - k_low planes back), summed in gz_kernel's corner order, stored
// scaled
__device__ __forceinline__ void gather_cell(
    int4 w, int k, int slot, const float* __restrict__ planes, int ring,
    int nxy, int nx, float scale, float* __restrict__ out) {
  const unsigned wx = w.x, wy = w.y, wz = w.z;
  int low = slot - (k - (int)(wz >> 16));
  if (low < 0) low += ring;
  // node offsets within a plane, index 0 the upper bound as in gz_kernel
  const int xi[2] = {(int)(wx & 0xffffu), (int)(wx >> 16)};
  const int yi[2] = {(int)(wy & 0xffffu) * nx, (int)(wy >> 16) * nx};
  const float* zp[2] = {planes + slot * nxy, planes + low * nxy};
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float v = zp[kk][yi[j] + xi[i]];
        acc = ((i + j + kk) & 1) ? acc - v : acc + v;
      }
    }
  }
  __stcs(out + w.w, acc * scale);
}

// obs (D, 3); ux (nx), uy (ny), uz (nz): the sorted distinct f32 bounds of
// each axis; cells (M, 4) in group order: for x, y and z the word (upper
// node | lower node << 16), then the cell's output column; the cells
// whose upper z node is k are [offsets[k], offsets[k + 1]); ring (the
// widest z span + 2) planes of nx x ny node values in shared memory, then
// the three axes and the offsets; out (D, M); block o computes row o
__global__ void __launch_bounds__(GZN_THREADS)
gz_nodes_kernel(const float* __restrict__ obs, const float* __restrict__ ux,
                const float* __restrict__ uy, const float* __restrict__ uz,
                const int4* __restrict__ cells,
                const int* __restrict__ offsets, float* __restrict__ out,
                int M, int nx, int ny, int nz, int ring, float scale) {
  extern __shared__ float planes[];  // [ring][nx * ny], then the axes
  const int nxy = nx * ny;
  float* sx = planes + ring * nxy;
  float* sy = sx + nx;
  float* sz = sy + ny;
  int* soff = reinterpret_cast<int*>(sz + nz);
  for (int t = threadIdx.x; t < nx; t += GZN_THREADS) sx[t] = ux[t];
  for (int t = threadIdx.x; t < ny; t += GZN_THREADS) sy[t] = uy[t];
  for (int t = threadIdx.x; t < nz; t += GZN_THREADS) sz[t] = uz[t];
  for (int t = threadIdx.x; t <= nz; t += GZN_THREADS) soff[t] = offsets[t];
  const int o = blockIdx.x;
  const float xo = __ldg(obs + 3 * o), yo = __ldg(obs + 3 * o + 1),
              zo = __ldg(obs + 3 * o + 2);
  out += (size_t)o * M;
  // a thread's nodes within a plane: (i, j) walked by the block's stride
  // without a division a node
  const int i0 = threadIdx.x % nx, j0 = threadIdx.x / nx;
  const int di = GZN_THREADS % nx, dj = GZN_THREADS / nx;
  __syncthreads();
  // step k computes plane k and gathers the cells of plane k - 1, whose
  // planes (k - 1 back to k - 1 - span) the ring still holds while plane k
  // takes the slot of plane k - ring; one barrier a step
  for (int k = 0, slot = 0; k <= nz; ++k) {
    const int prev = slot == 0 ? ring - 1 : slot - 1;
    const int c0 = k ? soff[k - 1] + threadIdx.x : 0;
    const int end = k ? soff[k] : 0;
    // up to GZN_PREFETCH index words a thread, loaded before the node
    // values are computed, which hides their latency
    int4 w[GZN_PREFETCH];
#pragma unroll
    for (int p = 0; p < GZN_PREFETCH; ++p)
      if (c0 + p * GZN_THREADS < end)
        w[p] = __ldg(cells + c0 + p * GZN_THREADS);
    if (k < nz) {
      // one node value at a time a thread (few registers, many warps)
      const float dz = sz[k] - zo;
      float* plane = planes + slot * nxy;
      int i = i0, j = j0;
      for (int ij = threadIdx.x; ij < nxy; ij += GZN_THREADS) {
        plane[ij] = nagy_term(sx[i] - xo, sy[j] - yo, dz);
        i += di;
        j += dj;
        if (i >= nx) {
          i -= nx;
          ++j;
        }
      }
    }
#pragma unroll
    for (int p = 0; p < GZN_PREFETCH; ++p)
      if (c0 + p * GZN_THREADS < end)
        gather_cell(w[p], k - 1, prev, planes, ring, nxy, nx, scale, out);
    for (int c = c0 + GZN_PREFETCH * GZN_THREADS; c < end; c += GZN_THREADS)
      gather_cell(__ldg(cells + c), k - 1, prev, planes, ring, nxy, nx, scale,
                  out);
    __syncthreads();
    slot = slot + 1 == ring ? 0 : slot + 1;
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

// the node kernel's dynamic shared memory: span + 2 planes of nx x ny
// values, then the axes and offsets (node_smem_bytes in ops/prism_gz.py,
// whose dispatcher sends a cell set to gz_matrix when it exceeds the
// card's limit); setting the kernel's attribute fails past that limit
int gz_nodes_matrix(const float* obs, const float* ux, const float* uy,
                    const float* uz, const int* cells, const int* offsets,
                    float* out, int D, int M, int nx, int ny, int nz,
                    int span, float scale, cudaStream_t stream) {
  if (D == 0 || M == 0) return 0;
  const size_t smem =
      ((size_t)(span + 2) * nx * ny + nx + ny + 2 * nz + 1) * 4;
  if (span < 0 || nx > 65536 || ny > 65536 || nz > 65536 || smem > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaFuncSetAttribute(
      gz_nodes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (set != cudaSuccess) return (int)set;
  gz_nodes_kernel<<<D, GZN_THREADS, smem, stream>>>(
      obs, ux, uy, uz, reinterpret_cast<const int4*>(cells), offsets, out, M,
      nx, ny, nz, span + 2, scale);
  return (int)cudaGetLastError();
}

const char* gz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
