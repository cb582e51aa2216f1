// Fused HMC leapfrog kernels for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces three Pallas TPU kernels of
// gravinv3dhmc_tpu/ops/leapfrog_pallas.py:
//   _traj_kernel (:146, built by make_fused_trajectory :254) — the L-step
//     trajectory: drift, clip/negate, residual GEMM, kick GEMM, then the
//     gradient recovery, trailing half kick and misfit values;
//   _iter_kernel (:421, built by make_fused_iteration :574) — one whole HMC
//     iteration: momentum refresh, the trajectory above, Metropolis accept
//     and select of the carried state;
//   _step_kernel (:87, built by make_fused_step :735) — ONE leapfrog step on
//     the uncentred A: drift, clip/negate, d = x A^T + fix, the row mean
//     over the true n_obs removed in the residual, the kick, and U, ud, um.
//
// What the TPU kernels compute is kept; how is not. They hold the centred
// kernel matrix A_c (Dp x Mp) and a chain tile VMEM-resident for all L
// steps. On this card a block has at most 227 KB of shared memory, while
// A_c is 7.7 MB in bf16 at the 640 x 6016 flagship, so the work is cut at
// the GEMMs instead:
//
//   refresh      one block per chain: Philox normals, p0 = pscale*n01, K0,
//                H0 = K0 + U, leading half kick p = p0 - eps/2 g   (_iter)
//   drift        elementwise: x += eps*im*p, clip to [low, high], negate p
//                where clipped (kept as x != clip(x), :203/:517)   (both)
//   residual     GEMM 1: r = (x A_c^T - dobs') * dmask, K split in slices
//                (4 at the flagship) reduced in a fixed order       (both)
//   kick         GEMM 2: p -= 2 eps (r A_c) + s_mod gm(x)           (both)
//   traj_finish  one block per chain: g = (pk - p)/eps, p_half =
//                (pk + p)/2, ud, um, U                              (both)
//   accept       one block per chain: K1, H1, Philox uniform, accept,
//                select of x, g, U, ud, um                          (_iter)
//   step_residual  GEMM 1's K slices (the residual_partial kernel above)
//                then one block per chain: d = sum of slices + fix, mean
//                over the true n_obs, r = ((d - mean) - dobs) * dmask,
//                ud = sum r^2                                       (_step)
//   step_misfit  one block per chain: um and U = ud + alpha um      (_step)
// The per-step op reuses drift and kick as they are; the kick epilogue
// already applies p -= s_data gdata + s_mod gm, the full kick of _step.
//
// What bounds it: each GEMM is 2*C*Mp*Dp FLOP, about 7.9 GFLOP at
// C=1024, Mp=6016, Dp=640, and A_c (7.7 MB bf16, 15.4 MB f32) stays in the
// 50 MB L2 across steps, so the GEMMs are bound by arithmetic. This first
// version is a tiled SIMT GEMM (64x64 block tile, 4x4 per thread, f32 FMA
// accumulation, A loaded as bf16 or f32 and widened in registers) —
// correct and simple, far below the card's tensor-core rate. wgmma with
// TMA-fed shared-memory rings, a persistent L-loop that keeps chain tiles
// on chip, and CUDA graphs over the step launches are later work.
//
// Random numbers: Philox4x32-10 keyed by a salt from the run seed, with
// counter (element group, chain, global iteration, stream); the plain
// torch version in ops/philox.py draws identical u32 words.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_cuda.py).
// -fmad=false keeps each elementwise product and sum rounded on its own,
// as PyTorch's plain version does; the GEMMs use fmaf explicitly.
// Every entry point launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // chains per block tile
constexpr int BN = 64;       // output columns per block tile
constexpr int BK = 16;       // reduction depth per shared-memory stage
constexpr int GEMM_THREADS = 256;
constexpr int ROW_THREADS = 256;

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;
constexpr uint32_t STREAM_MOMENTUM = 0u;
constexpr uint32_t STREAM_ACCEPT = 1u;
// 2*pi rounded to float, as the TPU kernel's 2 * np.float32(pi)
constexpr float TWO_PI = 6.28318548202514648f;

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(PHILOX_M0, c0), lo0 = PHILOX_M0 * c0;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c2), lo1 = PHILOX_M1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ float u24(uint32_t w) {
  return static_cast<float>(w >> 8) * (1.0f / 16777216.0f);
}

// Box-Muller over one word pair: (R cos, R sin)
__device__ __forceinline__ float2 box_muller(uint32_t w1, uint32_t w2) {
  const float u1 = u24(w1) + (0.5f / 16777216.0f);
  const float u2 = u24(w2);
  const float rad = sqrtf(-2.0f * logf(u1));
  const float th = TWO_PI * u2;
  return make_float2(rad * cosf(th), rad * sinf(th));
}

// sum over the block; every thread gets the result. sh holds >= 32 floats.
__device__ float block_sum(float v, float* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < (blockDim.x >> 5) ? sh[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) sh[0] = s;
  }
  __syncthreads();
  const float out = sh[0];
  __syncthreads();
  return out;
}

// four consecutive matrix elements widened to float
template <typename T> struct Load4;
template <> struct Load4<float> {
  __device__ static float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};
template <> struct Load4<__nv_bfloat16> {
  __device__ static float4 load(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 a, b;
    a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
    return make_float4(fa.x, fa.y, fb.x, fb.y);
  }
};

// the matvec operand rounded to the matrix type, as x.astype(matvec_dtype)
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Load one BM x BK tile of a row-major f32 chain operand S (rows = chains,
// K contiguous, leading dimension ld) transposed into sS[BK][BM + 4],
// rounded to the matrix type. Rows past C read as zero.
template <typename T>
__device__ __forceinline__ void load_chain_tile(const float* S, int ld, int C,
                                                int c0, int k0,
                                                float (*sS)[BM + 4]) {
  const int t = threadIdx.x;
  const int row = t >> 2, kq = (t & 3) * 4;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c0 + row < C)
    v = *reinterpret_cast<const float4*>(S + (size_t)(c0 + row) * ld + k0 + kq);
  sS[kq + 0][row] = round_to<T>(v.x);
  sS[kq + 1][row] = round_to<T>(v.y);
  sS[kq + 2][row] = round_to<T>(v.z);
  sS[kq + 3][row] = round_to<T>(v.w);
}

// the 4x4 register tile update over one shared-memory stage
__device__ __forceinline__ void mma_stage(float (*sS)[BM + 4],
                                          float (*sA)[BN + 4],
                                          float acc[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&sS[k][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&sA[k][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// ---------------------------------------------------------------- kernels

__global__ void refresh_kernel(const float* __restrict__ g,
                               const float* __restrict__ U,
                               const float* __restrict__ pscale,
                               const float* __restrict__ im,
                               const float* __restrict__ n01,
                               float* __restrict__ p, float* __restrict__ pk,
                               float* __restrict__ H0, int Mp, float half_eps,
                               uint32_t k0, uint32_t k1, uint32_t iteration) {
  __shared__ float sh[32];
  const int c = blockIdx.x;
  const size_t row = (size_t)c * Mp;
  float kin = 0.0f;
  for (int j = threadIdx.x; j < Mp / 4; j += blockDim.x) {
    float n[4];
    if (n01) {
      const float4 v = *reinterpret_cast<const float4*>(n01 + row + 4 * j);
      n[0] = v.x; n[1] = v.y; n[2] = v.z; n[3] = v.w;
    } else {
      const uint4 w = philox4x32_10((uint32_t)j, (uint32_t)c, iteration,
                                    STREAM_MOMENTUM, k0, k1);
      const float2 a = box_muller(w.x, w.y), b = box_muller(w.z, w.w);
      n[0] = a.x; n[1] = a.y; n[2] = b.x; n[3] = b.y;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = 4 * j + q;
      const float p0 = pscale[m] * n[q];
      kin += im[m] * p0 * p0;
      const float pv = p0 - half_eps * g[row + m];
      p[row + m] = pv;
      pk[row + m] = pv;
    }
  }
  const float K0 = 0.5f * block_sum(kin, sh);
  if (threadIdx.x == 0) H0[c] = K0 + U[c];
}

__global__ void drift_kernel(float* __restrict__ x, float* __restrict__ p,
                             float* __restrict__ pk,
                             const float* __restrict__ im,
                             const float* __restrict__ low,
                             const float* __restrict__ high, size_t n4,
                             int Mp, float eps) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const int m = (int)((4 * i) % Mp);
    const float4 xv = reinterpret_cast<float4*>(x)[i];
    const float4 pv = reinterpret_cast<float4*>(p)[i];
    const float4 iv = *reinterpret_cast<const float4*>(im + m);
    const float4 lv = *reinterpret_cast<const float4*>(low + m);
    const float4 hv = *reinterpret_cast<const float4*>(high + m);
    float xs[4] = {xv.x, xv.y, xv.z, xv.w};
    float ps[4] = {pv.x, pv.y, pv.z, pv.w};
    const float is[4] = {iv.x, iv.y, iv.z, iv.w};
    const float ls[4] = {lv.x, lv.y, lv.z, lv.w};
    const float hs[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float xn = xs[q] + eps * (is[q] * ps[q]);
      // clip as max-then-min with NaN propagating, like jnp.clip
      float xc = xn < ls[q] ? ls[q] : xn;
      xc = xc > hs[q] ? hs[q] : xc;
      if (xn != xc) ps[q] = -ps[q];
      xs[q] = xc;
    }
    const float4 xo = make_float4(xs[0], xs[1], xs[2], xs[3]);
    const float4 po = make_float4(ps[0], ps[1], ps[2], ps[3]);
    reinterpret_cast<float4*>(x)[i] = xo;
    reinterpret_cast<float4*>(p)[i] = po;
    if (pk) reinterpret_cast<float4*>(pk)[i] = po;
  }
}

// GEMM 1 in K slices: part[s, c, d] = sum over the s-th slice of m of
// round(x[c, m]) A[d, m]. At the flagship shape the output is only
// 16 x 10 tiles of 64 x 64 (1.2 waves on 132 SMs) with K = 6016 each, so
// blockIdx.z splits K and residual_reduce (step_reduce on the per-step
// path) adds the slices in a fixed order (deterministic, unlike atomics).
// The caller picks the split count from lf_residual_occupancy so that
// the blocks fill whole waves.
template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
residual_partial_kernel(const float* __restrict__ x, const T* __restrict__ A,
                        float* __restrict__ part, int C, int Dp, int Mp,
                        int k_per_split) {
  __shared__ __align__(16) float sX[BK][BM + 4];
  __shared__ __align__(16) float sA[BK][BN + 4];
  const int c0 = blockIdx.y * BM, d0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(Mp, k_begin + k_per_split);
  const int t = threadIdx.x;
  float acc[4][4] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    load_chain_tile<T>(x, Mp, C, c0, k0, sX);
    {  // A rows d0.. (K = m contiguous), stored transposed
      const int row = t >> 2, kq = (t & 3) * 4;
      const float4 v = Load4<T>::load(A + (size_t)(d0 + row) * Mp + k0 + kq);
      sA[kq + 0][row] = v.x;
      sA[kq + 1][row] = v.y;
      sA[kq + 2][row] = v.z;
      sA[kq + 3][row] = v.w;
    }
    __syncthreads();
    mma_stage(sX, sA, acc);
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * C * Dp;
  const int ty = t >> 4, tx = t & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= C) continue;
    *reinterpret_cast<float4*>(out + (size_t)c * Dp + d0 + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// r[c, d] = (sum_s part[s, c, d] - dobs[d]) * dmask[d]
__global__ void residual_reduce_kernel(const float* __restrict__ part,
                                       const float* __restrict__ dobs,
                                       const float* __restrict__ dmask,
                                       float* __restrict__ r, int splits,
                                       size_t n, int Dp) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float sum = part[i];
    for (int s = 1; s < splits; ++s) sum += part[(size_t)s * n + i];
    const int d = (int)(i % Dp);
    r[i] = (sum - dobs[d]) * dmask[d];
  }
}

// The per-step residual (_step_kernel :112-119): d = sum_s part[s] + fix,
// mean over the true n_obs (pad rows hold d == 0: their A rows and fix
// are zero), r = ((d - mean) - dobs) * dmask, ud = sum r^2. One block per
// chain; d is stashed in r between the two passes, each thread reading
// back only the entries it wrote. Bound by reading the split partials
// (splits * C * Dp floats, L2-resident), a few us a step.
__global__ void step_reduce_kernel(const float* __restrict__ part,
                                   const float* __restrict__ fix,
                                   const float* __restrict__ dobs,
                                   const float* __restrict__ dmask,
                                   float* __restrict__ r,
                                   float* __restrict__ ud, int splits,
                                   int C, int Dp, float inv_nobs) {
  __shared__ float sh[32];
  const size_t n = (size_t)C * Dp;
  const size_t row = (size_t)blockIdx.x * Dp;
  float sd = 0.0f;
  for (int d = threadIdx.x; d < Dp; d += blockDim.x) {
    float v = part[row + d];
    for (int s = 1; s < splits; ++s) v += part[(size_t)s * n + row + d];
    v += fix[d];
    r[row + d] = v;
    sd += v;
  }
  const float mean = block_sum(sd, sh) * inv_nobs;
  float sq = 0.0f;
  for (int d = threadIdx.x; d < Dp; d += blockDim.x) {
    const float rv = ((r[row + d] - mean) - dobs[d]) * dmask[d];
    r[row + d] = rv;
    sq += rv * rv;
  }
  const float udv = block_sum(sq, sh);
  if (threadIdx.x == 0) ud[blockIdx.x] = udv;
}

// um and U = ud + alpha um of the drifted state (_step_kernel :128-141),
// one block per chain; a single read of x, bound by launch latency.
__global__ void step_misfit_kernel(const float* __restrict__ x,
                                   const float* __restrict__ aprior,
                                   const float* __restrict__ wmsq,
                                   const float* __restrict__ ud,
                                   float* __restrict__ U,
                                   float* __restrict__ um, int Mp,
                                   float alpha, float beta, int ms) {
  __shared__ float sh[32];
  const int c = blockIdx.x;
  const size_t row = (size_t)c * Mp;
  float su = 0.0f;
  for (int m = threadIdx.x; m < Mp; m += blockDim.x) {
    const float dm = x[row + m] - aprior[m];
    const float dm2 = dm * dm;
    su += ms ? wmsq[m] * dm2 / (dm2 + beta) : dm2;
  }
  const float umv = block_sum(su, sh);
  if (threadIdx.x == 0) {
    um[c] = umv;
    U[c] = ud[c] + alpha * umv;
  }
}

// p[c, m] = p - s_data * (sum_d round(r[c, d]) A[d, m]) - s_mod * gm(x[c, m])
template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
kick_kernel(const float* __restrict__ r, const T* __restrict__ A,
            const float* __restrict__ x, float* __restrict__ p,
            const float* __restrict__ aprior,
            const float* __restrict__ gm_scale, int C, int Dp, int Mp,
            float s_data, float s_mod, float beta, int ms) {
  __shared__ __align__(16) float sR[BK][BM + 4];
  __shared__ __align__(16) float sA[BK][BN + 4];
  const int c0 = blockIdx.y * BM, m0 = blockIdx.x * BN;
  const int t = threadIdx.x;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < Dp; k0 += BK) {
    load_chain_tile<T>(r, Dp, C, c0, k0, sR);
    {  // A rows k0.. (N = m contiguous), stored as is
      const int krow = t >> 4, nq = (t & 15) * 4;
      const float4 v = Load4<T>::load(A + (size_t)(k0 + krow) * Mp + m0 + nq);
      *reinterpret_cast<float4*>(&sA[krow][nq]) = v;
    }
    __syncthreads();
    mma_stage(sR, sA, acc);
    __syncthreads();
  }
  const int ty = t >> 4, tx = t & 15;
  const int m = m0 + tx * 4;
  const float4 av = *reinterpret_cast<const float4*>(aprior + m);
  const float4 gv = *reinterpret_cast<const float4*>(gm_scale + m);
  const float aps[4] = {av.x, av.y, av.z, av.w};
  const float gss[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= C) continue;
    const size_t off = (size_t)c * Mp + m;
    const float4 xv = *reinterpret_cast<const float4*>(x + off);
    const float4 pv = *reinterpret_cast<const float4*>(p + off);
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
    float ps[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float dm = xs[j] - aps[j];
      float gm;
      if (ms) {
        const float inv = 1.0f / (dm * dm + beta);
        gm = gss[j] * dm * (inv * inv);
      } else {
        gm = dm;
      }
      ps[j] = ps[j] - s_data * acc[i][j] - s_mod * gm;
    }
    *reinterpret_cast<float4*>(p + off) = make_float4(ps[0], ps[1], ps[2],
                                                      ps[3]);
  }
}

// g = (pk - p)/eps (may alias pk), p <- (pk + p)/2, ud, um, U per chain
__global__ void traj_finish_kernel(const float* __restrict__ x, float* p,
                                   const float* pk, const float* __restrict__ r,
                                   float* g, float* __restrict__ U,
                                   float* __restrict__ ud,
                                   float* __restrict__ um,
                                   const float* __restrict__ aprior,
                                   const float* __restrict__ wmsq, int Dp,
                                   int Mp, float inv_eps, float alpha,
                                   float beta, int ms) {
  __shared__ float sh[32];
  const int c = blockIdx.x;
  const size_t row = (size_t)c * Mp;
  float su = 0.0f;
  for (int m = threadIdx.x; m < Mp; m += blockDim.x) {
    const float pkv = pk[row + m], pv = p[row + m];
    g[row + m] = (pkv - pv) * inv_eps;
    p[row + m] = 0.5f * (pkv + pv);
    const float dm = x[row + m] - aprior[m];
    const float dm2 = dm * dm;
    su += ms ? wmsq[m] * dm2 / (dm2 + beta) : dm2;
  }
  float sd = 0.0f;
  for (int d = threadIdx.x; d < Dp; d += blockDim.x) {
    const float rv = r[(size_t)c * Dp + d];
    sd += rv * rv;
  }
  const float udv = block_sum(sd, sh);
  const float umv = block_sum(su, sh);
  if (threadIdx.x == 0) {
    ud[c] = udv;
    um[c] = umv;
    U[c] = udv + alpha * umv;
  }
}

// Metropolis test on H = K(p) + U against H0; rejected chains take back
// their carried state bit for bit
__global__ void accept_kernel(float* __restrict__ x, float* __restrict__ g,
                              float* __restrict__ U, float* __restrict__ ud,
                              float* __restrict__ um,
                              const float* __restrict__ p,
                              const float* __restrict__ H0,
                              const float* __restrict__ x_in,
                              const float* __restrict__ g_in,
                              const float* __restrict__ U_in,
                              const float* __restrict__ ud_in,
                              const float* __restrict__ um_in,
                              const float* __restrict__ im,
                              const float* __restrict__ u,
                              float* __restrict__ acc_out, int Mp,
                              uint32_t k0, uint32_t k1, uint32_t iteration) {
  __shared__ float sh[32];
  const int c = blockIdx.x;
  const size_t row = (size_t)c * Mp;
  float kin = 0.0f;
  for (int m = threadIdx.x; m < Mp; m += blockDim.x) {
    const float pv = p[row + m];
    kin += im[m] * pv * pv;
  }
  const float K1 = 0.5f * block_sum(kin, sh);
  const float H1 = K1 + U[c];
  const float uu = u ? u[c]
                     : u24(philox4x32_10(0u, (uint32_t)c, iteration,
                                         STREAM_ACCEPT, k0, k1).x);
  // a NaN Hamiltonian fails both tests and rejects
  const bool acc = (H1 < H0[c]) || (uu < expf(-(H1 - H0[c])));
  __syncthreads();  // every thread has read U[c] before thread 0 may restore it
  if (!acc) {
    for (int m = threadIdx.x; m < Mp; m += blockDim.x) {
      x[row + m] = x_in[row + m];
      g[row + m] = g_in[row + m];
    }
  }
  if (threadIdx.x == 0) {
    if (!acc) {
      U[c] = U_in[c];
      ud[c] = ud_in[c];
      um[c] = um_in[c];
    }
    acc_out[c] = acc ? 1.0f : 0.0f;
  }
}

// raw Philox words of the momentum stream (for checking the plain version)
__global__ void philox_bits_kernel(uint32_t* __restrict__ out, int C,
                                   int width, uint32_t k0, uint32_t k1,
                                   uint32_t iteration) {
  const int groups = width / 4;
  const int total = C * groups;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int c = i / groups, j = i % groups;
    const uint4 w = philox4x32_10((uint32_t)j, (uint32_t)c, iteration,
                                  STREAM_MOMENTUM, k0, k1);
    *reinterpret_cast<uint4*>(out + (size_t)c * width + 4 * j) = w;
  }
}

int grid_for(size_t n, int threads) {
  const size_t b = (n + threads - 1) / threads;
  return (int)(b < 4096 ? (b ? b : 1) : 4096);
}

cudaError_t launch_residual_partial(const float* x, const void* A,
                                    int a_bf16, float* part, int splits,
                                    int C, int Dp, int Mp,
                                    cudaStream_t stream) {
  const int steps = Mp / BK;
  const int k_per_split = ((steps + splits - 1) / splits) * BK;
  const dim3 grid(Dp / BN, (C + BM - 1) / BM, splits);
  if (a_bf16)
    residual_partial_kernel<__nv_bfloat16><<<grid, GEMM_THREADS, 0, stream>>>(
        x, static_cast<const __nv_bfloat16*>(A), part, C, Dp, Mp,
        k_per_split);
  else
    residual_partial_kernel<float><<<grid, GEMM_THREADS, 0, stream>>>(
        x, static_cast<const float*>(A), part, C, Dp, Mp, k_per_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int lf_refresh(const float* g, const float* U, const float* pscale,
               const float* im, const float* n01, float* p, float* pk,
               float* H0, int C, int Mp, float half_eps, uint32_t k0,
               uint32_t k1, uint32_t iteration, cudaStream_t stream) {
  refresh_kernel<<<C, ROW_THREADS, 0, stream>>>(g, U, pscale, im, n01, p, pk,
                                                H0, Mp, half_eps, k0, k1,
                                                iteration);
  return (int)cudaGetLastError();
}

int lf_drift(float* x, float* p, float* pk, const float* im,
             const float* low, const float* high, int C, int Mp, float eps,
             cudaStream_t stream) {
  const size_t n4 = (size_t)C * Mp / 4;
  drift_kernel<<<grid_for(n4, 256), 256, 0, stream>>>(x, p, pk, im, low,
                                                       high, n4, Mp, eps);
  return (int)cudaGetLastError();
}

int lf_residual(const float* x, const void* A, int a_bf16, const float* dobs,
                const float* dmask, float* r, float* part, int splits, int C,
                int Dp, int Mp, cudaStream_t stream) {
  const cudaError_t err = launch_residual_partial(x, A, a_bf16, part, splits,
                                                  C, Dp, Mp, stream);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)C * Dp;
  residual_reduce_kernel<<<grid_for(n, 256), 256, 0, stream>>>(
      part, dobs, dmask, r, splits, n, Dp);
  return (int)cudaGetLastError();
}

int lf_step_residual(const float* x, const void* A, int a_bf16,
                     const float* fix, const float* dobs, const float* dmask,
                     float* r, float* ud, float* part, int splits, int C,
                     int Dp, int Mp, float inv_nobs, cudaStream_t stream) {
  const cudaError_t err = launch_residual_partial(x, A, a_bf16, part, splits,
                                                  C, Dp, Mp, stream);
  if (err != cudaSuccess) return (int)err;
  step_reduce_kernel<<<C, ROW_THREADS, 0, stream>>>(part, fix, dobs, dmask, r,
                                                    ud, splits, C, Dp,
                                                    inv_nobs);
  return (int)cudaGetLastError();
}

// resident blocks of the split GEMM per SM, and the SM count, so the
// caller can choose a split count that fills whole waves
int lf_residual_occupancy(int a_bf16, int* blocks_per_sm, int* sms) {
  cudaError_t err =
      a_bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks_per_sm, residual_partial_kernel<__nv_bfloat16>,
                   GEMM_THREADS, 0)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks_per_sm, residual_partial_kernel<float>,
                   GEMM_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                     dev);
}

int lf_step_misfit(const float* x, const float* aprior, const float* wmsq,
                   const float* ud, float* U, float* um, int C, int Mp,
                   float alpha, float beta, int ms, cudaStream_t stream) {
  step_misfit_kernel<<<C, ROW_THREADS, 0, stream>>>(x, aprior, wmsq, ud, U,
                                                    um, Mp, alpha, beta, ms);
  return (int)cudaGetLastError();
}

int lf_kick(const float* r, const void* A, int a_bf16, const float* x,
            float* p, const float* aprior, const float* gm_scale, int C,
            int Dp, int Mp, float s_data, float s_mod, float beta, int ms,
            cudaStream_t stream) {
  const dim3 grid(Mp / BN, (C + BM - 1) / BM);
  if (a_bf16)
    kick_kernel<__nv_bfloat16><<<grid, GEMM_THREADS, 0, stream>>>(
        r, static_cast<const __nv_bfloat16*>(A), x, p, aprior, gm_scale, C,
        Dp, Mp, s_data, s_mod, beta, ms);
  else
    kick_kernel<float><<<grid, GEMM_THREADS, 0, stream>>>(
        r, static_cast<const float*>(A), x, p, aprior, gm_scale, C, Dp, Mp,
        s_data, s_mod, beta, ms);
  return (int)cudaGetLastError();
}

int lf_traj_finish(const float* x, float* p, const float* pk, const float* r,
                   float* g, float* U, float* ud, float* um,
                   const float* aprior, const float* wmsq, int C, int Dp,
                   int Mp, float inv_eps, float alpha, float beta, int ms,
                   cudaStream_t stream) {
  traj_finish_kernel<<<C, ROW_THREADS, 0, stream>>>(
      x, p, pk, r, g, U, ud, um, aprior, wmsq, Dp, Mp, inv_eps, alpha, beta,
      ms);
  return (int)cudaGetLastError();
}

int lf_accept(float* x, float* g, float* U, float* ud, float* um,
              const float* p, const float* H0, const float* x_in,
              const float* g_in, const float* U_in, const float* ud_in,
              const float* um_in, const float* im, const float* u,
              float* acc, int C, int Mp, uint32_t k0, uint32_t k1,
              uint32_t iteration, cudaStream_t stream) {
  accept_kernel<<<C, ROW_THREADS, 0, stream>>>(x, g, U, ud, um, p, H0, x_in,
                                               g_in, U_in, ud_in, um_in, im,
                                               u, acc, Mp, k0, k1, iteration);
  return (int)cudaGetLastError();
}

int lf_philox_bits(uint32_t* out, int C, int width, uint32_t k0, uint32_t k1,
                   uint32_t iteration, cudaStream_t stream) {
  const size_t n = (size_t)C * (width / 4);
  philox_bits_kernel<<<grid_for(n, 256), 256, 0, stream>>>(out, C, width, k0,
                                                            k1, iteration);
  return (int)cudaGetLastError();
}

const char* lf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
