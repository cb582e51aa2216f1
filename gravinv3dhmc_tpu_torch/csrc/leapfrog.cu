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
//                H0 = K0 + U, leading half kick p = p0 - eps/2 g, pk = p
//                (or p alone, the per-step path's form)   (_iter, opens
//                every fused sampler path's iteration)
//   drift        elementwise: x += eps*im*p, clip to [low, high], negate p
//                where clipped (kept as x != clip(x), :203/:517)   (both)
//   residual     GEMM 1: r = (x A_c^T - dobs') * dmask, K split in slices
//                (the count planned in ops/leapfrog.py) reduced in a
//                fixed order                                        (both)
//   kick         GEMM 2: p -= 2 eps (r A_c) + s_mod gm(x)           (both)
//   traj_finish  one block per chain: g = (pk - p)/eps, p_half =
//                (pk + p)/2, ud, um, U                              (both)
//   accept       ACCEPT_CHAINS chains a block: K1, H1, Philox uniform,
//                accept, restore of rejected x, g, U, ud, um   (_iter,
//                closes every fused sampler path's iteration)
//   step_residual  GEMM 1's K slices (the residual_partial kernel above)
//                then one block per chain: d = sum of slices + fix, mean
//                over the true n_obs, r = ((d - mean) - dobs) * dmask,
//                ud = sum r^2                                       (_step)
//   step_misfit  one block per chain: um and U = ud + alpha um      (_step)
//   draws        elementwise: the momentum normals and accept uniforms
//                that refresh and accept draw, as inputs for the eager
//                sampler; at a shard's offsets (first chain c0, first
//                element group j0) the block of the whole batch's draws
//                                                   (_iter's on-chip PRNG)
// The per-step op reuses drift and kick as they are; the kick epilogue
// already applies p -= s_data gdata + s_mod gm, the full kick of _step.
//
// What bounds it: each GEMM is 2*C*Mp*Dp FLOP, about 7.9 GFLOP at
// C=1024, Mp=6016, Dp=640 (36 GFLOP at the ratiogrid's 1024 x 1024 x
// 17,152), and A_c (7.7 MB bf16, 15.4 MB f32) stays in the 50 MB L2
// across steps. The residual GEMM is bound by arithmetic; the kick's
// epilogue reads x and p and writes p (74 MB at uniformgrid), which
// bounds it by memory (22 us at 3.35 TB/s against 8 us of bf16 tensor
// work).
//
// Both GEMMs run on the tensor cores: wgmma fed by TMA through one
// warp-specialised mainloop (tc_mainloop below, whose comment gives the
// design). The residual (residual and step_residual) reads A as a K-major
// B (residual_partial_tc_kernel); the kick reads the same A as an
// MN-major B through wgmma's transpose immediate, with no transposed copy
// (kick_tc_kernel). With a bf16 matrix both operands of every product are
// bf16 values (x and r are rounded to bf16 as .astype(matvec_dtype) is in
// the TPU kernels), a bf16 x bf16 product is exact in f32, and the wgmma
// sum of every 256-deep run of K is added to the result in IEEE f32, so
// they compute the same products with the sums in another order. With an
// f32 matrix (realdata's trajectory precision: an f32 product of f32
// operands) the same mainloop computes each product from three bf16
// pieces of each operand, six bf16 products per k step
// (residual_partial_split_kernel, kick_split_persistent_kernel; see "The
// f32-matrix GEMMs" below). The dtype alone picks the kernel; there is no
// fallback between the two. A persistent L-loop that keeps chain tiles on
// chip is later work; the sampler replays whole iterations of these
// launches as CUDA graphs (inversion/hmc.py).
//
// Random numbers: Philox4x32-10 keyed by a salt from the run seed, with
// counter (element group, chain, global iteration, stream); the plain
// torch version in ops/philox.py draws identical u32 words. refresh,
// accept and draws take the key (k0, k1, iteration) as scalars, or, when
// their last argument `key` is not null, read it from those three words
// on the card: a captured graph then draws afresh each replay, as the
// sampler advances the words on the card. `key` comes last, so a caller
// that passes one more argument to an older library leaves it unread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_cuda.py).
// -fmad=false keeps each elementwise product and sum rounded on its own,
// as PyTorch's plain version does; wgmma is not touched by it. The
// library is not linked against the
// driver library: cuTensorMapEncodeTiled, a driver-API function, is
// fetched at run time through cudaGetDriverEntryPoint(ByVersion); <cuda.h>
// gives only its types.
// Every entry point launches on the given stream and returns
// cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int ROW_THREADS = 256;

// the tensor-core GEMMs (tc_mainloop; TcRing below sizes their rings)
constexpr int TC_BN = 128;      // output columns per block tile (wgmma N)
constexpr int TC_BK = 64;       // K per stage: 64 bf16 = one 128-byte row
constexpr int TC_PROMOTE = 4;   // bf16 matrix: stages per IEEE add
constexpr int TC_X_BOX = 32;    // f32 per 128-byte row of an x (or r) box
// an MN-major B tile comes in boxes of 64 columns (one 128-byte row) by
// the stage's rows of K, two per TC_BN-wide tile
constexpr int TC_MN_BOX = 64;
// the bf16 kick: consumer warpgroups (64 chains each) and ring stages
constexpr int KICK_CONSUMERS = 2;
constexpr int KICK_STAGES = 3;
// the f32-matrix GEMMs (six bf16 products a k step): the K depth of a
// stage, stages the tensor cores sum per IEEE add, whether the two
// consumer warpgroups take turns, and the consumer warpgroups and ring
// stages of the residual and the kick (f32_gemm_tune.py and, for the
// kick, kick_tune.py --f32 sweep them)
constexpr int SPLIT_BK = 32;        // K per stage: 32 bf16, 64-byte rows
constexpr int SPLIT_PROMOTE = 1;
constexpr int SPLIT_PINGPONG = 1;   // the consumers take turns to issue
constexpr int SPLIT_RES_CONSUMERS = 2;
constexpr int SPLIT_RES_STAGES = 5;
constexpr int SPLIT_KICK_CONSUMERS = 1;
constexpr int SPLIT_KICK_STAGES = 2;
// the matrix operand of the GEMM entries (a_mode): a bf16 matrix, or the
// three bf16 pieces of an f32 matrix, (3, Dp, Mp) (split_f32 in
// ops/leapfrog.py)
constexpr int A_BF16 = 1;
constexpr int A_F32_SPLIT = 2;
// the accept kernel: threads a block, chains a block, 16-byte loads in
// flight a thread (accept_tune.py sweeps them)
constexpr int ACCEPT_THREADS = 256;
constexpr int ACCEPT_CHAINS = 1;
constexpr int ACCEPT_UNROLL = 4;
// the draws kernel: threads a block, float4 groups a thread (gz_tune.py
// sweeps them)
constexpr int DRAWS_THREADS = 256;
constexpr int DRAWS_UNROLL = 4;

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

// Box-Muller over one word pair: (R cos, R sin), both from one sincosf
// (one argument reduction; the values of cosf and sinf)
__device__ __forceinline__ float2 box_muller(uint32_t w1, uint32_t w2) {
  const float u1 = u24(w1) + (0.5f / 16777216.0f);
  const float u2 = u24(w2);
  const float rad = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(TWO_PI * u2, &s, &c);
  return make_float2(rad * c, rad * s);
}

// momentum normals 4j .. 4j + 3 of chain c: Box-Muller over the word
// pairs of counter (j, c, iteration, STREAM_MOMENTUM)
__device__ __forceinline__ float4 momentum4(int j, int c, uint32_t iteration,
                                            uint32_t k0, uint32_t k1) {
  const uint4 w = philox4x32_10((uint32_t)j, (uint32_t)c, iteration,
                                STREAM_MOMENTUM, k0, k1);
  const float2 a = box_muller(w.x, w.y), b = box_muller(w.z, w.w);
  return make_float4(a.x, a.y, b.x, b.y);
}

// chain c's Metropolis uniform: word 0 of counter (0, c, iteration,
// STREAM_ACCEPT)
__device__ __forceinline__ float accept_uniform(int c, uint32_t iteration,
                                                uint32_t k0, uint32_t k1) {
  return u24(philox4x32_10(0u, (uint32_t)c, iteration, STREAM_ACCEPT, k0,
                           k1).x);
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

// ---------------------------------------------------------------- kernels

// sum over the four lanes of im * p^2, each product rounded on its own
__device__ __forceinline__ float kinetic4(float4 w, float4 p) {
  return ((w.x * p.x) * p.x + (w.y * p.y) * p.y) +
         ((w.z * p.z) * p.z + (w.w * p.w) * p.w);
}

// One block per chain, 16 bytes a thread a load: g (read once, streamed),
// pscale and im (shared by every chain, through the read-only path), the
// normals drawn in registers (or n01 streamed), p and, unless pk is null
// (the per-step path's p-only form), pk written as float4.
__global__ void __launch_bounds__(ROW_THREADS)
refresh_kernel(const float* __restrict__ g, const float* __restrict__ U,
               const float* __restrict__ pscale, const float* __restrict__ im,
               const float* __restrict__ n01, float* __restrict__ p,
               float* __restrict__ pk, float* __restrict__ H0, int Mp,
               float half_eps, uint32_t k0, uint32_t k1, uint32_t iteration,
               const uint32_t* __restrict__ key) {
  __shared__ float sh[32];
  if (key) {
    k0 = key[0];
    k1 = key[1];
    iteration = key[2];
  }
  const int c = blockIdx.x;
  const int n4 = Mp / 4;
  const size_t row4 = (size_t)c * n4;
  const float4* g4 = reinterpret_cast<const float4*>(g) + row4;
  const float4* s4 = reinterpret_cast<const float4*>(pscale);
  const float4* w4 = reinterpret_cast<const float4*>(im);
  float4* p4 = reinterpret_cast<float4*>(p) + row4;
  float4* pk4 = pk ? reinterpret_cast<float4*>(pk) + row4 : nullptr;
  float kin = 0.0f;
#pragma unroll 4
  for (int j = threadIdx.x; j < n4; j += ROW_THREADS) {
    const float4 v =
        n01 ? __ldcs(reinterpret_cast<const float4*>(n01) + row4 + j)
            : momentum4(j, c, iteration, k0, k1);
    const float4 sc = __ldg(s4 + j), gv = __ldcs(g4 + j);
    const float4 p0 = make_float4(sc.x * v.x, sc.y * v.y, sc.z * v.z,
                                  sc.w * v.w);
    kin += kinetic4(__ldg(w4 + j), p0);
    const float4 pv = make_float4(
        p0.x - half_eps * gv.x, p0.y - half_eps * gv.y,
        p0.z - half_eps * gv.z, p0.w - half_eps * gv.w);
    p4[j] = pv;
    if (pk4) pk4[j] = pv;
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

// the K stages [first, end) of slice z of n_stages split `splits` ways:
// sizes differ by at most one, and no slice is empty while splits <=
// n_stages (split_plan in ops/leapfrog.py cuts the same way)
__device__ __forceinline__ int2 slice_stages(int z, int n_stages,
                                             int splits) {
  return make_int2((int)((long long)z * n_stages / splits),
                   (int)((long long)(z + 1) * n_stages / splits));
}

// ------------------------------------------------ the tensor-core GEMMs

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive (the one expected arrival) and expect `bytes` from TMA
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// one 2-D TMA box at (inner coordinate, row) into shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k),
      "r"(row)
      : "memory");
}

// named barrier `id` of the block's two consumer warpgroups (256
// threads): wait for the other's arrival, or arrive without waiting
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void consumers_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// wgmma descriptor of a K-major bf16 tile of ROW_BYTES-byte rows (a
// stage of 64 or 32 of K) under the swizzle of that width, as TMA writes
// it: start address in 16-byte units, leading offset unused (1) for
// swizzled K-major, stride 8 rows between groups of 8 rows, layout type
// 1 = 128-byte swizzle, 2 = 64-byte swizzle
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t saddr) {
  static_assert(ROW_BYTES == 128 || ROW_BYTES == 64, "a 128- or 64-byte row");
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * ROW_BYTES) >> 4) << 32) |
         ((uint64_t)(ROW_BYTES == 128 ? 1 : 2) << 62);
}

// wgmma descriptor of an MN-major bf16 tile under the 128-byte swizzle,
// as TMA writes it in boxes of 64 columns (one 128-byte row) by the
// stage's K rows: start address in 16-byte units, leading offset the step
// from one 64-column box to the next (box_bytes), stride offset the step
// between groups of 8 K rows (1024 bytes), layout type 1 = 128-byte
// swizzle (the strides of CuTe's make_gmma_desc<GMMA::Major::MN>)
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t saddr,
                                                  uint32_t box_bytes) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) |
         ((uint64_t)(box_bytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// keeps the compiler from moving accumulator reads and writes across the
// asynchronous wgmma instructions
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] = a[64 x 16] (bf16, registers) * B[16 x 128] (bf16, shared
// memory through desc_b) + (accumulate ? d : 0), f32 accumulation. B is
// K-major (TRANS_B = 0: stored as 128 rows of 16 K) or MN-major
// (TRANS_B = 1: 16 K rows of 128 columns), the instruction's transpose
// immediate.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate), "n"(TRANS_B)
      : "memory");
}

// Two floats as PIECES bf16 pairs, each rounded to nearest even (as
// torch's .to(bfloat16)), the lower column in the low half: piece 0 is
// bf16_rn(v), piece q bf16_rn(v - pieces 0..q-1). Each difference is
// exact in f32 (v less its rounding to 8 bits fits in the 24), so the
// pieces carry v's 24 bits, 8 or 9 at a time (split_f32 in
// ops/leapfrog.py cuts A the same way).
template <int PIECES>
__device__ __forceinline__ void split_bf16x2(float2 v,
                                             uint32_t (&out)[PIECES]) {
#pragma unroll
  for (int q = 0; q < PIECES; ++q) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v.x, v.y);
    out[q] = *reinterpret_cast<const uint32_t*>(&b);
    if (q + 1 < PIECES) {
      const float2 w = __bfloat1622float2(b);
      v = make_float2(v.x - w.x, v.y - w.y);
    }
  }
}

// The ring of the warp-specialised tensor-core mainloop: CONSUMERS
// warpgroups of 64 chain rows each and one producer warp; a stage holds
// PIECES B tiles (TC_BN columns x BK of K, bf16: the bf16 matrix, or the
// three pieces of an f32 one) and the f32 operand's BM x BK tile (BK / 32
// boxes of 128-byte rows).
template <int CONSUMERS_, int STAGES_, int PIECES_ = 1, int BK_ = TC_BK>
struct TcRing {
  static constexpr int CONSUMERS = CONSUMERS_;
  static constexpr int STAGES = STAGES_;
  static constexpr int PIECES = PIECES_;
  static constexpr int BK = BK_;
  static_assert(BK == 64 || BK == 32, "a stage of 128- or 64-byte rows");
  static constexpr int BM = 64 * CONSUMERS;
  static constexpr int THREADS = 128 * CONSUMERS + 32;
  static constexpr int B_TILE = TC_BN * BK * 2;           // one bf16 tile
  static constexpr int MN_BOX_BYTES = TC_MN_BOX * BK * 2;  // half a tile
  static constexpr int B_BYTES = PIECES * B_TILE;
  static constexpr int X_BYTES = BM * BK * 4;
  static constexpr int STAGE_BYTES = B_BYTES + X_BYTES;
  // the ring plus slack to align it to the 1024-byte swizzle period
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;
};
// the residual GEMM: 128 x 128 tiles, a 4-stage ring (197 KB), one block
// an SM
using ResidualRing = TcRing<2, 4>;
using KickRing = TcRing<KICK_CONSUMERS, KICK_STAGES>;
// the f32-matrix GEMMs: three 8 KB B tiles a 32-deep stage (40 KB with
// 128 chains' x), five stages; the kick: one warpgroup of 64 chains (32
// KB a stage), two stages beside its epilogue tile, two blocks an SM
using SplitResidualRing =
    TcRing<SPLIT_RES_CONSUMERS, SPLIT_RES_STAGES, 3, SPLIT_BK>;
using SplitKickRing =
    TcRing<SPLIT_KICK_CONSUMERS, SPLIT_KICK_STAGES, 3, SPLIT_BK>;
// blocks an SM a ring's registers are bounded for: each consumer thread
// holds two 64-float accumulators, so only one-warpgroup blocks fit twice
template <class R>
constexpr int min_blocks() {
  return R::CONSUMERS == 1 ? 2 : 1;
}
// floats per row of the kick's epilogue tile in shared memory: the pad
// makes the accumulators' float2 writes free of bank conflicts
constexpr int KICK_TILE_LD = TC_BN + 8;
static_assert(KickRing::BM * KICK_TILE_LD * 4 <=
                  KickRing::STAGES * KickRing::STAGE_BYTES,
              "the kick's epilogue tile must fit in its ring");
// The persistent f32 kick's block: its consumer warpgroup(s) and a
// producer warpgroup, whose first warp issues the loads and whose three
// others apply the epilogue. The producer warpgroup gives up registers to
// the consumers (setmaxnreg): at launch every thread holds LAUNCH_REGS (the
// SM's 64K over THREADS times the blocks an SM, ptxas's count), and the
// block's total is then shared out again. Its shared memory: the ring,
// then the epilogue tile of the last tile's accumulators, padded as the
// bf16 kick's.
template <class R>
struct PersistentKick {
  static constexpr int THREADS = 128 * R::CONSUMERS + 128;
  static constexpr int EPILOGUE_WARPS = 3;
  static constexpr int LAUNCH_REGS =
      65536 / (THREADS * min_blocks<R>()) / 8 * 8;
  static constexpr int PRODUCER_REGS = 88;
  static constexpr int CONSUMER_REGS =
      ((R::CONSUMERS + 1) * LAUNCH_REGS - PRODUCER_REGS) / R::CONSUMERS / 8 *
      8;
  static constexpr int TILE_BYTES = R::BM * KICK_TILE_LD * 4;
  static constexpr int SMEM = R::SMEM + TILE_BYTES;
  static_assert(CONSUMER_REGS <= 256, "setmaxnreg takes up to 256");
};
using SplitKick = PersistentKick<SplitKickRing>;
static_assert(SplitResidualRing::SMEM <= 232448 && SplitKick::SMEM <= 232448,
              "a ring must fit in a block's shared memory");

// the ring: dynamic shared memory aligned to the swizzle's 1024-byte
// period
__device__ __forceinline__ unsigned char* tc_ring() {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  return smem_raw + (((raw + 1023u) & ~1023u) - raw);
}

// this consumer thread's first accumulator row in the block tile; the
// wgmma accumulator acc[4j + 2v + e] is row tc_row0() + 8v, column
// 8j + 2 (lane & 3) + e
__device__ __forceinline__ int tc_row0() {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
}

// The mainloop shared by the tensor-core GEMMs: acc = sum over the K
// stages [first, first + n) of bf16_rn(X[c0 + row, k]) B[k, n0 + col] for
// this consumer thread's 64 accumulator entries (tc_row0), f32
// accumulation. X is an f32 operand (rows = chains, K contiguous) read
// through x_map; B a bf16 matrix read through b_map, K-major (B_MN false:
// its rows are the N columns, K contiguous, as A in x A^T) or MN-major
// (B_MN true: its rows are K, N contiguous, as A in r A). Returns false in
// the producer warp, which has nothing left to do.
//
// Design: one producer warp (one thread) keeps a ring of STAGES stages
// full through TMA: per stage the B tile (K-major: one box of 128 rows x
// 64 bf16; MN-major: two boxes of 64 K rows x 64 columns) and two boxes
// of X (BM rows x 32 f32, a 128-byte swizzled row each), completion
// counted on the stage's `full` mbarrier. Rows >= C come from TMA's zero
// fill. Each consumer warpgroup owns 64 chain rows: per 16-deep k step a
// thread reads its wgmma A fragment (rows g and g + 8 of its warp's 16,
// columns 2t, 2t + 1, 2t + 8, 2t + 9) from the swizzled f32 tile, rounds
// it to bf16 in registers, and issues wgmma.m64n128k16 with B read by
// descriptor straight from the swizzled B tile (the MN-major one with the
// transpose immediate). Each warpgroup waits for its stage's wgmmas
// before it releases the stage (`empty` mbarrier, one arrival a consumer
// thread); the other warpgroups and the ring keep the tensor cores fed
// meanwhile.
//
// Precision: the tensor cores' own f32 accumulation loses bits over a long
// K chain (one wgmma accumulator per 8576-deep slice missed the float64
// product by 3.5e-5 of its largest value at ratiogrid's shape, cuBLAS's
// f32 GEMM by ~1e-6). So every TC_PROMOTE stages (256 deep) the product
// starts fresh in the tensor cores (scale-d = 0 on its first k step) and
// is then added to an f32 accumulator in registers with IEEE adds: error
// 5.9e-7, time +2 % (H100, 1024 x 1024 x 17,152). Adding after every
// stage cost +36 % there for no further gain.
//
// The f32-matrix GEMMs (R::PIECES = 3) run the same loop on three B tiles
// a stage, the bf16 pieces a0, a1, a2 of A, and split each f32 X value
// into three bf16 pieces x0, x1, x2 in registers (split_bf16x2). Per k
// step they issue the six products x_i a_j with i + j <= 2, smallest
// first: x2 a0, x1 a1, x0 a2, x1 a0, x0 a1, x0 a0 (each over all the
// stage's k steps before the next), so the small terms are summed before the
// large ones join the tensor-core accumulator. The three dropped terms
// are below 2^-26 of |x a|, and the pieces carry all of x's and a's 24
// bits, so the products are those of the f32 operands to f32 rounding,
// the six-pass bf16 scheme of the TPU's f32 matmul at HIGHEST precision.
// Every PROMOTE stages (SPLIT_PROMOTE) the sum goes to the IEEE f32
// accumulator; f32_gemm_tune.py measured the error at each interval
// (PERF.md).
//
// Their stages are 32 deep (three 8 KB B tiles and 16 KB of x, under the
// 64-byte swizzle for the K-major B), five in the residual's ring, which
// halves the registers the x pieces take and keeps more loads in flight;
// and the residual's two consumer warpgroups take turns to issue (named
// barriers 2 and 3), so one converts its next fragments while the
// other's products run (the kick's two blocks an SM, one warpgroup each,
// share the tensor cores instead). The stage depth, ring and interval
// were chosen by f32_gemm_tune.py's sweep (PERF.md).
//
// tc_mainloop is built from three pieces: the ring's barriers
// (tc_ring_init), the producer's loads of one tile's stages
// (tc_load_stages) and the consumers' K loop over them
// (tc_consume_stages). The persistent f32 kick runs the last two over
// many tiles, the ring's slots counted on from one tile to the next.

// The ring's barriers: stage s is full once its loads have landed, empty
// once every consumer thread has released it
template <class R>
struct TcBars {
  uint64_t full[R::STAGES];
  uint64_t empty[R::STAGES];
};
template <class R>
__device__ __forceinline__ TcBars<R>& tc_bars() {
  __shared__ __align__(8) TcBars<R> bars;
  return bars;
}

template <class R>
__device__ __forceinline__ void tc_ring_init() {
  TcBars<R>& bars = tc_bars<R>();
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&bars.full[s], 1);
      mbar_init(&bars.empty[s], R::CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// The producer's loads (one thread) of one tile's K stages [first,
// first + n) into the ring's slots it0 .. it0 + n - 1 (slot j is stage
// j % STAGES in its (j / STAGES)-th use)
template <class R, bool B_MN>
__device__ __forceinline__ void tc_load_stages(const CUtensorMap* x_map,
                                               const CUtensorMap* b_map,
                                               int piece_rows, int first,
                                               int n, int c0, int n0,
                                               int it0) {
  constexpr int STAGES = R::STAGES, PIECES = R::PIECES;
  TcBars<R>& bars = tc_bars<R>();
  const uint32_t ring_u32 = smem_u32(tc_ring());
  for (int i = 0; i < n; ++i) {
    const int j = it0 + i, s = j % STAGES;
    mbar_wait(&bars.empty[s], ((j / STAGES) & 1) ^ 1);
    const uint32_t dst = ring_u32 + s * R::STAGE_BYTES;
    const int k = (first + i) * R::BK;
    mbar_expect_tx(&bars.full[s], R::STAGE_BYTES);
    // piece q of B starts at row q * piece_rows of b_map
    for (int q = 0; q < PIECES; ++q) {
      const uint32_t bq = dst + q * R::B_TILE;
      const int row = q * piece_rows;
      if (B_MN) {
        tma_load_2d(bq, b_map, &bars.full[s], n0, row + k);
        tma_load_2d(bq + R::MN_BOX_BYTES, b_map, &bars.full[s],
                    n0 + TC_MN_BOX, row + k);
      } else {
        tma_load_2d(bq, b_map, &bars.full[s], k, row + n0);
      }
    }
    for (int xb = 0; xb < R::BK / TC_X_BOX; ++xb)
      tma_load_2d(dst + R::B_BYTES + xb * R::BM * 128, x_map, &bars.full[s],
                  k + xb * TC_X_BOX, c0);
  }
}

// A consumer thread's part of one tile's K loop over the ring's slots
// it0 .. it0 + n - 1 (tc_mainloop's design above)
template <class R, bool B_MN, int PROMOTE>
__device__ __forceinline__ void tc_consume_stages(int n, int it0,
                                                  float (&acc)[64]) {
  constexpr int STAGES = R::STAGES, PIECES = R::PIECES;
  static_assert(PIECES == 1 || PIECES == 3, "a bf16 matrix or three pieces");
  constexpr int PRODUCTS = PIECES == 1 ? 1 : 6;
  constexpr bool PINGPONG =
      SPLIT_PINGPONG && R::PIECES == 3 && R::CONSUMERS == 2;
  TcBars<R>& bars = tc_bars<R>();
  unsigned char* ring = tc_ring();
  const uint32_t ring_u32 = smem_u32(ring);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // this thread's fragment rows g and g + 8 of its warp's 16; every row
  // is g modulo 8, which is the swizzle's XOR for that row
  const int g = lane >> 2, t = lane & 3;
  const int row0 = tc_row0();
  // consumer 0 issues first: 1 has taken its turn before the loop
  const int wg = warp >> 2;
  if constexpr (PINGPONG)
    if (wg == 1) consumers_arrive(2);
  float stage_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = stage_acc[i] = 0.0f;
  for (int i = 0; i < n; ++i) {
    const int j = it0 + i, s = j % STAGES;
    mbar_wait(&bars.full[s], (j / STAGES) & 1);
    const unsigned char* xs = ring + s * R::STAGE_BYTES + R::B_BYTES;
    // a[q][kk]: piece q of the k step kk's fragment
    uint32_t a[PIECES][R::BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < R::BK / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // columns 2t, 2t + 1 and 2t + 8, 2t + 9
        const int col = kk * 16 + h * 8 + 2 * t;
        const int c = col % TC_X_BOX;
        const unsigned char* box = xs + (col / TC_X_BOX) * (R::BM * 128);
        const int off = (((c >> 2) ^ g) << 4) | ((c & 3) << 2);
#pragma unroll
        for (int v = 0; v < 2; ++v) {  // rows g, g + 8
          uint32_t pieces[PIECES];
          split_bf16x2<PIECES>(*reinterpret_cast<const float2*>(
                                   box + (row0 + 8 * v) * 128 + off),
                               pieces);
#pragma unroll
          for (int q = 0; q < PIECES; ++q) a[q][kk][2 * h + v] = pieces[q];
        }
      }
    }
    const uint32_t b = ring_u32 + s * R::STAGE_BYTES;
    const bool fresh = i % PROMOTE == 0;
    if constexpr (PINGPONG) consumers_sync(2 + wg);  // this one's turn
    fence_acc(stage_acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int p = 0; p < PRODUCTS; ++p) {
      // product p is x_xi a_bj: (2,0) (1,1) (0,2) (1,0) (0,1) (0,0)
      const int xi = PIECES == 1 ? 0 : p == 0 ? 2 : (p == 1 || p == 3) ? 1 : 0;
      const int bj = PIECES == 1 ? 0 : p == 2 ? 2 : (p == 1 || p == 4) ? 1 : 0;
      const uint32_t bp = b + bj * R::B_TILE;
#pragma unroll
      for (int kk = 0; kk < R::BK / 16; ++kk)
        // a k step is 32 bytes along a K-major row, 16 rows of 128 bytes
        // down an MN-major box
        wgmma_m64n128k16_rs<B_MN>(
            stage_acc, a[xi][kk],
            B_MN ? sw128_mn_desc(bp + kk * 16 * 128, R::MN_BOX_BYTES)
                 : kmajor_desc<R::BK * 2>(bp + kk * 32),
            p > 0 || kk > 0 || !fresh);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    // the other's turn (it has no turn after the last stage of consumer 1)
    if constexpr (PINGPONG)
      if (wg == 0 || i < n - 1) consumers_arrive(3 - wg);
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(stage_acc);
    mbar_arrive(&bars.empty[s]);
    if (i % PROMOTE == PROMOTE - 1 || i == n - 1) {
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] += stage_acc[e];
    }
  }
}

template <class R, bool B_MN, int PROMOTE>
__device__ __forceinline__ bool tc_mainloop(const CUtensorMap* x_map,
                                            const CUtensorMap* b_map,
                                            int piece_rows, int first, int n,
                                            int c0, int n0,
                                            float (&acc)[64]) {
  tc_ring_init<R>();
  if ((threadIdx.x >> 5) == R::CONSUMERS * 4) {  // the producer warp
    if ((threadIdx.x & 31) == 0)
      tc_load_stages<R, B_MN>(x_map, b_map, piece_rows, first, n, c0, n0, 0);
    return false;
  }
  tc_consume_stages<R, B_MN, PROMOTE>(n, 0, acc);
  return true;
}

// GEMM 1 in K slices with a bf16 matrix, on the tensor cores:
// part[s, c, d] = sum over the s-th slice of m of bf16_rn(x[c, m]) A[d, m],
// f32 accumulation. Both operands are K-major (a "TN" product); one block
// per 128 chains x 128 observations x one K slice.
//
// What bounds it: a 128 x 128 tile over a 64-deep stage is 2.1 MFLOP
// against 48 KB of operands (32 KB of f32 x, 16 KB of bf16 A), 43 FLOP a
// byte moved from L2 into shared memory, so at the tensor-core rate the
// L2-to-SM traffic, not the tensor cores, is the first limit; the x tile
// of one (chain tile, slice) is read by all Dp/128 observation tiles,
// launched next to each other (blockIdx.x) so they find it in L2.
//
// residual_partial_split_kernel below is the same GEMM with an f32 matrix.
template <class R, int PROMOTE>
__device__ __forceinline__ void residual_partial_tile(
    const CUtensorMap* x_map, const CUtensorMap* a_map, float* part, int C,
    int Dp, int n_stages, int splits) {
  const int2 st = slice_stages(blockIdx.z, n_stages, splits);
  const int c0 = blockIdx.y * R::BM, d0 = blockIdx.x * TC_BN;
  float acc[64];
  if (!tc_mainloop<R, false, PROMOTE>(x_map, a_map, Dp, st.x, st.y - st.x,
                                      c0, d0, acc))
    return;
  const int row0 = tc_row0(), t = threadIdx.x & 3;
  float* out = part + (size_t)blockIdx.z * C * Dp;
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int c = c0 + row0 + 8 * v;
    if (c >= C) continue;
    float* orow = out + (size_t)c * Dp + d0 + 2 * t;
#pragma unroll
    for (int j = 0; j < TC_BN / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) =
          make_float2(acc[4 * j + 2 * v], acc[4 * j + 2 * v + 1]);
  }
}

__global__ void __launch_bounds__(ResidualRing::THREADS,
                                  min_blocks<ResidualRing>())
residual_partial_tc_kernel(__grid_constant__ const CUtensorMap x_map,
                           __grid_constant__ const CUtensorMap a_map,
                           float* __restrict__ part, int C, int Dp,
                           int n_stages, int splits) {
  residual_partial_tile<ResidualRing, TC_PROMOTE>(&x_map, &a_map, part, C,
                                                  Dp, n_stages, splits);
}

// GEMM 1 in K slices with an f32 matrix, on the tensor cores at f32
// accuracy: part[s, c, d] = sum over the s-th slice of m of x[c, m]
// A[d, m], from A's three bf16 pieces (a_map over the (3 Dp, Mp) pieces)
// and x's, split in registers: six bf16 products a k step (tc_mainloop).
// Replaces the SIMT f32 kernel (64 x 64 tiles, 16-deep stages, fmaf).
//
// What bounds it: the tensor cores. Six bf16 products are 6 x 2 C Dp Mp
// FLOP at 989 TFLOP/s: 20.9 us at realdata's 256 x 640 x 10,496, against
// 51.3 us for one f32 product at the 67 TFLOP/s of the SIMT units and 11
// us of bytes. A 32-deep stage is 40 KB for 6.3 MFLOP (157 FLOP a byte
// from L2). At realdata's 256 chains there are only 10 output tiles, so K
// is cut into up to one wave of slices (residual_plan in
// ops/leapfrog.py).
__global__ void __launch_bounds__(SplitResidualRing::THREADS,
                                  min_blocks<SplitResidualRing>())
residual_partial_split_kernel(__grid_constant__ const CUtensorMap x_map,
                              __grid_constant__ const CUtensorMap a_map,
                              float* __restrict__ part, int C, int Dp,
                              int n_stages, int splits) {
  residual_partial_tile<SplitResidualRing, SPLIT_PROMOTE>(
      &x_map, &a_map, part, C, Dp, n_stages, splits);
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

// One entry of the kick epilogue: p - s_data gdata - s_mod gm(x), with gm
// the MS (gm_scale dm / (dm^2 + beta)^2) or Damping (dm) gradient of
// dm = x - aprior, each operation rounded on its own
__device__ __forceinline__ float kick_value(float p, float gdata, float x,
                                            float ap, float gs, float s_data,
                                            float s_mod, float beta, int ms) {
  const float dm = x - ap;
  float gm;
  if (ms) {
    const float inv = 1.0f / (dm * dm + beta);
    gm = gs * dm * (inv * inv);
  } else {
    gm = dm;
  }
  return p - s_data * gdata - s_mod * gm;
}

// The kick with a bf16 matrix, on the tensor cores:
// p[c, m] = p - s_data * (sum_d bf16_rn(r[c, d]) A[d, m]) - s_mod gm(x[c, m]),
// the GEMM f32-accumulated with M = chains, N = m and K = d. A (Dp x Mp,
// m contiguous) is B as stored, MN-major: tc_mainloop reads it through
// the transpose immediate, so no transposed copy is kept and A keeps its
// place in L2. One block per KickRing::BM chains x 128 columns covers all
// of K (Dp / 64 stages, 10 at uniformgrid, 16 at ratiogrid); no split.
// The chain tiles run fastest (blockIdx.x), so the blocks that read one
// 128-column slab of A run side by side and a wave reads 1/8 of A, not
// all of it. Ring and raster were timed on the H100 (kick_tune.py and
// PERF.md): 2 consumer warpgroups, 3 stages, 145 KB, one block an SM.
//
// What bounds it: memory. A 128 x 128 tile reads 128 KB of x and p and
// writes 64 KB of p from and to device memory, against 0.5-0.8 MB of
// operands streamed from L2 by the mainloop (r's f32 rows again for
// every column tile), and the whole call moves 84 MB (uniformgrid: x and
// p read, p written, r and A) against 7.9 GFLOP: 25 us at 3.35 TB/s, 8 us
// at the bf16 tensor rate. A block runs its mainloop and then its
// epilogue, and with one block an SM nothing overlaps the two. The f32
// kick below runs each tile's epilogue under the next tile's mainloop;
// this one, bound by bytes with a mainloop of 10 short stages, keeps the
// block-per-tile shape (PERF.md).
//
// The epilogue goes through shared memory: the consumers write their
// accumulators to a padded tile in the ring, idle once the mainloop is
// done, and each warp then reads x and p and writes p a tile row at a
// time, 512 contiguous bytes a warp instruction. Read straight from the
// accumulator layout, a warp instruction touched 8 rows of 32 bytes, and
// the call took 0.69 ms at 1024 x 640 x 6016 (H100, kick_tune.py), ten
// times what it takes with this one. Rows >= C are neither read nor
// written.
//
// kick_split_persistent_kernel below is the same kick with an f32 matrix.

// kick_value on a lane's four columns
__device__ __forceinline__ float4 kick_value4(float4 pv, float4 gd, float4 xv,
                                              float4 av, float4 gv,
                                              float s_data, float s_mod,
                                              float beta, int ms) {
  return make_float4(
      kick_value(pv.x, gd.x, xv.x, av.x, gv.x, s_data, s_mod, beta, ms),
      kick_value(pv.y, gd.y, xv.y, av.y, gv.y, s_data, s_mod, beta, ms),
      kick_value(pv.z, gd.z, xv.z, av.z, gv.z, s_data, s_mod, beta, ms),
      kick_value(pv.w, gd.w, xv.w, av.w, gv.w, s_data, s_mod, beta, ms));
}

// p -= s_data acc + s_mod gm(x) for the consumers' R::BM x TC_BN tile of
// accumulators, through the ring (see kick_tc_kernel)
template <class R>
__device__ __forceinline__ void kick_epilogue(
    const float (&acc)[64], const float* __restrict__ x, float* __restrict__ p,
    const float* __restrict__ aprior, const float* __restrict__ gm_scale,
    int C, int Mp, int c0, int m0, float s_data, float s_mod, float beta,
    int ms) {
  constexpr int CONSUMER_THREADS = R::CONSUMERS * 128;
  float* tile = reinterpret_cast<float*>(tc_ring());
  // every consumer is past the mainloop, which waited for every load
  // into this CTA: the ring is free
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMER_THREADS) : "memory");
  const int row0 = tc_row0(), col = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int v = 0; v < 2; ++v)
#pragma unroll
    for (int j = 0; j < TC_BN / 8; ++j)
      *reinterpret_cast<float2*>(tile + (row0 + 8 * v) * KICK_TILE_LD + col +
                                 8 * j) =
          make_float2(acc[4 * j + 2 * v], acc[4 * j + 2 * v + 1]);
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMER_THREADS) : "memory");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = m0 + 4 * lane;
  const float4 av = *reinterpret_cast<const float4*>(aprior + m);
  const float4 gv = *reinterpret_cast<const float4*>(gm_scale + m);
#pragma unroll 4
  for (int row = warp; row < R::BM; row += CONSUMER_THREADS / 32) {
    const int c = c0 + row;
    if (c >= C) break;
    const size_t off = (size_t)c * Mp + m;
    const float4 xv = *reinterpret_cast<const float4*>(x + off);
    const float4 pv = *reinterpret_cast<const float4*>(p + off);
    const float4 gd =
        *reinterpret_cast<const float4*>(tile + row * KICK_TILE_LD + 4 * lane);
    *reinterpret_cast<float4*>(p + off) =
        kick_value4(pv, gd, xv, av, gv, s_data, s_mod, beta, ms);
  }
}

template <class R, int PROMOTE>
__device__ __forceinline__ void kick_tile(
    const CUtensorMap* r_map, const CUtensorMap* a_map,
    const float* __restrict__ x, float* __restrict__ p,
    const float* __restrict__ aprior, const float* __restrict__ gm_scale,
    int C, int Mp, int n_stages, float s_data, float s_mod, float beta,
    int ms) {
  const int c0 = blockIdx.x * R::BM, m0 = blockIdx.y * TC_BN;
  float acc[64];
  // the matrix's pieces (3 Dp rows) start every Dp = n_stages * R::BK rows
  if (tc_mainloop<R, true, PROMOTE>(r_map, a_map, n_stages * R::BK, 0,
                                    n_stages, c0, m0, acc))
    kick_epilogue<R>(acc, x, p, aprior, gm_scale, C, Mp, c0, m0, s_data,
                     s_mod, beta, ms);
}

__global__ void __launch_bounds__(KickRing::THREADS, min_blocks<KickRing>())
kick_tc_kernel(__grid_constant__ const CUtensorMap r_map,
               __grid_constant__ const CUtensorMap a_map,
               const float* __restrict__ x, float* __restrict__ p,
               const float* __restrict__ aprior,
               const float* __restrict__ gm_scale, int C, int Mp,
               int n_stages, float s_data, float s_mod, float beta, int ms) {
  kick_tile<KickRing, TC_PROMOTE>(&r_map, &a_map, x, p, aprior, gm_scale, C,
                                  Mp, n_stages, s_data, s_mod, beta, ms);
}

// The kick with an f32 matrix, on the tensor cores at f32 accuracy:
// p[c, m] = p - s_data * (sum_d r[c, d] A[d, m]) - s_mod gm(x[c, m]), the
// product from A's three bf16 pieces read MN-major (a_map over the
// (3 Dp, Mp) pieces; no transposed copy, which a 32-bit wgmma operand
// would need: wgmma transposes only 16-bit ones) and r's, split in
// registers, six bf16 products a k step (tc_consume_stages); each entry of
// p is computed as the bf16 kick's epilogue computes it. Replaces the
// SIMT f32 kick (64 x 64 tiles, fmaf).
//
// What bounds it: the tensor cores, 6 x 2 C Dp Mp FLOP at 989 TFLOP/s:
// 47.8 us at uniformgrid's 1024 x 640 x 6016 and 85.5 us at realdata's
// 1024 x 640 x 10,752, against 29.7 and 52.6 us for the bytes (x and p
// read, p written, r and A's pieces read once).
//
// Design: persistent, two blocks an SM taking turns at the tensor cores.
// min(tiles, resident blocks) blocks walk the 64 x 128 output tiles
// (half the bf16 kick's: 64 chains, one consumer warpgroup) in the bf16
// kick's raster, chain tiles fastest, so the blocks that read one
// 128-column slab of A's pieces run side by side; block b takes tiles b,
// b + gridDim.x, ... (kick_plan in ops/leapfrog.py walks them the same
// way). A block is its consumer warpgroup and a producer warpgroup
// (PersistentKick). The producer's first warp loads tile after tile into
// the ring (two 32 KB stages) and never waits for an epilogue. The
// consumers run each tile's K loop, stash its accumulators in an
// epilogue tile of its own after the ring, and go on to the next tile at
// once; the producer warpgroup's other three warps apply the stashed tile
// to p (KickEpilogue) under that next tile's mainloop and the other
// block's. Two mbarriers hand the tile over: `tile_full` once every
// consumer has stashed, `tile_empty` once the epilogue warps have read it
// all. Every warp of the block shares the block's last tile's rows. The
// half tiles also even out the last round: 1,344 at realdata's 1024
// chains are 10.2 an SM, against 5.09 whole tiles. The K loop, its
// products and their order and the promotion every stage are
// tc_mainloop's, so p is bit for bit what a block a whole tile computes.
// Where the time went before (one block a 128 x 128 tile, one block an
// SM: each tile's 20-stage mainloop, then its epilogue, 192 KB of device
// memory, with the tensor cores idle, then the ring's fill): 0.110 ms at
// uniformgrid's 376 tiles (3 rounds of 132) and about 0.21 ms at
// realdata's 672 (6 rounds), 43 % and 40 % of the bound. This one takes
// 0.080 and 0.142 ms (60 % of both bounds); the same walk with both
// warpgroups of one block an SM on one 128 x 128 tile (the cooperative
// shape, a three-stage ring) took 0.096 and 0.187, though it reads A's
// pieces from L2 half as often (H100, kick_tune.py --f32; PERF.md).

// The epilogue of a stashed tile of R::BM chains: p -= s_data tile +
// s_mod gm(x) on its rows first, first + stride, ..., a warp a row, four
// rows' x and p loaded before any is written. Rows >= C are neither read
// nor written.
template <class R>
struct KickEpilogue {
  static constexpr int BATCH = 4;
  const float* tile;
  const float* x;
  float* p;
  const float* aprior;
  const float* gm_scale;
  int C, Mp;
  float s_data, s_mod, beta;
  int ms;

  __device__ __forceinline__ void rows(int c0, int m0, int first,
                                       int stride) const {
    const int col = 4 * (threadIdx.x & 31), m = m0 + col;
    const float4 av = *reinterpret_cast<const float4*>(aprior + m);
    const float4 gv = *reinterpret_cast<const float4*>(gm_scale + m);
    const int n = C - c0 < R::BM ? C - c0 : R::BM;
    for (int r0 = first; r0 < n; r0 += BATCH * stride) {
      float4 xs[BATCH], ps[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int row = r0 + u * stride;
        if (row < n) {
          const size_t off = (size_t)(c0 + row) * Mp + m;
          xs[u] = *reinterpret_cast<const float4*>(x + off);
          ps[u] = *reinterpret_cast<const float4*>(p + off);
        }
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int row = r0 + u * stride;
        if (row < n) {
          const float4 gd = *reinterpret_cast<const float4*>(
              tile + row * KICK_TILE_LD + col);
          *reinterpret_cast<float4*>(p + (size_t)(c0 + row) * Mp + m) =
              kick_value4(ps[u], gd, xs[u], av, gv, s_data, s_mod, beta, ms);
        }
      }
    }
  }
};

__global__ void __launch_bounds__(SplitKick::THREADS,
                                  min_blocks<SplitKickRing>())
kick_split_persistent_kernel(__grid_constant__ const CUtensorMap r_map,
                             __grid_constant__ const CUtensorMap a_map,
                             const float* __restrict__ x,
                             float* __restrict__ p,
                             const float* __restrict__ aprior,
                             const float* __restrict__ gm_scale, int C,
                             int Mp, int n_stages, float s_data, float s_mod,
                             float beta, int ms) {
  using R = SplitKickRing;
  constexpr int CONSUMER_WARPS = R::CONSUMERS * 4;
  constexpr int ALL_WARPS = CONSUMER_WARPS + SplitKick::EPILOGUE_WARPS;
  __shared__ __align__(8) uint64_t tile_full, tile_empty;
  const int chain_tiles = (C + R::BM - 1) / R::BM;
  const int tiles = chain_tiles * (Mp / TC_BN);
  if (threadIdx.x == 0) {
    mbar_init(&tile_full, CONSUMER_WARPS * 32);
    mbar_init(&tile_empty, SplitKick::EPILOGUE_WARPS * 32);
  }
  tc_ring_init<R>();  // fences the inits and syncs the block
  float* tile =
      reinterpret_cast<float*>(tc_ring() + R::STAGES * R::STAGE_BYTES);
  const KickEpilogue<R> epi{tile, x,     p,     aprior, gm_scale, C,
                            Mp,   s_data, s_mod, beta,   ms};
  const int warp = threadIdx.x >> 5;
  // the block's last tile
  const int last = blockIdx.x + (tiles - 1 - blockIdx.x) / gridDim.x *
                                    gridDim.x;
  const int last_c0 = last % chain_tiles * R::BM;
  const int last_m0 = last / chain_tiles * TC_BN;
  if (warp >= CONSUMER_WARPS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        SplitKick::PRODUCER_REGS));
    if (warp == CONSUMER_WARPS) {
      if ((threadIdx.x & 31) == 0)
        for (int t = blockIdx.x, it = 0; t < tiles;
             t += gridDim.x, it += n_stages)
          // the matrix's pieces (3 Dp rows) start every Dp = n_stages * BK
          tc_load_stages<R, true>(&r_map, &a_map, n_stages * R::BK, 0,
                                  n_stages, t % chain_tiles * R::BM,
                                  t / chain_tiles * TC_BN, it);
      return;
    }
    // the epilogue warps: every tile but the last
    const int e = warp - CONSUMER_WARPS - 1;
    int k = 0;
    for (int t = blockIdx.x; t < last; t += gridDim.x, ++k) {
      mbar_wait(&tile_full, k & 1);
      epi.rows(t % chain_tiles * R::BM, t / chain_tiles * TC_BN, e,
               SplitKick::EPILOGUE_WARPS);
      mbar_arrive(&tile_empty);
    }
    mbar_wait(&tile_full, k & 1);
    epi.rows(last_c0, last_m0, CONSUMER_WARPS + e, ALL_WARPS);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
      SplitKick::CONSUMER_REGS));
  float acc[64];
  int k = 0;
  for (int t = blockIdx.x, it = 0; t < tiles;
       t += gridDim.x, it += n_stages, ++k) {
    tc_consume_stages<R, true, SPLIT_PROMOTE>(n_stages, it, acc);
    // the epilogue warps are done with the tile before
    if (k) mbar_wait(&tile_empty, (k - 1) & 1);
    const int row0 = tc_row0(), col = 2 * (threadIdx.x & 3);
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int j = 0; j < TC_BN / 8; ++j)
        *reinterpret_cast<float2*>(tile + (row0 + 8 * v) * KICK_TILE_LD +
                                   col + 8 * j) =
            make_float2(acc[4 * j + 2 * v], acc[4 * j + 2 * v + 1]);
    mbar_arrive(&tile_full);
  }
  mbar_wait(&tile_full, (k - 1) & 1);
  epi.rows(last_c0, last_m0, warp, ALL_WARPS);
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

// Metropolis test on H1 = K(p) + U against H0; rejected chains take back
// their carried state bit for bit. Bound by bytes: p read once (72 MB at
// ratiogrid's 1024 x 17,152), plus x_in and g_in read and x and g written
// for each rejected chain. So the design keeps many bytes in flight:
// ACCEPT_CHAINS chains a block of ACCEPT_THREADS threads, each chain's
// threads issuing ACCEPT_UNROLL independent 16-byte loads of p (streamed,
// read once) and of im (read-only path, shared by every chain) before
// they add, into as many partial sums; a block-wide barrier, then one
// thread a chain takes the decision and restores U, ud, um, and a
// rejected chain's threads copy x_in and g_in back with the same unrolled
// 16-byte loads and stores. The configuration was chosen by the sweep of
// accept_tune.py.
template <int THREADS, int CHAINS, int UNROLL>
__global__ void __launch_bounds__(THREADS)
accept_kernel(float* __restrict__ x, float* __restrict__ g,
              float* __restrict__ U, float* __restrict__ ud,
              float* __restrict__ um, const float* __restrict__ p,
              const float* __restrict__ H0, const float* __restrict__ x_in,
              const float* __restrict__ g_in, const float* __restrict__ U_in,
              const float* __restrict__ ud_in,
              const float* __restrict__ um_in, const float* __restrict__ im,
              const float* __restrict__ u, float* __restrict__ acc_out, int C,
              int Mp, uint32_t k0, uint32_t k1, uint32_t iteration,
              const uint32_t* __restrict__ key) {
  constexpr int GROUP = THREADS / CHAINS;  // threads a chain
  static_assert(GROUP % 32 == 0 && GROUP * CHAINS == THREADS,
                "a chain takes whole warps");
  constexpr int GROUP_WARPS = GROUP / 32;
  __shared__ float sh[THREADS / 32];
  __shared__ int rejected[CHAINS];
  const int lc = threadIdx.x / GROUP, t = threadIdx.x % GROUP;
  const int c = blockIdx.x * CHAINS + lc;
  const int n4 = Mp / 4;
  const size_t row4 = (size_t)c * n4;
  float part[UNROLL];
#pragma unroll
  for (int q = 0; q < UNROLL; ++q) part[q] = 0.0f;
  if (c < C) {
    const float4* p4 = reinterpret_cast<const float4*>(p) + row4;
    const float4* w4 = reinterpret_cast<const float4*>(im);
    int j = t;
    for (; j + (UNROLL - 1) * GROUP < n4; j += UNROLL * GROUP) {
      float4 pv[UNROLL], wv[UNROLL];
#pragma unroll
      for (int q = 0; q < UNROLL; ++q) {
        pv[q] = __ldcs(p4 + j + q * GROUP);
        wv[q] = __ldg(w4 + j + q * GROUP);
      }
#pragma unroll
      for (int q = 0; q < UNROLL; ++q) part[q] += kinetic4(wv[q], pv[q]);
    }
    for (; j < n4; j += GROUP)
      part[0] += kinetic4(__ldg(w4 + j), __ldcs(p4 + j));
  }
  float kin = 0.0f;
#pragma unroll
  for (int q = 0; q < UNROLL; ++q) kin += part[q];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) kin += __shfl_xor_sync(0xffffffffu, kin, o);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = kin;
  __syncthreads();
  if (t == 0) {
    int rej = 0;
    if (c < C) {
      float K = 0.0f;
#pragma unroll
      for (int w = 0; w < GROUP_WARPS; ++w) K += sh[lc * GROUP_WARPS + w];
      const float H1 = 0.5f * K + U[c];
      const float h0 = H0[c];
      if (key) {
        k0 = key[0];
        k1 = key[1];
        iteration = key[2];
      }
      const float uu = u ? u[c] : accept_uniform(c, iteration, k0, k1);
      // a NaN Hamiltonian fails both tests and rejects
      const bool acc = (H1 < h0) || (uu < expf(-(H1 - h0)));
      if (!acc) {
        U[c] = U_in[c];
        ud[c] = ud_in[c];
        um[c] = um_in[c];
      }
      acc_out[c] = acc ? 1.0f : 0.0f;
      rej = !acc;
    }
    rejected[lc] = rej;
  }
  __syncthreads();
  if (!rejected[lc]) return;
  const float4* xi = reinterpret_cast<const float4*>(x_in) + row4;
  const float4* gi = reinterpret_cast<const float4*>(g_in) + row4;
  float4* xo = reinterpret_cast<float4*>(x) + row4;
  float4* go = reinterpret_cast<float4*>(g) + row4;
  int j = t;
  for (; j + (UNROLL - 1) * GROUP < n4; j += UNROLL * GROUP) {
    float4 xv[UNROLL], gv[UNROLL];
#pragma unroll
    for (int q = 0; q < UNROLL; ++q) {
      xv[q] = __ldcs(xi + j + q * GROUP);
      gv[q] = __ldcs(gi + j + q * GROUP);
    }
#pragma unroll
    for (int q = 0; q < UNROLL; ++q) {
      xo[j + q * GROUP] = xv[q];
      go[j + q * GROUP] = gv[q];
    }
  }
  for (; j < n4; j += GROUP) {
    xo[j] = __ldcs(xi + j);
    go[j] = __ldcs(gi + j);
  }
}

// One iteration's draws for the sampler that takes them as inputs (the
// eager shared-L path; the fused paths draw inside refresh and accept):
// n01 (C, width) the momentum normals and u (C,) the accept uniforms, the
// same values refresh and accept draw. What bounds it: the issued
// instructions of Philox and Box-Muller (integer multiplies, adds and
// xors at half the FP32 lanes' rate, logf, sincosf and sqrtf partly on
// the 16-lane MUFU pipe; gravinv3dhmc_tpu_torch/sass.py counts them) or
// writing n01 (70 MB at ratiogrid's 1024 x 17,152), whichever is larger.
// A 2-D grid, chain by column tile, so a thread finds its chain and
// element group without a division; DRAWS_UNROLL independent float4
// groups a thread in flight, stored with streaming stores (the draws are
// read once, by the sampler). A rank of a (chains, model) mesh draws its
// block of the whole batch's draws: row c of n01 is chain c0 + c, group j
// is element group j0 + j (elements 4 (j0 + j) .. 4 (j0 + j) + 3), so its
// cells start at a multiple of 4; the uniform depends on c0 only, and
// every rank of one chain group draws the same u.
__global__ void __launch_bounds__(DRAWS_THREADS)
draws_kernel(float* __restrict__ n01, float* __restrict__ u, int groups,
             int c0, int j0, uint32_t k0, uint32_t k1, uint32_t iteration,
             const uint32_t* __restrict__ key) {
  if (key) {
    k0 = key[0];
    k1 = key[1];
    iteration = key[2];
  }
  const int c = blockIdx.y;
  const int jt = blockIdx.x * (DRAWS_THREADS * DRAWS_UNROLL) + threadIdx.x;
  float4* row = reinterpret_cast<float4*>(n01) + (size_t)c * groups;
  float4 v[DRAWS_UNROLL];
#pragma unroll
  for (int q = 0; q < DRAWS_UNROLL; ++q) {
    const int j = jt + q * DRAWS_THREADS;
    if (j < groups) v[q] = momentum4(j0 + j, c0 + c, iteration, k0, k1);
  }
#pragma unroll
  for (int q = 0; q < DRAWS_UNROLL; ++q) {
    const int j = jt + q * DRAWS_THREADS;
    if (j < groups) __stcs(row + j, v[q]);
  }
  if (jt == 0) u[c] = accept_uniform(c0 + c, iteration, k0, k1);
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

// momentum4 of counters jn[0] .. jn[1] - 1 of chain c into out[j], one
// counter a pass of a loop kept rolled: gravinv3dhmc_tpu_torch/sass.py
// counts the instructions of one pass in this library's SASS to bound
// draws and refresh. The Philox key schedule, the same for every
// counter, stays out of the pass; c, the key and the iteration are the
// block's, as in draws and refresh.
__global__ void momentum4_loop_kernel(float4* __restrict__ out,
                                      const int* __restrict__ jn, int c,
                                      uint32_t k0, uint32_t k1,
                                      uint32_t iteration) {
  const int end = jn[1];
#pragma unroll 1
  for (int j = jn[0]; j < end; ++j)
    out[j] = momentum4(j, c, iteration, k0, k1);
}

// chain c's accept uniform, alone (sass.py counts it as it runs in draws:
// one a chain, c the block's)
__global__ void accept_uniform_once_kernel(float* __restrict__ out, int c,
                                           uint32_t k0, uint32_t k1,
                                           uint32_t iteration) {
  *out = accept_uniform(c, iteration, k0, k1);
}

int grid_for(size_t n, int threads) {
  const size_t b = (n + threads - 1) / threads;
  return (int)(b < 4096 ? (b ? b : 1) : 4096);
}

typedef CUresult (*TensorMapEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// A tensor map over a row-major (rows, inner) matrix with boxes of
// (box_rows, box_inner) under `swizzle` (128 bytes unless another is
// given: a box's inner extent in bytes); reads past the last
// row fill with zeros. Encoded on the host for each call (cheap host work).
cudaError_t tensor_map_2d(
    CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
    int elem_bytes, int inner, int rows, int box_inner, int box_rows,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  static TensorMapEncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<TensorMapEncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(
      map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the rings are above the 48 KB a block may take without asking; set once
// a device (the occupancy entries set it before any launch), so a launch
// makes no attribute call and can be captured into a CUDA graph
cudaError_t tc_allow_smem() {
  constexpr int MAX_DEVICES = 64;
  static bool allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && allowed[dev]) return cudaSuccess;
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  err =
      cudaFuncSetAttribute(residual_partial_tc_kernel, attr, ResidualRing::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kick_tc_kernel, attr, KickRing::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(residual_partial_split_kernel, attr,
                               SplitResidualRing::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kick_split_persistent_kernel, attr,
                               SplitKick::SMEM);
  if (err == cudaSuccess && dev < MAX_DEVICES) allowed[dev] = true;
  return err;
}

// out[0..4]: resident blocks per SM of `kernel`, the SM count, and its
// block tile (chains, columns) and K depth of one stage
template <typename K>
cudaError_t occupancy(K kernel, int threads, int smem, int tile_m,
                      int tile_n, int k_stage, int* out) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], kernel, threads, smem);
  if (err != cudaSuccess) return err;
  out[2] = tile_m;
  out[3] = tile_n;
  out[4] = k_stage;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, dev);
}

// The split GEMM on the tensor cores of a bf16 matrix A (a_mode A_BF16)
// or of the three bf16 pieces of an f32 one (A_F32_SPLIT: A points at
// the (3, Dp, Mp) pieces); Dp a multiple of 128, Mp of R::BK.
template <class R, class K>
cudaError_t launch_residual_tiles(K kernel, const float* x, const void* A,
                                  int pieces, float* part, int splits, int C,
                                  int Dp, int Mp, cudaStream_t stream) {
  if (Dp % TC_BN || Mp % R::BK || splits < 1 || splits > Mp / R::BK)
    return cudaErrorInvalidValue;
  CUtensorMap x_map, a_map;
  cudaError_t err = tensor_map_2d(&x_map, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                  4, Mp, C, TC_X_BOX, R::BM);
  if (err != cudaSuccess) return err;
  err = tensor_map_2d(&a_map, A, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, Mp,
                      pieces * Dp, R::BK, TC_BN,
                      R::BK == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return err;
  err = tc_allow_smem();
  if (err != cudaSuccess) return err;
  const dim3 grid(Dp / TC_BN, (C + R::BM - 1) / R::BM, splits);
  kernel<<<grid, R::THREADS, R::SMEM, stream>>>(x_map, a_map, part, C, Dp,
                                                Mp / R::BK, splits);
  return cudaGetLastError();
}

// The kick on the tensor cores, as launch_residual_tiles, on `grid`
// blocks of `threads` threads and `smem` bytes of shared memory; Mp a
// multiple of 128, Dp of R::BK.
template <class R, class K>
cudaError_t launch_kick_tiles(K kernel, dim3 grid, int threads, int smem,
                              const float* r, const void* A, int pieces,
                              const float* x, float* p, const float* aprior,
                              const float* gm_scale, int C, int Dp, int Mp,
                              float s_data, float s_mod, float beta, int ms,
                              cudaStream_t stream) {
  if (Mp % TC_BN || Dp % R::BK) return cudaErrorInvalidValue;
  CUtensorMap r_map, a_map;
  cudaError_t err = tensor_map_2d(&r_map, r, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                  4, Dp, C, TC_X_BOX, R::BM);
  if (err != cudaSuccess) return err;
  err = tensor_map_2d(&a_map, A, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, Mp,
                      pieces * Dp, TC_MN_BOX, R::BK);
  if (err != cudaSuccess) return err;
  err = tc_allow_smem();
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(r_map, a_map, x, p, aprior,
                                          gm_scale, C, Mp, Dp / R::BK, s_data,
                                          s_mod, beta, ms);
  return cudaGetLastError();
}

// the blocks of the persistent f32 kick the card holds at once: its
// blocks an SM times the SMs, from the occupancy query once a device.
// Refused unless the kernel holds PersistentKick::LAUNCH_REGS registers a
// thread, the count its setmaxnreg split assumes (with fewer, the
// consumers would wait for registers that never come).
cudaError_t kick_split_resident(int* resident) {
  constexpr int MAX_DEVICES = 64;
  static int cached[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && cached[dev]) {
    *resident = cached[dev];
    return cudaSuccess;
  }
  err = tc_allow_smem();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kick_split_persistent_kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs != SplitKick::LAUNCH_REGS)
    return cudaErrorInvalidConfiguration;
  int occ[5];
  err = occupancy(kick_split_persistent_kernel, SplitKick::THREADS,
                  SplitKick::SMEM, SplitKickRing::BM, TC_BN,
                  SplitKickRing::BK, occ);
  if (err != cudaSuccess) return err;
  if (occ[0] * occ[1] < 1) return cudaErrorInvalidConfiguration;
  *resident = occ[0] * occ[1];
  if (dev < MAX_DEVICES) cached[dev] = *resident;
  return cudaSuccess;
}

cudaError_t launch_residual_partial(const float* x, const void* A,
                                    int a_mode, float* part, int splits,
                                    int C, int Dp, int Mp,
                                    cudaStream_t stream) {
  if (a_mode == A_BF16)
    return launch_residual_tiles<ResidualRing>(residual_partial_tc_kernel, x,
                                               A, 1, part, splits, C, Dp, Mp,
                                               stream);
  if (a_mode == A_F32_SPLIT)
    return launch_residual_tiles<SplitResidualRing>(
        residual_partial_split_kernel, x, A, 3, part, splits, C, Dp, Mp,
        stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int lf_refresh(const float* g, const float* U, const float* pscale,
               const float* im, const float* n01, float* p, float* pk,
               float* H0, int C, int Mp, float half_eps, uint32_t k0,
               uint32_t k1, uint32_t iteration, cudaStream_t stream,
               const uint32_t* key) {
  if (Mp % 4) return (int)cudaErrorInvalidValue;
  refresh_kernel<<<C, ROW_THREADS, 0, stream>>>(g, U, pscale, im, n01, p, pk,
                                                H0, Mp, half_eps, k0, k1,
                                                iteration, key);
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

int lf_residual(const float* x, const void* A, int a_mode, const float* dobs,
                const float* dmask, float* r, float* part, int splits, int C,
                int Dp, int Mp, cudaStream_t stream) {
  const cudaError_t err = launch_residual_partial(x, A, a_mode, part, splits,
                                                  C, Dp, Mp, stream);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)C * Dp;
  residual_reduce_kernel<<<grid_for(n, 256), 256, 0, stream>>>(
      part, dobs, dmask, r, splits, n, Dp);
  return (int)cudaGetLastError();
}

int lf_step_residual(const float* x, const void* A, int a_mode,
                     const float* fix, const float* dobs, const float* dmask,
                     float* r, float* ud, float* part, int splits, int C,
                     int Dp, int Mp, float inv_nobs, cudaStream_t stream) {
  const cudaError_t err = launch_residual_partial(x, A, a_mode, part, splits,
                                                  C, Dp, Mp, stream);
  if (err != cudaSuccess) return (int)err;
  step_reduce_kernel<<<C, ROW_THREADS, 0, stream>>>(part, fix, dobs, dmask, r,
                                                    ud, splits, C, Dp,
                                                    inv_nobs);
  return (int)cudaGetLastError();
}

// How the split GEMM of the matrix mode runs, so the caller can plan a
// split count that fills whole waves. out[0..4]: resident blocks per SM,
// the SM count, the block tile's chains and observations, and the K depth
// of one stage (a slice covers whole stages).
int lf_residual_occupancy(int a_mode, int* out) {
  const cudaError_t err = tc_allow_smem();
  if (err != cudaSuccess) return (int)err;
  if (a_mode == A_BF16)
    return (int)occupancy(residual_partial_tc_kernel, ResidualRing::THREADS,
                          ResidualRing::SMEM, ResidualRing::BM, TC_BN, TC_BK,
                          out);
  if (a_mode == A_F32_SPLIT)
    return (int)occupancy(residual_partial_split_kernel,
                          SplitResidualRing::THREADS, SplitResidualRing::SMEM,
                          SplitResidualRing::BM, TC_BN, SplitResidualRing::BK,
                          out);
  return (int)cudaErrorInvalidValue;
}

// The kick's launch, as lf_residual_occupancy: its blocks cover all of K,
// so the caller only reports the tiling (the f32 kick's persistent
// blocks: min(tiles, resident blocks), as lf_kick launches them).
int lf_kick_occupancy(int a_mode, int* out) {
  const cudaError_t err = tc_allow_smem();
  if (err != cudaSuccess) return (int)err;
  if (a_mode == A_BF16)
    return (int)occupancy(kick_tc_kernel, KickRing::THREADS, KickRing::SMEM,
                          KickRing::BM, TC_BN, TC_BK, out);
  if (a_mode == A_F32_SPLIT)
    return (int)occupancy(kick_split_persistent_kernel, SplitKick::THREADS,
                          SplitKick::SMEM, SplitKickRing::BM, TC_BN,
                          SplitKickRing::BK, out);
  return (int)cudaErrorInvalidValue;
}

int lf_step_misfit(const float* x, const float* aprior, const float* wmsq,
                   const float* ud, float* U, float* um, int C, int Mp,
                   float alpha, float beta, int ms, cudaStream_t stream) {
  step_misfit_kernel<<<C, ROW_THREADS, 0, stream>>>(x, aprior, wmsq, ud, U,
                                                    um, Mp, alpha, beta, ms);
  return (int)cudaGetLastError();
}

// the kick on the tensor cores of a bf16 matrix A (a_mode A_BF16: a block
// a tile) or of the three bf16 pieces of an f32 one (A_F32_SPLIT: A points
// at the (3, Dp, Mp) pieces; min(tiles, resident blocks) persistent
// blocks); Mp a multiple of 128, Dp of 64
int lf_kick(const float* r, const void* A, int a_mode, const float* x,
            float* p, const float* aprior, const float* gm_scale, int C,
            int Dp, int Mp, float s_data, float s_mod, float beta, int ms,
            cudaStream_t stream) {
  if (a_mode == A_BF16)
    return (int)launch_kick_tiles<KickRing>(
        kick_tc_kernel, dim3((C + KickRing::BM - 1) / KickRing::BM,
                             Mp / TC_BN),
        KickRing::THREADS, KickRing::SMEM, r, A, 1, x, p, aprior, gm_scale, C,
        Dp, Mp, s_data, s_mod, beta, ms, stream);
  if (a_mode == A_F32_SPLIT) {
    int resident = 0;
    const cudaError_t err = kick_split_resident(&resident);
    if (err != cudaSuccess) return (int)err;
    const int tiles =
        (C + SplitKickRing::BM - 1) / SplitKickRing::BM * (Mp / TC_BN);
    return (int)launch_kick_tiles<SplitKickRing>(
        kick_split_persistent_kernel,
        dim3(tiles < resident ? tiles : resident), SplitKick::THREADS,
        SplitKick::SMEM, r, A, 3, x, p, aprior, gm_scale, C, Dp, Mp, s_data,
        s_mod, beta, ms, stream);
  }
  return (int)cudaErrorInvalidValue;
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
              uint32_t iteration, cudaStream_t stream, const uint32_t* key) {
  if (Mp % 4) return (int)cudaErrorInvalidValue;
  accept_kernel<ACCEPT_THREADS, ACCEPT_CHAINS, ACCEPT_UNROLL>
      <<<(C + ACCEPT_CHAINS - 1) / ACCEPT_CHAINS, ACCEPT_THREADS, 0, stream>>>(
          x, g, U, ud, um, p, H0, x_in, g_in, U_in, ud_in, um_in, im, u, acc,
          C, Mp, k0, k1, iteration, key);
  return (int)cudaGetLastError();
}

int lf_draws(float* n01, float* u, int C, int width, int c0, int j0,
             uint32_t k0, uint32_t k1, uint32_t iteration,
             cudaStream_t stream, const uint32_t* key) {
  if (width % 4 || C > 65535 || c0 < 0 || j0 < 0)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const int groups = width / 4, tile = DRAWS_THREADS * DRAWS_UNROLL;
  const dim3 grid(groups ? (groups + tile - 1) / tile : 1, C);
  draws_kernel<<<grid, DRAWS_THREADS, 0, stream>>>(n01, u, groups, c0, j0,
                                                   k0, k1, iteration, key);
  return (int)cudaGetLastError();
}

int lf_philox_bits(uint32_t* out, int C, int width, uint32_t k0, uint32_t k1,
                   uint32_t iteration, cudaStream_t stream) {
  const size_t n = (size_t)C * (width / 4);
  philox_bits_kernel<<<grid_for(n, 256), 256, 0, stream>>>(out, C, width, k0,
                                                            k1, iteration);
  return (int)cudaGetLastError();
}

// n (4 jn[1],): momentum normals 4 jn[0] .. 4 jn[1] - 1 of chain c in
// their places; u (1,): chain c's accept uniform; each from a one-thread
// kernel that runs only that (the code sass.py counts)
int lf_draw_units(float* n, float* u, const int* jn, int c, uint32_t k0,
                  uint32_t k1, uint32_t iteration, cudaStream_t stream) {
  momentum4_loop_kernel<<<1, 1, 0, stream>>>(reinterpret_cast<float4*>(n),
                                             jn, c, k0, k1, iteration);
  accept_uniform_once_kernel<<<1, 1, 0, stream>>>(u, c, k0, k1, iteration);
  return (int)cudaGetLastError();
}

const char* lf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
