// On-the-fly Legendre adjoint for Hopper (sm_90a).
//
// Replaces: commander_tpu/sphere/pallas_sht.py, _adj_kernel_mxu (the adjoint
// on the tutorial-scale path, nh >= 1024) and _adj_kernel (the VPU layout at
// nh < 1024); both compute, for spin weight mp in {0, +2, -2},
//   a_lm = sum_r lamhat_lm(r) [G_n(r,m) + (-1)^(l+m) G_s(r,m)],
// the exact transpose of legendre_synth.cu.
//
// What bounds it on this card: operations, the same count as the synthesis
// (17 flops per (ring, l, m) step at batch 3: 1.04 ms at nside 1024 / lmax
// 2000 against 0.11 ms for the compulsory bytes). What it adds is the sum
// over rings. On the TPU that sum is carried across a sequential grid axis
// in VMEM; Hopper blocks run in parallel and in no order, and the (B, nl,
// nm) output is far too large for shared memory. Knock-outs of the first
// version (22.7 ms) charged 5.7 ms to its way out of that: 16 ring slices
// of partial rows in device memory (1.54 GB), each read and written again
// once per 32 rings, about 15 GB of traffic per call.
//
// What the design does about it:
//  - the thread layout, lean chain state, staged A/B/beta tiles, careful
//    and fast tiles and heavy-first block order of the synthesis;
//    the precombined inputs G_n +- (-1)^m G_s of a thread's R rings stay in
//    registers (they are reused for every l; from shared memory they would
//    cost more bandwidth than the FMAs they feed);
//  - three levels of sums, each in a fixed order, no float atomics, so the
//    sampler's bits do not depend on scheduling: (1) a thread adds its R
//    rings; (2) every LCI ells the block's TY warps leave their sums in
//    shared memory (two buffers in turn, one __syncthreads per LCI ells) and
//    the block adds them per (l, b, m); (3) a thread-block cluster of CL
//    blocks shares one m tile and 32 CL neighbouring rings: once per tile of
//    LT ells the blocks exchange their sums through distributed shared
//    memory (again two buffers, one cluster barrier per tile) and each
//    block adds and writes a share of the rows;
//  - with CL = 8 and 8 ring slices, nh = 2048 rings need one pass: every
//    partial row is written once and never read back by this kernel. The
//    scratch halves (0.77 GB) and its traffic falls to ~0.8 GB, since rows
//    l < the m tile's first ell are neither written nor read. More rings
//    take further passes that add into the rows;
//  - sum_slices adds the slices in order and writes the zeros of the l < m
//    rows.
// The sum over rings stays on the FP32 pipe and is not given to mma: per m
// it is a product of width 2 NB = 6, and splitting lamhat into TF32 hi/lo
// parts would cost as many instructions as the 6 FMAs it replaces.
#include <cooperative_groups.h>

#include "legendre_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace legendre;

constexpr int LCI = 4;  // ells per sum across the block's warps (even)
static_assert(LT % LCI == 0 && LCI % 2 == 0, "tile and chunk sizes");

// Dynamic shared memory of one block, in float2 units then floats:
//   warp sums  [2][LCI][NB][TY][TM] float2   per-warp sums of LCI ells
//   block sums [2][LT][NB][TM]      float2   per-block sums of a tile
//   coef       [2][LT + 1][3][TM]   float    staged A, B, beta tiles; row
//                                            LT is never staged: the
//                                            read-ahead of the last ell
//                                            lands there
template <int NB>
struct AdjointSmem {
  static constexpr int WARP = LCI * NB * TY * TM;
  static constexpr int BLK = LT * NB * TM;
  static constexpr int COEF = (LT + 1) * 3 * TM;
  static constexpr size_t BYTES =
      (2 * WARP + 2 * BLK) * sizeof(float2) + 2 * COEF * sizeof(float);
};

// LCI ells of one thread: the sums over its R rings go to wslot, this
// thread's place in the warp-sum buffer. CAREFUL chunks may hold a seeding
// ell or chains that have not emerged, and test for both. co holds the
// coefficients of the chunk's first ell and leaves with those of the next
// chunk's: they are read from shared memory one ell ahead, so that no read
// waits in front of the arithmetic.
template <int NB, bool CAREFUL>
__device__ __forceinline__ void run_chunk(
    Chains& c, const float2 (&g)[2][NB][R], const float (*coef)[3][TM],
    float (&co)[3], float2* wslot, const float* seed_m, const int* seed_e,
    int l, int l0, int ring0, int nh, int nm, int m) {
  const int tx = threadIdx.x;
#pragma unroll
  for (int i = 0; i < LCI; ++i) {  // l is even: the parity of l + i is i & 1
    const int par = i & 1;
    const int nx = i + 1;
    const float Al = co[0], Bl = co[1], bl = co[2];
#pragma unroll
    for (int q = 0; q < 3; ++q) co[q] = coef[nx][q][tx];
    if (CAREFUL && l + i == l0)
      chains_seed(c, seed_m, seed_e, ring0, nh, nm, m);
    float2 s[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) s[b] = make_float2(0.0f, 0.0f);
    if (!CAREFUL || c.live) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float lam = chains_emit(c, k);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          s[b].x = fmaf(lam, g[par][b][k].x, s[b].x);
          s[b].y = fmaf(lam, g[par][b][k].y, s[b].y);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) wslot[(i * NB + b) * TY * TM] = s[b];
    chains_advance(c, Al, Bl, bl);
  }
}

template <int NB>
__global__ void __launch_bounds__(NTHREADS, NB <= 3 ? 2 : 1)
adjoint_kernel(const float* __restrict__ seed_m, const int* __restrict__ seed_e,
               const float* __restrict__ A, const float* __restrict__ Bc,
               const float* __restrict__ beta, const float* __restrict__ x,
               const float2* __restrict__ Gn, const float2* __restrict__ Gs,
               float2* __restrict__ part, int nh, int nl, int nm, int mp,
               int nslice) {
  using L = AdjointSmem<NB>;
  extern __shared__ __align__(16) float2 dyn[];
  float2* const warp_buf = dyn;
  float2* const blk_buf = dyn + 2 * L::WARP;
  float (*const coef_buf)[LT + 1][3][TM] =
      reinterpret_cast<float (*)[LT + 1][3][TM]>(blk_buf + 2 * L::BLK);
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = cluster.num_blocks();   // blocks along x share an m tile
  const int rank = cluster.block_rank();
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int slice = blockIdx.x / CL;
  const int m0 = blockIdx.y * TM;
  const int m = min(m0 + tx, nm - 1);  // clamped: every lane runs every sync
  const bool mok = m0 + tx < nm;
  const int amp = mp < 0 ? -mp : mp;
  const int l0 = max(m, amp);
  const int lstart = max(m0, amp);     // even
  const int ntile = (nl - lstart + LT - 1) / LT;
  const float pm = (m & 1) ? -1.0f : 1.0f;  // (-1)^m
  const size_t lm_stride = (size_t)nl * nm;
  float2* out = part + (size_t)slice * NB * lm_stride;
  const int nsuper = (nh + RINGS_PER_BLOCK * CL - 1) / (RINGS_PER_BLOCK * CL);
  int pw = 0, pb = 0;  // which warp-sum / block-sum buffer is written next

  for (int sc = slice, pass = 0; sc < nsuper; sc += nslice, ++pass) {
    const int ring0 = (sc * CL + rank) * RINGS_PER_BLOCK + ty * R;
    Chains c;
    chains_init(c, x, ring0, nh);
    float2 g[2][NB][R];  // inputs coupling to even and odd l
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const bool ok = ring0 + k < nh;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const size_t o = ((size_t)b * nh + ring0 + k) * nm + m;
        const float2 gn = ok ? Gn[o] : make_float2(0.f, 0.f);
        const float2 gs = ok ? Gs[o] : make_float2(0.f, 0.f);
        g[0][b][k] = make_float2(gn.x + pm * gs.x, gn.y + pm * gs.y);
        g[1][b][k] = make_float2(gn.x - pm * gs.x, gn.y - pm * gs.y);
      }
    }

    size_t off = stage_offset(lstart, m0, nm);  // of the tile staged next
    stage_coef(coef_buf[0], A, Bc, beta, off, lstart, nl, nm);
    cp_async_commit();
    for (int t = 0; t < ntile; ++t) {
      const int lt = lstart + t * LT;
      cp_async_wait_all();
      __syncthreads();  // tile t has landed; everyone is done with tile t-1
      if (t + 1 < ntile) {
        off += (size_t)LT * nm;
        stage_coef(coef_buf[(t + 1) & 1], A, Bc, beta, off, lt + LT, nl, nm);
        cp_async_commit();
      }
      const float (*coef)[3][TM] = coef_buf[t & 1];
      // warp-uniform: seeding ells are in the first tiles; after them a
      // warp is deep (its sums are zeros) or careful until one of its
      // chains has emerged
      const bool head = lt < m0 + TM;
      const bool careful = head || !__any_sync(0xffffffffu, c.live);
      const bool deep = careful && !head && chains_warp_deep(c);
      if (deep) chains_run_deep(c, coef);
      float co[3] = {coef[0][0][tx], coef[0][1][tx], coef[0][2][tx]};

      for (int ic = 0; ic < LT; ic += LCI) {
        float2* wslot = warp_buf + pw * L::WARP + ty * TM + tx;
        if (deep) {
#pragma unroll
          for (int q = 0; q < LCI * NB; ++q)
            wslot[q * TY * TM] = make_float2(0.0f, 0.0f);
        } else if (careful)
          run_chunk<NB, true>(c, g, coef + ic, co, wslot, seed_m, seed_e,
                              lt + ic, l0, ring0, nh, nm, m);
        else
          run_chunk<NB, false>(c, g, coef + ic, co, wslot, seed_m, seed_e,
                               lt + ic, l0, ring0, nh, nm, m);
        __syncthreads();
        // level 2: add the TY warps' sums of each (ell, b) row, warp 0 first
        for (int row = ty; row < LCI * NB; row += TY) {
          const float2* w = warp_buf + pw * L::WARP + row * TY * TM + tx;
          float2 v = w[0];
#pragma unroll
          for (int y = 1; y < TY; ++y) {
            v.x += w[y * TM].x;
            v.y += w[y * TM].y;
          }
          blk_buf[pb * L::BLK + (ic * NB + row) * TM + tx] = v;
        }
        pw ^= 1;
      }

      // level 3: add the cluster's blocks, rank 0 first; each block takes
      // the (ell, b) rows with row % CL == rank, one row per warp
      cluster.sync();
      for (int row = rank + CL * ty; row < LT * NB; row += CL * TY) {
        float2 v = make_float2(0.0f, 0.0f);
        for (int r = 0; r < CL; ++r) {
          const float2* rb = cluster.map_shared_rank(blk_buf + pb * L::BLK, r);
          const float2 w = rb[row * TM + tx];
          v.x += w.x;
          v.y += w.y;
        }
        const int l = lt + row / NB, b = row % NB;
        if (l < nl && mok) {
          float2* o = out + b * lm_stride + (size_t)l * nm + m;
          if (pass > 0) {
            const float2 old = *o;
            v = make_float2(old.x + v.x, old.y + v.y);
          }
          *o = v;
        }
      }
      pb ^= 1;
    }
  }
  cluster.sync();  // no block leaves while its sums may still be read
}

// alm[b, l, m] = sum over slices of part[s, b, l, m], slices in order; rows
// below the m tile's first ell were never written and are zero.
__global__ void sum_slices(const float2* __restrict__ part,
                           float2* __restrict__ alm, int nb, int nl, int nm,
                           int amp, int nslice) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  if (m >= nm) return;
  const size_t lm_stride = (size_t)nl * nm;
  const bool written = l >= max(m / TM * TM, amp);
  for (int b = 0; b < nb; ++b) {
    const size_t o = b * lm_stride + (size_t)l * nm + m;
    float re = 0.0f, im = 0.0f;
    if (written) {
      for (int s = 0; s < nslice; ++s) {
        const float2 v = part[(size_t)s * nb * lm_stride + o];
        re += v.x;
        im += v.y;
      }
    }
    alm[o] = make_float2(re, im);
  }
}

template <int NB>
cudaError_t launch(const float* seed_m, const int* seed_e, const float* A,
                   const float* Bc, const float* beta, const float* x,
                   const float2* Gn, const float2* Gs, float2* part, int nh,
                   int nl, int nm, int mp, int nslice, int cluster,
                   cudaStream_t s) {
  const size_t smem = AdjointSmem<NB>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      adjoint_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * nslice, (nm + TM - 1) / TM);
  cfg.blockDim = dim3(TM, TY);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, adjoint_kernel<NB>, seed_m, seed_e, A, Bc,
                            beta, x, Gn, Gs, part, nh, nl, nm, mp, nslice);
}

}  // namespace

// Gn, Gs (nb, nh, nm) complex64 -> alm (nb, nl, nm) complex64. part is
// scratch of (nslice, min(nb, MAX_NB), nl, nm) complex64; `cluster` blocks
// (a power of two up to MAX_CLUSTER) share an m tile; the batch runs in
// groups of at most MAX_NB. Returns the first CUDA error, or 0.
extern "C" int legendre_adjoint(const void* seed_m, const void* seed_e,
                                const void* A, const void* Bc,
                                const void* beta, const void* x,
                                const void* Gn, const void* Gs, void* part,
                                void* alm, int nb, int nh, int nl, int nm,
                                int mp, int nslice, int cluster,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t lm_stride = (size_t)nl * nm;
  if (cluster < 1 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)))
    return (int)cudaErrorInvalidValue;
  for (int b0 = 0; b0 < nb; b0 += MAX_NB) {
    const int g = nb - b0 < MAX_NB ? nb - b0 : MAX_NB;
    const float2* gn = static_cast<const float2*>(Gn) + (size_t)b0 * nh * nm;
    const float2* gs = static_cast<const float2*>(Gs) + (size_t)b0 * nh * nm;
    float2* pt = static_cast<float2*>(part);
    const float* sm = static_cast<const float*>(seed_m);
    const int* se = static_cast<const int*>(seed_e);
    const float* pA = static_cast<const float*>(A);
    const float* pB = static_cast<const float*>(Bc);
    const float* pb = static_cast<const float*>(beta);
    const float* px = static_cast<const float*>(x);
    cudaError_t e;
    switch (g) {
      case 1: e = launch<1>(sm, se, pA, pB, pb, px, gn, gs, pt, nh, nl, nm, mp, nslice, cluster, s); break;
      case 2: e = launch<2>(sm, se, pA, pB, pb, px, gn, gs, pt, nh, nl, nm, mp, nslice, cluster, s); break;
      case 3: e = launch<3>(sm, se, pA, pB, pb, px, gn, gs, pt, nh, nl, nm, mp, nslice, cluster, s); break;
      default: e = launch<4>(sm, se, pA, pB, pb, px, gn, gs, pt, nh, nl, nm, mp, nslice, cluster, s); break;
    }
    if (e != cudaSuccess) return (int)e;
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    // the partial buffer holds g batch entries of stride lm_stride per slice
    const int threads = 128;
    sum_slices<<<dim3((nm + threads - 1) / threads, nl), threads, 0, s>>>(
        pt, static_cast<float2*>(alm) + (size_t)b0 * lm_stride, g, nl, nm,
        mp < 0 ? -mp : mp, nslice);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
