// On-the-fly Legendre synthesis for Hopper (sm_90a).
//
// Replaces: commander_tpu/sphere/pallas_sht.py, _synth_kernel_mxu (the
// synthesis on the tutorial-scale path, nh >= 1024) and _synth_kernel (the
// VPU layout at nh < 1024); both compute the same function, for spin weight
// mp in {0, +2, -2}:
//   F_n(r,m) = sum_l lamhat_lm(r) a_lm,
//   F_s(r,m) = sum_l (-1)^(l+m) lamhat_lm(r) a_lm.
//
// What bounds it on this card: operations. Each (ring, l, m) step needs the
// recurrence (alpha = A x + B, new = alpha cur - beta prev: 5 flops) and 2
// FMAs per batch entry (re, im; the even/odd-l fold halves the 4 products),
// 17 flops at batch 3. At nside 1024 / lmax 2000 that is 4.1e9 steps, 7.0e10
// flops, 1.04 ms at 67 TFLOP/s FP32, against 0.11 ms for the compulsory
// bytes (pack, seeds, alm, F_n/F_s: 0.37 GB). Half of the FP32 slots a warp
// takes are not FMAs, so the reachable floor is about twice the bound.
// Measured knock-outs of this kernel's first version (14.1 ms) showed where
// the time went: the recurrence's bookkeeping (two exponents, the rescale
// factor, a three-way emit gate: ~70 instructions per ring-step) and
// coefficient loads on the dependent path (5 ms), not the FMAs.
//
// What the design does about it:
//  - lean chain state (legendre_common.cuh): 13 FP32 instructions per
//    ring-step at batch 3, 6 of them the FMAs;
//  - m on threadIdx.x, R = 4 neighbouring rings per thread in registers, TY
//    = 8 warps on further rings; one block covers 32 m x 32 rings and runs l
//    from the tile's first l to lmax, which skips the l < m triangle;
//  - tiles of LT ells x 32 m of A, B, beta and alm are staged in shared
//    memory with cp.async, double-buffered, one __syncthreads per tile, so
//    no global load sits in front of the arithmetic;
//  - the l loop is unrolled by parity: even-l and odd-l sums go to separate
//    registers (E, O) without a branch, combined at the end as F_n = E + O,
//    F_s = (-1)^m (E - O);
//  - before any chain of a warp has emerged (high m, polar rings) lamhat is
//    0 for the whole warp. Votes per tile pick the tile's code: the
//    careful version (seeding test, FMAs only in lanes with an emerged
//    chain, so a warp without one skips them), the fast one (no tests), or
//    the deep one (legendre_common.cuh: chains far below emergence run
//    the recurrence alone and are rescaled once per 8 ells; the rescale
//    branch took a quarter of the time before);
//  - blocks are ordered heavy first: the m tile is the slow grid axis, and
//    low m tiles run all ells.
// The contraction stays on the FP32 pipe: with 3-4 batch entries the
// product per m is 2001 x 6, far too narrow for mma tiles to repay the
// shared-memory round trip of lamhat, and the knock-out shows the FMAs are
// not what the kernel waits for.
#include "legendre_common.cuh"

namespace {

using namespace legendre;

// One staged tile. Row LT is never staged: it is where the read-ahead of
// the tile's last ell lands.
template <int NB>
struct SynthTile {
  float coef[LT + 1][3][TM];   // A, B, beta
  float2 alm[LT + 1][NB][TM];
};

template <int NB>
__device__ __forceinline__ void stage_tile(SynthTile<NB>& t, const float* A,
                                           const float* Bc, const float* beta,
                                           const float2* alm, size_t off,
                                           int lt, int nl, int nm) {
  stage_coef(t.coef, A, Bc, beta, off, lt, nl, nm);
  const size_t lm_stride = (size_t)nl * nm;
#pragma unroll
  for (int j = 0; j < LT / TY; ++j) {
    const int i = threadIdx.y + TY * j;
    const size_t o = off + (size_t)(TY * j) * nm;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (lt + i < nl)
        cp_async8(&t.alm[i][b][threadIdx.x], alm + b * lm_stride + o);
      else
        t.alm[i][b][threadIdx.x] = make_float2(0.0f, 0.0f);  // past lmax
    }
  }
  cp_async_commit();
}

// One tile of LT ells. CAREFUL tiles may hold a seeding ell of the block's
// m, or chains that have not emerged: they test for both. acc[parity][b][k]
// are the even-l / odd-l sums of ring k, batch entry b.
template <int NB, bool CAREFUL>
__device__ __forceinline__ void run_tile(const SynthTile<NB>& t, Chains& c,
                                         float2 (&acc)[2][NB][R],
                                         const float* seed_m,
                                         const int* seed_e, int lt, int l0,
                                         int ring0, int nh, int nm, int m) {
  const int tx = threadIdx.x;
  // this ell's coefficients and alm are read from shared memory one ell
  // ahead, so that no read waits in front of the arithmetic
  float Al = t.coef[0][0][tx], Bl = t.coef[0][1][tx], bl = t.coef[0][2][tx];
  float2 a[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) a[b] = t.alm[0][b][tx];
#pragma unroll 2
  for (int i2 = 0; i2 < LT; i2 += 2) {
#pragma unroll
    for (int par = 0; par < 2; ++par) {  // lt is even: parity of l is par
      const int nx = i2 + par + 1;
      const float An = t.coef[nx][0][tx], Bn = t.coef[nx][1][tx];
      const float bn = t.coef[nx][2][tx];
      float2 an[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) an[b] = t.alm[nx][b][tx];
      if (CAREFUL && lt + i2 + par == l0)
        chains_seed(c, seed_m, seed_e, ring0, nh, nm, m);
      if (!CAREFUL || c.live) {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const float lam = chains_emit(c, k);
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            acc[par][b][k].x = fmaf(lam, a[b].x, acc[par][b][k].x);
            acc[par][b][k].y = fmaf(lam, a[b].y, acc[par][b][k].y);
          }
        }
      }
      chains_advance(c, Al, Bl, bl);
      Al = An, Bl = Bn, bl = bn;
#pragma unroll
      for (int b = 0; b < NB; ++b) a[b] = an[b];
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(NTHREADS, NB <= 3 ? 2 : 1)
synth_kernel(const float* __restrict__ seed_m, const int* __restrict__ seed_e,
             const float* __restrict__ A, const float* __restrict__ Bc,
             const float* __restrict__ beta, const float* __restrict__ x,
             const float2* __restrict__ alm, float2* __restrict__ Fn,
             float2* __restrict__ Fs, int nh, int nl, int nm, int mp) {
  __shared__ SynthTile<NB> tile[2];
  const int m0 = blockIdx.y * TM;
  const int m = min(m0 + (int)threadIdx.x, nm - 1);  // clamped: all lanes run
  const bool mok = m0 + (int)threadIdx.x < nm;
  const int amp = mp < 0 ? -mp : mp;
  const int l0 = max(m, amp);        // seeding ell
  const int lstart = max(m0, amp);   // tile's first ell (even)
  const int ring0 = blockIdx.x * RINGS_PER_BLOCK + threadIdx.y * R;
  const int ntile = (nl - lstart + LT - 1) / LT;

  Chains c;
  chains_init(c, x, ring0, nh);
  float2 acc[2][NB][R];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int k = 0; k < R; ++k) acc[p][b][k] = make_float2(0.0f, 0.0f);

  size_t off = stage_offset(lstart, m0, nm);  // of the tile staged next
  stage_tile<NB>(tile[0], A, Bc, beta, alm, off, lstart, nl, nm);
  for (int t = 0; t < ntile; ++t) {
    const int lt = lstart + t * LT;
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; everyone is done with tile t-1
    if (t + 1 < ntile) {
      off += (size_t)LT * nm;
      stage_tile<NB>(tile[(t + 1) & 1], A, Bc, beta, alm, off, lt + LT, nl,
                     nm);
    }
    const SynthTile<NB>& cur = tile[t & 1];
    // warp-uniform: seeding ells are in the first tiles; after them a warp
    // is deep or careful until one of its chains has emerged
    const bool head = lt < m0 + TM;
    const bool careful = head || !__any_sync(0xffffffffu, c.live);
    if (careful && !head && chains_warp_deep(c))
      chains_run_deep(c, cur.coef);
    else if (careful)
      run_tile<NB, true>(cur, c, acc, seed_m, seed_e, lt, l0, ring0, nh, nm,
                         m);
    else
      run_tile<NB, false>(cur, c, acc, seed_m, seed_e, lt, l0, ring0, nh, nm,
                          m);
  }

  if (!mok) return;
  const float pm = (m & 1) ? -1.0f : 1.0f;  // (-1)^m
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (ring0 + k >= nh) continue;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const size_t o = ((size_t)b * nh + ring0 + k) * nm + m;
      const float2 e = acc[0][b][k], od = acc[1][b][k];
      Fn[o] = make_float2(e.x + od.x, e.y + od.y);
      Fs[o] = make_float2(pm * (e.x - od.x), pm * (e.y - od.y));
    }
  }
}

template <int NB>
void launch(const float* seed_m, const int* seed_e, const float* A,
            const float* Bc, const float* beta, const float* x,
            const float2* alm, float2* Fn, float2* Fs, int nh, int nl,
            int nm, int mp, cudaStream_t s) {
  dim3 block(TM, TY);
  dim3 grid((nh + RINGS_PER_BLOCK - 1) / RINGS_PER_BLOCK, (nm + TM - 1) / TM);
  synth_kernel<NB><<<grid, block, 0, s>>>(seed_m, seed_e, A, Bc, beta, x,
                                          alm, Fn, Fs, nh, nl, nm, mp);
}

}  // namespace

// alm (nb, nl, nm) complex64 -> Fn, Fs (nb, nh, nm) complex64; the batch
// is processed in groups of at most MAX_NB. Returns cudaGetLastError().
extern "C" int legendre_synth(const void* seed_m, const void* seed_e,
                              const void* A, const void* Bc, const void* beta,
                              const void* x, const void* alm, void* Fn,
                              void* Fs, int nb, int nh, int nl, int nm,
                              int mp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int b0 = 0; b0 < nb; b0 += MAX_NB) {
    const int g = nb - b0 < MAX_NB ? nb - b0 : MAX_NB;
    const float2* a = static_cast<const float2*>(alm) + (size_t)b0 * nl * nm;
    float2* fn = static_cast<float2*>(Fn) + (size_t)b0 * nh * nm;
    float2* fs = static_cast<float2*>(Fs) + (size_t)b0 * nh * nm;
    const float* sm = static_cast<const float*>(seed_m);
    const int* se = static_cast<const int*>(seed_e);
    const float* pA = static_cast<const float*>(A);
    const float* pB = static_cast<const float*>(Bc);
    const float* pb = static_cast<const float*>(beta);
    const float* px = static_cast<const float*>(x);
    switch (g) {
      case 1: launch<1>(sm, se, pA, pB, pb, px, a, fn, fs, nh, nl, nm, mp, s); break;
      case 2: launch<2>(sm, se, pA, pB, pb, px, a, fn, fs, nh, nl, nm, mp, s); break;
      case 3: launch<3>(sm, se, pA, pB, pb, px, a, fn, fs, nh, nl, nm, mp, s); break;
      default: launch<4>(sm, se, pA, pB, pb, px, a, fn, fs, nh, nl, nm, mp, s); break;
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
