// On-the-fly Legendre synthesis for Hopper (sm_90a).
//
// Replaces: commander_tpu/sphere/pallas_sht.py, _synth_kernel_mxu (the
// synthesis on the tutorial-scale path, nh >= 1024) and _synth_kernel (the
// VPU layout at nh < 1024); both compute the same function, for spin weight
// mp in {0, +2, -2}:
//   F_n(r,m) = sum_l lamhat_lm(r) a_lm,
//   F_s(r,m) = sum_l (-1)^(l+m) lamhat_lm(r) a_lm.
//
// What bounds it on this card: per (ring, l, m) step the recurrence needs
// A, B, beta at (l, m) and the batch's a_b(l, m). At lmax 2000 these rows
// are ~140 MB per pass, more than the 50 MB L2; read once per ring they
// would cost ~100 GB of traffic per synthesis. The FMA work (recurrence
// plus 4 accumulations per batch entry per step) is ~1e11 flops at the
// tutorial's shape, so the kernel is bound by how often a coefficient row
// is re-read.
//
// What the design does about it: m on threadIdx.x (neighbouring threads read
// neighbouring m and write the (b, r, m) outputs coalesced); R rings of
// recurrence state per thread in registers, so one load serves R rings; TY
// warps per block on further rings, reading the same rows from L1. One
// block covers 32 m x 32 rings and runs l from the tile's first l to lmax,
// which skips the l < m triangle. Accumulation is plain FP32 FMA into
// even-l / odd-l registers (E, O), combined at the end as F_n = E + O,
// F_s = (-1)^m (E - O), the parity fold of the VPU kernel.
#include "legendre_common.cuh"

namespace {

using namespace legendre;

template <int NB>
__global__ void __launch_bounds__(TM * TY)
synth_kernel(const float* __restrict__ seed_m, const int* __restrict__ seed_e,
             const float* __restrict__ A, const float* __restrict__ Bc,
             const float* __restrict__ beta, const float* __restrict__ x,
             const float2* __restrict__ alm, float2* __restrict__ Fn,
             float2* __restrict__ Fs, int nh, int nl, int nm, int mp) {
  const int m = blockIdx.x * TM + threadIdx.x;
  const bool mok = m < nm;
  const int amp = mp < 0 ? -mp : mp;
  const int l0 = max(m, amp);                           // seeding ell
  const int lstart = max((int)blockIdx.x * TM, amp);   // tile's first ell
  const size_t lm_stride = (size_t)nl * nm;

  float xr[R], cur[R], prev[R];
  int ce[R], pe[R], rr[R];
  float er[NB][R], ei[NB][R], orr[NB][R], oi[NB][R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    rr[k] = blockIdx.y * RINGS_PER_BLOCK + threadIdx.y + TY * k;
    xr[k] = (rr[k] < nh) ? x[rr[k]] : 0.0f;
    cur[k] = prev[k] = 0.0f;
    ce[k] = -128;
    pe[k] = 0;
#pragma unroll
    for (int b = 0; b < NB; ++b) er[b][k] = ei[b][k] = orr[b][k] = oi[b][k] = 0.0f;
  }
  if (!mok) return;  // no block-wide synchronisation below

  for (int l = lstart; l < nl; ++l) {
    if (l == l0) {  // inject the seed at l0 = max(m, |mp|)
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const bool ok = rr[k] < nh;
        cur[k] = ok ? seed_m[(size_t)rr[k] * nm + m] : 0.0f;
        ce[k] = ok ? seed_e[(size_t)rr[k] * nm + m] : -128;
        prev[k] = 0.0f;
        pe[k] = 0;
      }
    }
    const size_t lm = (size_t)l * nm + m;
    const float Al = __ldg(A + lm), Bl = __ldg(Bc + lm), bl = __ldg(beta + lm);
    float2 a[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) a[b] = __ldg(alm + b * lm_stride + lm);
    const bool odd = l & 1;  // uniform across the block
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float lam = emit(cur[k], ce[k]);
      if (odd) {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          orr[b][k] = fmaf(lam, a[b].x, orr[b][k]);
          oi[b][k] = fmaf(lam, a[b].y, oi[b][k]);
        }
      } else {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          er[b][k] = fmaf(lam, a[b].x, er[b][k]);
          ei[b][k] = fmaf(lam, a[b].y, ei[b][k]);
        }
      }
      advance(prev[k], pe[k], cur[k], ce[k], alpha_of(Al, xr[k], Bl), bl);
    }
  }

  const float pm = (m & 1) ? -1.0f : 1.0f;  // (-1)^m
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (rr[k] >= nh) continue;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const size_t o = ((size_t)b * nh + rr[k]) * nm + m;
      Fn[o] = make_float2(er[b][k] + orr[b][k], ei[b][k] + oi[b][k]);
      Fs[o] = make_float2(pm * (er[b][k] - orr[b][k]),
                          pm * (ei[b][k] - oi[b][k]));
    }
  }
}

template <int NB>
void launch(const float* seed_m, const int* seed_e, const float* A,
            const float* Bc, const float* beta, const float* x,
            const float2* alm, float2* Fn, float2* Fs, int nh, int nl,
            int nm, int mp, cudaStream_t s) {
  dim3 block(TM, TY);
  dim3 grid((nm + TM - 1) / TM, (nh + RINGS_PER_BLOCK - 1) / RINGS_PER_BLOCK);
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
