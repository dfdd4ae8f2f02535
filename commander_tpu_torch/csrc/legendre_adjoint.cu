// On-the-fly Legendre adjoint for Hopper (sm_90a).
//
// Replaces: commander_tpu/sphere/pallas_sht.py, _adj_kernel_mxu (the adjoint
// on the tutorial-scale path, nh >= 1024) and _adj_kernel (the VPU layout at
// nh < 1024); both compute, for spin weight mp in {0, +2, -2},
//   a_lm = sum_r lamhat_lm(r) [G_n(r,m) + (-1)^(l+m) G_s(r,m)],
// the exact transpose of legendre_synth.cu.
//
// What bounds it on this card: the same coefficient traffic as the
// synthesis (A, B, beta rows per (ring, l, m) step), plus the sum over rings.
// On the TPU that sum is carried across a sequential grid axis in VMEM;
// Hopper blocks run in parallel and in no order, so nothing carries across
// them, and the (B, nl, nm) output is far too large for shared memory.
//
// What the design does about it: the thread layout of the synthesis (m on
// threadIdx.x, R rings per thread in registers, TY warps on further rings),
// with the precombined inputs G_n +- (-1)^m G_s held in registers per ring.
// Every LC ells the block reduces its TY x R rings in shared memory and adds
// the sums into a partial output of its ring slice; blocks of one slice walk
// that slice's ring chunks in turn, so each partial entry has one writer. A
// second small kernel then adds the slices in a fixed order. No float
// atomics: the sampler's output bits do not depend on block scheduling.
// Known cost: a __syncthreads pair per LC ells, and a read-modify-write of
// the partial rows per ring chunk.
#include "legendre_common.cuh"

namespace {

using namespace legendre;

constexpr int LC = 4;  // ells per shared-memory reduction

template <int NB>
__global__ void __launch_bounds__(TM * TY)
adjoint_kernel(const float* __restrict__ seed_m, const int* __restrict__ seed_e,
               const float* __restrict__ A, const float* __restrict__ Bc,
               const float* __restrict__ beta, const float* __restrict__ x,
               const float2* __restrict__ Gn, const float2* __restrict__ Gs,
               float2* __restrict__ part, int nh, int nl, int nm, int mp,
               int nslice) {
  __shared__ float red[LC][2 * NB][TY][TM];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TM + tx;
  const int m0 = blockIdx.x * TM;
  const int m = m0 + tx;
  const bool mok = m < nm;
  const int slice = blockIdx.y;
  const int amp = mp < 0 ? -mp : mp;
  const int l0 = max(m, amp);
  const int lstart = max(m0, amp);
  const float pm = (m & 1) ? -1.0f : 1.0f;  // (-1)^m
  const size_t lm_stride = (size_t)nl * nm;
  float2* out = part + (size_t)slice * NB * lm_stride;

  // zero this block's columns of its slice's partial output, all ells
  for (int e = tid; e < NB * nl * TM; e += TM * TY) {
    const int mm = m0 + e % TM;
    const int l = (e / TM) % nl;
    const int b = e / (TM * nl);
    if (mm < nm) out[b * lm_stride + (size_t)l * nm + mm] = make_float2(0.f, 0.f);
  }
  __syncthreads();

  const int nchunks = (nh + RINGS_PER_BLOCK - 1) / RINGS_PER_BLOCK;
  for (int c = slice; c < nchunks; c += nslice) {
    float xr[R], cur[R], prev[R];
    int ce[R], pe[R], rr[R];
    float2 ge[NB][R], go[NB][R];  // even-l and odd-l combined inputs
#pragma unroll
    for (int k = 0; k < R; ++k) {
      rr[k] = c * RINGS_PER_BLOCK + ty + TY * k;
      const bool ok = mok && rr[k] < nh;
      xr[k] = ok ? x[rr[k]] : 0.0f;
      cur[k] = prev[k] = 0.0f;
      ce[k] = -128;
      pe[k] = 0;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const size_t o = ((size_t)b * nh + rr[k]) * nm + m;
        const float2 gn = ok ? Gn[o] : make_float2(0.f, 0.f);
        const float2 gs = ok ? Gs[o] : make_float2(0.f, 0.f);
        ge[b][k] = make_float2(gn.x + pm * gs.x, gn.y + pm * gs.y);
        go[b][k] = make_float2(gn.x - pm * gs.x, gn.y - pm * gs.y);
      }
    }

    for (int lc = lstart; lc < nl; lc += LC) {
#pragma unroll
      for (int i = 0; i < LC; ++i) {
        const int l = lc + i;
        float sr[NB], si[NB];
#pragma unroll
        for (int b = 0; b < NB; ++b) sr[b] = si[b] = 0.0f;
        if (mok && l < nl) {
          if (l == l0) {
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
          const float Al = __ldg(A + lm), Bl = __ldg(Bc + lm);
          const float bl = __ldg(beta + lm);
          const bool odd = l & 1;
#pragma unroll
          for (int k = 0; k < R; ++k) {
            const float lam = emit(cur[k], ce[k]);
#pragma unroll
            for (int b = 0; b < NB; ++b) {
              const float2 g = odd ? go[b][k] : ge[b][k];
              sr[b] = fmaf(lam, g.x, sr[b]);
              si[b] = fmaf(lam, g.y, si[b]);
            }
            advance(prev[k], pe[k], cur[k], ce[k], alpha_of(Al, xr[k], Bl), bl);
          }
        }
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          red[i][2 * b][ty][tx] = sr[b];
          red[i][2 * b + 1][ty][tx] = si[b];
        }
      }
      __syncthreads();
      // sum the TY warps' ring partials; add into the slice's partial rows
      for (int e = tid; e < LC * NB * TM; e += TM * TY) {
        const int mm = e % TM;
        const int b = (e / TM) % NB;
        const int i = e / (TM * NB);
        const int l = lc + i;
        if (l < nl && m0 + mm < nm) {
          float s_re = 0.0f, s_im = 0.0f;
#pragma unroll
          for (int y = 0; y < TY; ++y) {
            s_re += red[i][2 * b][y][mm];
            s_im += red[i][2 * b + 1][y][mm];
          }
          float2* o = out + b * lm_stride + (size_t)l * nm + m0 + mm;
          const float2 v = *o;
          *o = make_float2(v.x + s_re, v.y + s_im);
        }
      }
      __syncthreads();
    }
  }
}

// alm[b, l, m] = sum over slices of part[s, b, l, m], slices in order.
__global__ void sum_slices(const float2* __restrict__ part,
                           float2* __restrict__ alm, int nb, size_t lm_stride,
                           int nslice) {
  const size_t n = (size_t)nb * lm_stride;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float re = 0.0f, im = 0.0f;
    for (int s = 0; s < nslice; ++s) {
      const float2 v = part[(size_t)s * n + i];
      re += v.x;
      im += v.y;
    }
    alm[i] = make_float2(re, im);
  }
}

template <int NB>
void launch(const float* seed_m, const int* seed_e, const float* A,
            const float* Bc, const float* beta, const float* x,
            const float2* Gn, const float2* Gs, float2* part, int nh, int nl,
            int nm, int mp, int nslice, cudaStream_t s) {
  dim3 block(TM, TY);
  dim3 grid((nm + TM - 1) / TM, nslice);
  adjoint_kernel<NB><<<grid, block, 0, s>>>(seed_m, seed_e, A, Bc, beta, x,
                                            Gn, Gs, part, nh, nl, nm, mp,
                                            nslice);
}

}  // namespace

// Gn, Gs (nb, nh, nm) complex64 -> alm (nb, nl, nm) complex64. part is
// scratch of (nslice, min(nb, MAX_NB), nl, nm) complex64; the batch runs in
// groups of at most MAX_NB. Returns cudaGetLastError().
extern "C" int legendre_adjoint(const void* seed_m, const void* seed_e,
                                const void* A, const void* Bc,
                                const void* beta, const void* x,
                                const void* Gn, const void* Gs, void* part,
                                void* alm, int nb, int nh, int nl, int nm,
                                int mp, int nslice, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t lm_stride = (size_t)nl * nm;
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
    switch (g) {
      case 1: launch<1>(sm, se, pA, pB, pb, px, gn, gs, pt, nh, nl, nm, mp, nslice, s); break;
      case 2: launch<2>(sm, se, pA, pB, pb, px, gn, gs, pt, nh, nl, nm, mp, nslice, s); break;
      case 3: launch<3>(sm, se, pA, pB, pb, px, gn, gs, pt, nh, nl, nm, mp, nslice, s); break;
      default: launch<4>(sm, se, pA, pB, pb, px, gn, gs, pt, nh, nl, nm, mp, nslice, s); break;
    }
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const size_t n = (size_t)g * lm_stride;
    const int threads = 256;
    const int blocks = (int)((n + threads - 1) / threads < 65535
                                 ? (n + threads - 1) / threads : 65535);
    // the partial buffer holds g batch entries of stride lm_stride per slice
    sum_slices<<<blocks, threads, 0, s>>>(
        pt, static_cast<float2*>(alm) + (size_t)b0 * lm_stride, g, lm_stride,
        nslice);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
