// Shared pieces of the on-the-fly Legendre kernels (legendre_synth.cu,
// legendre_adjoint.cu): the scaled three-term recurrence of
// commander_tpu/sphere/pallas_sht.py (_emit, _rec_advance), carried over
// exactly.
//
// lamhat_l = sqrt((2l+1)/4pi) d^l_{m,mp}(theta) is held as a float mantissa
// and an int32 block exponent in units of 2^SCALE_POW. A value is emitted
// only while its exponent is 0, -1 or -2; a seed exponent of -128 means
// "never emit". The coefficient pack (cuda_sht._coeff_pack) has the norm
// folded into A, B, beta and the seeds, so no per-l multiply remains.
#pragma once

#include <cuda_runtime.h>

namespace legendre {

constexpr int SCALE_POW = 30;
constexpr float BIG = 1073741824.0f;           // 2^30
constexpr float BIGI = 9.313225746154785e-10f;  // 2^-30

// Block shape shared by both kernels: 32 consecutive m on threadIdx.x (so
// coefficient and alm loads and the (b, r, m) stores are coalesced), TY
// warps on threadIdx.y, and R rings of recurrence state per thread held in
// registers, so one coefficient load serves R rings and the block's TY
// warps read the same coefficient row out of L1.
constexpr int TM = 32;
constexpr int TY = 8;
constexpr int R = 4;
constexpr int RINGS_PER_BLOCK = TY * R;   // 32
constexpr int MAX_NB = 4;                 // batch entries per launch

// Gate the scaled mantissa: representable iff exponent in {0, -1, -2}.
//
// Every floating-point operation of the recurrence is written as a
// single-rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc
// never contracts into an FMA. The recurrence is marginally stable near the
// poles, where any change of rounding grows like eps * l^1.5; with these
// intrinsics the plain torch version (cuda_sht.pack_otf) reproduces its
// values bit for bit, so the two can be compared at 1e-5.
__device__ __forceinline__ float emit(float cur, int cur_e) {
  return cur_e == 0 ? cur
       : cur_e == -1 ? __fmul_rn(cur, BIGI)
       : cur_e == -2 ? __fmul_rn(cur, BIGI * BIGI)
       : 0.0f;
}

// alpha = A x + B, rounded after the product as the plain version does.
__device__ __forceinline__ float alpha_of(float A, float x, float B) {
  return __fadd_rn(__fmul_rn(A, x), B);
}

// One scaled recurrence step l -> l+1:
//   new = alpha cur - beta prev sc,  sc rescales prev to cur's exponent.
// After a rescale the divided cur carries the INCREMENTED exponent into the
// next step's prev exponent (the emergence-boundary fix; without it the
// beta*prev term is double-scaled, ~1e8 mode amplification at nside 512).
__device__ __forceinline__ void advance(float& prev, int& prev_e, float& cur,
                                        int& cur_e, float alpha, float beta) {
  const int de = prev_e - cur_e;
  float sc = de == 0 ? 1.0f : (de <= -1 ? BIGI : BIG);
  if (de <= -2) sc = 0.0f;
  float nw = __fsub_rn(__fmul_rn(alpha, cur),
                      __fmul_rn(__fmul_rn(beta, prev), sc));
  const bool grow = fabsf(nw) > BIG;
  if (grow) {
    nw = __fmul_rn(nw, BIGI);
    cur = __fmul_rn(cur, BIGI);
  }
  const int ne = cur_e + (grow ? 1 : 0);
  prev = cur;
  prev_e = ne;
  cur = nw;
  cur_e = ne;
}

}  // namespace legendre
