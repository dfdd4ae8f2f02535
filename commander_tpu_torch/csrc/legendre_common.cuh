// Shared pieces of the on-the-fly Legendre kernels (legendre_synth.cu,
// legendre_adjoint.cu): the scaled three-term recurrence of
// commander_tpu/sphere/pallas_sht.py (_emit, _rec_advance), with the same
// bits, and the staging of coefficient tiles into shared memory.
//
// lamhat_l = sqrt((2l+1)/4pi) d^l_{m,mp}(theta) is held as a float mantissa
// and an int32 block exponent in units of 2^30. A value is emitted only
// while its exponent is 0, -1 or -2; a seed exponent of -128 means "never
// emit". The coefficient pack (cuda_sht._coeff_pack) has the norm folded
// into A, B, beta and the seeds, so no per-l multiply remains.
//
// The chain state is lean. The reference recurrence carries two exponents
// (of cur and of prev), but after every step they are equal, and on the
// seeding step prev is 0, so the factor that rescales prev to cur's exponent
// is always 1 or multiplies 0: one exponent is kept and that factor is
// gone. The three-way emit gate depends on the exponent alone, which
// changes only on a rescale (once per 2^30 of growth), so the gate is kept
// as a factor scl in {1, 2^-30, 2^-60, 0} and emitting is one multiply.
// Both changes leave every bit of lamhat as it was (x * 1.0f is exact).
//
// Every floating-point operation of the recurrence is a single-rounded
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never contracts
// into an FMA. The recurrence is marginally stable near the poles, where any
// change of rounding grows like eps * l^1.5; with these intrinsics the plain
// torch version (cuda_sht.pack_otf) reproduces its values bit for bit, so
// the two can be compared at 1e-5.
#pragma once

#include <cuda_runtime.h>

namespace legendre {

constexpr float BIG = 1073741824.0f;            // 2^30
constexpr float BIGI = 9.313225746154785e-10f;  // 2^-30

// Block shape shared by both kernels: 32 consecutive m on threadIdx.x (so
// the staged tiles and the (b, r, m) rows are read and written coalesced),
// TY warps on threadIdx.y, and R neighbouring rings of recurrence state per
// thread in registers, so one coefficient serves R rings.
constexpr int TM = 32;
constexpr int TY = 8;
constexpr int R = 4;
constexpr int RINGS_PER_BLOCK = TY * R;   // 32
constexpr int NTHREADS = TM * TY;         // 256
constexpr int MAX_NB = 4;                 // batch entries per launch
constexpr int MAX_CLUSTER = 8;            // blocks per cluster (portable)
constexpr int LT = 16;                    // ells per staged tile
static_assert(LT % TY == 0 && LT % 2 == 0, "a warp stages whole rows");

// The emit gate as a factor: representable iff exponent in {0, -1, -2}.
__device__ __forceinline__ float scale_of(int e) {
  return e == 0 ? 1.0f : e == -1 ? BIGI : e == -2 ? BIGI * BIGI : 0.0f;
}

// The R recurrence chains of one thread.
struct Chains {
  float cur[R], prev[R], scl[R], x[R];
  int e[R];
  unsigned live;  // 1 once some chain of this thread has emerged (scl != 0)
};

__device__ __forceinline__ void chains_init(Chains& c, const float* x,
                                            int ring0, int nh) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    c.x[k] = ring0 + k < nh ? x[ring0 + k] : 0.0f;
    c.cur[k] = c.prev[k] = c.scl[k] = 0.0f;
    c.e[k] = -128;
  }
  c.live = 0u;
}

// Inject the seeds at l0 = max(m, |mp|); rings past nh never emit.
__device__ __forceinline__ void chains_seed(Chains& c, const float* seed_m,
                                            const int* seed_e, int ring0,
                                            int nh, int nm, int m) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const bool ok = ring0 + k < nh;
    const size_t o = (size_t)(ring0 + k) * nm + m;
    c.cur[k] = ok ? seed_m[o] : 0.0f;
    c.e[k] = ok ? seed_e[o] : -128;
    c.prev[k] = 0.0f;
    c.scl[k] = scale_of(c.e[k]);
    c.live |= c.scl[k] != 0.0f ? 1u : 0u;
  }
}

// The value emitted at the current l: one multiply by the kept gate.
__device__ __forceinline__ float chains_emit(const Chains& c, int k) {
  return __fmul_rn(c.cur[k], c.scl[k]);
}

// One recurrence step l -> l+1 of chain k, new = (A x + B) cur - beta prev,
// each product and sum rounded once, in this order; returns |new|.
__device__ __forceinline__ float chain_step(Chains& c, int k, float A,
                                            float B, float beta) {
  const float alpha = __fadd_rn(__fmul_rn(A, c.x[k]), B);
  const float nw = __fsub_rn(__fmul_rn(alpha, c.cur[k]),
                             __fmul_rn(beta, c.prev[k]));
  c.prev[k] = c.cur[k];
  c.cur[k] = nw;
  return fabsf(nw);
}

// One step of all R chains. A chain that outgrows 2^30 is divided by it,
// cur and prev alike, and its exponent goes up by one: rare, so the R tests
// are folded into one branch.
__device__ __forceinline__ void chains_advance(Chains& c, float A, float B,
                                               float beta) {
  bool grow = false;
#pragma unroll
  for (int k = 0; k < R; ++k) grow |= chain_step(c, k, A, B, beta) > BIG;
  if (grow) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (fabsf(c.cur[k]) > BIG) {
        c.cur[k] = __fmul_rn(c.cur[k], BIGI);
        c.prev[k] = __fmul_rn(c.prev[k], BIGI);
        c.e[k] += 1;
        c.scl[k] = scale_of(c.e[k]);
        c.live |= c.scl[k] != 0.0f ? 1u : 0u;
      }
    }
  }
}

// Deep tiles. Before emergence a chain grows by up to sqrt(2m+3) (2^6 at m
// = 2000) per ell, and a warp holds 32 R chains, so almost every ell of such
// a warp would take the rescale branch. A warp whose chains are all at
// exponent <= DEEP_E emits nothing for the whole tile (an exponent rises by
// at most 2 per DEEP_RUN ells), so it runs the tile's recurrence with no
// test and divides at the end of each run of DEEP_RUN ells. The bits are
// those of the step-by-step rule: scaling by 2^-30 commutes with every
// rounding (no overflow: 2^30 * 2^(6.1 * 8) < 2^127; no underflow: prev is
// within 2^7 of cur), and in this region |lamhat| grows monotonically, so
// dividing late reaches the same mantissa and exponent.
constexpr int DEEP_E = -10;
constexpr int DEEP_RUN = 8;
static_assert(LT % DEEP_RUN == 0, "a tile is whole runs");

// Warp-uniform: every chain of this warp is at exponent <= DEEP_E.
__device__ __forceinline__ bool chains_warp_deep(const Chains& c) {
  int mx = c.e[0];
#pragma unroll
  for (int k = 1; k < R; ++k) mx = max(mx, c.e[k]);
  return __all_sync(0xffffffffu, mx <= DEEP_E);
}

// One tile of LT ells of a deep warp: recurrence only.
__device__ __forceinline__ void chains_run_deep(Chains& c,
                                                const float (*coef)[3][TM]) {
  const int tx = threadIdx.x;
  for (int h = 0; h < LT; h += DEEP_RUN) {
#pragma unroll
    for (int i = 0; i < DEEP_RUN; ++i) {
      const int row = h + i;
      const float A = coef[row][0][tx], B = coef[row][1][tx];
      const float beta = coef[row][2][tx];
#pragma unroll
      for (int k = 0; k < R; ++k) chain_step(c, k, A, B, beta);
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      while (fabsf(c.cur[k]) > BIG) {
        c.cur[k] = __fmul_rn(c.cur[k], BIGI);
        c.prev[k] = __fmul_rn(c.prev[k], BIGI);
        c.e[k] += 1;
      }
    }
  }
}

// Asynchronous copies global -> shared, 4 or 8 bytes each: the pack's rows
// are nm floats (2001 at lmax 2000: 8004 bytes), so wider copies would be
// misaligned on every other row.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Where this thread's first staged element of the tile at ell lt lies in an
// (nl, nm) array: warp ty copies the rows of ells lt + ty + TY j, lane tx
// column m0 + tx (columns past nm-1 repeat the last one; their results are
// never stored). The offset moves on by LT * nm from tile to tile, so a
// copy's address costs one add.
__device__ __forceinline__ size_t stage_offset(int lt, int m0, int nm) {
  return (size_t)(lt + (int)threadIdx.y) * nm
         + min(m0 + (int)threadIdx.x, nm - 1);
}

// Stage the A, B, beta rows of ells lt .. lt+LT-1 into coef[LT][3][TM];
// rows past lmax get zeros, which keep the chains finite (their results
// are never stored).
__device__ __forceinline__ void stage_coef(float (*coef)[3][TM],
                                           const float* A, const float* Bc,
                                           const float* beta, size_t off,
                                           int lt, int nl, int nm) {
#pragma unroll
  for (int j = 0; j < LT / TY; ++j) {
    const int i = threadIdx.y + TY * j;
    const size_t o = off + (size_t)(TY * j) * nm;
    float* dst = &coef[i][0][threadIdx.x];
    if (lt + i < nl) {
      cp_async4(dst, A + o);
      cp_async4(dst + TM, Bc + o);
      cp_async4(dst + 2 * TM, beta + o);
    } else {
      dst[0] = dst[TM] = dst[2 * TM] = 0.0f;
    }
  }
}

}  // namespace legendre
