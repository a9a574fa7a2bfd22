// Non-isothermal iterative two-stream flux solve for Hopper (sm_90a).
//
// Replaces the Pallas kernels of the JAX package
//   helios_tpu/kernels/sweep_pallas.py:162  _noniso_sweep_kernel       (fp32)
//   helios_tpu/kernels/sweep_pallas.py:234  _noniso_sweep_kernel_df64  (fp64
//                                            as two-float32 pairs)
// with one template instantiated for float and double (the H100 has
// hardware fp64, so the df64 pair arithmetic has no counterpart here).  It
// computes what helios_tpu.fastpath.fband_noniso_flat computes
// (fastpath.py:645-685; HELIOS reference fband_noniso, kernels.cu:1521-1800):
// per spectral column, n_passes times
//   down sweep, i = L-1 .. 0:
//     Fc_down[i] = a_up[i]  * F_down[i+1] + b_up[i]  * Fc_up[i]   + s_ud[i]
//     F_down[i]  = a_low[i] * Fc_down[i]  + b_low[i] * F_up[i]    + s_ld[i]
//   boundary:  F_up[0] = refl * (F_dir0 + F_down[0]) + emis
//   up sweep, i = 0 .. L-1:
//     Fc_up[i]   = a_low[i] * F_up[i]     + b_low[i] * Fc_down[i] + s_lu[i]
//     F_up[i+1]  = a_up[i]  * Fc_up[i]    + b_up[i]  * F_down[i+1] + s_uu[i]
// with F_down[L] = toa and the previous solve's F_up / Fc_up as the first
// pass's upward fluxes.  The expressions are those of the JAX oracle, in its
// order; the Pallas kernels' flattening of the two half-layer recurrences
// into one (sweep_pallas.py:169-187) reassociates two roundings and is not
// carried over.  nvcc contracts a*b + c into fma, so results match the plain
// PyTorch version to rounding, not bitwise.
//
// Layout: every [L, S] / [L+1, S] array is row-major with the spectral
// column s fastest; one thread per column, so a warp reads each layer row
// coalesced.
//
// Bound.  Memory.  One call at the flagship shape (L = 105, S = 7700) reads
// 8 [L,S] coefficient/source arrays, 4 [S] boundary rows, F_up_prev [L+1,S]
// and Fc_up_prev [L,S], and writes F_down, F_up [L+1,S] and Fc_down, Fc_up
// [L,S]: (14 L + 7) S values, 91.0 MB in fp64 (27 us at the data-sheet
// 3.35 TB/s) and 45.5 MB in fp32 (13.6 us).  The arithmetic, 16 flops per
// layer and pass (52 MFLOP for 4 passes in fp64), is no limit.
//
// The chain.  Each column is a chain of 2 L n_passes dependent layer steps
// (one layer of one sweep), each of two fma-add pairs.  All 8 operands of a
// step are known before the chain reaches it: 6 coefficients and sources,
// and 2 fluxes of the other sweep (this pass's down sweep, or the last
// pass's up sweep; the first pass reads F_up_prev / Fc_up_prev).  The ring
// of column_ring.cuh streams all 8, fluxes included, kRingDepth steps ahead
// of the chain, so a step waits on no load; a flux written fewer than
// kRingDepth steps before it is read (the layers next to a turn) is stored
// into the ring by the step that computes it.  The sweeps keep their snake
// order (the down sweep ends at layer 0, where the up sweep starts), so the
// most recently touched lines are reused first.  Blocks are 32 columns
// wide: 241 blocks at S = 7700, resident in one wave on 132 SMs.
//
// With the loads off the chain, a warp's own instruction stream sets the
// pace: one warp issues a step's ~100 instructions (ring bookkeeping, eight
// cp.async, addresses, the chain, the stores) at a few cycles each, however
// many warps share the card.  So the middle of each sweep, where no operand
// is handed over and the issued steps lie in the same sweep, runs steady():
// kSteady steps at a time, with fixed strides and no per-step bookkeeping,
// the next step's operands read before this step's chain.  The steps near a
// turn (about kRingDepth / 2 before it and kRingDepth + kSteady after it)
// run the general step.
//
// What this design leaves on the table:
//  * coefficient re-reads: each pass reads a_up, b_up, a_low, b_low twice
//    (once per sweep) and the sources once, 20 [L,S] arrays per pass with
//    the fluxes; the 52 MB fp64 coefficient set does not fit in the 50 MB L2
//    beside the fluxes, so part of every pass comes from HBM;
//  * the general step near the turns, about 1.5 kRingDepth + kSteady of
//    each sweep's L steps (14% at L = 105 in fp32, 37% in fp64);
//  * the source assembly (noniso_coeffs_from_cache, fastpath.py:328-340)
//    runs unfused before the kernel and writes the four [L,S] sources to
//    HBM; fusing it would read the Planck rows and the cache directly.

#include <climits>
#include <cstddef>

#include <cuda_runtime.h>

#include "column_ring.cuh"

namespace {

constexpr int kThreads = 32;  // columns per block
// layer steps in flight ahead of the chain, by precision (measured with
// scripts/torch_ring_tuning.py: fp64 gains from depth, fp32 does not)
constexpr int kRingDepth64 = 24;
constexpr int kRingDepth32 = 8;
template <typename T>
constexpr int kRingDepth = sizeof(T) == 8 ? kRingDepth64 : kRingDepth32;
constexpr int kSteady = 4;  // steps per block of a sweep's steady middle

// The operands of one layer step.  Both half-layer recurrences of both
// sweeps read
//   fc = A1 * carry + B1 * X1 + S1,   f = A2 * fc + B2 * X2 + S2:
//   down, layer i:  a_up, b_up, s_ud;  a_low, b_low, s_ld;  Fc_up[i], F_up[i]
//   up, layer i:    a_low, b_low, s_lu;  a_up, b_up, s_uu;
//                   Fc_down[i], F_down[i+1]
enum { kA1, kB1, kS1, kA2, kB2, kS2, kX1, kX2, kFields };

template <typename T>
using Ring = helios::ColumnRing<T, kRingDepth<T>, kFields, kThreads>;

// Steps from the step that writes a flux operand of layer i to the step
// that reads it; a pass is 2 L steps (the down sweep, then the up sweep).
// A gap of kRingDepth or more goes through global memory and the ring's
// loads; a smaller one is stored into the ring by the writing step.
// Fc_up[i] of a down step: the last pass's up step of layer i.
__device__ __forceinline__ int down_x1_gap(int L, int i) {
  return 2 * L - 1 - 2 * i;
}
// F_up[i] of a down step: the last pass's up step of layer i - 1, or for
// i = 0 the boundary, computed in the up step of layer 0.
__device__ __forceinline__ int down_x2_gap(int L, int i) {
  return i == 0 ? 2 * L - 1 : 2 * L - 2 * i;
}
// Fc_down[i] of an up step: this pass's down step of layer i.
__device__ __forceinline__ int up_x1_gap(int i) { return 2 * i + 1; }
// F_down[i+1] of an up step: this pass's down step of layer i + 1; F_down[L]
// = toa is written before the chain starts.
__device__ __forceinline__ int up_x2_gap(int L, int i) {
  return i == L - 1 ? INT_MAX : 2 * i + 2;
}

// kSteady steps of a sweep's steady middle, from `stage` on: no operand is
// handed over in the ring, no step is the boundary, and the steps issued
// kRingDepth ahead are in the same sweep and load every operand.  Step j
// stores out_c[j * dir] and out_f[j * dir] and issues src[field][j * dir].
// The next step's operands are read from the ring before this step's chain
// runs, and the issue does not wait for the chain, so the warp's other
// instructions overlap the chain's latency.
template <typename T>
__device__ __forceinline__ void steady(const Ring<T>& ring, int& stage,
                                       T& carry, const T* const* src,
                                       T* out_c, T* out_f, ptrdiff_t dir) {
  T cur[kFields];
  Ring<T>::wait();
#pragma unroll
  for (int f = 0; f < kFields; ++f) cur[f] = ring(stage, f);
#pragma unroll
  for (int j = 0; j < kSteady; ++j) {
#pragma unroll
    for (int f = 0; f < kFields; ++f) ring.load(stage, f, src[f] + j * dir);
    Ring<T>::commit();
    const int next = Ring<T>::advance(stage, 1);
    T nxt[kFields];
    if (j + 1 < kSteady) {
      Ring<T>::wait();
#pragma unroll
      for (int f = 0; f < kFields; ++f) nxt[f] = ring(next, f);
    }
    const T fc = cur[kA1] * carry + cur[kB1] * cur[kX1] + cur[kS1];
    const T f = cur[kA2] * fc + cur[kB2] * cur[kX2] + cur[kS2];
    out_c[j * dir] = fc;
    out_f[j * dir] = f;
    carry = f;
    stage = next;
    if (j + 1 < kSteady) {
#pragma unroll
      for (int g = 0; g < kFields; ++g) cur[g] = nxt[g];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
noniso_sweep_kernel(const T* __restrict__ a_up, const T* __restrict__ b_up,
                    const T* __restrict__ s_ud, const T* __restrict__ s_uu,
                    const T* __restrict__ a_low, const T* __restrict__ b_low,
                    const T* __restrict__ s_ld, const T* __restrict__ s_lu,
                    const T* __restrict__ toa, const T* __restrict__ refl,
                    const T* __restrict__ emis, const T* __restrict__ fdir0,
                    const T* __restrict__ fup_prev,
                    const T* __restrict__ fcup_prev,
                    T* __restrict__ fdown, T* __restrict__ fup,
                    T* __restrict__ fcdown, T* __restrict__ fcup,
                    int L, int S, int n_passes) {
  __shared__ T slots[Ring<T>::kElements];
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const size_t ss = static_cast<size_t>(S);
  const Ring<T> ring(slots, threadIdx.x);

  const T top = toa[s];
  const T r = refl[s];
  const T e = emis[s];
  const T d0 = fdir0[s];
  fdown[L * ss + s] = top;

  // the loads of the next step to issue: pass ip, step it of the pass (the
  // down step of layer L-1-it, or for it >= L the up step of layer it-L)
  int ip = 0, it = 0;
  auto issue = [&](int stage) {
    if (ip < n_passes) {
      if (it < L) {
        const int i = L - 1 - it;
        const size_t k = i * ss + s;
        ring.load(stage, kA1, a_up + k);
        ring.load(stage, kB1, b_up + k);
        ring.load(stage, kS1, s_ud + k);
        ring.load(stage, kA2, a_low + k);
        ring.load(stage, kB2, b_low + k);
        ring.load(stage, kS2, s_ld + k);
        if (ip == 0) {
          ring.load(stage, kX1, fcup_prev + k);
          ring.load(stage, kX2, fup_prev + k);
        } else {
          if (down_x1_gap(L, i) >= kRingDepth<T>)
            ring.load(stage, kX1, fcup + k);
          if (down_x2_gap(L, i) >= kRingDepth<T>)
            ring.load(stage, kX2, fup + k);
        }
      } else {
        const int i = it - L;
        const size_t k = i * ss + s;
        ring.load(stage, kA1, a_low + k);
        ring.load(stage, kB1, b_low + k);
        ring.load(stage, kS1, s_lu + k);
        ring.load(stage, kA2, a_up + k);
        ring.load(stage, kB2, b_up + k);
        ring.load(stage, kS2, s_uu + k);
        if (up_x1_gap(i) >= kRingDepth<T>) ring.load(stage, kX1, fcdown + k);
        if (up_x2_gap(L, i) >= kRingDepth<T>)
          ring.load(stage, kX2, fdown + k + ss);
      }
      if (++it == 2 * L) {
        it = 0;
        ++ip;
      }
    }
    Ring<T>::commit();
  };

  for (int stage = 0; stage < kRingDepth<T>; ++stage) issue(stage);

  int stage = 0;
  for (int p = 0; p < n_passes; ++p) {
    const bool last = p + 1 == n_passes;
    T carry = top;
    const T* down_src[kFields] = {a_up,  b_up,  s_ud,
                                  a_low, b_low, s_ld,
                                  p == 0 ? fcup_prev : fcup,
                                  p == 0 ? fup_prev : fup};
    for (int i = L - 1; i >= 0; --i) {
      if (L - 1 - i >= kRingDepth<T> / 2 &&
          i >= kRingDepth<T> + kSteady - 1) {
        const size_t kq = (i - kRingDepth<T>) * ss + s, k = i * ss + s;
        const T* src[kFields];
        for (int f = 0; f < kFields; ++f) src[f] = down_src[f] + kq;
        steady(ring, stage, carry, src, fcdown + k, fdown + k,
               -static_cast<ptrdiff_t>(ss));
        it += kSteady;
        i -= kSteady - 1;
        continue;
      }
      ring.wait();
      const size_t k = i * ss + s;
      const T fc = ring(stage, kA1) * carry +
                   ring(stage, kB1) * ring(stage, kX1) + ring(stage, kS1);
      const T f = ring(stage, kA2) * fc + ring(stage, kB2) * ring(stage, kX2) +
                  ring(stage, kS2);
      fcdown[k] = fc;
      fdown[k] = f;
      if (up_x1_gap(i) < kRingDepth<T>)
        ring(Ring<T>::advance(stage, up_x1_gap(i)), kX1) = fc;
      if (i > 0 && up_x2_gap(L, i - 1) < kRingDepth<T>)
        ring(Ring<T>::advance(stage, up_x2_gap(L, i - 1)), kX2) = f;
      carry = f;
      issue(stage);
      stage = Ring<T>::advance(stage, 1);
    }
    carry = r * (d0 + carry) + e;
    fup[s] = carry;
    if (!last && down_x2_gap(L, 0) < kRingDepth<T>)
      ring(Ring<T>::advance(stage, down_x2_gap(L, 0)), kX2) = carry;
    const T* up_src[kFields] = {a_low, b_low, s_lu, a_up,
                                b_up,  s_uu,  fcdown, fdown + ss};
    for (int i = 0; i < L; ++i) {
      if (i >= kRingDepth<T> / 2 && i + kRingDepth<T> + kSteady <= L) {
        const size_t kq = (i + kRingDepth<T>) * ss + s, k = i * ss + s;
        const T* src[kFields];
        for (int f = 0; f < kFields; ++f) src[f] = up_src[f] + kq;
        steady(ring, stage, carry, src, fcup + k, fup + ss + k,
               static_cast<ptrdiff_t>(ss));
        it += kSteady;  // may end the pass's issue
        if (it == 2 * L) {
          it = 0;
          ++ip;
        }
        i += kSteady - 1;
        continue;
      }
      ring.wait();
      const size_t k = i * ss + s;
      const T fc = ring(stage, kA1) * carry +
                   ring(stage, kB1) * ring(stage, kX1) + ring(stage, kS1);
      const T f = ring(stage, kA2) * fc + ring(stage, kB2) * ring(stage, kX2) +
                  ring(stage, kS2);
      fcup[k] = fc;
      fup[k + ss] = f;
      if (!last) {
        if (down_x1_gap(L, i) < kRingDepth<T>)
          ring(Ring<T>::advance(stage, down_x1_gap(L, i)), kX1) = fc;
        if (i + 1 < L && down_x2_gap(L, i + 1) < kRingDepth<T>)
          ring(Ring<T>::advance(stage, down_x2_gap(L, i + 1)), kX2) = f;
      }
      carry = f;
      issue(stage);
      stage = Ring<T>::advance(stage, 1);
    }
  }
  // every group still open holds no copy: the issue ran past the last step
}

template <typename T>
int launch(const T* a_up, const T* b_up, const T* s_ud, const T* s_uu,
           const T* a_low, const T* b_low, const T* s_ld, const T* s_lu,
           const T* toa, const T* refl, const T* emis, const T* fdir0,
           const T* fup_prev, const T* fcup_prev, T* fdown, T* fup,
           T* fcdown, T* fcup, int L, int S, int n_passes, void* stream) {
  const int blocks = (S + kThreads - 1) / kThreads;
  noniso_sweep_kernel<T><<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      a_up, b_up, s_ud, s_uu, a_low, b_low, s_ld, s_lu, toa, refl, emis,
      fdir0, fup_prev, fcup_prev, fdown, fup, fcdown, fcup, L, S, n_passes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes.  They launch on the given stream
// without synchronising and return cudaGetLastError() after the launch.
extern "C" {

int noniso_sweep_f64(const double* a_up, const double* b_up,
                     const double* s_ud, const double* s_uu,
                     const double* a_low, const double* b_low,
                     const double* s_ld, const double* s_lu,
                     const double* toa, const double* refl,
                     const double* emis, const double* fdir0,
                     const double* fup_prev, const double* fcup_prev,
                     double* fdown, double* fup, double* fcdown,
                     double* fcup, int L, int S, int n_passes, void* stream) {
  return launch<double>(a_up, b_up, s_ud, s_uu, a_low, b_low, s_ld, s_lu, toa,
                        refl, emis, fdir0, fup_prev, fcup_prev, fdown, fup,
                        fcdown, fcup, L, S, n_passes, stream);
}

int noniso_sweep_f32(const float* a_up, const float* b_up, const float* s_ud,
                     const float* s_uu, const float* a_low,
                     const float* b_low, const float* s_ld, const float* s_lu,
                     const float* toa, const float* refl, const float* emis,
                     const float* fdir0, const float* fup_prev,
                     const float* fcup_prev, float* fdown, float* fup,
                     float* fcdown, float* fcup, int L, int S, int n_passes,
                     void* stream) {
  return launch<float>(a_up, b_up, s_ud, s_uu, a_low, b_low, s_ld, s_lu, toa,
                       refl, emis, fdir0, fup_prev, fcup_prev, fdown, fup,
                       fcdown, fcup, L, S, n_passes, stream);
}

const char* helios_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
