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
// pass's upward fluxes.
//
// Layout: every [L, S] / [L+1, S] array is row-major with the spectral
// column s fastest, so one thread per column reads each layer row as one
// coalesced load across a warp.  The Pallas kernels' algebraic flattening of
// the two half-layer recurrences into one (sweep_pallas.py:169-187) is not
// carried over: it reassociates two roundings, and the recurrences here are
// written in the order of the JAX oracle.  nvcc contracts a*b + c into fma,
// so results match the plain PyTorch version to rounding, not bitwise.
//
// Bound.  Memory.  One call at the flagship shape (L = 105, S = 7700) reads
// 8 [L,S] coefficient/source arrays, 4 [S] boundary rows, F_up_prev [L+1,S]
// and Fc_up_prev [L,S], and writes F_down, F_up [L+1,S] and Fc_down, Fc_up
// [L,S]: (14 L + 7) S values, 91.0 MB in fp64 (27 us at the data-sheet
// 3.35 TB/s) and 45.5 MB in fp32 (13.6 us).  The arithmetic, 16 flops per
// layer and pass (52 MFLOP for 4 passes in fp64), is no limit.
//
// What this simple design leaves on the table:
//  * occupancy: one thread per column gives S = 7700 threads, 121 blocks
//    of 64 for 132 SMs, i.e. about two warps per SM; each step of the
//    sequential layer chain waits on its loads with little to hide them;
//  * coefficient re-reads: each pass reads the 8 coefficient arrays again
//    (4x for 4 passes); the 52 MB fp64 coefficient set does not quite fit
//    in the 50 MB L2, so most re-reads go to HBM;
//  * the source assembly (noniso_coeffs_from_cache, fastpath.py:616-628)
//    runs unfused before the kernel and writes the four [L,S] sources to
//    HBM; fusing it would read the Planck rows and the cache directly.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

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
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const size_t ss = static_cast<size_t>(S);

  for (int i = 0; i < L; ++i) {
    fup[i * ss + s] = fup_prev[i * ss + s];
    fcup[i * ss + s] = fcup_prev[i * ss + s];
  }
  fup[L * ss + s] = fup_prev[L * ss + s];

  const T top = toa[s];
  const T r = refl[s];
  const T e = emis[s];
  const T d0 = fdir0[s];
  fdown[L * ss + s] = top;

  for (int p = 0; p < n_passes; ++p) {
    T carry = top;
    for (int i = L - 1; i >= 0; --i) {
      const size_t k = i * ss + s;
      const T fc = a_up[k] * carry + b_up[k] * fcup[k] + s_ud[k];
      const T f = a_low[k] * fc + b_low[k] * fup[k] + s_ld[k];
      fcdown[k] = fc;
      fdown[k] = f;
      carry = f;
    }
    carry = r * (d0 + carry) + e;
    fup[s] = carry;
    for (int i = 0; i < L; ++i) {
      const size_t k = i * ss + s;
      const T fc = a_low[k] * carry + b_low[k] * fcdown[k] + s_lu[k];
      const T f = a_up[k] * fc + b_up[k] * fdown[k + ss] + s_uu[k];
      fcup[k] = fc;
      fup[k + ss] = f;
      carry = f;
    }
  }
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
