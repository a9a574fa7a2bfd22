// Isothermal iterative two-stream flux solve for Hopper (sm_90a).
//
// Replaces the Pallas kernels of the JAX package
//   helios_tpu/kernels/sweep_pallas.py:27  _iso_sweep_kernel       (fp32)
//   helios_tpu/kernels/sweep_pallas.py:75  _iso_sweep_kernel_df64  (fp64 as
//                                           two-float32 pairs)
// with one template instantiated for float and double (the H100 has
// hardware fp64, so the df64 pair arithmetic has no counterpart here).  It
// computes what helios_tpu.fastpath.fband_iso_flat computes
// (fastpath.py:368-411; HELIOS reference fband_iso, kernels.cu:1366-1515):
// per spectral column, n_passes times
//   down sweep, i = L-1 .. 0:
//     F_down[i]   = a[i] * F_down[i+1] + b_nm[i] * F_up[i]     + s_down[i]
//   boundary:  F_up[0] = refl * (F_dir0 + F_down[0]) + emis
//   up sweep, i = 0 .. L-1:
//     F_up[i+1]   = a[i] * F_up[i]     + b_nm[i] * F_down[i+1] + s_up[i]
// with F_down[L] = toa and the previous solve's F_up as the first pass's
// upward flux.  The iterating RCE loop runs 3*scat+1 passes, the
// post-processing run 1000*scat+1 in one call.
//
// Layout: every [L, S] / [L+1, S] array is row-major with the spectral
// column s fastest, so one thread per column reads each layer row as one
// coalesced load across a warp.  The recurrences keep the JAX oracle's
// operation order a*carry + b*F + s; the df64 Pallas kernel's staged
// src = b*F + s vector pass (sweep_pallas.py:116-118, :142-144) is not
// carried over, since it reassociates.  nvcc contracts a*b + c into fma, so
// results match the plain PyTorch version to rounding, not bitwise.
//
// Bound.  One call at the flagship shape (L = 105, S = 7700) reads a, b_nm,
// s_down, s_up [L,S], the four [S] boundary rows and F_up_prev [L+1,S], and
// writes F_down, F_up [L+1,S]: (7 L + 7) S values, 45.7 MB in fp64 (13.6 us
// at the data-sheet 3.35 TB/s) and 22.9 MB in fp32 (6.8 us).  The
// arithmetic is 8 flops per layer and pass (four fma): at 4 passes 26 MFLOP,
// below the bytes; at 1001 passes 6.47 GFLOP, 0.190 ms at the data-sheet
// 34 TFLOP/s fp64 (0.097 ms at 67 TFLOP/s fp32), above them.
//
// What this simple design leaves on the table:
//  * latency: each layer step waits on its own loads, and one thread per
//    column gives S = 7700 threads, 121 blocks of 64 for 132 SMs, about two
//    warps per SM to hide it; at 1001 passes the 26 MB of fp64 coefficients
//    and the 13 MB of fluxes stay in the 50 MB L2, so the chain is bound by
//    L2 latency, not HBM;
//  * re-reads: each pass reads a, b_nm and both sources again, and re-reads
//    the other stream's fluxes just written; shared-memory or register
//    residency of a column block would take them off the L2;
//  * the source assembly (iso_coeffs_from_cache, fastpath.py) runs unfused
//    before the kernel and writes s_down, s_up to HBM.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

template <typename T>
__global__ void __launch_bounds__(kThreads)
iso_sweep_kernel(const T* __restrict__ a, const T* __restrict__ b_nm,
                 const T* __restrict__ s_down, const T* __restrict__ s_up,
                 const T* __restrict__ toa, const T* __restrict__ refl,
                 const T* __restrict__ emis, const T* __restrict__ fdir0,
                 const T* __restrict__ fup_prev, T* __restrict__ fdown,
                 T* __restrict__ fup, int L, int S, int n_passes) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const size_t ss = static_cast<size_t>(S);

  for (int i = 0; i <= L; ++i) fup[i * ss + s] = fup_prev[i * ss + s];

  const T top = toa[s];
  const T r = refl[s];
  const T e = emis[s];
  const T d0 = fdir0[s];
  fdown[L * ss + s] = top;

  for (int p = 0; p < n_passes; ++p) {
    T carry = top;
    for (int i = L - 1; i >= 0; --i) {
      const size_t k = i * ss + s;
      carry = a[k] * carry + b_nm[k] * fup[k] + s_down[k];
      fdown[k] = carry;
    }
    carry = r * (d0 + carry) + e;
    fup[s] = carry;
    for (int i = 0; i < L; ++i) {
      const size_t k = i * ss + s;
      carry = a[k] * carry + b_nm[k] * fdown[k + ss] + s_up[k];
      fup[k + ss] = carry;
    }
  }
}

template <typename T>
int launch(const T* a, const T* b_nm, const T* s_down, const T* s_up,
           const T* toa, const T* refl, const T* emis, const T* fdir0,
           const T* fup_prev, T* fdown, T* fup, int L, int S, int n_passes,
           void* stream) {
  const int blocks = (S + kThreads - 1) / kThreads;
  iso_sweep_kernel<T><<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      a, b_nm, s_down, s_up, toa, refl, emis, fdir0, fup_prev, fdown, fup, L,
      S, n_passes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes.  They launch on the given stream
// without synchronising and return cudaGetLastError() after the launch.
extern "C" {

int iso_sweep_f64(const double* a, const double* b_nm, const double* s_down,
                  const double* s_up, const double* toa, const double* refl,
                  const double* emis, const double* fdir0,
                  const double* fup_prev, double* fdown, double* fup, int L,
                  int S, int n_passes, void* stream) {
  return launch<double>(a, b_nm, s_down, s_up, toa, refl, emis, fdir0,
                        fup_prev, fdown, fup, L, S, n_passes, stream);
}

int iso_sweep_f32(const float* a, const float* b_nm, const float* s_down,
                  const float* s_up, const float* toa, const float* refl,
                  const float* emis, const float* fdir0,
                  const float* fup_prev, float* fdown, float* fup, int L,
                  int S, int n_passes, void* stream) {
  return launch<float>(a, b_nm, s_down, s_up, toa, refl, emis, fdir0,
                       fup_prev, fdown, fup, L, S, n_passes, stream);
}

const char* helios_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
