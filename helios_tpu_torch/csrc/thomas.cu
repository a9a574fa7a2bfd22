// Batched tridiagonal (Thomas) solve for Hopper (sm_90a).
//
// Replaces the Pallas kernel of the JAX package
//   helios_tpu/kernels/thomas_pallas.py:31  _thomas_kernel_df64  (fp64 as
//                                           two-float32 pairs)
// with one template instantiated for float and double (the H100 has
// hardware fp64, so the df64 pair arithmetic has no counterpart here).  It
// computes what helios_tpu.ops.thomas.thomas_solve computes
// (ops/thomas.py:34-73; HELIOS reference fband_matrix_*, kernels.cu:
// 1916-1967): per spectral column s, the system with diagonal b,
// super-diagonal c and sub-diagonal a_i = c_{i-1}:
//   forward, i = 0 .. n-1:
//     denom = b[i] - c[i-1] * cp[i-1]
//     cp[i] = c[i] / denom
//     dp[i] = (d[i] - c[i-1] * dp[i-1]) / denom
//   with c[-1] = cp[-1] = dp[-1] = 0;
//   back-substitution, i = n-1 .. 0:
//     x[i] = dp[i] - cp[i] * x[i+1],  x[n] = 0.
// The matrix flux method (flux_calc_method = matrix) runs it once per flux
// solve, n = 2 (L+1) rows for isothermal layers, 4 (L+1) - 2 otherwise.
//
// Layout: b, c, d, x, dp are [n, S] row-major with the spectral column s
// fastest, so one thread per column reads every row as one coalesced load
// across a warp.  c[i-1] is kept in a register from the previous row.  cp
// lives in the output x (each thread reads its cp[i] back once before it
// overwrites it with x[i]); dp is a scratch array the wrapper allocates.
// nvcc contracts a*b + c into fma, so results match the plain PyTorch
// version to rounding, not bitwise.  Unlike the Pallas kernel, no identity
// columns pad S to a lane tile.
//
// Bound.  Each input read once and each output written once: b, c, d and x
// at [n, S], 4 n S values: 104.0 MB in fp64 at n = 422, S = 7700 (31.0 us at
// the data-sheet 3.35 TB/s), 52.2 MB at n = 212 (15.6 us).  The arithmetic
// (two divisions, three fma, one multiply per row and column) is below
// that at the data-sheet 34 TFLOP/s fp64.
//
// What this simple design leaves on the table:
//  * latency: each row's division waits on the previous row, and one
//    thread per column gives S = 7700 threads, about two warps per SM;
//  * the scratch traffic: cp and dp are written and read back once more
//    than the bound counts;
//  * the row assembly (ops/thomas.py) runs unfused before the kernel and
//    writes b, c, d to device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

template <typename T>
__global__ void __launch_bounds__(kThreads)
thomas_kernel(const T* __restrict__ b, const T* __restrict__ c,
              const T* __restrict__ d, T* __restrict__ x,
              T* __restrict__ dp, int n, int S) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const size_t ss = static_cast<size_t>(S);

  T c_prev = T(0), cp_prev = T(0), dp_prev = T(0);
  for (int i = 0; i < n; ++i) {
    const size_t k = i * ss + s;
    const T c_i = c[k];
    const T denom = b[k] - c_prev * cp_prev;
    cp_prev = c_i / denom;
    dp_prev = (d[k] - c_prev * dp_prev) / denom;
    x[k] = cp_prev;
    dp[k] = dp_prev;
    c_prev = c_i;
  }
  T x_next = T(0);
  for (int i = n - 1; i >= 0; --i) {
    const size_t k = i * ss + s;
    x_next = dp[k] - x[k] * x_next;
    x[k] = x_next;
  }
}

template <typename T>
int launch(const T* b, const T* c, const T* d, T* x, T* dp, int n, int S,
           void* stream) {
  const int blocks = (S + kThreads - 1) / kThreads;
  thomas_kernel<T><<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(b, c, d, x, dp, n,
                                                          S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes.  They launch on the given stream
// without synchronising and return cudaGetLastError() after the launch.
extern "C" {

int thomas_f64(const double* b, const double* c, const double* d, double* x,
               double* dp, int n, int S, void* stream) {
  return launch<double>(b, c, d, x, dp, n, S, stream);
}

int thomas_f32(const float* b, const float* c, const float* d, float* x,
               float* dp, int n, int S, void* stream) {
  return launch<float>(b, c, d, x, dp, n, S, stream);
}

const char* helios_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
