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
// The elimination is the reference's, unpivoted, with its two divisions:
// with the default surface albedo row 0 is [-1e-8, 1], and any change of
// its rounding shows ~1e8-fold in the BOA downward flux.  nvcc contracts
// a*b + c into fma, so results match the plain PyTorch version to
// rounding, not bitwise.  Unlike the Pallas kernel, no identity columns pad
// S to a lane tile.
//
// Layout: b, c, d, x, dp are [n, S] row-major with the spectral column s
// fastest; one thread per column, so a warp reads every row coalesced.
// c[i-1] is kept in a register from the previous row.  cp lives in the
// output x until back-substitution overwrites it; dp is a scratch array the
// wrapper allocates.
//
// Bound.  Each input read once and each output written once: b, c, d and x
// at [n, S], 4 n S values: 104.0 MB in fp64 at n = 422, S = 7700 (31.0 us at
// the data-sheet 3.35 TB/s), 52.2 MB at n = 212 (15.6 us).  The arithmetic
// (two divisions, three fma, one multiply per row and column) is below
// that at the data-sheet 34 TFLOP/s fp64.
//
// The chain.  Each column is a chain of 2 n dependent row steps; a forward
// step waits on its own two divisions, a back step on one fma.  The ring of
// column_ring.cuh streams each step's operands kRingDepth steps ahead of
// the chain: b, c, d going forward, then cp and dp in reverse row order
// (a snake: the last rows eliminated are the first read back, while their
// lines are still in L2).  The rows within kRingDepth / 2 of the end are
// handed from the forward step to the back step through the ring
// directly.  Blocks are 32 columns wide: 241 blocks at S = 7700, resident
// in one wave on 132 SMs.
//
// What this design leaves on the table:
//  * the step's bookkeeping: with the loads off the chain, the warp's own
//    instruction stream (ring cursor, three cp.async, addresses, the two
//    divisions, the stores) sets the pace; the rows away from the turn run
//    in fixed-stride blocks of kSteady (steady_forward, steady_back), the
//    rows within about kRingDepth of it in the general step;
//  * the cp / dp round trip: both are written and read back once more than
//    the bound counts, 2 n S values each way through L2 and partly HBM;
//  * the row assembly (ops/thomas.py) runs unfused before the kernel and
//    writes b, c, d to device memory.

#include <cstddef>

#include <cuda_runtime.h>

#include "column_ring.cuh"

namespace {

constexpr int kThreads = 32;    // columns per block
constexpr int kRingDepth = 16;  // row steps in flight ahead of the chain
constexpr int kSteady = 4;      // row steps per block away from the turn

// The operands of one row step: b, c, d going forward; cp and dp going back.
enum { kB, kC, kD, kFields, kCp = kB, kDp = kC };

template <typename T>
using Ring = helios::ColumnRing<T, kRingDepth, kFields, kThreads>;

// Steps from the forward step of row i, which writes cp[i] and dp[i], to
// the back-substitution step of row i, which reads them.  A gap of
// kRingDepth or more goes through global memory and the ring's loads; a
// smaller one is stored into the ring by the forward step.
__device__ __forceinline__ long long back_gap(int n, int i) {
  return 2LL * n - 1 - 2LL * i;
}

// kSteady forward rows from `stage` on whose issued rows, kRingDepth ahead,
// are forward rows too: row j stores x_out[j * ss], dp_out[j * ss] and
// issues b, c, d at [j * ss] of bq, cq, dq.  The next row's operands are
// read from the ring before this row's divisions, and the issue does not
// wait for them, so the warp's other instructions overlap the chain.
template <typename T>
__device__ __forceinline__ void steady_forward(
    const Ring<T>& ring, int& stage, T& c_prev, T& cp_prev, T& dp_prev,
    const T* bq, const T* cq, const T* dq, T* x_out, T* dp_out, size_t ss) {
  T cur[kFields];
  Ring<T>::wait();
#pragma unroll
  for (int f = 0; f < kFields; ++f) cur[f] = ring(stage, f);
#pragma unroll
  for (int j = 0; j < kSteady; ++j) {
    ring.load(stage, kB, bq + j * ss);
    ring.load(stage, kC, cq + j * ss);
    ring.load(stage, kD, dq + j * ss);
    Ring<T>::commit();
    const int next = Ring<T>::advance(stage, 1);
    T nxt[kFields];
    if (j + 1 < kSteady) {
      Ring<T>::wait();
#pragma unroll
      for (int f = 0; f < kFields; ++f) nxt[f] = ring(next, f);
    }
    const T c_i = cur[kC];
    const T denom = cur[kB] - c_prev * cp_prev;
    cp_prev = c_i / denom;
    dp_prev = (cur[kD] - c_prev * dp_prev) / denom;
    x_out[j * ss] = cp_prev;
    dp_out[j * ss] = dp_prev;
    c_prev = c_i;
    stage = next;
    if (j + 1 < kSteady) {
#pragma unroll
      for (int f = 0; f < kFields; ++f) cur[f] = nxt[f];
    }
  }
}

// kSteady back-substitution rows (going down) from `stage` on whose cp and
// dp came through the ring's loads and whose issued rows are back rows too:
// row j stores x_out[-j * ss] and issues cp, dp at [-j * ss] of xq, dpq.
template <typename T>
__device__ __forceinline__ void steady_back(const Ring<T>& ring, int& stage,
                                            T& x_next, const T* xq,
                                            const T* dpq, T* x_out,
                                            size_t ss) {
  const ptrdiff_t down = -static_cast<ptrdiff_t>(ss);
  T cp_i, dp_i;
  Ring<T>::wait();
  cp_i = ring(stage, kCp);
  dp_i = ring(stage, kDp);
#pragma unroll
  for (int j = 0; j < kSteady; ++j) {
    ring.load(stage, kCp, xq + j * down);
    ring.load(stage, kDp, dpq + j * down);
    Ring<T>::commit();
    const int next = Ring<T>::advance(stage, 1);
    T cp_n = cp_i, dp_n = dp_i;
    if (j + 1 < kSteady) {
      Ring<T>::wait();
      cp_n = ring(next, kCp);
      dp_n = ring(next, kDp);
    }
    x_next = dp_i - cp_i * x_next;
    x_out[j * down] = x_next;
    stage = next;
    cp_i = cp_n;
    dp_i = dp_n;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
thomas_kernel(const T* __restrict__ b, const T* __restrict__ c,
              const T* __restrict__ d, T* __restrict__ x,
              T* __restrict__ dp, int n, int S) {
  __shared__ T slots[Ring<T>::kElements];
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const size_t ss = static_cast<size_t>(S);
  const Ring<T> ring(slots, threadIdx.x);

  // the loads of the next step to issue: forward row g for g < n, then
  // back-substitution row 2 n - 1 - g
  long long g = 0;
  auto issue = [&](int stage) {
    if (g < n) {
      const size_t k = g * ss + s;
      ring.load(stage, kB, b + k);
      ring.load(stage, kC, c + k);
      ring.load(stage, kD, d + k);
    } else if (g < 2LL * n) {
      const int i = static_cast<int>(2LL * n - 1 - g);
      const size_t k = i * ss + s;
      if (back_gap(n, i) >= kRingDepth) {
        ring.load(stage, kCp, x + k);
        ring.load(stage, kDp, dp + k);
      }
    }
    ++g;
    Ring<T>::commit();
  };

  for (int stage = 0; stage < kRingDepth; ++stage) issue(stage);

  int stage = 0;
  T c_prev = T(0), cp_prev = T(0), dp_prev = T(0);
  for (int i = 0; i < n; ++i) {
    if (i + kRingDepth + kSteady <= n) {
      const size_t k = i * ss + s, kq = k + kRingDepth * ss;
      steady_forward(ring, stage, c_prev, cp_prev, dp_prev, b + kq, c + kq,
                     d + kq, x + k, dp + k, ss);
      g += kSteady;
      i += kSteady - 1;
      continue;
    }
    ring.wait();
    const size_t k = i * ss + s;
    const T c_i = ring(stage, kC);
    const T denom = ring(stage, kB) - c_prev * cp_prev;
    cp_prev = c_i / denom;
    dp_prev = (ring(stage, kD) - c_prev * dp_prev) / denom;
    x[k] = cp_prev;
    dp[k] = dp_prev;
    if (back_gap(n, i) < kRingDepth) {
      const int back =
          Ring<T>::advance(stage, static_cast<int>(back_gap(n, i)));
      ring(back, kCp) = cp_prev;
      ring(back, kDp) = dp_prev;
    }
    c_prev = c_i;
    issue(stage);
    stage = Ring<T>::advance(stage, 1);
  }
  T x_next = T(0);
  for (int i = n - 1; i >= 0; --i) {
    if (back_gap(n, i) >= kRingDepth && i >= kRingDepth + kSteady - 1) {
      const size_t k = i * ss + s, kq = k - kRingDepth * ss;
      steady_back(ring, stage, x_next, x + kq, dp + kq, x + k, ss);
      g += kSteady;
      i -= kSteady - 1;
      continue;
    }
    ring.wait();
    const size_t k = i * ss + s;
    x_next = ring(stage, kDp) - ring(stage, kCp) * x_next;
    x[k] = x_next;
    issue(stage);
    stage = Ring<T>::advance(stage, 1);
  }
  // every group still open holds no copy: the issue ran past the last step
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
