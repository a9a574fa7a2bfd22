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
// post-processing run 1000*scat+1 in one call, the matrix method's
// absorption fallback one pass with b_nm = 0.
//
// Layout: every [L, S] / [L+1, S] array is row-major with the spectral
// column s fastest; one thread per column, so a warp reads each layer row
// as one coalesced load.  The recurrences keep the JAX oracle's operation
// order a*carry + b*F + s; the df64 Pallas kernel's staged src = b*F + s
// vector pass (sweep_pallas.py:116-118, :142-144) is not carried over,
// since it reassociates.  nvcc contracts a*b + c into fma, so results match
// the plain PyTorch version to rounding, not bitwise.
//
// Bounds.  One call at the flagship shape (L = 105, S = 7700) reads a,
// b_nm, s_down, s_up [L,S], the four [S] boundary rows and F_up_prev
// [L+1,S], and writes F_down, F_up [L+1,S]: (7 L + 7) S values, 45.7 MB in
// fp64 (13.6 us at the data-sheet 3.35 TB/s), 22.9 MB in fp32 (6.8 us).
// The arithmetic is 8 flops per layer and pass: at 4 passes 26 MFLOP,
// below the bytes; at 1001 passes 6.47 GFLOP, 0.190 ms at the data-sheet
// 34 TFLOP/s fp64 (0.097 ms at 67 TFLOP/s fp32), above them.
//
// Residency.  A column's whole state is small: a, b_nm, s_down, s_up (4 L
// values) and one flux slot per interface (L + 1).  The down sweep's step i
// reads F_up[i] from slot i and writes F_down[i] there; the up sweep's step
// i reads F_down[i+1] from slot i+1 and writes F_up[i+1] there; slot L
// holds toa (the up sweep's last step overwrites it with F_up[L], and it is
// reset after each pass but the last).  So each thread copies its column
// into shared memory once, with cp.async (all copies issued before the
// first wait), and every pass runs from there: a layer step reads shared
// memory (~30 cycles), not L2 (~500 cycles, the earlier design's wait at
// 1001 passes, when the 39 MB working set sat in the 50 MB L2).  Global
// memory is written only in the last pass.  Shared memory is laid out
// [array][layer][column in block], so a warp's 32 threads read 32
// consecutive words, free of bank conflicts.
//
// Capacity.  5 L + 1 values per column are 4,208 B in fp64 at L = 105, at
// most 55 columns per SM (228 KB): 7,260 columns per wave against S =
// 7,700, so the fully resident fp64 kernel runs in two waves.  The streamed
// variant keeps s_up out of shared memory and streams it through a
// per-thread cp.async ring of kRingBlocks blocks of kSteady rows (6.5 MB of
// s_up stays in L2 across passes): 4 L + 1 values plus the ring, 3,560 B
// per column, so two blocks of 32 columns share an SM and all 241 blocks
// run at once.  fp32 is fully resident in one wave (2,104 B per column).
// kStreamSourceUp64 / kStreamSourceUp32 pick the variant per precision:
// fp64 streams (on an H100 at 1001 passes 4.9 ms, against 7.4 ms resident
// in two waves; one wave of resident columns takes 3.7-3.8 ms), fp32 stays
// resident (2.8 ms against 5.5 ms streamed); at 4 passes both fp64
// variants take 0.04-0.06 ms (scripts/torch_ring_tuning.py).  The launch
// picks the block width, the largest of kMaxWidth, 16, 8, 4, 2, 1 whose
// columns fit the card's opt-in per-block shared memory (232,448 B on the
// H100): fp64 at L = 1000 takes 32 KB per column, so blocks of 4.  A column
// that does not fit alone (fp64 L > 7,257 streamed, fp32 L > 11,622
// resident) is refused with cudaErrorInvalidValue, and
// helios_launch_error_detail() says the limit.
// ptxas (sm_90a): 168 registers in fp64 (214-218 for blocks of 4 or fewer),
// 96 in fp32, no spills, no stack; all shared memory is dynamic (113,920 B
// per block of 32 in fp64 at L = 105, 67,328 B in fp32).
//
// The step.  With the loads off L2, one column's chain sets the pace: the
// time does not change from 32 columns to 7,700.  The middle of each sweep
// runs straight-line blocks of kSteady steps at fixed strides, the
// operands of the next block read from shared memory before this block's
// chain runs (two register sets in turn): a step is four ld.shared, the
// chain's dependent fma and add, one st.shared (in the last pass a global
// store), and no branch.  The L mod kSteady top rows run one step at a
// time, in loops kept rolled: the code of a pass is run once per pass, and
// unrolled remainders and copy loops cost the 1001-pass call a fifth of its
// time on an H100.
//
// What this design leaves:
//  * the serial chain per column, 2 L n_passes dependent steps: about 23 ns
//    per step in fp64 (18 ns resident) and 13 ns in fp32 on an H100 at
//    1001 passes, where the chain alone is two dependent operations; the
//    warp issues in order, so each block still waits on its loads once.
//    A scan over layers inside a column would go under the chain, but it
//    reassociates the recurrence;
//  * the source assembly (fastpath.iso_coeffs_from_cache) runs unfused
//    before the kernel and writes s_down, s_up to HBM.

#include <cstddef>
#include <cstdio>

#include <cuda_runtime.h>

#include "column_ring.cuh"

namespace {

// Stream s_up through a cp.async ring (1) or keep it resident (0), by
// precision (both timed by scripts/torch_ring_tuning.py).
constexpr int kStreamSourceUp64 = 1;
constexpr int kStreamSourceUp32 = 0;
template <typename T>
constexpr bool kStreamSourceUp =
    (sizeof(T) == 8 ? kStreamSourceUp64 : kStreamSourceUp32) != 0;
constexpr int kSteady = 8;      // layer steps per straight-line block
constexpr int kRingBlocks = 3;  // blocks of s_up rows in the ring
constexpr int kMaxWidth = 32;   // columns per block, at most
static_assert(kMaxWidth > 16 && kMaxWidth <= 32, "blocks narrow to 16");

// the operands of one layer step: carry = A * carry + B * F + Src
enum { kA, kB, kSrc, kF, kFields };

// Values per column in shared memory: per layer a, b_nm, s_down (and s_up
// when resident); then L + 1 flux slots; then the s_up ring when streamed.
template <bool Stream>
constexpr int kValuesPerLayer = Stream ? 4 : 5;
template <bool Stream>
constexpr int kValuesFixed = 1 + (Stream ? kRingBlocks * kSteady : 0);

template <typename T, bool Stream>
size_t column_bytes(int L) {
  return (static_cast<size_t>(kValuesPerLayer<Stream>) * L +
          kValuesFixed<Stream>) * sizeof(T);
}

// A thread's column in shared memory, and the pass that runs on it; array
// X's row i is X[i * W].
template <typename T, int W, bool Stream>
struct Column {
  T* a;
  T* b;
  T* sd;
  T* su;    // resident s_up (null when streamed)
  T* flux;  // L + 1 slots
  T* ring;  // kRingBlocks * kSteady rows of s_up (null when resident)
  int L;
  int nb;   // whole blocks of kSteady rows, layers [0, nb kSteady)

  __device__ Column(T* smem, int L_, int lane) : L(L_), nb(L_ / kSteady) {
    const size_t rows = static_cast<size_t>(L) * W;
    T* p = smem + lane;
    a = p;
    b = p + rows;
    sd = p + 2 * rows;
    p += 3 * rows;
    su = Stream ? nullptr : p;
    p += Stream ? 0 : rows;
    flux = p;
    ring = Stream ? p + rows + W : nullptr;
  }

  // Start copying s_up rows of block q into its ring stage and close their
  // group: kSteady rows for q < nb, the L - nb kSteady top rows for q = nb,
  // none beyond (an empty group keeps one group per block).
  __device__ __forceinline__ void issue_up_sources(const T* su_col,
                                                   size_t ss, int q) const {
    if (Stream && q <= nb) {
      T* stage = ring + (q % kRingBlocks) * kSteady * W;
      const T* src = su_col + static_cast<size_t>(q) * kSteady * ss;
      if (q < nb) {
#pragma unroll
        for (int j = 0; j < kSteady; ++j)
          helios::copy_async(stage + j * W, src + j * ss);
      } else {
#pragma unroll 1
        for (int j = 0; j < L - nb * kSteady; ++j)
          helios::copy_async(stage + j * W, src + j * ss);
      }
    }
    helios::commit_group();
  }

  // Operands of down block n (rows (nb-1-n) kSteady + kSteady-1 downward).
  __device__ __forceinline__ void load_down(int n,
                                            T (&v)[kFields][kSteady]) const {
    const int i0 = (nb - n) * kSteady - 1;
#pragma unroll
    for (int j = 0; j < kSteady; ++j) {
      const int k = (i0 - j) * W;
      v[kA][j] = a[k];
      v[kB][j] = b[k];
      v[kSrc][j] = sd[k];
      v[kF][j] = flux[k];
    }
  }

  template <bool Last>
  __device__ __forceinline__ void chain_down(int n,
                                             const T (&v)[kFields][kSteady],
                                             T& carry, T* fdown_col,
                                             size_t ss) const {
    const int i0 = (nb - n) * kSteady - 1;
#pragma unroll
    for (int j = 0; j < kSteady; ++j) {
      carry = v[kA][j] * carry + v[kB][j] * v[kF][j] + v[kSrc][j];
      flux[(i0 - j) * W] = carry;
      if (Last) fdown_col[(i0 - j) * ss] = carry;
    }
  }

  // Operands of up block n (rows n kSteady upward); a streamed s_up block
  // is read from its ring stage, which is then refilled with block
  // n + kRingBlocks.  One group per block: at block n the groups up to
  // n + kRingBlocks - 1 are committed, so waiting for all but the newest
  // kRingBlocks - 1 waits for block n's.
  __device__ __forceinline__ void load_up(int n, T (&v)[kFields][kSteady],
                                          const T* su_col, size_t ss) const {
    const int i0 = n * kSteady;
    if (Stream) {
      helios::wait_group<kRingBlocks - 1>();
      const T* stage = ring + (n % kRingBlocks) * kSteady * W;
#pragma unroll
      for (int j = 0; j < kSteady; ++j) v[kSrc][j] = stage[j * W];
      issue_up_sources(su_col, ss, n + kRingBlocks);
    }
#pragma unroll
    for (int j = 0; j < kSteady; ++j) {
      const int k = (i0 + j) * W;
      v[kA][j] = a[k];
      v[kB][j] = b[k];
      if (!Stream) v[kSrc][j] = su[k];
      v[kF][j] = flux[k + W];
    }
  }

  template <bool Last>
  __device__ __forceinline__ void chain_up(int n,
                                           const T (&v)[kFields][kSteady],
                                           T& carry, T* fup_col,
                                           size_t ss) const {
    const int i0 = n * kSteady;
#pragma unroll
    for (int j = 0; j < kSteady; ++j) {
      carry = v[kA][j] * carry + v[kB][j] * v[kF][j] + v[kSrc][j];
      if (Last)
        fup_col[(i0 + j + 1) * ss] = carry;
      else
        flux[(i0 + j + 1) * W] = carry;
    }
  }

  // One pass: the down sweep, the boundary, the up sweep.  Only the last
  // pass writes global memory (F_down in its down sweep, F_up in its up
  // sweep).
  template <bool Last>
  __device__ __forceinline__ void pass(const T* su_col, T* fdown_col,
                                       T* fup_col, size_t ss, T top, T r,
                                       T e, T d0) const {
    T v0[kFields][kSteady], v1[kFields][kSteady];
    // the up sweep's first s_up blocks land while the down sweep runs
    if (Stream)
      for (int q = 0; q < kRingBlocks; ++q) issue_up_sources(su_col, ss, q);

    T carry = top;
#pragma unroll 1
    for (int i = L - 1; i >= nb * kSteady; --i) {
      const int k = i * W;
      carry = a[k] * carry + b[k] * flux[k] + sd[k];
      flux[k] = carry;
      if (Last) fdown_col[i * ss] = carry;
    }
    // down blocks in turns of two register sets: block n+1's operands are
    // read before block n's chain
    if (nb > 0) {
      load_down(0, v0);
      int n = 0;
      for (; n + 1 < nb; n += 2) {
        load_down(n + 1, v1);
        chain_down<Last>(n, v0, carry, fdown_col, ss);
        if (n + 2 < nb) load_down(n + 2, v0);
        chain_down<Last>(n + 1, v1, carry, fdown_col, ss);
      }
      if (n < nb) chain_down<Last>(n, v0, carry, fdown_col, ss);
    }

    carry = r * (d0 + carry) + e;
    flux[0] = carry;
    if (Last) fup_col[0] = carry;

    if (nb > 0) {
      load_up(0, v0, su_col, ss);
      int n = 0;
      for (; n + 1 < nb; n += 2) {
        load_up(n + 1, v1, su_col, ss);
        chain_up<Last>(n, v0, carry, fup_col, ss);
        if (n + 2 < nb) load_up(n + 2, v0, su_col, ss);
        chain_up<Last>(n + 1, v1, carry, fup_col, ss);
      }
      if (n < nb) chain_up<Last>(n, v0, carry, fup_col, ss);
    }
    if (Stream && nb * kSteady < L) helios::wait_group<kRingBlocks - 1>();
#pragma unroll 1
    for (int i = nb * kSteady; i < L; ++i) {
      const int k = i * W;
      const T src =
          Stream ? ring[((nb % kRingBlocks) * kSteady + i - nb * kSteady) * W]
                 : su[k];
      carry = a[k] * carry + b[k] * flux[k + W] + src;
      if (Last)
        fup_col[(i + 1) * ss] = carry;
      else
        flux[k + W] = carry;
    }
    if (!Last) flux[L * W] = top;
  }
};

template <typename T, int W, bool Stream>
__global__ void __launch_bounds__(W)
iso_sweep_kernel(const T* __restrict__ a, const T* __restrict__ b_nm,
                 const T* __restrict__ s_down, const T* __restrict__ s_up,
                 const T* __restrict__ toa, const T* __restrict__ refl,
                 const T* __restrict__ emis, const T* __restrict__ fdir0,
                 const T* __restrict__ fup_prev, T* __restrict__ fdown,
                 T* __restrict__ fup, int L, int S, int n_passes) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  const int s = blockIdx.x * W + threadIdx.x;
  if (s >= S) return;
  const size_t ss = static_cast<size_t>(S);
  const Column<T, W, Stream> c(reinterpret_cast<T*>(smem_bytes), L,
                               threadIdx.x);

  // the column into shared memory: every copy issued, then one wait
  for (int i = 0; i < L; ++i) {
    const size_t k = i * ss + s;
    helios::copy_async(c.a + i * W, a + k);
    helios::copy_async(c.b + i * W, b_nm + k);
    helios::copy_async(c.sd + i * W, s_down + k);
    if (!Stream) helios::copy_async(c.su + i * W, s_up + k);
    helios::copy_async(c.flux + i * W, fup_prev + k);
  }
  helios::commit_group();
  const T top = toa[s];
  const T r = refl[s];
  const T e = emis[s];
  const T d0 = fdir0[s];
  c.flux[L * W] = top;
  fdown[L * ss + s] = top;
  helios::wait_group<0>();

  for (int p = 1; p < n_passes; ++p)
    c.template pass<false>(s_up + s, fdown + s, fup + s, ss, top, r, e, d0);
  c.template pass<true>(s_up + s, fdown + s, fup + s, ss, top, r, e, d0);
  // any group still open holds no copy: the last ring issue ran past L
}

char g_error_detail[256] = "";

template <typename T, int W, bool Stream>
int launch_width(const T* a, const T* b_nm, const T* s_down, const T* s_up,
                 const T* toa, const T* refl, const T* emis, const T* fdir0,
                 const T* fup_prev, T* fdown, T* fup, int L, int S,
                 int n_passes, int device, int optin, size_t smem,
                 cudaStream_t stream) {
  const auto kernel = iso_sweep_kernel<T, W, Stream>;
  // once per instance and device: allow the opt-in shared memory and ask
  // for the largest shared-memory carveout, so that blocks share an SM
  static unsigned long long configured = 0;
  if (device < 64 && !(configured >> device & 1)) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured |= 1ull << device;
  }
  const int blocks = (S + W - 1) / W;
  iso_sweep_kernel<T, W, Stream><<<blocks, W, smem, stream>>>(
      a, b_nm, s_down, s_up, toa, refl, emis, fdir0, fup_prev, fdown, fup, L,
      S, n_passes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* a, const T* b_nm, const T* s_down, const T* s_up,
           const T* toa, const T* refl, const T* emis, const T* fdir0,
           const T* fup_prev, T* fdown, T* fup, int L, int S, int n_passes,
           void* stream) {
  constexpr bool kStream = kStreamSourceUp<T>;
  g_error_detail[0] = '\0';
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t column = column_bytes<T, kStream>(L);
  if (column > static_cast<size_t>(optin)) {
    const long max_L = (static_cast<long>(optin) / sizeof(T) -
                        kValuesFixed<kStream>) / kValuesPerLayer<kStream>;
    std::snprintf(g_error_detail, sizeof g_error_detail,
                  "L = %d needs %zu B of shared memory per column in %s, "
                  "above the %d B a block can have: %s takes L up to %ld",
                  L, column, sizeof(T) == 8 ? "fp64" : "fp32", optin,
                  sizeof(T) == 8 ? "fp64" : "fp32", max_L);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int width = kMaxWidth;
  if (width * column > static_cast<size_t>(optin)) width = 16;
  while (width > 1 && width * column > static_cast<size_t>(optin)) width /= 2;
  const size_t smem = width * column;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HELIOS_ISO_WIDTH(w)                                                 \
  case w:                                                                   \
    return launch_width<T, w, kStream>(a, b_nm, s_down, s_up, toa, refl,    \
                                       emis, fdir0, fup_prev, fdown, fup, L, \
                                       S, n_passes, device, optin, smem, st);
  switch (width) {
    HELIOS_ISO_WIDTH(kMaxWidth)
    HELIOS_ISO_WIDTH(16)
    HELIOS_ISO_WIDTH(8)
    HELIOS_ISO_WIDTH(4)
    HELIOS_ISO_WIDTH(2)
    default:
      return launch_width<T, 1, kStream>(a, b_nm, s_down, s_up, toa, refl,
                                         emis, fdir0, fup_prev, fdown, fup,
                                         L, S, n_passes, device, optin, smem,
                                         st);
  }
#undef HELIOS_ISO_WIDTH
}

}  // namespace

// Plain C entry points, loaded with ctypes.  They launch on the given stream
// without synchronising and return cudaGetLastError() after the launch (or
// the error that kept it from launching).
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

// Why the last launch was refused before it reached CUDA ("" otherwise).
const char* helios_launch_error_detail() { return g_error_detail; }

}  // extern "C"
