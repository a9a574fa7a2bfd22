// The flux integration of one flux solve in one pass, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it fuses the chain of PyTorch ops and
// ordered_sum launches that integrated the three fluxes on the card
// (helios_tpu_torch.kernels.integrate.band_integrate_reference; in the JAX
// package fastpath.gauss_band_flat and forward.integrate_flux_flat, whose
// band total is the jnp.sum at helios_tpu/forward.py:668).  That chain ran
// 14 kernels per flux solve (three Gauss products, three ordered sums over
// y, three halvings, the two band products and their add, two ordered
// sums over the bins) and F_net a 15th, only to produce five sums in a
// fixed order.  Here it is one launch.
//
// What it computes, for each row r (an interface, or an (interface,
// planet) pair of a batch: fluxes [L+1, P, S] are R = (L+1) P rows of
// S = B Y values, and row r belongs to member p = r mod P) and bin b:
//   s = 0;  for y = 0 .. Y-1:  s = s + f[r, b Y + y] * w[y]
//                                           (for F_down, F_up and F_dir)
//   band = 0.5 * s
//   up_b = F_up_band[r, b] * dl[p, b]
//   down_b = (F_dir_band[r, b] + F_down_band[r, b]) * dl[p, b]
//   acc = 0;  acc = acc + carry[r] (a sliced model's slices before this
//   one);  for b = 0 .. B-1:  acc = acc + up_b   (and down_b)
//   F_net = up_tot - down_tot
// every product, add and difference rounded on its own (__dmul_rn,
// __dadd_rn, ...: nvcc would contract s + f * w into an fma), in the
// chain's order, so the results are the chain's bit for bit in fp64 and
// fp32.  A padded bin (dl = 0) adds an exact zero.  Outputs: bands [3, R,
// B] (F_down, F_up, F_dir) and tots [3, R] (F_up_tot, F_down_tot, F_net).
//
// Layout: one block per row.  The row's three fluxes are staged into
// shared memory a tile of TB bins at a time by cp.async, 16 bytes per copy
// where the source allows (the shared copy keeps the source's offset
// within 16 bytes, so any row start works), consecutive threads on
// consecutive addresses; a ring of kStages stages, so the next tiles are in
// flight while tile c is summed.  Thread j of the block forms bin j's three Gauss sums
// in y order from shared memory, writes the three bands and leaves up_b
// and down_b in shared memory; after a __syncthreads one thread adds the
// tile's values to the row's two totals in bin order, while the next
// tile's copies land.  No atomics, no second pass: the chain of B
// dependent adds per row (about 1-2 us at B = 385) is the price of the
// fixed order.
//
// Bound: each input read once and each output written once, 3 R S values
// read and 3 R B + 3 R written: 20.6 MB in fp64 at the flagship (R = 106,
// S = 7700), 6.1 us at the data-sheet 3.35 TB/s, and 164.6 MB at an
// 8-planet batch (R = 848), 49.1 us.  The arithmetic, 2 operations per
// flux value and 8 per bin, is 5.2 MFLOP at the flagship, 0.15 us at 34
// TFLOP/s fp64: the bytes bound it.  At the flagship's 106 rows each SM
// holds one block, and the time (about 2.5x the bound on an H100) goes to
// each tile's Gauss sums from shared memory and its chain of adds, not to
// the bytes in flight: more or larger stages were no faster at the
// flagship and slower at the batch (scripts/torch_ring_tuning.py
// --kernels band_integrate), and so was staging each bin at an odd stride
// to spare the bank conflicts of ny = 20, timed the same way and dropped.
// A batch of 8 planets fills the card with 848 blocks and comes within
// 1.5x of the bound.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

#include "column_ring.cuh"

namespace {

constexpr int kThreads = 256;
// a ring of kStages stages of the three fluxes' tiles, kStageBytes each
// (scripts/torch_ring_tuning.py --kernels band_integrate times others)
constexpr int kStageBytes = 32768;
constexpr int kStages = 2;

__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Start copying the 16 bytes at src (global, 16-byte aligned) to dst
// (shared, 16-byte aligned), bypassing L1.
__device__ __forceinline__ void copy_async_16(void* dst, const void* src) {
  const unsigned smem = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem),
               "l"(src)
               : "memory");
}

// Where src's values land in the stage buffer buf (16-byte aligned, V - 1
// elements of slack): at the same offset within 16 bytes as src.
template <typename T>
__device__ __forceinline__ T* staged(T* buf, const T* src) {
  return buf + (reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T);
}

// The block starts copying src[0 .. n) into staged(buf, src): scalar
// copies up to src's first 16-byte boundary and after its last, 16-byte
// copies between them.
template <typename T>
__device__ __forceinline__ void stage_copy(T* buf, const T* src, int n) {
  constexpr int V = 16 / sizeof(T);
  T* dst = staged(buf, src);
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15) /
                  static_cast<int>(sizeof(T));
  const int head = min(n, (V - mis) % V);
  const int n_vec = (n - head) / V;
  for (int i = threadIdx.x; i < head; i += kThreads)
    helios::copy_async(dst + i, src + i);
  for (int v = threadIdx.x; v < n_vec; v += kThreads)
    copy_async_16(dst + head + v * V, src + head + v * V);
  for (int i = head + n_vec * V + threadIdx.x; i < n; i += kThreads)
    helios::copy_async(dst + i, src + i);
}

// Elements of the block's shared memory: the Y weights, the tile's up_b
// and down_b, and kStages x 3 flux tiles of TB Y values (+ slack).
template <typename T>
__host__ __device__ constexpr int stage_len(int TB, int Y) {
  return round_up(TB * Y, 16 / static_cast<int>(sizeof(T))) +
         16 / static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int shared_len(int TB, int Y) {
  return round_up(Y, 16 / static_cast<int>(sizeof(T))) +
         round_up(2 * TB, 16 / static_cast<int>(sizeof(T))) +
         kStages * 3 * stage_len<T>(TB, Y);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_integrate_kernel(const T* __restrict__ f_down,
                      const T* __restrict__ f_up,
                      const T* __restrict__ f_dir, const T* __restrict__ w,
                      const T* __restrict__ dl,
                      const T* __restrict__ carry_up,
                      const T* __restrict__ carry_down, T* __restrict__ bands,
                      T* __restrict__ tots, int R, int B, int Y, int P,
                      int dl_stride, int has_carry, int TB) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ws = reinterpret_cast<T*>(smem_raw);
  constexpr int V = 16 / sizeof(T);
  T* const ud_up = ws + round_up(Y, V);
  T* const ud_down = ud_up + TB;
  T* const stages = ud_up + round_up(2 * TB, V);
  const int Ls = stage_len<T>(TB, Y);

  const int r = blockIdx.x;
  const long long S = static_cast<long long>(B) * Y;
  const T* const rows[3] = {f_down + r * S, f_up + r * S, f_dir + r * S};
  const T* const dl_row = dl + static_cast<long long>(r % P) * dl_stride;
  const int tiles = (B + TB - 1) / TB;

  for (int y = threadIdx.x; y < Y; y += kThreads) ws[y] = w[y];
  auto issue = [&](int c) {
    const int b0 = c * TB;
    const int n = min(TB, B - b0) * Y;
    T* const buf = stages + (c % kStages) * 3 * Ls;
    for (int f = 0; f < 3; ++f)
      stage_copy(buf + f * Ls, rows[f] + static_cast<long long>(b0) * Y, n);
    helios::commit_group();
  };

  T acc_up = T(0), acc_down = T(0);
  if (has_carry && threadIdx.x == 0) {
    acc_up = add_rn(acc_up, carry_up[r]);
    acc_down = add_rn(acc_down, carry_down[r]);
  }
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < tiles)
      issue(c);
    else
      helios::commit_group();           // an empty group keeps the count
  }
  for (int c = 0; c < tiles; ++c) {
    // into the stage that tile c - 1 was summed from
    if (c + kStages - 1 < tiles)
      issue(c + kStages - 1);
    else
      helios::commit_group();
    helios::wait_group<kStages - 1>();  // this thread's copies of tile c
    __syncthreads();                    // everyone's
    const int b0 = c * TB;
    const int nb = min(TB, B - b0);
    const int j = threadIdx.x;
    if (j < nb) {
      T* const buf = stages + (c % kStages) * 3 * Ls;
      const long long off = static_cast<long long>(b0) * Y;
      const T* const pd = staged(buf, rows[0] + off) + j * Y;
      const T* const pu = staged(buf + Ls, rows[1] + off) + j * Y;
      const T* const pr = staged(buf + 2 * Ls, rows[2] + off) + j * Y;
      T sd = T(0), su = T(0), sr = T(0);
      for (int y = 0; y < Y; ++y) {
        const T wy = ws[y];
        sd = add_rn(sd, mul_rn(pd[y], wy));
        su = add_rn(su, mul_rn(pu[y], wy));
        sr = add_rn(sr, mul_rn(pr[y], wy));
      }
      const T half = T(0.5);
      const T band_down = mul_rn(half, sd);
      const T band_up = mul_rn(half, su);
      const T band_dir = mul_rn(half, sr);
      const long long o = static_cast<long long>(r) * B + b0 + j;
      const long long plane = static_cast<long long>(R) * B;
      bands[o] = band_down;
      bands[plane + o] = band_up;
      bands[2 * plane + o] = band_dir;
      const T d = dl_row[b0 + j];
      ud_up[j] = mul_rn(band_up, d);
      ud_down[j] = mul_rn(add_rn(band_dir, band_down), d);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll 8
      for (int k = 0; k < nb; ++k) {
        acc_up = add_rn(acc_up, ud_up[k]);
        acc_down = add_rn(acc_down, ud_down[k]);
      }
    }
  }
  if (threadIdx.x == 0) {
    tots[r] = acc_up;
    tots[R + r] = acc_down;
    tots[2 * R + r] = sub_rn(acc_up, acc_down);
  }
  // the groups still open hold no copy
}

char g_error_detail[256] = "";

template <typename T>
int launch(const T* f_down, const T* f_up, const T* f_dir, const T* w,
           const T* dl, const T* carry_up, const T* carry_down, T* bands,
           T* tots, int R, int B, int Y, int P, int dl_stride, int has_carry,
           void* stream) {
  g_error_detail[0] = '\0';
  int TB = kStageBytes / (3 * Y * static_cast<int>(sizeof(T)));
  TB = TB < 1 ? 1 : (TB > kThreads ? kThreads : TB);
  TB = TB > B ? B : TB;
  const size_t smem = shared_len<T>(TB, Y) * sizeof(T);
  const auto kernel = band_integrate_kernel<T>;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) {
    std::snprintf(g_error_detail, sizeof g_error_detail,
                  "ny = %d needs %zu B of shared memory per block in %s, "
                  "above the %d B a block can have",
                  Y, smem, sizeof(T) == 8 ? "fp64" : "fp32", optin);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // once per device: allow the opt-in shared memory
  static unsigned long long configured = 0;
  if (device < 64 && !(configured >> device & 1)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured |= 1ull << device;
  }
  band_integrate_kernel<T>
      <<<R, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      f_down, f_up, f_dir, w, dl, carry_up, carry_down, bands, tots, R, B, Y,
      P, dl_stride, has_carry, TB);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes.  They launch on the given stream
// without synchronising and return cudaGetLastError() after the launch (or
// the error that kept it from launching).  carry_up and carry_down are read
// only when has_carry is 1; dl is read at (r mod P) * dl_stride + b.
extern "C" {

int band_integrate_f64(const double* f_down, const double* f_up,
                       const double* f_dir, const double* w,
                       const double* dl, const double* carry_up,
                       const double* carry_down, double* bands, double* tots,
                       int R, int B, int Y, int P, int dl_stride,
                       int has_carry, void* stream) {
  return launch<double>(f_down, f_up, f_dir, w, dl, carry_up, carry_down,
                        bands, tots, R, B, Y, P, dl_stride, has_carry,
                        stream);
}

int band_integrate_f32(const float* f_down, const float* f_up,
                       const float* f_dir, const float* w, const float* dl,
                       const float* carry_up, const float* carry_down,
                       float* bands, float* tots, int R, int B, int Y, int P,
                       int dl_stride, int has_carry, void* stream) {
  return launch<float>(f_down, f_up, f_dir, w, dl, carry_up, carry_down,
                       bands, tots, R, B, Y, P, dl_stride, has_carry, stream);
}

const char* helios_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Why the last launch was refused before it reached CUDA ("" otherwise).
const char* helios_launch_error_detail() { return g_error_detail; }

}  // extern "C"
