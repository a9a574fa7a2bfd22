// Random Overlap opacity mixing for Hopper (sm_90a).
//
// Replaces the Pallas kernel of the JAX package
//   helios_tpu/kernels/ro_pallas.py:225  _ro_kernel  (fp64 as two-float32
//                                        pairs, int32 sort keys)
// with one template instantiated for float and double.  It computes what
// helios_tpu_torch.kernels.ro.ro_mix_reference computes: per cell c (a
// layer-bin pair) of two ny-point k-distributions m = mixed[c], n = new[c],
// both ascending (HELIOS reference add_to_mixed_opac, kernels.cu:
// 3263-3399):
//   * if 0.01 m[0] > n[ny-1] or 0.01 n[0] > m[ny-1] (negligible overlap):
//       out = m + n;
//   * else Random Overlap: the ny^2 sums m[i] + n[j] with the weights
//     (w_i/2)(w_j/2), sorted ascending (stable: ties in the order of the
//     flat index i*ny + j); yg = cumsum(weight) - weight/2; for each Gauss
//     node g_y, first_y = #(yg <= g_y) and the interval index
//       w_y = clip(max(first_y, w_{y-1} + 1), 1, ny^2 - 1);
//     out[y] = (k[w-1] (yg[w] - g_y) + k[w] (g_y - yg[w-1]))
//              / (yg[w] - yg[w-1]).
//
// Design: one warp per cell.  The ny^2 (key, flat index) pairs sit in the
// warp's shared memory, padded to a power of two n_pad >= 32 with +inf keys
// whose indices come after every real one.  A bitonic sort compares (key,
// index) lexicographically, which is the stable order of the plain version
// (torch.sort(stable=True)) and of the JAX oracle (jax.lax.sort).  The
// weights are rebuilt from the carried index after the sort, as
// ro_pallas.py:351-358 does.  One lane sums them in index order, as the
// plain version does: the interpolation divides by weight differences of
// ~1e-4 (ny = 20), so a sum in another order (a warp scan, torch.cumsum on
// CUDA) would move the result by 1e-12 (fp64) and 1e-4 (fp32) relative.
// Lanes 0..ny-1 count first_y, every lane runs the short w_y recurrence on
// shuffled counts, and lane y interpolates node y with products that are
// not contracted into fma, so the kernel computes the plain version's
// operations in its order, to the last bit.  Negligible cells write m + n
// and skip the sort.  The Pallas kernel's int32-key compression
// (ro_pallas.py:21-31) was a measure for Mosaic and is lossy at ~2^-38; the
// fp64 keys are sorted as they are.  Any ny in [2, 32] (n_pad <= 1024)
// runs; the wrapper refuses others.
//
// Bound.  Bytes: mixed, new and out at [C, ny], 3 C ny values: 19.4 MB in
// fp64 at C = 40425 layer-bin cells, ny = 20 (5.8 us at the data-sheet
// 3.35 TB/s).  Operations per non-negligible cell: the ny^2 sums, a merge of
// ny sorted runs (ny^2 log2 ny comparisons), the ny^2 weight products,
// the ny^2 scan additions and the ny^2 half-weight subtractions; ny
// additions per negligible cell.  At ny = 20 that is 3329 per cell, 4.0 us
// for 40425 cells at the data-sheet 34 TFLOP/s fp64: the bytes bound it.
//
// What this simple design leaves on the table:
//  * the full bitonic network (45 stages at n_pad = 512) ignores that the
//    sums arrive as 2 ny sorted runs; a merge would do ~ny^2 log2 ny work;
//  * the cumulative sum is one lane's serial chain of ny^2 additions, and
//    first_y is ny^3 comparisons, not a binary search;
//  * one warp per cell leaves the cell's sums in shared memory between the
//    phases; nothing is kept in registers.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxNy = 32;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T positive_infinity();
template <>
__device__ __forceinline__ double positive_infinity<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}
template <>
__device__ __forceinline__ float positive_infinity<float>() {
  return __int_as_float(0x7f800000);
}

// products and sums that nvcc does not contract into fma
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

template <typename T>
__global__ void ro_mix_kernel(const T* __restrict__ mixed,
                              const T* __restrict__ newo,
                              const T* __restrict__ gauss_w,
                              const T* __restrict__ gauss_y,
                              T* __restrict__ out, int C, int ny, int n_pad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int cell = blockIdx.x * warps + warp;
  if (cell >= C) return;  // the whole warp: cell is uniform across it

  // per warp: key[n_pad], yg[n_pad] (T), then idx[n_pad] (ushort) after
  // every warp's T arrays
  T* key = reinterpret_cast<T*>(smem_raw) + warp * 2 * n_pad;
  T* yg = key + n_pad;
  unsigned short* idx =
      reinterpret_cast<unsigned short*>(reinterpret_cast<T*>(smem_raw) +
                                        warps * 2 * n_pad) +
      warp * n_pad;

  const int n2 = ny * ny;
  const size_t base = static_cast<size_t>(cell) * ny;
  T m = T(0), n = T(0), hw = T(0), g = T(0);
  if (lane < ny) {
    m = mixed[base + lane];
    n = newo[base + lane];
    hw = T(0.5) * gauss_w[lane];
    g = gauss_y[lane];
  }
  const T m_first = __shfl_sync(kFull, m, 0);
  const T m_last = __shfl_sync(kFull, m, ny - 1);
  const T n_first = __shfl_sync(kFull, n, 0);
  const T n_last = __shfl_sync(kFull, n, ny - 1);
  if (T(0.01) * m_first > n_last || T(0.01) * n_first > m_last) {
    if (lane < ny) out[base + lane] = m + n;
    return;
  }

  // the pairwise sums, flat index t = i*ny + j; +inf sentinels after n2
  for (int t = lane; t < n_pad; t += kWarp) {
    const int i = t / ny;
    const int j = t - i * ny;
    const T mi = __shfl_sync(kFull, m, min(i, ny - 1));
    const T nj = __shfl_sync(kFull, n, j);
    key[t] = t < n2 ? mi + nj : positive_infinity<T>();
    idx[t] = static_cast<unsigned short>(t);
  }
  __syncwarp();

  // bitonic sort, ascending in (key, idx)
  for (int k = 2; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = lane; t < n_pad; t += kWarp) {
        const int p = t ^ j;
        if (p > t) {
          const T a = key[t], b = key[p];
          const unsigned short ia = idx[t], ib = idx[p];
          const bool a_after_b = a > b || (a == b && ia > ib);
          if (a_after_b == ((t & k) == 0)) {
            key[t] = b;
            key[p] = a;
            idx[t] = ib;
            idx[p] = ia;
          }
        }
      }
      __syncwarp();
    }
  }

  // weights (w_i/2)(w_j/2) from the carried index
  for (int t = lane; t < n_pad; t += kWarp) {
    const int id = idx[t];
    const int i = id / ny;
    const int j = id - i * ny;
    const T wi = __shfl_sync(kFull, hw, min(i, ny - 1));
    const T wj = __shfl_sync(kFull, hw, j);
    yg[t] = id < n2 ? mul_rn(wi, wj) : T(0);
  }
  __syncwarp();
  // yg = cumsum(weight) - weight/2, summed in index order in one lane
  if (lane == 0) {
    T acc = T(0);
    for (int t = 0; t < n2; ++t) {
      const T wt = yg[t];
      acc = add_rn(acc, wt);
      yg[t] = acc - mul_rn(T(0.5), wt);
    }
  }
  __syncwarp();

  // first_y = #(yg <= g_y) over the n2 real entries, then the interval
  // index recurrence (every lane runs it on the shuffled counts)
  int first = 0;
  if (lane < ny) {
    for (int t = 0; t < n2; ++t) first += yg[t] <= g;
  }
  int w_lane = 1, w_prev = 0;
  for (int y = 0; y < ny; ++y) {
    const int f = __shfl_sync(kFull, first, y);
    int w = y == 0 ? f : max(f, w_prev + 1);
    w = min(max(w, 1), n2 - 1);
    if (lane == y) w_lane = w;
    w_prev = w;
  }

  if (lane < ny) {
    const T k_lo = key[w_lane - 1], k_hi = key[w_lane];
    const T yg_lo = yg[w_lane - 1], yg_hi = yg[w_lane];
    out[base + lane] =
        add_rn(mul_rn(k_lo, yg_hi - g), mul_rn(k_hi, g - yg_lo)) /
        (yg_hi - yg_lo);
  }
}

template <typename T>
int launch(const T* mixed, const T* newo, const T* gauss_w, const T* gauss_y,
           T* out, int C, int ny, void* stream) {
  if (ny < 2 || ny > kMaxNy || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int n_pad = kWarp;
  while (n_pad < ny * ny) n_pad <<= 1;
  const int warps = n_pad <= 512 ? 4 : 2;  // <= 36.9 KB shared per block
  const size_t smem =
      static_cast<size_t>(warps) * n_pad * (2 * sizeof(T) + sizeof(short));
  const int blocks = (C + warps - 1) / warps;
  ro_mix_kernel<T><<<blocks, warps * kWarp, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      mixed, newo, gauss_w, gauss_y, out, C, ny, n_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes.  They launch on the given stream
// without synchronising and return cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for an ny outside [2, 32]).
extern "C" {

int ro_mix_f64(const double* mixed, const double* newo,
               const double* gauss_w, const double* gauss_y, double* out,
               int C, int ny, void* stream) {
  return launch<double>(mixed, newo, gauss_w, gauss_y, out, C, ny, stream);
}

int ro_mix_f32(const float* mixed, const float* newo, const float* gauss_w,
               const float* gauss_y, float* out, int C, int ny,
               void* stream) {
  return launch<float>(mixed, newo, gauss_w, gauss_y, out, C, ny, stream);
}

const char* helios_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
