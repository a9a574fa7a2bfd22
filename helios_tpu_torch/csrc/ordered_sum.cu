// Sums and cumulative sums in a fixed order, for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  It takes the place of torch.sum and
// torch.cumsum where the loops reduce on the card: the Gauss-point and
// band sums of the flux integration (fastpath.gauss_band_flat,
// forward.integrate_flux_flat), the layer scans of the altitude, the
// heating and smoothing sums, the direct beam's optical depth above each
// interface, and the adiabat and zone sums of the convective adjustment.
// PyTorch's CUDA reductions and scans choose their order by the tensor's
// shape: a 1-D cumsum runs through cub's parallel scan and the same values
// along the leading axis of a 2-D tensor through a sequential loop, and
// the band sums of 385 values per row split differently for a planet's 106
// rows than for a batch's 848.  So on the card a planet in a batch of P
// came out a few ulps off its run alone (the altitude scan first, then the
// band totals and the adiabat's scan), which moved its convective
// adjustment by up to 4.6 K at the surface.  Here every sum runs in index
// order whatever the shape and the alignment, so a batch member is bit for
// bit its run alone.
//
// What it computes: the input is viewed as [O, K, I] (row-major, I
// fastest), the reduced axis K in the middle.  For every (o, i):
//   acc = 0;  for k = 0 .. K-1:  acc = acc + x[o, k, i]
// with scan = 1 writing out[o, k, i] = acc at every k ([O, K, I]), with
// scan = 0 writing out[o, i] = acc once ([O, I]).  One add per element and
// no multiply, so the compiler has nothing to contract: the result is the
// plain in-order loop's, bit for bit, in fp64 and fp32.
//
// Layout: one thread per (o, i), consecutive threads on consecutive i, so
// a warp reads each k's row coalesced when I > 1 (the layer scans of
// [L, P, S] and [L, P] tensors); with I = 1 (the band sums, K = ny or nbin
// contiguous values per row) consecutive threads read neighbouring rows
// and the lines stay in L1 across the thread's K loads.
//
// Bound: each input read once, each output written once, (O K I + O I)
// values for a sum and 2 O K I for a scan; the K - 1 adds per output are
// far below the card's rate.  At the flagship batch's Gauss sums
// ([106 x 8 x 385] rows of 20 doubles) that is 55.4 MB, 16.5 us at the
// data-sheet 3.35 TB/s.  The band sums have few rows (106 P) of 385, and
// there each thread's chain of 385 dependent adds, not the bytes, sets the
// time: the price of the fixed order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ordered_sum_kernel(const T* __restrict__ x, T* __restrict__ out, int O,
                   int K, int I, int scan) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (t >= static_cast<long long>(O) * I) return;
  const long long o = t / I, i = t - o * I;
  const long long base = o * K * I + i;
  const T* p = x + base;
  T acc = T(0);
  if (scan) {
    T* q = out + base;
    for (int k = 0; k < K; ++k) {
      acc = acc + p[static_cast<long long>(k) * I];
      q[static_cast<long long>(k) * I] = acc;
    }
  } else {
    for (int k = 0; k < K; ++k) acc = acc + p[static_cast<long long>(k) * I];
    out[t] = acc;
  }
}

template <typename T>
int launch(const T* x, T* out, int O, int K, int I, int scan, void* stream) {
  const long long n = static_cast<long long>(O) * I;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  ordered_sum_kernel<T><<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(x, out, O, K,
                                                               I, scan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes.  They launch on the given stream
// without synchronising and return cudaGetLastError() after the launch.
extern "C" {

int ordered_sum_f64(const double* x, double* out, int O, int K, int I,
                    int scan, void* stream) {
  return launch<double>(x, out, O, K, I, scan, stream);
}

int ordered_sum_f32(const float* x, float* out, int O, int K, int I,
                    int scan, void* stream) {
  return launch<float>(x, out, O, K, I, scan, stream);
}

const char* helios_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
