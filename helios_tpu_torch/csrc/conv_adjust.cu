// The convective adjustment of a column in one launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: helios_tpu/rce/convect.py has no pallas_call.
// It fuses the chain of PyTorch ops of
// helios_tpu_torch.rce.convect.plain_adjustment (the reference's
// host_functions.py:337-635), which on the card ran ~780 launches per
// adjustment of 4 rounds (zone search, segment sums, powers, gathers and
// wheres over [L+1] columns) and ~15 ordered_sum launches, each on a few
// hundred bytes: its time was the launches' latency, not their work.
//
// What it computes, for each member p of a batch (a planet is P = 1), on
// its column of L layers and the ghost layer at index L (arrays [n, P],
// element (k, p) at k * P + p):
//   the entry check (conv_check, pert +1e-6) and, while the member runs
//   (members[p]) and is unstable, up to `rounds` rounds of: the marks
//   (mark_convective_layers, pert -1e-6, no stitching) ORed with the
//   check's flags, the zones (find_zones), the adiabat factors
//   (_adiabat_factors, with the global prefix sum of log a and its
//   subtraction, as there), the enthalpy-weighted sums of each zone and
//   the new temperatures (conv_correct), and the re-check;
//   then the final correction on every member: the marks with hole
//   stitching when `stitch` (past iteration 5000), the check, the zones,
//   the fudge factors (fudge_factors: dampara 0.5 / 4 by zone with a
//   star, 8 without, or the user's value, by `damp_mode` 0 / 1 / 2) and
//   conv_correct with them.
// An input the members share may come as one column ([n], an expanded
// view with member stride 0): its bit in `shared` (enum Arg) says so.
// Outputs: t_round [L+1, P], the temperatures after the rounds (what a
// host loop of one round per launch continues from); t_out [L+1, P] and
// conv_out [L+1, P], the adjusted temperatures and the final marks;
// needed, the most rounds a member ran; unstable, whether a running
// member was still unstable after `rounds` rounds (its result is then
// not the adjustment's).  A round after stability changes no bit, so a
// member that stops early ends as after `rounds` unrolled rounds.
//
// Bit for bit the chain, in fp64 and fp32: the same expressions in the
// same order, every product, quotient, sum and difference rounded on its
// own (__dmul_rn, __ddiv_rn, ...: nvcc would contract a * b + c into an
// fma), ::pow, ::log and ::exp as torch's CUDA kernels call them, Python
// scalars rounded to T as torch casts them, and each zone's sums in index
// order from +0.0.  The molar masses come in units of AMU (mmm_amu), the
// chain's own quotient mmm / AMU, which the caller takes with torch: how
// torch divides by a Python scalar is its own (in fp32 neither the
// product with 1 / AMU nor the true quotient).  The chain sums through
// the other zones' masked +0.0 values, which change no bit of a sum that
// starts at +0.0 and never reaches -0.0, so only the zone's own layers
// are added here.
//
// Layout: one block per member; the column and its scratch (flags, zones,
// weights, factors, per-zone sums) in shared memory, about 11 KB at L =
// 105 in fp64.  Threads across layers do the elementwise parts; one
// thread each runs the index-ordered scans (the prefix sum of log a, the
// zone search, the stitching's nearest marks), one thread per zone its
// two sums.
//
// Bound: the launch's latency and its chains of dependent adds, pow, log
// and exp, not bytes or operations: a column is 11 arrays of L + 1 values
// (9.3 KB in fp64) and a round a few thousand pows and logs.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdio>

namespace {

constexpr int kThreads = 128;
// the reference's constants (helios_tpu_torch.rce.convect): the pressure
// above which the check ignores the top, 1 / e (Python's 1.0 / math.e),
// and the checks' relative perturbation of kappa
constexpr double kPTopIgnore = 1e1;
constexpr double kGapRatio = 1.0 / 2.718281828459045;
constexpr double kPert = 1e-6;
constexpr int kNone = INT_MIN;
// the dynamic shared memory a block may use on an H100
constexpr size_t kMaxShared = 232448;

char g_detail[256];

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
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}

// Element (i, p) of the input `arg` (its bit in `shared`: one column
// that the members share) of a member's [n, P] arrays.
__device__ __forceinline__ long long at(int shared, int arg, int i, int P,
                                        int p) {
  return (shared >> arg & 1) ? i : static_cast<long long>(i) * P + p;
}

// the inputs' bits in `shared`, in the entry points' order
enum Arg { kPLay, kPInt, kKappaLay, kKappaInt, kCp, kMmm, kFah, kFss, kFdt,
           kFut };

__host__ __device__ constexpr size_t round_up(size_t n, size_t m) {
  return (n + m - 1) / m * m;
}

// Bytes of shared memory a block takes at L layers: 10 arrays of T, 5 of
// int and 3 of flags, each of up to L + 2 entries.
template <typename T>
__host__ __device__ constexpr size_t shared_bytes(int L) {
  return round_up(10 * sizeof(T) * (L + 2), 16) +
         round_up(5 * sizeof(int) * (L + 2) + 2 * sizeof(int), 16) +
         3 * static_cast<size_t>(L + 2);
}

// One member's column in shared memory.
template <typename T>
struct Column {
  int L;
  T* t;      // [L+1] temperatures
  T* pl;     // [L]   p_lay
  T* pi;     // [L+1] p_int
  T* kl;     // [L]   kappa_lay
  T* ki;     // [L+1] kappa_int
  T* w;      // [L]   enthalpy weights
  T* lb;     // [L]   log b
  T* csp;    // [L]   prefix sums of log a before each layer
  T* fac;    // [L]   adiabat factors (log a before the rounds)
  T* mp;     // [L+1] per zone: fudge factor, then mean potential T
  int* zol;  // [L]   zone of each layer, -1 radiative
  int* zs;   // [L+2] zone starts (-1: the ghost), zs[nz] = -2
  int* ze;   // [L+1] zone ends
  int* lo;   // [L+1] scratch: nearest mark below, wide gaps
  int* hi;   // [L+1] scratch: nearest mark above
  int* nz;   // [1]   zones
  unsigned char* u;   // [L+1] conv_check's flags
  unsigned char* c;   // [L+1] marks, then corrected
  unsigned char* pr;  // [L]   pair flags, the surface's at L-1
};

template <typename T>
__device__ Column<T> carve(unsigned char* smem, int L) {
  Column<T> k;
  k.L = L;
  T* f = reinterpret_cast<T*>(smem);
  const int n = L + 2;
  T** arrays[] = {&k.t, &k.pl, &k.pi, &k.kl, &k.ki,
                  &k.w, &k.lb, &k.csp, &k.fac, &k.mp};
  for (int a = 0; a < 10; ++a) *arrays[a] = f + a * n;
  int* g = reinterpret_cast<int*>(smem + round_up(10 * sizeof(T) * n, 16));
  int** ints[] = {&k.zol, &k.zs, &k.ze, &k.lo, &k.hi};
  for (int a = 0; a < 5; ++a) *ints[a] = g + a * n;
  k.nz = g + 5 * n;
  unsigned char* b = reinterpret_cast<unsigned char*>(g) +
                     round_up(5 * sizeof(int) * n + 2 * sizeof(int), 16);
  k.u = b;
  k.c = b + n;
  k.pr = b + 2 * n;
  return k;
}

// _pair_unstable and _surface_unstable with kappa times c = 1 + pert:
// pr[i], i < L-1, is layer i+1 colder than the adiabat through layer i
// (and p_lay[i] above 10 ubar); pr[L-1] the surface's flag.
template <typename T>
__device__ void pairs(const Column<T>& k, T c) {
  const int L = k.L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    if (i < L - 1) {
      const T between = mul_rn(
          k.t[i], ::pow(div_rn(k.pi[i + 1], k.pl[i]), mul_rn(k.kl[i], c)));
      const T ad = mul_rn(between, ::pow(div_rn(k.pl[i + 1], k.pi[i + 1]),
                                         mul_rn(k.ki[i + 1], c)));
      k.pr[i] = (k.t[i + 1] < ad) && (k.pl[i] > T(kPTopIgnore));
    } else {
      const T ad = mul_rn(
          k.t[L], ::pow(div_rn(k.pl[0], k.pi[0]), mul_rn(k.ki[0], c)));
      k.pr[i] = k.t[0] < ad;
    }
  }
  __syncthreads();
}

// conv_check into u; whether any layer is unstable.
template <typename T>
__device__ bool check(const Column<T>& k) {
  const int L = k.L;
  pairs(k, T(1.0 + kPert));
  const bool surf = k.pr[L - 1];
  bool any = false;
  for (int i = threadIdx.x; i <= L; i += blockDim.x) {
    bool v = surf;
    if (i < L) {
      v = (i < L - 1 && k.pr[i]) || (i >= 1 && k.pr[i - 1]) ||
          (i == 0 && surf);
    }
    k.u[i] = v;
    any = any || v;
  }
  return __syncthreads_or(any);
}

// mark_convective_layers into c, without the stitching: pairs of pert
// -1e-6, the kink removal below the top layer, the surface.
template <typename T>
__device__ void mark(const Column<T>& k) {
  const int L = k.L;
  pairs(k, T(1.0 + -kPert));
  const bool surf = k.pr[L - 1];
  for (int i = threadIdx.x; i <= L; i += blockDim.x) {
    bool v = surf;
    if (i < L) {
      v = (i < L - 1 && k.pr[i]) || (i >= 1 && k.pr[i - 1]);
      if (i < L - 1) v = v && !(k.t[i + 1] > k.t[i]);
      if (i == 0) v = v || surf;
    }
    k.c[i] = v;
  }
  __syncthreads();
}

// stitch_zone_holes on c: a radiative layer with a mark below (or the
// ghost's) and above, and p_lay[above] / p_bottom > 1/e, is marked.
template <typename T>
__device__ void stitch(const Column<T>& k) {
  const int L = k.L;
  if (threadIdx.x == 0) {
    int run = k.c[L] ? -1 : kNone;
    for (int i = 0; i < L; ++i) {
      if (k.c[i]) run = i;
      k.lo[i] = run;
    }
  }
  if (threadIdx.x == blockDim.x - 1) {
    int run = kNone;
    for (int i = L - 1; i >= 0; --i) {
      if (k.c[i]) run = i;
      k.hi[i] = run;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const int below = k.lo[i], above = k.hi[i];
    if (!k.c[i] && below != kNone && above != kNone) {
      const T bottom = below >= 0 ? k.pl[below] : k.pi[0];
      if (div_rn(k.pl[above], bottom) > T(kGapRatio)) k.c[i] = 1;
    }
  }
  __syncthreads();
}

// c |= u: the corrected flags.
template <typename T>
__device__ void corrected(const Column<T>& k) {
  for (int i = threadIdx.x; i <= k.L; i += blockDim.x)
    k.c[i] = k.c[i] || k.u[i];
  __syncthreads();
}

// find_zones over c in the extended order (ghost first, then layers
// 0..L-1): starts, ends, each layer's zone, the count.
template <typename T>
__device__ void zones(const Column<T>& k) {
  const int L = k.L;
  if (threadIdx.x == 0) {
    int nz = 0, cur = -1;
    bool prev = false;
    for (int j = 0; j <= L; ++j) {
      const bool e = j == 0 ? k.c[L] : k.c[j - 1];
      if (e && !prev) {
        cur = nz++;
        k.zs[cur] = j - 1;
      }
      if (e) k.ze[cur] = j - 1;
      if (j > 0) k.zol[j - 1] = e ? cur : -1;
      prev = e;
    }
    k.zs[nz] = -2;
    k.nz[0] = nz;
  }
  __syncthreads();
}

// conv_correct on the zones: the adiabat factors, each zone's weighted
// sums of T and of the factors in index order, its mean potential
// temperature (times mp[z], its fudge factor, with `fudged`), and the new
// temperatures of the zones' layers and of the ghost in zone 0.
template <typename T>
__device__ void correct(const Column<T>& k, bool fudged) {
  const int L = k.L, nz = k.nz[0];
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const int z = k.zol[i];
    if (z < 0) continue;
    const int s = max(k.zs[z], 0);
    const T seg = i > s ? sub_rn(k.csp[i], k.csp[s]) : T(0);
    k.fac[i] = ::exp(add_rn(k.lb[i], seg));
  }
  __syncthreads();
  for (int z = threadIdx.x; z < nz; z += blockDim.x) {
    T num = T(0), den = T(0);
    for (int i = max(k.zs[z], 0); i <= k.ze[z]; ++i) {
      num = add_rn(num, mul_rn(k.w[i], k.t[i]));
      den = add_rn(den, mul_rn(k.w[i], k.fac[i]));
    }
    T mean = den != T(0) ? div_rn(num, den) : T(0);
    if (fudged) mean = mul_rn(mean, k.mp[z]);
    k.mp[z] = mean;
  }
  __syncthreads();
  for (int i = threadIdx.x; i <= L; i += blockDim.x) {
    if (i < L) {
      const int z = k.zol[i];
      if (z >= 0) k.t[i] = mul_rn(k.mp[z], k.fac[i]);
    } else if (k.c[L]) {
      k.t[L] = k.mp[0];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ long long floor_div2(long long a) {
  return a >= 0 ? a / 2 : -((1 - a) / 2);
}

// fudge_factors into mp[z] for the zones z < nz: the test interface in
// the middle of the first gap above zone z's zones wider than a scale
// height, else at int(0.8 end_last + 0.2 L); the flux balance there to
// the power 1/dampara, clamped to [0.99, 1.01].
template <typename T>
__device__ void fudge(const Column<T>& k, int P, int p, int shared,
                      const T* fah, const T* fss, const T* fdt, const T* fut,
                      int mode, T damp, T fint) {
  const int L = k.L, nz = k.nz[0], last = nz - 1;
  for (int z = threadIdx.x; z < nz; z += blockDim.x) {
    const T bottom = k.ze[z] >= 0 ? k.pl[k.ze[z]] : k.pi[0];
    const T top = k.pl[min(max(k.zs[z + 1], 0), L - 1)];
    k.lo[z] = div_rn(top, bottom) < T(kGapRatio) && z < last;
  }
  __syncthreads();
  for (int z = threadIdx.x; z < nz; z += blockDim.x) {
    int first = -1;
    for (int y = z; y < last && first < 0; ++y)
      if (k.lo[y]) first = y;
    long long itf;
    if (first >= 0) {
      itf = floor_div2(static_cast<long long>(k.ze[first]) +
                       k.zs[first + 1] + 1);
    } else {
      itf = static_cast<long long>(
          add_rn(mul_rn(T(0.8), static_cast<T>(k.ze[last])),
                 static_cast<T>(0.2 * static_cast<double>(L))));
    }
    itf = min(max(itf, 1LL), static_cast<long long>(L));
    const T dampara = mode == 0 ? (z < last ? T(0.5) : T(4.0))
                      : mode == 1 ? T(8.0) : damp;
    const int lo = static_cast<int>(itf) - 1, hi = static_cast<int>(itf);
    T x = add_rn(fint, fah[at(shared, kFah, lo, P, p)]);
    x = add_rn(x, fss[at(shared, kFss, lo, P, p)]);
    x = add_rn(x, fdt[at(shared, kFdt, hi, P, p)]);
    x = div_rn(x, fut[at(shared, kFut, hi, P, p)]);
    // torch.clamp: a NaN stays NaN, as both comparisons leave it
    T f = ::pow(x, div_rn(T(1), dampara));
    if (f < T(0.99)) f = T(0.99);
    if (f > T(1.01)) f = T(1.01);
    k.mp[z] = f;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_adjust_kernel(const T* __restrict__ t_in, const T* __restrict__ p_lay,
                   const T* __restrict__ p_int, const T* __restrict__ kappa_lay,
                   const T* __restrict__ kappa_int, const T* __restrict__ c_p,
                   const T* __restrict__ mmm_amu, const T* __restrict__ fah,
                   const T* __restrict__ fss, const T* __restrict__ fdt,
                   const T* __restrict__ fut,
                   const bool* __restrict__ members, T* __restrict__ t_round,
                   T* __restrict__ t_out, bool* __restrict__ conv_out,
                   unsigned long long* __restrict__ needed,
                   bool* __restrict__ unstable, int L, int P, int rounds,
                   int stitching, int mode, int shared, T fint, T damp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Column<T> k = carve<T>(smem, L);
  const int p = blockIdx.x;
  for (int i = threadIdx.x; i <= L; i += blockDim.x) {
    k.t[i] = t_in[static_cast<long long>(i) * P + p];
    k.pi[i] = p_int[at(shared, kPInt, i, P, p)];
    k.ki[i] = kappa_int[at(shared, kKappaInt, i, P, p)];
    if (i < L) {
      k.pl[i] = p_lay[at(shared, kPLay, i, P, p)];
      k.kl[i] = kappa_lay[at(shared, kKappaLay, i, P, p)];
    }
  }
  __syncthreads();
  // what no round changes: the enthalpy weights
  // c_p / (mmm / AMU) * ((p_int[i] - p_int[i+1]) / p_int[0]), log b and
  // log a (in fac), then the prefix sums of log a
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    k.w[i] = mul_rn(div_rn(c_p[at(shared, kCp, i, P, p)],
                           mmm_amu[at(shared, kMmm, i, P, p)]),
                    div_rn(sub_rn(k.pi[i], k.pi[i + 1]), k.pi[0]));
    const T b = mul_rn(k.ki[i], ::log(div_rn(k.pl[i], k.pi[i])));
    k.lb[i] = b;
    k.fac[i] = add_rn(b, mul_rn(k.kl[i], ::log(div_rn(k.pi[i + 1],
                                                      k.pl[i]))));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T acc = T(0);
    k.csp[0] = T(0);
    for (int i = 1; i < L; ++i) {
      acc = add_rn(acc, k.fac[i - 1]);
      k.csp[i] = acc;
    }
  }
  // (check's first barrier orders the scan before any round)
  bool active = check(k) && members[p];
  int r = 0;
  for (; r < rounds && active; ++r) {
    mark(k);
    corrected(k);
    zones(k);
    correct(k, false);
    active = check(k);
  }
  for (int i = threadIdx.x; i <= L; i += blockDim.x)
    t_round[static_cast<long long>(i) * P + p] = k.t[i];
  if (threadIdx.x == 0) {
    if (r > 0) atomicMax(needed, static_cast<unsigned long long>(r));
    if (active) *unstable = true;
  }
  // the final correction, on every member
  mark(k);
  if (stitching) stitch(k);
  for (int i = threadIdx.x; i <= L; i += blockDim.x)
    conv_out[static_cast<long long>(i) * P + p] = k.c[i];
  __syncthreads();
  corrected(k);
  zones(k);
  fudge(k, P, p, shared, fah, fss, fdt, fut, mode, damp, fint);
  correct(k, true);
  for (int i = threadIdx.x; i <= L; i += blockDim.x)
    t_out[static_cast<long long>(i) * P + p] = k.t[i];
}

template <typename T>
int launch(const T* t_in, const T* p_lay, const T* p_int, const T* kappa_lay,
           const T* kappa_int, const T* c_p, const T* mmm_amu, const T* fah,
           const T* fss, const T* fdt, const T* fut, const bool* members,
           T* t_round, T* t_out, bool* conv_out, long long* needed,
           bool* unstable, int L, int P, int rounds, int stitching, int mode,
           int shared, double F_intern, double dampara, void* stream) {
  g_detail[0] = '\0';
  const size_t bytes = shared_bytes<T>(L);
  if (L < 1 || P < 1 || rounds < 1 || mode < 0 || mode > 2 ||
      shared < 0 || shared >= 1 << (kFut + 1) || bytes > kMaxShared) {
    snprintf(g_detail, sizeof g_detail,
             "L = %d, P = %d, rounds = %d, mode = %d, shared = %d: the column "
             "needs %zu bytes of shared memory, at most %zu (L <= %d)",
             L, P, rounds, mode, shared, bytes, kMaxShared,
             static_cast<int>(kMaxShared / (10 * sizeof(T) + 20 + 3)) - 3);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        conv_adjust_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(needed, 0, sizeof(long long), s);
  if (rc == cudaSuccess) rc = cudaMemsetAsync(unstable, 0, sizeof(bool), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  conv_adjust_kernel<T><<<P, kThreads, bytes, s>>>(
      t_in, p_lay, p_int, kappa_lay, kappa_int, c_p, mmm_amu, fah, fss, fdt,
      fut,
      members, t_round, t_out, conv_out,
      reinterpret_cast<unsigned long long*>(needed), unstable, L, P, rounds,
      stitching, mode, shared, static_cast<T>(F_intern),
      static_cast<T>(dampara));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes.  They zero `needed` and
// `unstable`, launch on the given stream without synchronising and return
// the first CUDA error (helios_launch_error_detail says why a shape was
// refused).
extern "C" {

int conv_adjust_f64(const double* t_in, const double* p_lay,
                    const double* p_int, const double* kappa_lay,
                    const double* kappa_int, const double* c_p,
                    const double* mmm_amu, const double* fah,
                    const double* fss,
                    const double* fdt, const double* fut, const bool* members,
                    double* t_round, double* t_out, bool* conv_out,
                    long long* needed, bool* unstable, int L, int P,
                    int rounds, int stitching, int mode, int shared,
                    double F_intern, double dampara, void* stream) {
  return launch<double>(t_in, p_lay, p_int, kappa_lay, kappa_int, c_p, mmm_amu,
                        fah, fss, fdt, fut, members, t_round, t_out, conv_out,
                        needed, unstable, L, P, rounds, stitching, mode,
                        shared, F_intern, dampara, stream);
}

int conv_adjust_f32(const float* t_in, const float* p_lay, const float* p_int,
                    const float* kappa_lay, const float* kappa_int,
                    const float* c_p, const float* mmm_amu, const float* fah,
                    const float* fss, const float* fdt, const float* fut,
                    const bool* members, float* t_round, float* t_out,
                    bool* conv_out, long long* needed, bool* unstable, int L,
                    int P, int rounds, int stitching, int mode, int shared,
                    double F_intern, double dampara, void* stream) {
  return launch<float>(t_in, p_lay, p_int, kappa_lay, kappa_int, c_p, mmm_amu,
                       fah, fss, fdt, fut, members, t_round, t_out, conv_out,
                       needed, unstable, L, P, rounds, stitching, mode,
                       shared, F_intern, dampara, stream);
}

const char* helios_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* helios_launch_error_detail() { return g_detail; }

}  // extern "C"
