// Random Overlap opacity mixing for Hopper (sm_90a).
//
// Replaces the Pallas kernel of the JAX package
//   helios_tpu/kernels/ro_pallas.py:225  _ro_kernel  (fp64 as two-float32
//                                        pairs, int32 sort keys)
// with one template instantiated for float and double.  It computes what
// helios_tpu_torch.kernels.ro.ro_mix_reference computes: per cell c (a
// layer-bin pair) of two ny-point k-distributions m = mixed[c], n = new[c]
// (HELIOS reference add_to_mixed_opac, kernels.cu:3263-3399):
//   * if 0.01 m[0] > n[ny-1] or 0.01 n[0] > m[ny-1] (negligible overlap):
//       out = m + n;
//   * else Random Overlap: the ny^2 sums m[i] + n[j] with the weights
//     (w_i/2)(w_j/2), sorted ascending (stable: ties in the order of the
//     flat index i*ny + j); yg = cumsum(weight) - weight/2, the sum taken
//     in that order; for each Gauss node g_y, first_y = #(yg <= g_y) and
//     the interval index
//       w_y = clip(max(first_y, w_{y-1} + 1), 1, ny^2 - 1);
//     out[y] = (k[w-1] (yg[w] - g_y) + k[w] (g_y - yg[w-1]))
//              / (yg[w] - yg[w-1]),
//     products and sums not contracted into fma.
// The result equals the plain version bit for bit, on every input.
//
// Design: one thread per cell, streaming.  When n is non-decreasing (and
// m, n are finite), row i of the sums, m[i] + n[j] over j, is
// non-decreasing too, because rounding is monotone.  A merge of the ny rows
// that pops the least (key, row) each time therefore yields exactly the
// stable order: within a row the pops come in j order, and a tie across
// rows goes to the smaller i, which has the smaller flat index.  The merge
// is a loser tree of ny leaves (heap order, node q's children 2q and 2q+1,
// leaf i at q = ny + i): each internal node keeps the (key, tag) that lost
// its match, with tag = i << 8 | j, or (i + ny) << 8 once row i is used
// up, so that a used-up row sorts after every live one even at key +inf.
// Keys are compared as order-preserving unsigned integers (-0 and +0 map
// alike, as they compare equal); in fp32 the key and the tag share one
// 64-bit word, so one unsigned comparison orders them.  A pop loads the
// nodes of its leaf's path at once, runs the comparisons as one chain of
// selects and writes the nodes that changed after it.  Everything after
// the sort runs in the same pass, as the sums come out in order: the
// weight sum (in the plain version's order), yg, the rebin recurrence and
// the interpolation.  Node y's w_y is known when the stream first passes
// g_y (first_y is then the current position t, and w_y = min(max(t,
// w_{y-1} + 1), ny^2 - 1) >= t); the nodes known but not yet reached form
// a queue whose w values are consecutive, w_head, w_head + 1, ... (capped
// at ny^2 - 1), because each was known at a position no later than its
// predecessor's w.  So the thread keeps the previous (key, yg), the head
// of the queue and the last w, and writes node y when the stream reaches
// w_y; at the last position every node still unknown has first_y = ny^2,
// so w = ny^2 - 1, the end of the stream.  No array of ny^2 entries is
// stored and no ny^3 count is made.
//
// Why the stream's first_y is #(yg <= g_y): the Gauss nodes are
// non-decreasing (checked once per launch, with every half-weight positive
// and finite), and yg is non-decreasing along the stream.  With a the
// running sum before position t, w = weight(t) and u = weight(t-1),
// yg[t] = fl(fl(a + w) - w/2) and yg[t-1] = fl(a - u/2); rounding is
// monotone, so yg[t] >= yg[t-1] whenever fl(a + w) - w/2 >= a - u/2, which
// only the rounding of a + w (and of the halving, below twice the smallest
// normal) can break.  No bound on the weights is taken to exclude that (a
// launch-wide one, least weight >= 4 eps (sum of half-weights)^2, failed
// Gauss-Legendre weights in fp32 above ny = 86 and sent every live cell to
// the general branch): the stream itself checks at each position that yg
// did not decrease, and a cell where it did goes to the general branch,
// which overwrites all its nodes.
//
// An exact general branch covers every other input: a cell whose n is not
// non-decreasing or whose m or n is not finite, a cell whose stream saw yg
// decrease, or a launch whose weights fail the check.  After its streaming lanes are done, the warp takes such
// cells one at a time, all 32 lanes on one cell, in the streaming scratch
// (the warp's tree region becomes the sort's permutation of 16-bit flat
// indices): each lane ranks flat indices against all others in (key,
// index) order, NaN after every number as torch.sort puts it; then every
// lane runs the weight sum along the permutation and counts #(yg <= g_y)
// for its nodes (y = lane + 32 k), the w recurrence runs on shuffled
// counts, and a second run of the sum picks up yg at w-1 and w.  It costs
// O(ny^4 / 32) per cell, slow but never taken by the tables' cells: the
// on-the-fly workload of chip_smoke.py sends none there (it counts them).
//
// Built for this card: the per-thread arrays (the tree's nodes, the cell's
// m and n, its ny outputs) lie [slot][lane] within the warp's region, so
// data-dependent slot indices never conflict on a bank; the block's
// [cells, ny] rows of mixed and new are staged into those arrays by
// coalesced cp.async copies of single values, and out is written back
// coalesced from the output slots.  Shared memory holds the half-weights
// (read at every pop); the Gauss nodes are read from L1, each one use
// ahead of need, so that no lane's rare rebin step waits on them.  Blocks
// of 64 cells take 45,472 B in fp64 at ny = 20 (25,168 B in fp32): five
// (eight) blocks to an SM, so the 632 blocks of 40425 cells run in one
// wave on 132 SMs (at 45,632 B, four fit, and the second wave doubled the
// time).  No tensor cores: there is no matrix product.
//
// Bound.  Bytes: mixed, new and out at [C, ny], 3 C ny values: 19.4 MB in
// fp64 at C = 40425 layer-bin cells, ny = 20 (5.8 us at the data-sheet
// 3.35 TB/s).  Operations per non-negligible cell: the ny^2 sums, a merge
// of ny sorted runs (ny^2 log2 ny comparisons), the ny^2 weight products,
// the ny^2 scan additions and the ny^2 half-weight subtractions; ny
// additions per negligible cell.  At ny = 20 that is 3329 per cell, 4.0 us
// for 40425 cells at the data-sheet 34 TFLOP/s fp64: the bytes bound it.
// What sets this design's time instead is one thread's chain of ny^2 = 400
// dependent pops: on an H100 a lone cell's stream takes ~0.13 ms in fp64
// (~640 cycles a pop), and all 40425 cells in one wave ~0.19 ms
// (scripts/torch_ring_tuning.py --ro-cells); the replay's shared-memory
// loads and stores are most of a pop.
//
// ny runs from 2 to 126: a warp's tree region (32 (ny-1) (sizeof(T) + 4)
// bytes) must hold the general branch's 2 ny^2 bytes of permutation, which
// holds for fp32 up to ny = 126; tags keep j in 8 bits.

#include <cuda_runtime.h>

#include "column_ring.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kMaxNy = 126;
constexpr int kNodesPerLane = (kMaxNy + kWarp - 1) / kWarp;
constexpr int kTagBits = 8;
// warps (cells / 32) per block where they fit
constexpr int kBlockWarps = 2;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Limits;
template <>
struct Limits<double> {
  static __device__ __forceinline__ double inf() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
};
template <>
struct Limits<float> {
  static __device__ __forceinline__ float inf() {
    return __int_as_float(0x7f800000);
  }
};

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

// the plain version's interpolation at node g between two stream entries
template <typename T>
__device__ __forceinline__ T interpolate(T k_lo, T yg_lo, T k_hi, T yg_hi,
                                         T g) {
  return add_rn(mul_rn(k_lo, yg_hi - g), mul_rn(k_hi, g - yg_lo)) /
         (yg_hi - yg_lo);
}

// (ka, a) before (kb, b) in torch.sort's stable ascending order: NaN after
// every number, ties (and NaNs) in index order
template <typename T>
__device__ __forceinline__ bool sorts_before(T ka, int a, T kb, int b) {
  const bool na = ka != ka, nb = kb != kb;
  if (na || nb) return !na || (nb && a < b);
  return ka < kb || (ka == kb && a < b);
}

// Order-preserving unsigned images of non-NaN keys: unsigned order is the
// floating-point order, and -0 and +0 map alike (x + 0 turns -0 into +0),
// so that the tree compares integers and agrees with torch.sort.
__device__ __forceinline__ unsigned long long ordered(double x) {
  const unsigned long long u = __double_as_longlong(x + 0.0);
  return u ^ (static_cast<unsigned long long>(
                  static_cast<long long>(u) >> 63) | (1ull << 63));
}
__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned u = __float_as_uint(x + 0.0f);
  return u ^ (static_cast<unsigned>(static_cast<int>(u) >> 31) | (1u << 31));
}

// The loser tree's entries (ordered key, tag), [slot][lane] at one lane,
// node q in slot q - 1.  fp64: the 64-bit key and the tag in two arrays,
// 12 bytes a node; fp32: key << 32 | tag in one 64-bit word, so that one
// unsigned comparison orders (key, tag).
template <typename T>
struct Tree;
template <>
struct Tree<double> {
  static constexpr int kNodeBytes = 12;
  struct Entry {
    unsigned long long key;
    int tag;
  };
  unsigned long long* key;
  int* tag;
  __device__ Tree(unsigned char* region, int ny, int lane)
      : key(reinterpret_cast<unsigned long long*>(region) + lane),
        tag(reinterpret_cast<int*>(reinterpret_cast<unsigned long long*>(
                region) + (ny - 1) * kWarp) + lane) {}
  static __device__ Entry make(double k, int t) { return {ordered(k), t}; }
  static __device__ Entry sentinel() { return {~0ull, 0x7fffffff}; }
  static __device__ int tag_of(Entry e) { return e.tag; }
  static __device__ bool before(Entry a, Entry b) {
    return (a.key < b.key) | ((a.key == b.key) & (a.tag < b.tag));
  }
  __device__ Entry load(int slot) const {
    return {key[slot * kWarp], tag[slot * kWarp]};
  }
  __device__ void store(int slot, Entry e) const {
    key[slot * kWarp] = e.key;
    tag[slot * kWarp] = e.tag;
  }
};
template <>
struct Tree<float> {
  static constexpr int kNodeBytes = 8;
  using Entry = unsigned long long;
  unsigned long long* word;
  __device__ Tree(unsigned char* region, int, int lane)
      : word(reinterpret_cast<unsigned long long*>(region) + lane) {}
  static __device__ Entry make(float k, int t) {
    return static_cast<unsigned long long>(ordered(k)) << 32 |
           static_cast<unsigned>(t);
  }
  static __device__ Entry sentinel() { return ~0ull; }
  static __device__ int tag_of(Entry e) { return static_cast<int>(e); }
  static __device__ bool before(Entry a, Entry b) { return a < b; }
  __device__ Entry load(int slot) const { return word[slot * kWarp]; }
  __device__ void store(int slot, Entry e) const { word[slot * kWarp] = e; }
};

// The block's table of half-weights at the start of its shared memory,
// padded so that the warps' regions after it stay 16-byte aligned
template <typename T>
__host__ __device__ size_t table_bytes(int ny) {
  return (ny * sizeof(T) + 15) / 16 * 16;
}

// A warp's region of shared memory, every array [slot][lane]: the loser
// tree's ny-1 nodes, then the cell's m, n and outputs.
template <typename T>
struct WarpArrays {
  unsigned char* tree;
  T* m;
  T* n;
  T* out;

  static __host__ __device__ size_t bytes(int ny) {
    return static_cast<size_t>(kWarp) *
           ((ny - 1) * Tree<T>::kNodeBytes + 3 * ny * sizeof(T));
  }
  __device__ WarpArrays(unsigned char* base, int ny) {
    tree = base;
    m = reinterpret_cast<T*>(base + static_cast<size_t>(kWarp) * (ny - 1) *
                                        Tree<T>::kNodeBytes);
    n = m + ny * kWarp;
    out = n + ny * kWarp;
  }
};

// The streaming merge of one cell (this thread's), for a loser tree whose
// leaves lie at most Depth levels below the root.  M, N, O point at the
// thread's lane of its warp's m, n and outputs (slot stride kWarp).  Every
// level of a leaf's path but the last holds a node (ny > 2^(Depth-1)), so
// only the last is checked.  Returns false if yg decreased somewhere along
// the stream (the outputs are then not the cell's).
template <typename T, int Depth>
__device__ bool stream_cell(const Tree<T>& tree, const T* M, const T* N,
                            T* O, const T* hw, const T* gy, int ny) {
  using Entry = typename Tree<T>::Entry;
  const int n2 = ny * ny;
  const T inf = Limits<T>::inf();
  // the winner of node c's subtree during the build (c >= ny: a leaf,
  // row c - ny at column 0)
  auto entry = [&](int c) {
    return c >= ny ? Tree<T>::make(M[(c - ny) * kWarp] + N[0],
                                   (c - ny) << kTagBits)
                   : tree.load(c - 1);
  };
  // build: each node's winner bottom-up, then each node's loser top-down
  // (a node's children still hold their winners when it is visited)
  for (int q = ny - 1; q >= 1; --q) {
    const Entry l = entry(2 * q), r = entry(2 * q + 1);
    tree.store(q - 1, Tree<T>::before(r, l) ? r : l);
  }
  Entry win = tree.load(0);
  for (int q = 1; q < ny; ++q) {
    const Entry l = entry(2 * q), r = entry(2 * q + 1);
    tree.store(q - 1, Tree<T>::before(r, l) ? l : r);
  }

  T acc = T(0), pk = T(0), pyg = T(0);
  bool rising = true;  // yg never decreased (NaN fails)
  int y_next = 0;  // the first node whose w is not known yet
  int y_out = 0;   // the first node not written yet
  int w_last = 0;  // w of node y_next - 1 (0 before node 0)
  int w_head = 0;  // w of node y_out, while y_out < y_next
  // the Gauss nodes come from L1, each loaded one use ahead: g_next (the
  // first node not known) and g_out (the first node not written)
  T g_next = __ldg(gy), g_next1 = __ldg(gy + 1);
  T g_out = g_next, g_out1 = g_next1;
  for (int t = 0; t < n2; ++t) {
    // the popped entry: row r, column j.  Every load of this pop is
    // issued first: the row's next entry, the replay path, the weights
    const int wt = Tree<T>::tag_of(win);
    const int r = wt >> kTagBits;
    const int j = wt & ((1 << kTagBits) - 1);
    const int j1 = j + 1;
    const int leaf_q = ny + r;
    const T m_r = M[r * kWarp];
    const T n_next = N[min(j1, ny - 1) * kWarp];
    Entry path[Depth];
#pragma unroll
    for (int d = 0; d < Depth - 1; ++d)
      path[d] = tree.load((leaf_q >> (d + 1)) - 1);
    const int q_top = leaf_q >> Depth;  // 0 for a leaf one level higher
    path[Depth - 1] = q_top >= 1 ? tree.load(q_top - 1) : Tree<T>::sentinel();
    const T k = m_r + N[j * kWarp];
    const T h_r = hw[r], h_j = hw[j];

    // the replay, the chain that carries the stream: row r's next entry
    // (or +inf with a used-up tag) against the path's losers; the nodes
    // that change are written after the chain, off it
    Entry carry = Tree<T>::make(j1 < ny ? m_r + n_next : inf,
                                j1 < ny ? (r << kTagBits | j1)
                                        : (r + ny) << kTagBits);
    Entry put[Depth];
    bool swap[Depth];
#pragma unroll
    for (int d = 0; d < Depth; ++d) {
      swap[d] = Tree<T>::before(path[d], carry);
      put[d] = carry;
      carry = swap[d] ? path[d] : carry;
    }
#pragma unroll
    for (int d = 0; d < Depth; ++d)
      if (swap[d]) tree.store((leaf_q >> (d + 1)) - 1, put[d]);

    // off that chain: the popped entry's weight, running sum and yg, in
    // stream order, then the rebin
    const T wgt = mul_rn(h_r, h_j);
    acc = add_rn(acc, wgt);
    const T yg = acc - mul_rn(T(0.5), wgt);
    rising = rising && yg >= pyg;
    // nodes whose g the stream has passed (all of them at the end)
    while (y_next < ny && (yg > g_next || t == n2 - 1)) {
      w_last = min(max(t, w_last + 1), n2 - 1);
      if (y_next == y_out) w_head = w_last;
      ++y_next;
      g_next = g_next1;
      g_next1 = __ldg(gy + min(y_next + 1, ny - 1));
    }
    // nodes whose interval ends here
    while (y_out < y_next && w_head == t) {
      O[y_out * kWarp] = interpolate(pk, pyg, k, yg, g_out);
      ++y_out;
      g_out = g_out1;
      g_out1 = __ldg(gy + min(y_out + 1, ny - 1));
      w_head = min(w_head + 1, n2 - 1);
    }
    pk = k;
    pyg = yg;
    win = carry;
  }
  return rising;
}

// The general branch for the cell of lane `src`, run by the whole warp.
// W: the warp's arrays; `perm` overlays the warp's tree.  Output y goes to
// O[y * kWarp].
template <typename T>
__device__ void general_cell(const WarpArrays<T>& W, int src, int lane,
                             const T* hw, const T* gy, int ny, T* O) {
  const int n2 = ny * ny;
  const T* M = W.m + src;
  const T* N = W.n + src;
  unsigned short* perm = reinterpret_cast<unsigned short*>(W.tree);
  // the sorted order: perm[rank of t] = t
  for (int t0 = 0; t0 < n2; t0 += kWarp) {
    const int t = t0 + lane;
    const bool valid = t < n2;
    const int ti = valid ? t / ny : 0;
    const int tj = valid ? t - ti * ny : 0;
    const T kt = M[ti * kWarp] + N[tj * kWarp];
    int rank = 0;
    for (int s = 0, si = 0, sj = 0; s < n2; ++s) {
      rank += sorts_before(M[si * kWarp] + N[sj * kWarp], s, kt, t);
      if (++sj == ny) {
        sj = 0;
        ++si;
      }
    }
    if (valid) perm[rank] = static_cast<unsigned short>(t);
  }
  __syncwarp();

  // #(yg <= g_y) for this lane's nodes y = lane + 32 k
  T g[kNodesPerLane];
  int count[kNodesPerLane];
#pragma unroll
  for (int k = 0; k < kNodesPerLane; ++k) {
    const int y = lane + kWarp * k;
    g[k] = gy[min(y, ny - 1)];
    count[k] = 0;
  }
  T acc = T(0);
  for (int t = 0; t < n2; ++t) {
    const int id = perm[t];
    const int i = id / ny;
    const T wgt = mul_rn(hw[i], hw[id - i * ny]);
    acc = add_rn(acc, wgt);
    const T yg = acc - mul_rn(T(0.5), wgt);
#pragma unroll
    for (int k = 0; k < kNodesPerLane; ++k) count[k] += yg <= g[k];
  }
  // w_y = clip(max(first_y, w_{y-1} + 1), 1, n2 - 1), on shuffled counts
  int w[kNodesPerLane];
  int w_prev = 0;
  for (int y = 0; y < ny; ++y) {
    int c = count[0];
#pragma unroll
    for (int k = 1; k < kNodesPerLane; ++k) c = (y >> 5) == k ? count[k] : c;
    const int f = __shfl_sync(kFull, c, y & (kWarp - 1));
    const int wy = min(max(f, w_prev + 1), n2 - 1);
#pragma unroll
    for (int k = 0; k < kNodesPerLane; ++k)
      if (y == lane + kWarp * k) w[k] = wy;
    w_prev = wy;
  }
  // yg at w-1 and w, from a second run of the same sum
  T yg_lo[kNodesPerLane], yg_hi[kNodesPerLane];
  acc = T(0);
  for (int t = 0; t < n2; ++t) {
    const int id = perm[t];
    const int i = id / ny;
    const T wgt = mul_rn(hw[i], hw[id - i * ny]);
    acc = add_rn(acc, wgt);
    const T yg = acc - mul_rn(T(0.5), wgt);
#pragma unroll
    for (int k = 0; k < kNodesPerLane; ++k) {
      if (lane + kWarp * k < ny) {
        if (t == w[k] - 1) yg_lo[k] = yg;
        if (t == w[k]) yg_hi[k] = yg;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kNodesPerLane; ++k) {
    const int y = lane + kWarp * k;
    if (y < ny) {
      const int lo = perm[w[k] - 1], hi = perm[w[k]];
      const int il = lo / ny, ih = hi / ny;
      const T k_lo = M[il * kWarp] + N[(lo - il * ny) * kWarp];
      const T k_hi = M[ih * kWarp] + N[(hi - ih * ny) * kWarp];
      O[y * kWarp] = interpolate(k_lo, yg_lo[k], k_hi, yg_hi[k], g[k]);
    }
  }
  __syncwarp();  // perm is read before the next cell overwrites it
}

template <typename T, int Depth>
__global__ void __launch_bounds__(kBlockWarps * kWarp) ro_mix_kernel(const T* __restrict__ mixed,
                              const T* __restrict__ newo,
                              const T* __restrict__ gauss_w,
                              const T* __restrict__ gauss_y,
                              T* __restrict__ out, int C, int ny) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hw = reinterpret_cast<T*>(smem_raw);  // half-weights w/2
  const T* gy = gauss_y;                    // read through L1 (__ldg)
  unsigned char* warps0 = smem_raw + table_bytes<T>(ny);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const WarpArrays<T> W(
      warps0 + warp * WarpArrays<T>::bytes(ny), ny);

  // stage the block's rows [slot j][lane] and the Gauss tables
  const int c0 = blockIdx.x * blockDim.x;
  const int cells = min(static_cast<int>(blockDim.x), C - c0);
  const size_t g0 = static_cast<size_t>(c0) * ny;
  for (int e = threadIdx.x; e < cells * ny; e += blockDim.x) {
    const int c = e / ny;
    const int j = e - c * ny;
    const WarpArrays<T> D(
        warps0 + (c / kWarp) * WarpArrays<T>::bytes(ny), ny);
    helios::copy_async(D.m + j * kWarp + c % kWarp, mixed + g0 + e);
    helios::copy_async(D.n + j * kWarp + c % kWarp, newo + g0 + e);
  }
  helios::commit_group();
  for (int k = threadIdx.x; k < ny; k += blockDim.x)
    hw[k] = T(0.5) * gauss_w[k];
  helios::wait_group<0>();
  __syncthreads();

  // the launch's check for the stream (see the header), from the tables
  bool weights_ok = true;
  for (int k = 0; k < ny; ++k) {
    const T h = hw[k];
    weights_ok = weights_ok && h > T(0) && isfinite(h);
    if (k > 0) weights_ok = weights_ok && __ldg(gy + k - 1) <= __ldg(gy + k);
  }

  const T* M = W.m + lane;
  const T* N = W.n + lane;
  T* O = W.out + lane;
  bool general = false;
  if (threadIdx.x < cells) {
    if (T(0.01) * M[0] > N[(ny - 1) * kWarp] ||
        T(0.01) * N[0] > M[(ny - 1) * kWarp]) {
      for (int y = 0; y < ny; ++y)
        O[y * kWarp] = M[y * kWarp] + N[y * kWarp];
    } else {
      bool sorted = weights_ok;
      for (int j = 0; j < ny; ++j) {
        const T nj = N[j * kWarp];
        sorted = sorted && isfinite(M[j * kWarp]) && isfinite(nj) &&
                 (j == 0 || N[(j - 1) * kWarp] <= nj);
      }
      general = !(sorted &&
                  stream_cell<T, Depth>(Tree<T>(W.tree, ny, lane), M, N, O,
                                        hw, gy, ny));
    }
  }
  __syncwarp();
  for (unsigned pending = __ballot_sync(kFull, general); pending;
       pending &= pending - 1) {
    const int src = __ffs(pending) - 1;
    general_cell<T>(W, src, lane, hw, gy, ny, W.out + src);
  }
  __syncthreads();

  // write the block's outputs back, coalesced
  for (int e = threadIdx.x; e < cells * ny; e += blockDim.x) {
    const int c = e / ny;
    const int j = e - c * ny;
    const WarpArrays<T> D(
        warps0 + (c / kWarp) * WarpArrays<T>::bytes(ny), ny);
    out[g0 + e] = D.out[j * kWarp + c % kWarp];
  }
}

template <typename T, int Depth>
int launch_depth(const T* mixed, const T* newo, const T* gauss_w,
                 const T* gauss_y, T* out, int C, int ny, int device,
                 int optin, cudaStream_t stream, int* occupancy) {
  const auto kernel = ro_mix_kernel<T, Depth>;
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
  // blocks of kBlockWarps warps where they fit, else one
  int warps = kBlockWarps;
  size_t smem = table_bytes<T>(ny) + warps * WarpArrays<T>::bytes(ny);
  if (smem > static_cast<size_t>(optin)) {
    warps = 1;
    smem = table_bytes<T>(ny) + WarpArrays<T>::bytes(ny);
  }
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = warps * kWarp;
  if (occupancy != nullptr) {
    occupancy[0] = threads;
    occupancy[1] = static_cast<int>(smem);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occupancy[2], kernel, threads, smem));
  }
  kernel<<<(C + threads - 1) / threads, threads, smem, stream>>>(
      mixed, newo, gauss_w, gauss_y, out, C, ny);
  return static_cast<int>(cudaGetLastError());
}

// Launch on `stream`, or (occupancy != nullptr) launch nothing and report
// the launch's threads per block, shared memory per block and blocks per SM.
template <typename T>
int launch(const T* mixed, const T* newo, const T* gauss_w, const T* gauss_y,
           T* out, int C, int ny, void* stream, int* occupancy = nullptr) {
  if (ny < 2 || ny > kMaxNy || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the deepest leaf, 2 ny - 1, lies floor(log2(2 ny - 1)) levels down
  int depth = 0;
  while ((2 * ny - 1) >> (depth + 1)) ++depth;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HELIOS_RO_DEPTH(d)                                                \
  case d:                                                                 \
    return launch_depth<T, d>(mixed, newo, gauss_w, gauss_y, out, C, ny, \
                              device, optin, st, occupancy);
  switch (depth) {
    HELIOS_RO_DEPTH(1)
    HELIOS_RO_DEPTH(2)
    HELIOS_RO_DEPTH(3)
    HELIOS_RO_DEPTH(4)
    HELIOS_RO_DEPTH(5)
    HELIOS_RO_DEPTH(6)
    HELIOS_RO_DEPTH(7)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HELIOS_RO_DEPTH
}

}  // namespace

// Plain C entry points, loaded with ctypes.  They launch on the given stream
// without synchronising and return cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for an ny outside [2, 126]).
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

// The launch's shape at ny points in fp64 (bits 64) or fp32 (32), without
// launching: shape[0] threads per block, shape[1] bytes of shared memory
// per block, shape[2] blocks one SM holds at once.
int ro_mix_occupancy(int bits, int ny, int* shape) {
  return bits == 64 ? launch<double>(nullptr, nullptr, nullptr, nullptr,
                                     nullptr, 1, ny, nullptr, shape)
                    : launch<float>(nullptr, nullptr, nullptr, nullptr,
                                    nullptr, 1, ny, nullptr, shape);
}

const char* helios_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
