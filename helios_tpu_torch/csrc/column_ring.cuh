// cp.async staging of the column kernels: the copy primitives (also used by
// iso_sweep.cu) and the per-thread staging ring of noniso_sweep.cu and
// thomas.cu.
//
// Both kernels give each thread one spectral column and walk its rows in a
// serial chain.  Each step of the chain reads one value of its own column
// from each of a few arrays, and none of those loads depends on the chain.
// ColumnRing keeps them in flight ahead of it: each thread owns Depth
// stages of Fields values in shared memory, and a stage is filled by
// cp.async (one 4- or 8-byte copy per value, one commit group per stage)
// Depth steps before the step that reads it.  A kernel's loop is
//
//     for d < Depth:  issue the loads of step d into stage d;  commit()
//     for each step g, stage = g % Depth:
//         wait()                           the loads of step g have landed
//         compute step g from `stage`
//         issue the loads of step g + Depth into `stage`;  commit()
//                                          (an empty group past the end)
//
// so that wait(), cp.async.wait_group Depth-1, leaves exactly the Depth-1
// newer stages in flight.  No thread touches another's slots, so there is
// no __syncthreads; each value is copied on its own, so nothing needs more
// than the element's alignment and every row length S works.
//
// A value that the chain itself writes fewer than Depth steps before it is
// read (the fluxes near a turn of the sweep, the last rows of a Thomas
// elimination) is not in global memory yet when its stage is issued: the
// step that computes it stores it into the stage directly, and the issue
// skips that field.  The rest of the chain's own earlier stores are read
// back through the ring like any input.
//
// Layout [Depth][Fields][Width]: the 32 threads of a warp touch 32
// consecutive elements of one field, free of bank conflicts.

#pragma once

#include <cuda_runtime.h>

namespace helios {

// Start copying the 4- or 8-byte value *src (global memory) into *dst
// (shared memory).
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8,
                "cp.async copies 4 or 8 bytes per value");
  const unsigned smem = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem),
               "l"(src), "n"(static_cast<int>(sizeof(T)))
               : "memory");
}

// Close the group of the copies started since the last commit.
__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `Pending` of the newest groups are still in flight.
template <int Pending>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

template <typename T, int Depth, int Fields, int Width>
class ColumnRing {
  static_assert(Depth >= 2, "a ring of one stage loads nothing ahead");

 public:
  // elements of the block's shared array (at most 48 KB in all)
  static constexpr int kElements = Depth * Fields * Width;

  // the ring of thread `lane` (< Width) of the block, in `smem`
  __device__ ColumnRing(T* smem, int lane) : base_(smem + lane) {}

  // the value of `field` in `stage`
  __device__ T& operator()(int stage, int field) const {
    return base_[(stage * Fields + field) * Width];
  }

  // start copying *src into (stage, field)
  __device__ void load(int stage, int field, const T* src) const {
    copy_async(&(*this)(stage, field), src);
  }

  // close the group of one stage's copies
  __device__ static void commit() { commit_group(); }

  // wait until the oldest of the Depth stages in flight has landed
  __device__ static void wait() { wait_group<Depth - 1>(); }

  // the stage `ahead` (0 <= ahead < Depth) steps after `stage`
  __device__ static int advance(int stage, int ahead) {
    const int next = stage + ahead;
    return next < Depth ? next : next - Depth;
  }

 private:
  T* base_;
};

}  // namespace helios
