// The walk's end-of-walk integrity vector on Hopper, in one launch.
//
// Replaces pumiumtally_tpu/ops/walk.py::integrity_vector (:274), which
// the JAX package left to XLA (no pl.pallas_call); on the card the port
// ran it as 18 torch kernels after the scatter. The plain PyTorch version
// is pumiumtally_tpu_torch/ops/walk.py::integrity_vector.
//
// What it computes, in the walk's type T: over the lanes, with comp =
// in_flight & done and wc = comp ? weight : 0, the sums Σ wc * pseg and
// Σ wc * |cur - origin| (every lane's product, as the plain version's
// dot products take them) and the largest comp ? |pseg - |cur - origin||
// : 0 (a NaN wins, as torch's amax); 0, 0, 0 for the initial search.
// Over the flux: the entries that are not in [0, max of T] (negative, NaN
// or infinite), the plain version's numel - count(flux >= 0 & flux <=
// max). The lanes in flight and the lanes in flight and done. The counts
// are int64 until the one cast to T at the end. |v| is sqrt((x*x + y*y)
// + z*z); the build's --fmad=false keeps products and sums apart, so the
// sums differ from torch's only by their order.
//
// Determinism: the grid is a function of the shapes alone; each thread
// takes its lanes and flux entries in a fixed order, each block folds
// its threads in a fixed tree and writes its partials, and the last
// block to finish (a ticket, reset to 0 by that block) folds the
// partials in a fixed tree over block order: no float atomics, so the
// vector is the same bits from run to run. The flux is read, never
// written; nothing is read back to the host.
//
// What bounds it: bytes, each input read once (the flux and, a lane, its
// two flags, weight, pseg and both positions), and 6 values written.
// Design: one grid-strided pass over lanes and flux together by at most
// MAX_BLOCKS blocks of BLOCK threads, partials in registers, one
// 48-byte partial a block.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_BLOCKS = 1024;
constexpr int WARPS = BLOCK / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t DYNAMIC_SMEM = 0;  // a launch's dynamic shared memory

template <typename T> struct Limits;
template <> struct Limits<float> {
  static __device__ __forceinline__ float max() { return FLT_MAX; }
};
template <> struct Limits<double> {
  static __device__ __forceinline__ double max() { return DBL_MAX; }
};

template <typename T>
struct Partial {
  T wp, wd, resid;
  long long bad, flying, comp;
};

// The larger of a and b, a NaN in either winning (torch's amax).
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (b > a || b != b) && a == a ? b : a;
}

template <typename T>
__device__ __forceinline__ Partial<T> fold(Partial<T> a, const Partial<T>& b) {
  a.wp += b.wp;
  a.wd += b.wd;
  a.resid = nan_max(a.resid, b.resid);
  a.bad += b.bad;
  a.flying += b.flying;
  a.comp += b.comp;
  return a;
}

template <typename T>
__device__ __forceinline__ Partial<T> shfl_down(const Partial<T>& v, int d) {
  Partial<T> o;
  o.wp = __shfl_down_sync(FULL, v.wp, d);
  o.wd = __shfl_down_sync(FULL, v.wd, d);
  o.resid = __shfl_down_sync(FULL, v.resid, d);
  o.bad = __shfl_down_sync(FULL, v.bad, d);
  o.flying = __shfl_down_sync(FULL, v.flying, d);
  o.comp = __shfl_down_sync(FULL, v.comp, d);
  return o;
}

// The block's fold in a fixed tree (valid in thread 0).
template <typename T>
__device__ Partial<T> block_fold(Partial<T> v) {
  __shared__ Partial<T> warp_part[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = fold(v, shfl_down(v, d));
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? warp_part[lane] : Partial<T>{0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v = fold(v, shfl_down(v, d));
  }
  __syncthreads();
  return v;
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
integrity_kernel(const uint8_t* __restrict__ in_flight,
                 const uint8_t* __restrict__ done,
                 const T* __restrict__ weight, const T* __restrict__ pseg,
                 const T* __restrict__ cur, const T* __restrict__ origin,
                 long long n, const T* __restrict__ flux, long long nflux,
                 int initial, Partial<T>* partials, unsigned* ticket,
                 T* __restrict__ out) {
  __shared__ bool last;
  Partial<T> v{0, 0, 0, 0, 0, 0};
  const long long stride = (long long)gridDim.x * BLOCK;
  const long long first = (long long)blockIdx.x * BLOCK + threadIdx.x;
  for (long long i = first; i < n; i += stride) {
    const bool fly = in_flight[i] != 0;
    const bool comp = fly && done[i] != 0;
    v.flying += fly;
    v.comp += comp;
    if (!initial) {
      const T dx = cur[3 * i] - origin[3 * i];
      const T dy = cur[3 * i + 1] - origin[3 * i + 1];
      const T dz = cur[3 * i + 2] - origin[3 * i + 2];
      const T dist = sqrt((dx * dx + dy * dy) + dz * dz);
      const T p = pseg[i];
      const T wc = comp ? weight[i] : (T)0;
      v.wp += wc * p;
      v.wd += wc * dist;
      v.resid = nan_max(v.resid, comp ? fabs(p - dist) : (T)0);
    }
  }
  for (long long j = first; j < nflux; j += stride) {
    const T x = flux[j];
    v.bad += !(x >= (T)0 && x <= Limits<T>::max());
  }
  v = block_fold(v);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = v;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The partials in a fixed tree over block order: thread t folds blocks
  // t, t + BLOCK, ... in order, then the block's tree.
  Partial<T> a{0, 0, 0, 0, 0, 0};
  for (int b = threadIdx.x; b < (int)gridDim.x; b += BLOCK) {
    Partial<T> p;
    const volatile Partial<T>* src = partials + b;
    p.wp = src->wp;
    p.wd = src->wd;
    p.resid = src->resid;
    p.bad = src->bad;
    p.flying = src->flying;
    p.comp = src->comp;
    a = fold(a, p);
  }
  a = block_fold(a);
  if (threadIdx.x == 0) {
    out[0] = a.wp;
    out[1] = a.wd;
    out[2] = a.resid;
    out[3] = (T)a.bad;
    out[4] = (T)a.flying;
    out[5] = (T)a.comp;
    *ticket = 0u;
  }
}

int blocks_for(long long n, long long nflux) {
  const long long work = n > nflux ? n : nflux;
  const long long b = (work + BLOCK - 1) / BLOCK;
  return (int)(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

template <typename T>
int launch(const void* in_flight, const void* done, const void* weight,
           const void* pseg, const void* cur, const void* origin,
           long long n, const void* flux, long long nflux, int initial,
           void* partials, void* ticket, void* out, void* stream) {
  if (n < 0 || nflux < 0) return (int)cudaErrorInvalidValue;
  integrity_kernel<T><<<blocks_for(n, nflux), BLOCK, DYNAMIC_SMEM,
                        (cudaStream_t)stream>>>(
      (const uint8_t*)in_flight, (const uint8_t*)done, (const T*)weight,
      (const T*)pseg, (const T*)cur, (const T*)origin, n, (const T*)flux,
      nflux, initial, (Partial<T>*)partials, (unsigned*)ticket, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points: pumi_integrity_f32 / _f64. in_flight, done: [n] bool;
// weight, pseg: [n]; cur, origin: [n, 3]; flux: [nflux]; out: [6] (the
// vector in integrity/invariants.py's field order). partials (at least
// pumi_integrity_partial_bytes()) and ticket (one uint32, zero and left
// zero) are the caller's scratch; two launches must not share them at
// once. Returns the launch's cudaError_t.
#define PUMI_INTEGRITY(TAG, T)                                               \
  extern "C" int pumi_integrity_##TAG(                                      \
      const void* in_flight, const void* done, const void* weight,          \
      const void* pseg, const void* cur, const void* origin, long long n,   \
      const void* flux, long long nflux, int initial, void* partials,       \
      void* ticket, void* out, void* stream) {                              \
    return launch<T>(in_flight, done, weight, pseg, cur, origin, n, flux,   \
                     nflux, initial, partials, ticket, out, stream);        \
  }
PUMI_INTEGRITY(f32, float)
PUMI_INTEGRITY(f64, double)
#undef PUMI_INTEGRITY

// The bytes of the partials scratch: one Partial<double> a block, for the
// most blocks a launch takes.
extern "C" long long pumi_integrity_partial_bytes(void) {
  return (long long)MAX_BLOCKS * (long long)sizeof(Partial<double>);
}

// pumi_integrity_smem gives the dynamic shared memory bytes a launch
// passes (none), for the resource contracts.
extern "C" long long pumi_integrity_smem(void) {
  return (long long)DYNAMIC_SMEM;
}
