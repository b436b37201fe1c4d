// The megastep's flight sampling on Hopper: one move's destination and
// collision/roulette draws for every lane, keyed by (seed, move, particle).
//
// Replaces pumiumtally_tpu/ops/source.py::sample_move (:179) and the
// flight of ops/walk.py::megastep_impl's body, which the JAX package left
// to XLA (no pl.pallas_call). The plain PyTorch version is
// pumiumtally_tpu_torch/ops/source.py::sample_flight_plain.
//
// What it computes, bit for bit what the JAX package draws:
//  * the lane key threefry2x32(move key, (0, clip(pid, 0, n_total-1))),
//    the move key fold_in(key(seed), move) coming from the host as two
//    kernel arguments (a pure function of seed and move: no copy, no read);
//  * five uniforms, draw i the threefry2x32 block of the lane key at
//    counter (0, i): float32 ((b1 ^ b2) >> 9 | 0x3F800000) - 1, float64
//    ((b1 << 32 | b2) >> 12 | 0x3FF0000000000000) - 1 (jax.random.uniform
//    with threefry_partitionable);
//  * mu = 2u0 - 1, phi = 2pi u1, s = sqrt(max(1 - mu^2, 0)), direction
//    (s cos phi, s sin phi, mu), ell = -log1p(-u2), and the destination
//    origin + direction * (ell / max(sigma_t[region], tiny)) for alive
//    lanes (the origin for dead ones), region = class_id[row] with
//    row = (i / cap) * max_local + clip(elem, 0, max_local - 1): lane i
//    sits in block i / cap of cap slots, whose part-local element rows
//    start at (i / cap) * max_local of the stacked class table. With
//    cap = n and max_local = ntet this is class_id[clip(elem, 0, ntet-1)]
//    of one mesh; with the partitioned megastep's stacked slots it is the
//    JAX megastep's sigma_dev[chip_base + clip(elem, 0, max_local-1)]
//    (pumiumtally_tpu/ops/walk_partitioned.py:1385-1387);
//  * coll_u = u3 and roul_u = u4 written for the physics.
// cos, sin, log1p and sqrt are the correctly rounded or libdevice
// functions (cosf, never __cosf), the plain version's on the card; the
// build's --fmad=false keeps every product and sum apart, as torch's.
//
// What bounds it: operations. A lane runs six threefry2x32 blocks (the
// lane key and five draws), each 20 rounds of add, rotate (one funnel
// shift) and xor plus five key injections, ~80 integer operations, and
// reads ~37 B and writes ~20 B (float32). At 1,048,576 lanes that is
// ~0.5 G integer operations against ~60 MB of traffic: the integer pipes,
// not the memory, set the floor. Design: one thread per lane, the draws
// in registers, nothing in shared memory; the region gathers
// (class_id[elem], sigma_t[region]) are cached loads of small tables.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr size_t DYNAMIC_SMEM = 0;  // a launch's dynamic shared memory

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// The 20-round threefry2x32 block of key (k0, k1) at counter (x0, x1).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#define PUMI_ROUND(r) x0 += x1; x1 = rotl(x1, r) ^ x0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (i % 2 == 0) {
      PUMI_ROUND(13) PUMI_ROUND(15) PUMI_ROUND(26) PUMI_ROUND(6)
    } else {
      PUMI_ROUND(17) PUMI_ROUND(29) PUMI_ROUND(16) PUMI_ROUND(24)
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
#undef PUMI_ROUND
}

template <typename T> struct Real;

template <> struct Real<float> {
  static __device__ __forceinline__ float uniform(uint32_t b1, uint32_t b2) {
    return __uint_as_float(((b1 ^ b2) >> 9) | 0x3F800000u) - 1.0f;
  }
  static __device__ __forceinline__ float two_pi() { return 6.2831855f; }
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
  static __device__ __forceinline__ float c(float x) { return cosf(x); }
  static __device__ __forceinline__ float s(float x) { return sinf(x); }
  static __device__ __forceinline__ float rt(float x) { return sqrtf(x); }
  static __device__ __forceinline__ float l1p(float x) { return log1pf(x); }
};

template <> struct Real<double> {
  static __device__ __forceinline__ double uniform(uint32_t b1, uint32_t b2) {
    const unsigned long long bits =
        ((((unsigned long long)b1 << 32) | b2) >> 12) | 0x3FF0000000000000ull;
    return __longlong_as_double((long long)bits) - 1.0;
  }
  static __device__ __forceinline__ double two_pi() {
    return 6.283185307179586;
  }
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
  static __device__ __forceinline__ double c(double x) { return cos(x); }
  static __device__ __forceinline__ double s(double x) { return sin(x); }
  static __device__ __forceinline__ double rt(double x) { return sqrt(x); }
  static __device__ __forceinline__ double l1p(double x) { return log1p(x); }
};

template <typename T>
__global__ void __launch_bounds__(BLOCK)
sample_flight_kernel(uint32_t mk0, uint32_t mk1,
                     const int32_t* __restrict__ pid, int n_total,
                     const int32_t* __restrict__ elem,
                     const uint8_t* __restrict__ alive,
                     const T* __restrict__ origin,
                     const int32_t* __restrict__ class_id, int cap,
                     int max_local, const T* __restrict__ sigma_t,
                     int nclass, int n,
                     T* __restrict__ dest, T* __restrict__ coll_u,
                     T* __restrict__ roul_u, T* __restrict__ u_out) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const int p = min(max(pid[i], 0), n_total - 1);
  uint32_t lk0 = 0u, lk1 = (uint32_t)p;
  threefry(mk0, mk1, lk0, lk1);
  T u[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    uint32_t b1 = 0u, b2 = (uint32_t)k;
    threefry(lk0, lk1, b1, b2);
    u[k] = Real<T>::uniform(b1, b2);
  }
  if (u_out != nullptr) {
#pragma unroll
    for (int k = 0; k < 5; ++k) u_out[(long long)i * 5 + k] = u[k];
  }
  const T mu = u[0] * (T)2 - (T)1;
  const T phi = u[1] * Real<T>::two_pi();
  const T s = Real<T>::rt(fmax(((T)1 - mu * mu), (T)0));
  const T ell = -Real<T>::l1p(-u[2]);
  const long long e = (long long)(i / cap) * max_local
                      + min(max(elem[i], 0), max_local - 1);
  const int region = min(max(class_id[e], 0), nclass - 1);
  const T scale = ell / fmax(__ldg(sigma_t + region), Real<T>::tiny());
  const T dir[3] = {s * Real<T>::c(phi), s * Real<T>::s(phi), mu};
  const long long o = (long long)i * 3;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T x = origin[o + k];
    dest[o + k] = alive[i] ? x + dir[k] * scale : x;
  }
  coll_u[i] = u[3];
  roul_u[i] = u[4];
}

template <typename T>
int launch(uint32_t mk0, uint32_t mk1, const void* pid, int n_total,
           const void* elem, const void* alive, const void* origin,
           const void* class_id, int cap, int max_local, const void* sigma_t,
           int nclass, int n, void* dest, void* coll_u, void* roul_u,
           void* u_out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_total < 1 || cap < 1 || max_local < 1 || nclass < 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + BLOCK - 1) / BLOCK;
  sample_flight_kernel<T>
      <<<blocks, BLOCK, DYNAMIC_SMEM, (cudaStream_t)stream>>>(
      mk0, mk1, (const int32_t*)pid, n_total, (const int32_t*)elem,
      (const uint8_t*)alive, (const T*)origin, (const int32_t*)class_id, cap,
      max_local, (const T*)sigma_t, nclass, n, (T*)dest, (T*)coll_u, (T*)roul_u,
      (T*)u_out);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points: pumi_sample_flight_f32 / _f64. mk0, mk1 are the move
// key's words; cap and max_local map a lane to its row of class_id (see
// the top of this file); u_out, when not null, receives each lane's five
// uniforms ([n, 5], a check of the draws). Returns the launch's
// cudaError_t.
extern "C" int pumi_sample_flight_f32(
    unsigned mk0, unsigned mk1, const void* pid, int n_total,
    const void* elem, const void* alive, const void* origin,
    const void* class_id, int cap, int max_local, const void* sigma_t,
    int nclass, int n, void* dest, void* coll_u, void* roul_u, void* u_out,
    void* stream) {
  return launch<float>(mk0, mk1, pid, n_total, elem, alive, origin, class_id,
                       cap, max_local, sigma_t, nclass, n, dest, coll_u,
                       roul_u, u_out, stream);
}

extern "C" int pumi_sample_flight_f64(
    unsigned mk0, unsigned mk1, const void* pid, int n_total,
    const void* elem, const void* alive, const void* origin,
    const void* class_id, int cap, int max_local, const void* sigma_t,
    int nclass, int n, void* dest, void* coll_u, void* roul_u, void* u_out,
    void* stream) {
  return launch<double>(mk0, mk1, pid, n_total, elem, alive, origin,
                        class_id, cap, max_local, sigma_t, nclass, n, dest,
                        coll_u, roul_u, u_out, stream);
}

// pumi_source_smem gives the dynamic shared memory bytes a flight launch
// passes (none), for the resource contracts.
extern "C" long long pumi_source_smem(void) {
  return (long long)DYNAMIC_SMEM;
}
