// The walk on Hopper: one whole move for every particle lane in one launch.
//
// Replaces the TPU kernel pumiumtally_tpu/ops/walk_pallas.py::_make_kernel
// (launched by trace_pallas_impl at pl.pallas_call), which is bitwise the
// XLA crossing body of pumiumtally_tpu/ops/walk.py::trace_impl. The plain
// PyTorch version is pumiumtally_tpu_torch/ops/walk.py::trace; this kernel
// computes the same values operation for operation (build with
// --fmad=false so no multiply-add is contracted).
//
// Design, from what the walk computes rather than how the TPU kernel was
// blocked:
//  * One thread per lane. The whole crossing loop runs in the thread until
//    the lane is done or has run max_crossings iterations. Threads retire
//    on their own, so the TPU's straggler compaction has no counterpart.
//  * The geo20 row is one direct load: 5 x 16 B in float32 (80 B) or
//    10 x 16 B in float64 (160 B). The 4 topology codes are read through an
//    integer view of their bits. The TPU's one-hot MXU gather is dropped.
//  * The tally has two modes (template flag ORDERED). Ordered, the
//    default of the wrapper: each scored crossing appends one record
//    (bin = elem*G + g, order = it*n + lane, c = seg*w) to device buffers
//    through a slot counter, and the walk touches no flux; csrc/scatter.cu
//    then folds every bin in (iteration, lane) order, the add order of the
//    JAX walk (tally_peel), so the flux is bitwise reproducible. The
//    warp's scoring lanes take their slots with one atomic (a coalesced
//    group). The counter keeps counting past the capacity and records
//    past it are dropped, so the wrapper can size the buffers to the count
//    and run the walk again. Atomic: two atomicAdds per scored crossing,
//    (c, c^2) into the flat flux at 2*(elem*G + g) and +1, in an order that
//    differs from run to run.
//  * Per lane the kernel writes position, element, material code, done,
//    scored track length, crossings, chase hops, segments and its
//    iteration count. The wrapper (ops/walk_cuda.py) reduces these to the
//    stats vector; the max of the iteration counts equals the JAX loop's
//    iteration count, since every active lane advances once per iteration.
//
// What bounds it: every iteration of a lane does one dependent random
// 80/160 B row read and, when it scores, one record (ordered) or two
// atomics (atomic). At the 998,250-tet mesh the 80 MB float32 table does
// not fit the 50 MB L2, so the kernel is bound by the latency of those
// reads, not by their bytes. The bytes the
// walk must move are far fewer: each row it needs once, each flux bin it
// scores read and written once, and the lanes' inputs and outputs, over
// 3.35 TB/s. Keeping rows close (shared memory, TMA prefetch of the next
// row) and a warp-aggregated tally are later work.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

template <typename T>
struct Real;

template <>
struct Real<float> {
  static constexpr float eps = 1.1920928955078125e-07f;  // 2^-23
  static constexpr float big = 3.40282346638528859812e+38f;
  static __device__ __forceinline__ int code(float v) {
    return __float_as_int(v);
  }
  static __device__ __forceinline__ float exp2i(int k) {
    return __int_as_float((k + 127) << 23);
  }
  static __device__ __forceinline__ float sqrt_(float x) {
    return __fsqrt_rn(x);
  }
  static __device__ __forceinline__ float div_(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ void load_row(const float* __restrict__ geo,
                                                  int e, float* r) {
    const float4* p = reinterpret_cast<const float4*>(geo + (size_t)e * 20);
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      float4 v = __ldg(p + k);
      r[4 * k + 0] = v.x;
      r[4 * k + 1] = v.y;
      r[4 * k + 2] = v.z;
      r[4 * k + 3] = v.w;
    }
  }
};

template <>
struct Real<double> {
  static constexpr double eps = 2.220446049250313080847e-16;  // 2^-52
  static constexpr double big = 1.79769313486231570815e+308;
  static __device__ __forceinline__ int code(double v) {
    // int64 bits; the codes are below 2^31, so the narrowing is exact.
    return (int)__double_as_longlong(v);
  }
  static __device__ __forceinline__ double exp2i(int k) {
    return __longlong_as_double((long long)(k + 1023) << 52);
  }
  static __device__ __forceinline__ double sqrt_(double x) {
    return __dsqrt_rn(x);
  }
  static __device__ __forceinline__ double div_(double a, double b) {
    return __ddiv_rn(a, b);
  }
  static __device__ __forceinline__ void load_row(const double* __restrict__ geo,
                                                  int e, double* r) {
    const double2* p = reinterpret_cast<const double2*>(geo + (size_t)e * 20);
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      double2 v = __ldg(p + k);
      r[2 * k + 0] = v.x;
      r[2 * k + 1] = v.y;
    }
  }
};

template <typename T, bool ROBUST, bool INITIAL, bool ORDERED>
__global__ void __launch_bounds__(128)
walk_kernel(const T* __restrict__ geo, const T* __restrict__ origin,
            const T* __restrict__ dest, const int* __restrict__ elem_in,
            const bool* __restrict__ fly_in, const T* __restrict__ weight,
            const int* __restrict__ group, int n, int n_groups,
            int max_crossings, T tolerance, int score_squares,
            T* __restrict__ flux, T* __restrict__ pos_out,
            int* __restrict__ elem_out, int* __restrict__ mat_out,
            bool* __restrict__ done_out, T* __restrict__ pseg_out,
            int* __restrict__ ncross_out, int* __restrict__ nchase_out,
            int* __restrict__ nseg_out, int* __restrict__ iters_out,
            int* __restrict__ rec_bin, long long* __restrict__ rec_order,
            T* __restrict__ rec_c, unsigned long long* __restrict__ rec_count,
            long long capacity) {
  typedef Real<T> R;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T inf = (T)__int_as_float(0x7f800000);  // +inf
  const T tol_floor = (T)8 * R::eps;
  const T nudge_c = (T)32 * R::eps;  // 4 * tol_floor, as the JAX walk folds it

  T cx = origin[3 * i], cy = origin[3 * i + 1], cz = origin[3 * i + 2];
  const T ex = dest[3 * i], ey = dest[3 * i + 1], ez = dest[3 * i + 2];
  int elem = elem_in[i];
  bool done = !fly_in[i];
  const T w = weight[i];
  const int g = group[i];
  const bool good_group = g >= 0 && g < n_groups;
  int mat = -2, prev = -1, stuck = 0;
  int ncross = 0, nchase = 0, nseg = 0;
  T pseg = w * (T)0;

  int it = 0;
  for (; it < max_crossings && !done; ++it) {
    T r[20];
    R::load_row(geo, elem, r);
    int code[4], nbrs[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      code[f] = R::code(r[16 + f]);
      nbrs[f] = (code[f] & 0xFFFFFF) - 1;
    }
    const T ux = ex - cx, uy = ey - cy, uz = ez - cz;

    // exit_face: least plane parameter among faces the ray heads out of.
    T num[4], t_all[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const T n0 = r[3 * f], n1 = r[3 * f + 1], n2 = r[3 * f + 2];
      const T denom = (n0 * ux + n1 * uy) + n2 * uz;
      num[f] = r[12 + f] - ((n0 * cx + n1 * cy) + n2 * cz);
      T t = denom > (T)0 ? R::div_(num[f], denom) : inf;
      t_all[f] = t < (T)0 ? (T)0 : t;
    }
    T t_exit = ROBUST && prev >= 0 && nbrs[0] == prev ? inf : t_all[0];
    int face = 0;
#pragma unroll
    for (int f = 1; f < 4; ++f) {
      const T t = ROBUST && prev >= 0 && nbrs[f] == prev ? inf : t_all[f];
      if (t < t_exit) {
        t_exit = t;
        face = f;
      }
    }
    bool has_exit = isfinite(t_exit);
    bool chase = false, contained = true;
    if (ROBUST) {
      // The entry-face mask must not strand a lane that had an exit.
      T t0 = t_all[0];
      int f0 = 0;
#pragma unroll
      for (int f = 1; f < 4; ++f) {
        if (t_all[f] < t0) {
          t0 = t_all[f];
          f0 = f;
        }
      }
      if (!has_exit && isfinite(t0)) {
        t_exit = t0;
        face = f0;
        has_exit = true;
      }
      // Relocation chase: a lane stuck for 4 zero-progress crossings in an
      // element that does not contain it hops toward the point.
      T sd[4];
      T sdmax = -num[0];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        sd[f] = -num[f];
        if (f > 0 && sd[f] > sdmax) sdmax = sd[f];
      }
      contained = sdmax <= (T)0;
      chase = stuck >= 4 && !contained;
      if (chase) {
        // Unsigned arithmetic: the hash relies on 32-bit wraparound.
        const uint32_t h = (uint32_t)elem * 2654435769u + (uint32_t)it * 40503u;
        const bool any_interior =
            nbrs[0] >= 0 || nbrs[1] >= 0 || nbrs[2] >= 0 || nbrs[3] >= 0;
        T best = -R::big;
        int cf = 0;
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const T wf = (T)1 + (T)((h >> (2 * f)) & 3u) * (T)0.125;
          const T s = (nbrs[f] >= 0 || !any_interior) ? sd[f] * wf : -R::big;
          if (f == 0 || s > best) {
            best = s;
            cf = f;
          }
        }
        face = cf;
        t_exit = (T)0;
        has_exit = true;
      }
    }

    const T dn = R::sqrt_((ux * ux + uy * uy) + uz * uz);
    const T dn_safe = dn > (T)0 ? dn : (T)1;
    T tol_eff = R::div_(tolerance, dn_safe);
    tol_eff = tol_eff < tol_floor ? tol_floor : tol_eff;
    const bool reached = t_exit >= (T)1 - tol_eff || !has_exit;
    const T t_step = t_exit < (T)1 ? t_exit : (T)1;
    const T xx = cx + t_step * ux, xy = cy + t_step * uy, xz = cz + t_step * uz;

    const bool crossed = !reached && has_exit;
    ncross += crossed && !chase;
    nchase += chase;
    const int code_f = code[face];
    const int next_elem = crossed ? nbrs[face] : -1;

    if (!INITIAL && !chase) {
      const T seg = t_step * dn;
      if (good_group) {
        const T c = seg * w;
        if (ORDERED) {
          const cg::coalesced_group scoring = cg::coalesced_threads();
          unsigned long long base = 0;
          if (scoring.thread_rank() == 0)
            base = atomicAdd(rec_count, (unsigned long long)scoring.size());
          const unsigned long long slot =
              scoring.shfl(base, 0) + scoring.thread_rank();
          if (slot < (unsigned long long)capacity) {
            rec_bin[slot] = elem * n_groups + g;
            rec_order[slot] = (long long)it * n + i;
            rec_c[slot] = c;
          }
        } else {
          T* bin = flux + 2 * ((long long)elem * n_groups + g);
          atomicAdd(bin, c);
          if (score_squares) atomicAdd(bin + 1, c * c);
        }
      }
      nseg += 1;
      pseg = pseg + seg;
    }

    const bool domain_exit = crossed && next_elem == -1;
    bool material_stop = false;
    if (!INITIAL) material_stop = crossed && ((code_f >> 30) & 1) && !chase;
    const bool newly_done = reached || domain_exit || material_stop;
    if (!INITIAL) {
      if (material_stop)
        mat = (code_f >> 24) & 0x3F;
      else if (reached || domain_exit)
        mat = -1;
    }

    const bool hopped = crossed && next_elem != -1;
    if (ROBUST && hopped) prev = chase ? -1 : elem;
    if (hopped) elem = next_elem;
    cx = xx;
    cy = xy;
    cz = xz;
    if (ROBUST) {
      // Escalated bump: guaranteed forward progress per crossing.
      const bool continuing = crossed && !newly_done;
      const T ax = fabs(cx), ay = fabs(cy), az = fabs(cz);
      T amax = ax;
      if (ay > amax) amax = ay;
      if (az > amax) amax = az;
      const T scale1 = (T)1 + amax;
      const T nudge0 = R::div_(nudge_c * scale1, dn_safe);
      const T cap = tol_eff > nudge0 ? tol_eff : nudge0;
      T nudge_t = nudge0 * R::exp2i(stuck);
      nudge_t = nudge_t < cap ? nudge_t : cap;
      const bool zero_step = continuing && t_step < nudge0 && !contained;
      stuck = zero_step ? (stuck + 1 < 48 ? stuck + 1 : 48)
                        : (continuing ? 0 : stuck);
      T extra = nudge_t - t_step;
      extra = extra > (T)0 ? extra : (T)0;
      if (continuing) {
        cx = cx + extra * ux;
        cy = cy + extra * uy;
        cz = cz + extra * uz;
      }
    }
    done = newly_done;
  }

  pos_out[3 * i] = cx;
  pos_out[3 * i + 1] = cy;
  pos_out[3 * i + 2] = cz;
  elem_out[i] = elem;
  mat_out[i] = mat;
  done_out[i] = done;
  pseg_out[i] = pseg;
  ncross_out[i] = ncross;
  nchase_out[i] = nchase;
  nseg_out[i] = nseg;
  iters_out[i] = it;
}

template <typename T, bool ROBUST, bool INITIAL, bool ORDERED>
int launch(const void* geo, const void* origin, const void* dest,
           const void* elem_in, const void* fly_in, const void* weight,
           const void* group, int n, int n_groups, int max_crossings,
           double tolerance, int score_squares, void* flux, void* pos_out,
           void* elem_out, void* mat_out, void* done_out, void* pseg_out,
           void* ncross_out, void* nchase_out, void* nseg_out,
           void* iters_out, void* rec_bin, void* rec_order, void* rec_c,
           void* rec_count, long long capacity, void* stream) {
  const int block = 128;
  const int grid = (n + block - 1) / block;
  walk_kernel<T, ROBUST, INITIAL, ORDERED>
      <<<grid, block, 0, (cudaStream_t)stream>>>(
          (const T*)geo, (const T*)origin, (const T*)dest,
          (const int*)elem_in, (const bool*)fly_in, (const T*)weight,
          (const int*)group, n, n_groups, max_crossings, (T)tolerance,
          score_squares, (T*)flux, (T*)pos_out, (int*)elem_out,
          (int*)mat_out, (bool*)done_out, (T*)pseg_out, (int*)ncross_out,
          (int*)nchase_out, (int*)nseg_out, (int*)iters_out, (int*)rec_bin,
          (long long*)rec_order, (T*)rec_c, (unsigned long long*)rec_count,
          capacity);
  return (int)cudaGetLastError();
}

// The initial search scores nothing, so it has no ordered instantiation.
template <typename T>
int dispatch(int robust, int initial, int ordered, const void* geo,
             const void* origin, const void* dest, const void* elem_in,
             const void* fly_in, const void* weight, const void* group, int n,
             int n_groups, int max_crossings, double tolerance,
             int score_squares, void* flux, void* pos_out, void* elem_out,
             void* mat_out, void* done_out, void* pseg_out, void* ncross_out,
             void* nchase_out, void* nseg_out, void* iters_out, void* rec_bin,
             void* rec_order, void* rec_c, void* rec_count,
             long long capacity, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
#define PUMI_WALK_LAUNCH(R, I, O)                                              \
  return launch<T, R, I, O>(geo, origin, dest, elem_in, fly_in, weight, group, \
                            n, n_groups, max_crossings, tolerance,             \
                            score_squares, flux, pos_out, elem_out, mat_out,   \
                            done_out, pseg_out, ncross_out, nchase_out,        \
                            nseg_out, iters_out, rec_bin, rec_order, rec_c,    \
                            rec_count, capacity, stream)
  if (initial) {
    if (robust) PUMI_WALK_LAUNCH(true, true, false);
    PUMI_WALK_LAUNCH(false, true, false);
  }
  if (ordered) {
    if (robust) PUMI_WALK_LAUNCH(true, false, true);
    PUMI_WALK_LAUNCH(false, false, true);
  }
  if (robust) PUMI_WALK_LAUNCH(true, false, false);
  PUMI_WALK_LAUNCH(false, false, false);
#undef PUMI_WALK_LAUNCH
}

}  // namespace

// C entry points pumi_walk_f32 and pumi_walk_f64. Every pointer and the
// stream are passed as void*; the return value is the cudaError_t of the
// launch. In ordered mode (initial == 0) the records go to rec_bin [cap]
// int32, rec_order [cap] int64 and rec_c [cap] of the walk's type, and
// rec_count (one uint64, zeroed by the caller) ends at the number of
// records the walk made, which may exceed cap; flux is not touched.
#define PUMI_WALK_ENTRY(NAME, T)                                               \
  extern "C" int NAME(                                                         \
      int robust, int initial, int ordered, const void* geo,                   \
      const void* origin, const void* dest, const void* elem_in,               \
      const void* fly_in, const void* weight, const void* group, int n,        \
      int n_groups, int max_crossings, double tolerance, int score_squares,    \
      void* flux, void* pos_out, void* elem_out, void* mat_out,                \
      void* done_out, void* pseg_out, void* ncross_out, void* nchase_out,      \
      void* nseg_out, void* iters_out, void* rec_bin, void* rec_order,         \
      void* rec_c, void* rec_count, long long capacity, void* stream) {        \
    return dispatch<T>(robust, initial, ordered, geo, origin, dest, elem_in,   \
                       fly_in, weight, group, n, n_groups, max_crossings,      \
                       tolerance, score_squares, flux, pos_out, elem_out,      \
                       mat_out, done_out, pseg_out, ncross_out, nchase_out,    \
                       nseg_out, iters_out, rec_bin, rec_order, rec_c,         \
                       rec_count, capacity, stream);                           \
  }

PUMI_WALK_ENTRY(pumi_walk_f32, float)
PUMI_WALK_ENTRY(pumi_walk_f64, double)
