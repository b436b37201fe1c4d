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
//  * Persistent threads that refill. A warp issues for as long as its
//    longest lane runs: with one lane per thread, a thread whose lane is
//    done idles until its whole warp is (26% of the lane slots did work at
//    the main path's first move). So the grid holds only as many threads
//    as stay resident on the card, each thread walks one lane at a time,
//    and a thread whose lane is done (or has run max_crossings
//    iterations) writes that lane's outputs and takes the next lane slot
//    from a device counter in the same loop: the threads that need a lane
//    take consecutive slots with one atomic. The warp meets in a ballot
//    on every trip, so it stays converged, and leaves the loop together
//    when none of its threads has a lane left. This is the
//    GPU form of the JAX walk's straggler compaction (ops/walk.py
//    first_k_active, compact_round); cf. Aila & Laine, "Understanding the
//    Efficiency of Ray Traversal on GPUs" (HPG 2009). Every lane keeps its
//    own iteration count, truncation and record keys, so results do not
//    depend on which thread walks a lane or when. Each warp adds its loop
//    trips to a counter, so a run can read the share of lane slots that
//    did work.
//  * Slot s walks the lane of record lanes[s]: the lane schedule
//    (pumi_lanes, below) writes every lane's inputs as one record in slot
//    order, a move's lanes by start element and the initial search's by
//    destination cell, so the lanes in flight walk a window of the element
//    table (element ids run in raster order on the box) and share its rows
//    in the caches. A warp takes its slots 32 at a time: the counter is
//    read a batch ahead and the batch is copied to shared memory
//    asynchronously (cp.async), so a thread takes its next lane without
//    waiting on memory.
//  * The geo20 row is one direct load: 5 x 16 B in float32 (80 B) or
//    10 x 16 B in float64 (160 B). The 4 topology codes are read through an
//    integer view of their bits. The TPU's one-hot MXU gather is dropped.
//  * The tally has two modes (template flag ORDERED). Ordered, the
//    default of the wrapper: each scored crossing appends one record
//    (bin = elem*G + g, order = it*n + lane, c = seg*w) to device buffers
//    through a slot counter, and the walk touches no flux; csrc/scatter.cu
//    then folds every bin in (iteration, lane) order, the add order of the
//    JAX walk (tally_peel), so the flux is bitwise reproducible whatever
//    order the records arrive in. The warp's scoring lanes take their
//    slots with one atomic (a coalesced group). The counter keeps counting
//    past the capacity and records past it are dropped, so the wrapper can
//    size the buffers to the count and run the walk again. Atomic: (c,
//    c^2) added to the flat flux at 2*(elem*G + g), in float32 as one 8 B
//    vector reduction, in an order that differs from run to run.
//  * Per lane the kernel writes position, element, material code, done,
//    scored track length, crossings, chase hops, segments and its
//    iteration count. The wrapper (ops/walk_cuda.py) reduces these to the
//    stats vector; the max of the iteration counts equals the JAX loop's
//    iteration count, since every active lane advances once per iteration.
//  * The feature tails (template flag FEAT; the main path's instantiation
//    has it off, so its code is the same as without them): the JAX walk's
//    record_crossing and its checkify invariants (trace_impl). Recorded
//    crossing points go to per-lane buffers indexed by the lane's own
//    index, as every per-lane output: a lane keeps its count in a register
//    from the count buffer (in/out, so a re-walk appends) and writes its
//    k-th genuine crossing (not a chase hop) to row k while k < K. The
//    checks are the JAX walk's four in-loop checks, each a bit of a thread's
//    error word, ORed into the launch's error counter once a thread is
//    done; the wrapper reads it with the record count and raises the
//    lowest set bit's message (ops/walk.py CHECKS), so the message does
//    not depend on timing. No device assert and no trap: either would
//    leave the CUDA context unusable for every later call in the process.
//    Every layout has them; the partitioned layout records points only
//    (its step has no checks, and a crossing into another part is a hop
//    the range check would flag), a crossing into another part recorded
//    once, by the part it leaves.
//  * The table layout (template flag LAYOUT). PACKED reads a geo20 row.
//    UNPACKED reads the element's four face planes and neighbors from
//    their own tables, and the class tables where a lane crosses a face:
//    the four-gather fallback of the JAX walk body (ops/walk.py:823-826)
//    for meshes past geo20's limits. PARTITIONED walks the stacked tables
//    of mesh parts (pumiumtally_tpu/ops/walk_partitioned.py::_walk_phase):
//    a neighbor code < -1 names another part's row, and a lane that
//    crosses into it freezes there with that part and row for the
//    exchange; the classes compare through the neighbor-class table, so
//    no remote row is read. A partitioned lane's carried state (entry
//    face, zero-progress count, material, track length) comes by lane
//    index beside its record, and its records are keyed by its slot in
//    the stacked parts. The lane schedule, the refill and the ordered
//    scatter are the same for every layout.
//  * The block width (template value BLOCK, threads per block). Every
//    instantiation has 128; the packed, non-feature, robust initial search
//    and ordered move, the main path's, are built at 64, 256 and 512 too,
//    the counterpart of the JAX kernel's lane_block ladder, which the
//    port's autotuner (pumiumtally_tpu_torch/tuning/) times. A warp's
//    batches take 2 x 32 lane records of shared memory (48 B in float32, 80
//    B in float64), 12 KB / 20 KB a block at 128 and 48 KB / 80 KB at 512:
//    past the 48 KB of static shared memory (float64 at 512) they are
//    dynamic shared memory. The width changes which thread walks a lane,
//    not what the lane computes: every width gives the same bits.
//
// What bounds it: every iteration of a lane does one random 80/160 B row
// read that depends on the last and, when it scores, one record (ordered)
// or one vector atomic (atomic), so the walk is bound by the latency of
// those reads and by the row traffic of the lanes in flight, not by the
// bytes it must move. At the 998,250-tet mesh the 80 MB float32 table
// does not fit the 50 MB L2; the lane order keeps the rows of the lanes
// in flight in a window of it. The bytes the walk must move are far
// fewer: each row it needs once, each flux bin it scores read and
// written once, and the lanes' inputs and outputs, over 3.35 TB/s. The
// tail is the other loss: at the end, threads finish the lanes they hold
// while their warps have no lane left to hand out. Keeping rows close
// (shared memory, TMA prefetch of the next row) is later work.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
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
  // The unpacked layout's planes of row e into r[0..15], geo20's order.
  static __device__ __forceinline__ void load_planes(
      const float* __restrict__ normals, const float* __restrict__ d,
      long long e, float* r) {
    const float4* p = reinterpret_cast<const float4*>(normals + e * 12);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float4 v = __ldg(p + k);
      r[4 * k + 0] = v.x;
      r[4 * k + 1] = v.y;
      r[4 * k + 2] = v.z;
      r[4 * k + 3] = v.w;
    }
    float4 v = __ldg(reinterpret_cast<const float4*>(d + e * 4));
    r[12] = v.x;
    r[13] = v.y;
    r[14] = v.z;
    r[15] = v.w;
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
  static __device__ __forceinline__ void load_planes(
      const double* __restrict__ normals, const double* __restrict__ d,
      long long e, double* r) {
    const double2* p = reinterpret_cast<const double2*>(normals + e * 12);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      double2 v = __ldg(p + k);
      r[2 * k + 0] = v.x;
      r[2 * k + 1] = v.y;
    }
    const double2* q = reinterpret_cast<const double2*>(d + e * 4);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      double2 v = __ldg(q + k);
      r[12 + 2 * k] = v.x;
      r[13 + 2 * k] = v.y;
    }
  }
};

constexpr int DEFAULT_BLOCK = 128;
constexpr int WARP = 32;
// Static shared memory a block may declare; past it a launch passes the
// batches' bytes as dynamic shared memory.
constexpr size_t STATIC_SMEM = 48 * 1024;
// The walk table's layout (template flag LAYOUT of walk_kernel).
constexpr int PACKED = 0;       // geo20 rows (the main path)
constexpr int UNPACKED = 1;     // four tables, a mesh without geo20
constexpr int PARTITIONED = 2;  // four tables of stacked mesh parts
// The four uint64 counters of a launch, zeroed by the caller.
constexpr int REC_COUNT = 0;   // records made (ordered mode)
constexpr int NEXT_SLOT = 1;   // lane slots taken
constexpr int WARP_TRIPS = 2;  // loop trips summed over warps
constexpr int ERR_BITS = 3;    // the checks' error bits (FEAT)
// The checks' bits, in the precedence of ops/walk.py CHECKS (bit 4, the
// track-length check after the walk, is the wrapper's).
constexpr unsigned CHECK_CONTAINED = 1u;   // position in its element
constexpr unsigned CHECK_FINITE = 2u;      // finite crossing point
constexpr unsigned CHECK_ELEM_RANGE = 4u;  // hop target in range
constexpr unsigned CHECK_CONTRIB = 8u;     // contribution >= 0, finite
constexpr unsigned FULL = 0xffffffffu;

// (c, c*c) into a flux pair, or c alone without squares. In float32 the
// pair is one 8 B vector reduction (global memory, compute capability
// 9.x); PTX has no vector add of float64, so there it is two.
__device__ __forceinline__ void add_pair(float* f, float c, int sq) {
  if (sq)
    atomicAdd(reinterpret_cast<float2*>(f), make_float2(c, c * c));
  else
    atomicAdd(f, c);
}

__device__ __forceinline__ void add_pair(double* f, double c, int sq) {
  atomicAdd(f, c);
  if (sq) atomicAdd(f + 1, c * c);
}

// a[f] by selects, so the arrays stay in registers (an index known only at
// run time would put them on the stack).
__device__ __forceinline__ int pick4(const int (&a)[4], int f) {
  return f == 0 ? a[0] : f == 1 ? a[1] : f == 2 ? a[2] : a[3];
}

// Whether a neighbor code names an element: -1 is the domain boundary, and
// in the partitioned layout a code < -1 is another part's row. The other
// layouts' codes are >= -1, where the test is the packed walk's own.
template <bool PART>
__device__ __forceinline__ bool names_elem(int c) {
  return PART ? c != -1 : c >= 0;
}

// One lane's inputs, as a warp's batch holds them in shared memory.
template <typename T>
struct __align__(16) Lane {
  T o[3], d[3], w;
  int elem, group, index, fly;
};
static_assert(sizeof(Lane<float>) == 48, "float32 lane");
static_assert(sizeof(Lane<double>) == 80, "float64 lane");

// The shared-memory bytes of a block's batches (two of 32 lanes a warp),
// and those of them a launch passes as dynamic shared memory (0 while they
// fit the static limit).
template <typename T>
__host__ __device__ constexpr size_t batch_bytes(int block) {
  return sizeof(Lane<T>) * 2 * (size_t)block;
}
template <typename T>
__host__ __device__ constexpr size_t dynamic_bytes(int block) {
  return batch_bytes<T>(block) > STATIC_SMEM ? batch_bytes<T>(block) : 0;
}

// The batches of a block: its static shared memory `s` while they fit the
// static limit, else its dynamic shared memory (the launch passes
// dynamic_bytes). Through this helper the 128-thread instantiations keep
// the machine code they had before the width was a template value.
template <typename T, int BLOCK>
__device__ __forceinline__ Lane<T> (*block_batches(
    Lane<T> (*s)[2][WARP]))[2][WARP] {
  if constexpr (dynamic_bytes<T>(BLOCK) > 0) {
    extern __shared__ __align__(16) unsigned char walk_smem[];
    return reinterpret_cast<Lane<T>(*)[2][WARP]>(walk_smem);
  } else {
    return s;
  }
}

// The feature tails' arguments (read only by the FEAT instantiations).
template <typename T>
struct Features {
  T* xp;       // [n, k, 3] crossing points (record)
  int* kx;     // [n] crossing counts, in/out (record)
  int k;       // points kept a lane
  int record;  // record the crossing points
  int checks;  // evaluate the invariant checks
  int ntet;    // elements, the hop target's range
  T tol10;     // 10 * tolerance, rounded once to T (the containment bound)
};

// The unpacked layout's tables (LAYOUT UNPACKED and PARTITIONED), the
// four-gather fallback of the JAX walk body and the per-part tables of
// its partitioned walk: per row its four face planes, its four neighbor
// codes (a row >= 0, -1 the domain boundary, and in the partitioned
// layout < -1 an element of another part, -2 - (part * max_local + row)),
// its class and the class across each face (its own on the boundary).
// A row is 100 B in float32 against geo20's 80 B; the walk reads the two
// class tables only where a lane crosses a face.
template <typename T>
struct Tables {
  const T* normals;    // [rows, 4, 3]
  const T* d;          // [rows, 4]
  const int* nbr;      // [rows, 4]
  const int* cls;      // [rows]
  const int* nbr_cls;  // [rows, 4]
};

// The partitioned walk phase's lane state (LAYOUT PARTITIONED), by lane
// index; a lane's element is a row of the stacked parts, part * max_local
// + its part-local row. Material ids (class values) and scored track
// lengths carry in and out through mat_out and pseg_out.
struct Parts {
  const long long* slot;  // [n] the lane's slot: its tally order key
  long long stride;       // the slots of all parts: order = it*stride + slot
  int max_local;          // rows a part
  int reset;              // the iteration the chase hash's count restarts
                          // at (0: never): a compacted round's fresh count
  int* prev;              // [n] in/out: entry-face code (-1 none)
  int* stuck;             // [n] in/out: zero-progress crossings
  int* target;            // [n] out: the part the lane froze for, or -1
  int* target_elem;       // [n] out: its row there
};

// A lane's record in device memory, written by lane_place in slot order,
// so a warp's batch of 32 slots is one contiguous block it copies to
// shared memory: the Lane and zero padding to whole 32 B sectors (64 B in
// float32, 96 B in float64). The place pass writes records at scattered
// slots, and a 48 B record that shared a sector with its neighbour left
// that sector part written (the pass took 0.11 against 0.06 ms). The walk
// copies the Lane alone, so its batches keep their shared memory and the
// SM its L1.
template <typename T>
struct __align__(32) LaneRecord {
  Lane<T> l;
};
static_assert(sizeof(LaneRecord<float>) == 64, "float32 lane record");
static_assert(sizeof(LaneRecord<double>) == 96, "float64 lane record");

// ---- The lane schedule: the walk's inputs into Lane records in slot order.
//
// Slot order puts the lanes' keys in non-decreasing order (within a key
// the order is the device's): a move's key is its start element, the
// initial search's its destination's cell on a grid over the mesh's
// box (ops/walk_cuda.py lane_keys, destination_cells). Three launches, a
// counting sort that moves each lane's record once:
//  1. lane_count: lanes per key into counts (the lanes of one key in a
//     warp make one atomic);
//  2. lane_scan: each block scans a tile of SCAN_TILE counts into
//     tile-relative offsets and the last block to finish scans the tiles'
//     sums in place (a last-block-done scan: one launch, no spin);
//  3. lane_place: thread r reads lane r's inputs (coalesced), claims a
//     slot in its key's range (one atomic a key a warp; counts are spent
//     as cursors, so every count ends at 0 and the buffer is ready for the
//     next call without a memset) and the warp writes its records with
//     16 B stores, a whole record a group of threads.
// No permutation is kept: the walk writes a lane's outputs through
// Lane.index. What bounds it: the bytes, each lane's inputs read once and
// its Lane written once (37 + 48 B a lane in float32); the records land
// at scattered slots, so the place pass pays a scattered 64 B write a
// lane (the Lane and its padding), and its claim an atomic and a read of
// its key's offset.
constexpr int SCHED_THREADS = 256;
constexpr int SCAN_ITEMS = 16;
constexpr int SCAN_TILE = SCHED_THREADS * SCAN_ITEMS;

// A lane's key, clamped to [0, nkeys). CELL: the cell of its destination,
// (c2 * cells1 + c1) * cells0 + c0 with ck = clamp(floor(nan_to_num((d_k -
// lo_k) * scale_k)), 0, cells_k - 1) in the walk's type, the arithmetic of
// ops/walk_cuda.py destination_cells; else its start element.
template <typename T>
struct LaneKey {
  int cell, nkeys;
  T lo[3], scale[3];
  int cells[3];
  __device__ __forceinline__ int operator()(const int* __restrict__ elem,
                                            const T* __restrict__ dest,
                                            int r) const {
    int k;
    if (cell) {
      int c[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        T v = (dest[3 * r + d] - lo[d]) * scale[d];
        if (isnan(v)) v = (T)0;
        v = floor(v);
        const T top = (T)(cells[d] - 1);
        v = v < (T)0 ? (T)0 : (v > top ? top : v);
        c[d] = (int)v;
      }
      k = (c[2] * cells[1] + c[1]) * cells[0] + c[0];
    } else {
      k = elem[r];
    }
    return k < 0 ? 0 : (k >= nkeys ? nkeys - 1 : k);
  }
};

template <typename T>
__global__ void __launch_bounds__(SCHED_THREADS)
lane_count(LaneKey<T> key, const int* __restrict__ elem,
           const T* __restrict__ dest, int n, int* __restrict__ counts) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned live = __ballot_sync(FULL, r < n);
  if (r >= n) return;
  const int k = key(elem, dest, r);
  const unsigned same = __match_any_sync(live, k);
  if ((int)(threadIdx.x & 31) == __ffs(same) - 1)
    atomicAdd(counts + k, __popc(same));
}

// Exclusive scan of one int per thread over the block; returns the
// thread's prefix and sets *total to the block's sum.
__device__ int block_scan(int v, int* total) {
  __shared__ int warp_sums[SCHED_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < SCHED_THREADS / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, s, d);
      if (lane >= d) s += y;
    }
    if (lane < SCHED_THREADS / 32) warp_sums[lane] = s;
  }
  __syncthreads();
  const int ex = x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[SCHED_THREADS / 32 - 1];
  __syncthreads();
  return ex;
}

// The exclusive scan of SCAN_TILE values of in[len] from base into out
// (plus carry; in place allowed); returns their sum. The tile passes
// through shared memory (padded a word every 32 against bank conflicts),
// so global loads and stores are coalesced while each thread scans
// SCAN_ITEMS consecutive values. COHERENT loads from L2: the values were
// written by other blocks of this launch.
template <bool COHERENT>
__device__ int scan_tile(const int* in, int* out, long long base,
                         long long len, int carry) {
  __shared__ int tile[SCAN_TILE + SCAN_TILE / 32];
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int i = k * SCHED_THREADS + threadIdx.x;
    const long long g = base + i;
    tile[i + (i >> 5)] =
        g < len ? (COHERENT ? __ldcg(in + g) : __ldg(in + g)) : 0;
  }
  __syncthreads();
  int v[SCAN_ITEMS];
  int s = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int i = threadIdx.x * SCAN_ITEMS + k;
    v[k] = tile[i + (i >> 5)];
    s += v[k];
  }
  int total;
  int ex = block_scan(s, &total) + carry;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int i = threadIdx.x * SCAN_ITEMS + k;
    tile[i + (i >> 5)] = ex;
    ex += v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int i = k * SCHED_THREADS + threadIdx.x;
    if (base + i < len) out[base + i] = tile[i + (i >> 5)];
  }
  __syncthreads();
  return total;
}

// offsets[k] = the lanes of keys below k in k's tile; the last block to
// finish turns tile_sums[t] into the lanes of the tiles below t and sets
// the ticket back to 0. A key's first slot is offsets[k] + tile_sums[k /
// SCAN_TILE].
__global__ void __launch_bounds__(SCHED_THREADS)
lane_scan(const int* __restrict__ counts, int nkeys, int* __restrict__ offsets,
          int* tile_sums, unsigned* ticket) {
  __shared__ bool last;
  const int total = scan_tile<false>(
      counts, offsets, (long long)blockIdx.x * SCAN_TILE, nkeys, 0);
  if (threadIdx.x == 0) {
    tile_sums[blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int carry = 0;
  for (long long base = 0; base < gridDim.x; base += SCAN_TILE)
    carry += scan_tile<true>(tile_sums, tile_sums, base, gridDim.x, carry);
  if (threadIdx.x == 0) *ticket = 0u;
}

// A lane record as 16 B words, padding zero.
template <typename T>
union LaneWords {
  LaneRecord<T> r;
  int4 v[sizeof(LaneRecord<T>) / 16];
};

// The place pass. Each thread builds its lane's record and stages it in
// its warp's slice of shared memory; the warp then writes its 32 records
// 16 B a thread, the threads of one record side by side, so each store
// instruction writes whole records and not 32 scattered 16 B pieces.
template <typename T>
__global__ void __launch_bounds__(SCHED_THREADS)
lane_place(LaneKey<T> key, const T* __restrict__ origin,
           const T* __restrict__ dest, const int* __restrict__ elem,
           const bool* __restrict__ fly, const T* __restrict__ weight,
           const int* __restrict__ group, int n,
           const int* __restrict__ offsets, const int* __restrict__ tile_sums,
           int* __restrict__ counts, LaneRecord<T>* __restrict__ lanes) {
  constexpr int C = (int)(sizeof(LaneRecord<T>) / 16);  // 16 B words
  __shared__ int4 staged[SCHED_THREADS / 32][32 * C];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const unsigned live = __ballot_sync(FULL, r < n);
  if (live == 0u) return;
  int4* const mine = staged[threadIdx.x >> 5];
  int slot = 0;
  if (r < n) {
    const int k = key(elem, dest, r);
    const unsigned same = __match_any_sync(live, k);
    const int lead = __ffs(same) - 1, size = __popc(same);
    int left = 0;
    if (lane == lead) left = atomicSub(counts + k, size);
    left = __shfl_sync(same, left, lead);
    slot = __ldg(offsets + k) + __ldg(tile_sums + k / SCAN_TILE) + left -
           size + __popc(same & ((1u << lane) - 1u));
    LaneWords<T> u;
#pragma unroll
    for (int j = 0; j < C; ++j) u.v[j] = make_int4(0, 0, 0, 0);
    Lane<T>& l = u.r.l;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      l.o[d] = origin[3 * r + d];
      l.d[d] = dest[3 * r + d];
    }
    l.w = weight[r];
    l.elem = elem[r];
    l.group = group[r];
    l.index = r;
    l.fly = fly[r];
#pragma unroll
    for (int j = 0; j < C; ++j) mine[lane * C + j] = u.v[j];
  }
  __syncwarp();
  int4* const out = reinterpret_cast<int4*>(lanes);
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int q = j * 32 + lane;  // word q % C of the warp's record q / C
    const int src = q / C;
    const int s = __shfl_sync(FULL, slot, src);
    if ((live >> src) & 1u) out[(long long)s * C + q % C] = mine[q];
  }
}

// Asynchronous copy of one lane record from device to shared memory.
template <typename T>
__device__ __forceinline__ void copy_lane(Lane<T>* dst, const Lane<T>* src) {
#pragma unroll
  for (int k = 0; k < (int)(sizeof(Lane<T>) / 16); ++k)
    __pipeline_memcpy_async(reinterpret_cast<char*>(dst) + 16 * k,
                            reinterpret_cast<const char*>(src) + 16 * k, 16);
}

template <typename T, bool ROBUST, bool INITIAL, bool ORDERED, bool FEAT,
          int LAYOUT, int BLOCK = DEFAULT_BLOCK>
__global__ void __launch_bounds__(BLOCK)
walk_kernel(const T* __restrict__ geo,
            const LaneRecord<T>* __restrict__ lanes,
            int n, int n_groups, int max_crossings, T tolerance,
            int score_squares, T* __restrict__ flux, T* __restrict__ pos_out,
            int* __restrict__ elem_out, int* __restrict__ mat_out,
            bool* __restrict__ done_out, T* __restrict__ pseg_out,
            int* __restrict__ ncross_out, int* __restrict__ nchase_out,
            int* __restrict__ nseg_out, int* __restrict__ iters_out,
            int* __restrict__ rec_bin, long long* __restrict__ rec_order,
            T* __restrict__ rec_c, unsigned long long* __restrict__ counters,
            long long capacity, Features<T> feat, Tables<T> tab,
            Parts part) {
  typedef Real<T> R;
  constexpr bool PART = LAYOUT == PARTITIONED;
  // The partitioned layout records points only: its step has no checks.
  constexpr bool CHECKS = FEAT && !PART;
  const T inf = (T)__int_as_float(0x7f800000);  // +inf
  const T tol_floor = (T)8 * R::eps;
  const T nudge_c = (T)32 * R::eps;  // 4 * tol_floor, as the JAX walk folds it

  // The lane this thread walks (-1: none) and that lane's state.
  const int lane = threadIdx.x & 31;
  int i = -1;
  T cx = 0, cy = 0, cz = 0, ex = 0, ey = 0, ez = 0, w = 0, pseg = 0;
  int elem = 0, g = 0, mat = 0, prev = 0, stuck = 0;
  int ncross = 0, nchase = 0, nseg = 0, it = 0;
  // PARTITIONED: the lane's part's first row (else 0), and the part it
  // froze for at a crossing into another part with that element's row.
  int base = 0, target = -1, target_elem = 0;
  bool done = true, good_group = false;
  unsigned long long trips = 0;  // the warp's loop trips
  int kx = 0;                    // the lane's recorded crossings (FEAT)
  unsigned err = 0;              // the thread's check bits (FEAT)

  // Slots come to a warp in batches of 32 through a double buffer in
  // shared memory: buf[cur] is handed out (qn slots, the next at qpos)
  // while the next batch (nn slots) is copied in, and lane 0 holds the
  // slot base of the batch after that (pend), taken from the counter a
  // whole batch ahead. So a refill waits on no memory access.
  __shared__ Lane<T>
      batches[dynamic_bytes<T>(BLOCK) ? 1 : BLOCK / WARP][2][WARP];
  Lane<T>(*const buf)[WARP] =
      block_batches<T, BLOCK>(batches)[threadIdx.x / WARP];
  unsigned long long pend = 0;
  int cur = 0, qn = 0, qpos = 0, nn = 0;
  bool dry = false;  // the counter has passed n (the same in the warp)
  auto fetch = [&](int b) {
    nn = 0;
    if (!dry) {
      const long long base = (long long)__shfl_sync(FULL, pend, 0);
      const long long left = (long long)n - base;
      nn = left <= 0 ? 0 : left < WARP ? (int)left : WARP;
      dry = nn < WARP;
      if (lane < nn) copy_lane(&buf[b][lane], &lanes[base + lane].l);
      if (lane == 0 && !dry)
        pend = atomicAdd(counters + NEXT_SLOT, (unsigned long long)WARP);
    }
    __pipeline_commit();
  };
  if (lane == 0)
    pend = atomicAdd(counters + NEXT_SLOT, (unsigned long long)WARP);
  fetch(0);
  qn = nn;
  fetch(1);
  __pipeline_wait_prior(1);
  __syncwarp();

  for (;;) {
    // Refill: every thread without a lane takes the next slot of the
    // batch. The whole warp meets in these collectives on every trip, so
    // it stays converged; it leaves the loop together.
    unsigned want = __ballot_sync(FULL, i < 0);
    while (want) {
      if (qpos == qn) {
        if (nn == 0) break;  // no slot left
        __pipeline_wait_prior(0);
        __syncwarp();
        cur ^= 1;
        qn = nn;
        qpos = 0;
        fetch(cur ^ 1);
      }
      const int rank = __popc(want & ((1u << lane) - 1u));
      const bool take = ((want >> lane) & 1u) && qpos + rank < qn;
      if (take) {
        const Lane<T>& l = buf[cur][qpos + rank];
        i = l.index;
        cx = l.o[0];
        cy = l.o[1];
        cz = l.o[2];
        ex = l.d[0];
        ey = l.d[1];
        ez = l.d[2];
        w = l.w;
        elem = l.elem;
        g = l.group;
        done = !l.fly;
        good_group = g >= 0 && g < n_groups;
        mat = -2;
        prev = -1;
        stuck = 0;
        ncross = nchase = nseg = 0;
        pseg = w * (T)0;
        it = 0;
        if (PART) {
          base = elem / part.max_local * part.max_local;
          mat = mat_out[i];
          pseg = pseg_out[i];
          prev = part.prev[i];
          stuck = part.stuck[i];
          target = -1;
          target_elem = 0;
        }
        if (FEAT && feat.record) kx = feat.kx[i];
      }
      const unsigned took = __ballot_sync(FULL, take);
      qpos += __popc(took);
      want &= ~took;
    }
    if (!__any_sync(FULL, i >= 0)) break;
    ++trips;
    if (i >= 0 && !done && target < 0 && it < max_crossings) {
      T r[20];
      int code[4], nbrs[4];
      if (LAYOUT == PACKED) {
        R::load_row(geo, elem, r);
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          code[f] = R::code(r[16 + f]);
          nbrs[f] = (code[f] & 0xFFFFFF) - 1;
        }
      } else {
        R::load_planes(tab.normals, tab.d, elem, r);
        const int4 nb = __ldg(reinterpret_cast<const int4*>(tab.nbr) + elem);
        nbrs[0] = nb.x;
        nbrs[1] = nb.y;
        nbrs[2] = nb.z;
        nbrs[3] = nb.w;
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
      // prev holds a neighbor code (PARTITIONED: another part's too), -1
      // for none: the face back to it is masked.
      const bool has_prev = names_elem<PART>(prev);
      T t_exit = ROBUST && has_prev && nbrs[0] == prev ? inf : t_all[0];
      int face = 0;
#pragma unroll
      for (int f = 1; f < 4; ++f) {
        const T t = ROBUST && has_prev && nbrs[f] == prev ? inf : t_all[f];
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
        // Relocation chase: a lane stuck for 4 zero-progress crossings in
        // an element that does not contain it hops toward the point.
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
          // The hash takes the part-local row, as the JAX walks do.
          // PARTITIONED: the count restarts at part.reset, as a compacted
          // round of the JAX phase restarts its loop counter.
          const int hit = PART && part.reset > 0 && it >= part.reset
                              ? it - part.reset
                              : it;
          const uint32_t h =
              (uint32_t)(elem - base) * 2654435769u + (uint32_t)hit * 40503u;
          // Another part's face counts as interior.
          const bool any_interior =
              names_elem<PART>(nbrs[0]) || names_elem<PART>(nbrs[1]) ||
              names_elem<PART>(nbrs[2]) || names_elem<PART>(nbrs[3]);
          T best = -R::big;
          int cf = 0;
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const T wf = (T)1 + (T)((h >> (2 * f)) & 3u) * (T)0.125;
            const T s =
                (names_elem<PART>(nbrs[f]) || !any_interior) ? sd[f] * wf
                                                             : -R::big;
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

      if (CHECKS && feat.checks) {
        // The lane lies in its parent element within the tolerance and
        // rounding: every signed distance -num[f] <= bound (false for NaN).
        const T ax = fabs(cx), ay = fabs(cy), az = fabs(cz);
        T amax = ax;
        if (ay > amax) amax = ay;
        if (az > amax) amax = az;
        const T bound = feat.tol10 + (T)64 * tol_floor * (amax + (T)1);
        bool inside = true;
#pragma unroll
        for (int f = 0; f < 4; ++f) inside = inside && (-num[f] <= bound);
        if (!inside) err |= CHECK_CONTAINED;
      }

      const T dn = R::sqrt_((ux * ux + uy * uy) + uz * uz);
      const T dn_safe = dn > (T)0 ? dn : (T)1;
      T tol_eff = R::div_(tolerance, dn_safe);
      tol_eff = tol_eff < tol_floor ? tol_floor : tol_eff;
      const bool reached = t_exit >= (T)1 - tol_eff || !has_exit;
      const T t_step = t_exit < (T)1 ? t_exit : (T)1;
      const T xx = cx + t_step * ux, xy = cy + t_step * uy,
              xz = cz + t_step * uz;

      const bool crossed = !reached && has_exit;
      ncross += crossed && !chase;
      nchase += chase;
      if (FEAT && feat.record && crossed && !chase) {
        if (kx < feat.k) {
          T* p = feat.xp + ((size_t)i * feat.k + kx) * 3;
          p[0] = xx;
          p[1] = xy;
          p[2] = xz;
        }
        ++kx;
      }
      int next_elem = crossed ? pick4(nbrs, face) : -1;
      if (CHECKS && feat.checks) {
        if (!(isfinite(xx) && isfinite(xy) && isfinite(xz)))
          err |= CHECK_FINITE;
        // A hop out of the table ends the lane as a domain exit (its row
        // cannot be read); the check reports it.
        if (next_elem < -1 || next_elem >= feat.ntet) {
          err |= CHECK_ELEM_RANGE;
          next_elem = -1;
        }
      }

      if (!INITIAL && !chase) {
        // The partitioned JAX walk takes |xpoint - cur| as the segment.
        T seg;
        if (PART) {
          const T sx = xx - cx, sy = xy - cy, sz = xz - cz;
          seg = R::sqrt_((sx * sx + sy * sy) + sz * sz);
        } else {
          seg = t_step * dn;
        }
        if (CHECKS && feat.checks) {
          const T c = seg * w;
          if (!(c >= (T)0 && isfinite(c))) err |= CHECK_CONTRIB;
        }
        if (good_group) {
          const T c = seg * w;
          if (ORDERED) {
            const cg::coalesced_group scoring = cg::coalesced_threads();
            unsigned long long base = 0;
            if (scoring.thread_rank() == 0)
              base = atomicAdd(counters + REC_COUNT,
                               (unsigned long long)scoring.size());
            const unsigned long long slot =
                scoring.shfl(base, 0) + scoring.thread_rank();
            if (slot < (unsigned long long)capacity) {
              rec_bin[slot] = elem * n_groups + g;
              rec_order[slot] =
                  PART ? (long long)it * part.stride + __ldg(part.slot + i)
                       : (long long)it * n + i;
              rec_c[slot] = c;
            }
          } else {
            add_pair(flux + 2 * ((long long)elem * n_groups + g), c,
                     score_squares);
          }
        }
        nseg += 1;
        pseg = pseg + seg;
      }

      const bool domain_exit = crossed && next_elem == -1;
      bool material_stop = false;
      int stop_class = 0;
      if (!INITIAL) {
        if (LAYOUT == PACKED) {
          const int code_f = pick4(code, face);
          material_stop = crossed && ((code_f >> 30) & 1) && !chase;
          stop_class = (code_f >> 24) & 0x3F;
        } else if (crossed && next_elem != -1 && !chase) {
          stop_class = __ldg(tab.nbr_cls + 4 * (long long)elem + face);
          material_stop = stop_class != __ldg(tab.cls + elem);
        }
      }
      const bool newly_done = reached || domain_exit || material_stop;
      if (!INITIAL) {
        if (material_stop)
          mat = stop_class;
        else if (reached || domain_exit)
          mat = -1;
      }
      if (PART && crossed && next_elem < -1) {
        // Into another part: the lane freezes at the cut for the exchange.
        const int c = -2 - next_elem;
        target = c / part.max_local;
        target_elem = c % part.max_local;
      }

      // A crossing into another part is no hop: the lane stays frozen.
      const bool hopped =
          crossed && (PART ? next_elem >= 0 : next_elem != -1);
      if (ROBUST && hopped) prev = chase ? -1 : elem - base;
      if (hopped) elem = base + next_elem;
      cx = xx;
      cy = xy;
      cz = xz;
      if (ROBUST) {
        // Escalated bump: guaranteed forward progress per crossing.
        const bool continuing = (PART ? hopped : crossed) && !newly_done;
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
      ++it;
    }
    if (i >= 0 && (done || target >= 0 || it >= max_crossings)) {
      pos_out[3 * i] = cx;
      pos_out[3 * i + 1] = cy;
      pos_out[3 * i + 2] = cz;
      elem_out[i] = elem - base;
      if (PART) {
        part.prev[i] = prev;
        part.stuck[i] = stuck;
        part.target[i] = target;
        part.target_elem[i] = target_elem;
      }
      mat_out[i] = mat;
      done_out[i] = done;
      pseg_out[i] = pseg;
      ncross_out[i] = ncross;
      nchase_out[i] = nchase;
      nseg_out[i] = nseg;
      iters_out[i] = it;
      if (FEAT && feat.record) feat.kx[i] = kx;
      i = -1;
    }
  }
  __pipeline_wait_prior(0);
  if (lane == 0) atomicAdd(counters + WARP_TRIPS, trips);
  if (CHECKS && err) atomicOr(counters + ERR_BITS, (unsigned long long)err);
}

// Calls f(kernel, block) with the kernel instantiation for the flags and
// its block width. The initial search scores nothing, so it has no ordered
// instantiation. The feature tails are instantiated for what the facade,
// the re-walk and the partitioned step launch, the initial search and the
// ordered move, on every layout; the atomic tally (packed only) has none.
// Every instantiation has DEFAULT_BLOCK; the packed, non-feature, robust
// initial search and ordered move have the wider and narrower widths too.
template <typename T, int L, bool FEAT, typename F>
int with_layout(int robust, int initial, int ordered, F f) {
  constexpr int B = DEFAULT_BLOCK;
  if (initial)
    return robust ? f(walk_kernel<T, true, true, false, FEAT, L>, B)
                  : f(walk_kernel<T, false, true, false, FEAT, L>, B);
  if (!ordered) return (int)cudaErrorInvalidValue;
  return robust ? f(walk_kernel<T, true, false, true, FEAT, L>, B)
                : f(walk_kernel<T, false, false, true, FEAT, L>, B);
}

template <typename T, int L, typename F>
int with_feat(int robust, int initial, int ordered, int feat, F f) {
  return feat ? with_layout<T, L, true>(robust, initial, ordered, f)
              : with_layout<T, L, false>(robust, initial, ordered, f);
}

template <typename T, int B, typename F>
int with_width(int initial, F f) {
  return initial ? f(walk_kernel<T, true, true, false, false, PACKED, B>, B)
                 : f(walk_kernel<T, true, false, true, false, PACKED, B>, B);
}

template <typename T, typename F>
int with_kernel(int robust, int initial, int ordered, int feat, int layout,
                int block, F f) {
  if (block != DEFAULT_BLOCK) {
    if (layout != PACKED || feat || !robust || !(initial || ordered))
      return (int)cudaErrorInvalidValue;
    switch (block) {
      case 64:
        return with_width<T, 64>(initial, f);
      case 256:
        return with_width<T, 256>(initial, f);
      case 512:
        return with_width<T, 512>(initial, f);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (layout == UNPACKED)
    return with_feat<T, UNPACKED>(robust, initial, ordered, feat, f);
  if (layout == PARTITIONED)
    return with_feat<T, PARTITIONED>(robust, initial, ordered, feat, f);
  if (layout != PACKED) return (int)cudaErrorInvalidValue;
  if (feat || initial || ordered)
    return with_feat<T, PACKED>(robust, initial, ordered, feat, f);
  return robust
             ? f(walk_kernel<T, true, false, false, false, PACKED>,
                 DEFAULT_BLOCK)
             : f(walk_kernel<T, false, false, false, false, PACKED>,
                 DEFAULT_BLOCK);
}

// Blocks of `block` threads for n lanes: as many as stay resident on the
// card at once (the threads refill), fewer when n needs fewer. A kernel
// whose batches are dynamic shared memory (`smem` bytes) is allowed them
// first.
template <typename K>
int grid_for(K kernel, int block, size_t smem, long long n, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 0)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block,
                                                      smem);
  const long long resident = (long long)per_sm * sms;
  const long long need = (n + block - 1) / block;
  *grid = (int)(need < resident ? need : resident);
  return (int)e;
}

template <typename T>
int walk(int robust, int initial, int ordered, const void* geo,
         const void* lanes, int n, int n_groups, int max_crossings,
         double tolerance, int score_squares, void* flux, void* pos_out,
         void* elem_out, void* mat_out, void* done_out, void* pseg_out,
         void* ncross_out, void* nchase_out, void* nseg_out, void* iters_out,
         void* rec_bin, void* rec_order, void* rec_c, void* counters,
         long long capacity, const Features<T>& feat, int layout,
         const Tables<T>& tab, const Parts& part, int block, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if ((uintptr_t)lanes % 32) return (int)cudaErrorInvalidValue;
  if (layout != PACKED &&
      ((uintptr_t)tab.normals % 16 || (uintptr_t)tab.d % 16 ||
       (uintptr_t)tab.nbr % 16))
    return (int)cudaErrorInvalidValue;
  // The partitioned step has no invariant checks (a crossing into another
  // part is a hop the range check would flag).
  if (layout == PARTITIONED && (part.max_local < 1 || feat.checks))
    return (int)cudaErrorInvalidValue;
  const int on = feat.record || feat.checks;
  return with_kernel<T>(robust, initial, ordered, on, layout, block,
                        [&](auto kernel, int width) {
    int grid = 0;
    const size_t smem = dynamic_bytes<T>(width);
    const int e = grid_for(kernel, width, smem, n, &grid);
    if (e != 0) return e;
    kernel<<<grid, width, smem, (cudaStream_t)stream>>>(
        (const T*)geo, (const LaneRecord<T>*)lanes, n, n_groups,
        max_crossings,
        (T)tolerance, score_squares, (T*)flux, (T*)pos_out, (int*)elem_out,
        (int*)mat_out, (bool*)done_out, (T*)pseg_out, (int*)ncross_out,
        (int*)nchase_out, (int*)nseg_out, (int*)iters_out, (int*)rec_bin,
        (long long*)rec_order, (T*)rec_c, (unsigned long long*)counters,
        capacity, feat, tab, part);
    return (int)cudaGetLastError();
  });
}

// The three launches of the lane schedule (see lane_count). counts
// [nkeys] must be zero and is left zero; offsets [nkeys], tile_sums
// [ceil(nkeys / SCAN_TILE)] and ticket (zero, left zero) are scratch.
template <typename T>
int schedule(const void* origin, const void* dest, const void* elem,
             const void* fly, const void* weight, const void* group, int n,
             const LaneKey<T>& key, void* counts, void* offsets,
             void* tile_sums, void* ticket, void* lanes, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (key.nkeys < 1 || (uintptr_t)lanes % 32)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (int)(((long long)n + SCHED_THREADS - 1) / SCHED_THREADS);
  const int tiles = (int)(((long long)key.nkeys + SCAN_TILE - 1) / SCAN_TILE);
  lane_count<T><<<blocks, SCHED_THREADS, 0, s>>>(
      key, (const int*)elem, (const T*)dest, n, (int*)counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lane_scan<<<tiles, SCHED_THREADS, 0, s>>>((const int*)counts, key.nkeys,
                                            (int*)offsets, (int*)tile_sums,
                                            (unsigned*)ticket);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lane_place<T><<<blocks, SCHED_THREADS, 0, s>>>(
      key, (const T*)origin, (const T*)dest, (const int*)elem,
      (const bool*)fly, (const T*)weight, (const int*)group, n,
      (const int*)offsets, (const int*)tile_sums, (int*)counts,
      (LaneRecord<T>*)lanes);
  return (int)cudaGetLastError();
}

template <typename T>
int resident(int robust, int initial, int ordered, int layout, int block,
             int* threads) {
  return with_kernel<T>(robust, initial, ordered, 0, layout, block,
                        [&](auto kernel, int width) {
    int grid = 0;
    const int e =
        grid_for(kernel, width, dynamic_bytes<T>(width), 1LL << 40, &grid);
    *threads = grid * width;
    return e;
  });
}

}  // namespace

// C entry points; every pointer and the stream are passed as void*, and
// the return value is the cudaError_t of the launches.
//
// pumi_lanes_<t> is the lane schedule: it writes the n lanes' records (64 B
// each in float32, 96 B in float64) into lanes [n] (32 B aligned) in slot
// order. cell = 0 keys a lane by elem, cell = 1 by its
// destination's cell (lo, scale and cells per axis); keys are clamped to
// [0, nkeys). counts [nkeys] int32 and ticket (one uint32) are zero and
// left zero; offsets [nkeys] and tile_sums [ceil(nkeys / 4096)] int32 are
// scratch. After a failed call counts and ticket must be zeroed again.
//
// pumi_walk_<t> launches one walk over the records of pumi_lanes_<t>: slot
// s walks lane lanes[s].index. counters is four uint64 zeroed by the
// caller: records made, lane slots taken, warp loop trips, check bits. In
// ordered mode (initial == 0) the records go to rec_bin [cap] int32,
// rec_order [cap] int64 and rec_c [cap] of the walk's type, and the record
// count may end above cap; flux is not touched. record != 0 records each
// lane's first k crossing points into xp [n, k, 3] from the counts kx [n]
// int32 on (in/out); checks != 0 sets the check bits (ntet elements, tol10
// = 10 * tolerance; not on layout 2); either takes the feature
// instantiation, which the atomic tally (initial == 0, ordered == 0) does
// not have. layout 0
// walks geo (geo20 rows); layout 1 the unpacked tables normals, d, nbr,
// cls, nbr_cls (16 B aligned, see Tables); layout 2 the stacked parts'
// tables, with the lane state of Parts: slot [n] int64, stride, max_local,
// reset, prev, stuck [n] int32 in/out, target, target_elem [n] int32 out, and
// mat_out and pseg_out read before they are written. block is the threads
// per block: 128 for every instantiation, or 64, 256 or 512 for the packed
// (layout 0), non-feature, robust initial search and ordered move; another
// combination returns cudaErrorInvalidValue.
// pumi_walk_resident_<t> gives the threads a launch of that instantiation
// and block width keeps resident on the current device.
#define PUMI_WALK_ENTRY(TAG, T)                                                \
  extern "C" int pumi_lanes_##TAG(                                             \
      const void* origin, const void* dest, const void* elem, const void* fly, \
      const void* weight, const void* group, int n, int cell, int nkeys,       \
      double lo0, double lo1, double lo2, double scale0, double scale1,        \
      double scale2, int cells0, int cells1, int cells2,                       \
      void* counts, void* offsets, void* tile_sums, void* ticket, void* lanes, \
      void* stream) {                                                          \
    const LaneKey<T> key{cell,                                                 \
                         nkeys,                                                \
                         {(T)lo0, (T)lo1, (T)lo2},                             \
                         {(T)scale0, (T)scale1, (T)scale2},                    \
                         {cells0, cells1, cells2}};                            \
    return schedule<T>(origin, dest, elem, fly, weight, group, n, key,         \
                       counts, offsets, tile_sums, ticket, lanes, stream);     \
  }                                                                            \
  extern "C" int pumi_walk_##TAG(                                              \
      int robust, int initial, int ordered, const void* geo,                   \
      const void* lanes, int n, int n_groups, int max_crossings,               \
      double tolerance, int score_squares, void* flux, void* pos_out,          \
      void* elem_out, void* mat_out, void* done_out, void* pseg_out,           \
      void* ncross_out, void* nchase_out, void* nseg_out, void* iters_out,     \
      void* rec_bin, void* rec_order, void* rec_c, void* counters,             \
      long long capacity, void* xp, void* kx, int k, int record, int checks,   \
      int ntet, double tol10, int layout, const void* normals, const void* d,  \
      const void* nbr, const void* cls, const void* nbr_cls, const void* slot, \
      long long stride, int max_local, int reset, void* prev, void* stuck,     \
      void* target, void* target_elem, int block, void* stream) {              \
    const Features<T> feat{(T*)xp, (int*)kx, k, record, checks, ntet,          \
                           (T)tol10};                                          \
    const Tables<T> tab{(const T*)normals, (const T*)d, (const int*)nbr,       \
                        (const int*)cls, (const int*)nbr_cls};                 \
    const Parts part{(const long long*)slot, stride, max_local, reset,         \
                     (int*)prev, (int*)stuck, (int*)target,                    \
                     (int*)target_elem};                                       \
    return walk<T>(robust, initial, ordered, geo, lanes, n, n_groups,          \
                   max_crossings, tolerance, score_squares, flux, pos_out,     \
                   elem_out, mat_out, done_out, pseg_out, ncross_out,          \
                   nchase_out, nseg_out, iters_out, rec_bin, rec_order, rec_c, \
                   counters, capacity, feat, layout, tab, part, block,         \
                   stream);                                                    \
  }                                                                            \
  extern "C" int pumi_walk_resident_##TAG(int robust, int initial,             \
                                          int ordered, int layout, int block,  \
                                          int* threads) {                      \
    return resident<T>(robust, initial, ordered, layout, block, threads);      \
  }

PUMI_WALK_ENTRY(f32, float)
PUMI_WALK_ENTRY(f64, double)

// pumi_walk_smem_<t> gives the dynamic shared memory bytes a walk launch
// of `block` threads passes (0 while its batches fit the static limit):
// what the resource contracts' mirror of dynamic_bytes is held to.
extern "C" long long pumi_walk_smem_f32(int block) {
  return (long long)dynamic_bytes<float>(block);
}
extern "C" long long pumi_walk_smem_f64(int block) {
  return (long long)dynamic_bytes<double>(block);
}
