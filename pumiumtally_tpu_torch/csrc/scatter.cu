// The tally scatter on Hopper: records (bin, order, c) into the flat flux,
// c into flux[2*bin] and c*c into flux[2*bin+1].
//
// Replaces the TPU kernels of scripts/probe_pallas_gather.py::run_scatter
// (pl.pallas_call over make_k_outer and make_k_peeled) and, in its ordered
// form, the walk's tally tally_peel in pumiumtally_tpu/ops/walk_pallas.py.
// The plain PyTorch versions are scatter_atomic_plain and
// scatter_ordered_plain in pumiumtally_tpu_torch/ops/scatter.py.
//
// * pumi_scatter_atomic_<t> (the probe's "outer"): each thread takes 4
//   records with 16 B loads of their bins and values and adds each to its
//   bin. With squares, a float32 record's (c, c^2) pair is one 8 B vector
//   reduction (atomicAdd on float2, global memory, compute capability
//   9.x): half the L2 atomic operations of two scalar adds. PTX has no
//   vector add of float64, so a float64 record makes two. A bin's order of
//   adds is the device's.
// * The ordered scatter: each bin gets its adds in ascending (order,
//   record index), bitwise the sequence of the plain version (the probe's
//   "peeled", and the walk's tally). The TPU kernel peels collisions
//   inside a 128-lane block with one-hot products on the MXU; on this
//   card the records of a whole move are ordered at once. The fold is
//   f = f + c and, with squares, f2 = f2 + c*c, seeded from the flux; no
//   library sort or scan is used. Two paths, chosen by the data:
//   - the bucket path. A bucket is 2^shift consecutive bins (the caller
//     picks the shift so that the mean bucket holds at most a third of
//     BUCKET_CAP records). pumi_bucket_count counts the records of every
//     bucket (one integer atomic per warp and bucket, __match_any_sync),
//     scans the counts and finds the largest count and the range of the
//     order keys; the caller reads those three numbers (the call's one
//     host sync) and, when no bucket holds more than BUCKET_CAP records
//     and the keys fit, pumi_scatter_bucket_<t> places every record in its
//     bucket's range (the slot within a bucket is the device's) as one
//     16 B store: a key (local bin << (obits + ibits) | (order - least
//     order) << ibits | record index, at most 63 bits), whose order is
//     (bin, order, index), beside the value's bits. Then one block a
//     bucket loads its range into shared memory once, counts, scans and
//     places the records per bin there, and one thread folds each bin in
//     key order (a sorting network in registers for <= 8 records,
//     repeated minimum for <= 32; a larger bin is ranked by the whole
//     block, each record counting the keys below its own, then folded by
//     one thread). Every key and value of the fold comes from shared
//     memory, and a bucket's bins are contiguous in the flux. The
//     counters (31,196 at the main path's move 1) stay in L2, and the
//     placement's stores advance one cursor per bucket, so they merge in
//     L2 instead of landing at random in device memory: one 16 B store a
//     record takes a third of the time of four stores of 4-8 B;
//   - the crowded path, for a call in which some bucket holds more than
//     BUCKET_CAP records (a point source puts ~n/G records in one bin) or
//     whose keys do not fit 63 bits:
//     pumi_scatter_ordered_<t> runs passes 1-4 and
//     pumi_scatter_ordered_large_<t> pass 5 by bin, over all records:
//     1. count the records of every bin (integer atomics);
//     2. exclusive prefix sum of the counts over the bins: tiles of 4096
//        scanned in one block each with warp shuffles, the tile sums
//        scanned by one block, then added back;
//     3. place every record's index in its bin's range, in ranges of bins
//        whose indices take at most 24 MB, so they stay in L2;
//     4. fold each bin of at most 32 records by one thread (sorting
//        network for <= 8, repeated minimum for <= 32, keys read through
//        the indices); list a larger bin with its start in a scratch sized
//        to the listed bins' records;
//     5. the caller reads the list's length and records once and, only
//        when it is not empty, allocates that scratch and launches blocks
//        of 1024 threads that sort each listed bin (bitonic tiles of 2048
//        keys in shared memory, then merge-path passes in device memory)
//        and fold it by one thread.
//
// What bounds it: the bytes of the records and of the touched bins are
// the least it must move. The bucket path adds the 16 B record it writes
// and reads back once, a read of the bins for the count and of the order
// keys for their range; the crowded path adds random 4 B index stores and
// key reads into arrays larger than L2, and 3 passes over the bins. The
// per-bin folds are chains of dependent adds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr int SMALL = 32;             // bins folded by one thread
constexpr int TINY = 8;               // ... with their keys in registers
constexpr int SORT_THREADS = 1024;
constexpr int SORT_TILE = 2 * SORT_THREADS;  // bitonic tile in shared memory
constexpr int MERGE_ITEMS = 4;        // outputs per thread in a merge pass
constexpr int LARGE_BLOCKS = 264;     // two per SM of an H100
constexpr int PLACE_BYTES = 24 << 20;  // record indices per range (L2 50 MB)
constexpr int BUCKET_CAP = 2048;      // records of a bucket in shared memory
constexpr int BUCKET_THREADS = 256;   // threads of a bucket's block
constexpr int BUCKET_SHIFT_MAX = 10;  // at most 1024 bins a bucket
constexpr long long KEY_MAX = 0x7fffffffffffffffLL;
constexpr int IDX_MAX = 0x7fffffff;

__device__ __forceinline__ bool key_less(long long ka, int ia, long long kb,
                                         int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

constexpr int ATOMIC_ITEMS = 4;  // records per thread of atomic_kernel

// (c, c*c) into a flux pair, or c alone without squares. In float32 the
// pair is one 8 B vector reduction.
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

// 4 values from 16 B aligned memory in one (float) or two (double) loads.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 x = __ldg(reinterpret_cast<const double2*>(p));
  const double2 y = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = y.x;
  v[3] = y.y;
}

// VEC: bin and c are 16 B aligned, so a thread's 4 records load as vectors.
template <typename T, bool VEC>
__global__ void atomic_kernel(T* __restrict__ flux, const int* __restrict__ bin,
                              const T* __restrict__ c, int m, int sq) {
  const long long r0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * ATOMIC_ITEMS;
  if (r0 >= m) return;
  int b[ATOMIC_ITEMS];
  T v[ATOMIC_ITEMS];
  const int k = m - r0 < ATOMIC_ITEMS ? (int)(m - r0) : ATOMIC_ITEMS;
  if (VEC && k == ATOMIC_ITEMS) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(bin + r0));
    b[0] = x.x;
    b[1] = x.y;
    b[2] = x.z;
    b[3] = x.w;
    load4(c + r0, v);
  } else {
#pragma unroll
    for (int j = 0; j < ATOMIC_ITEMS; ++j) {
      b[j] = j < k ? bin[r0 + j] : 0;
      v[j] = j < k ? c[r0 + j] : (T)0;
    }
  }
#pragma unroll
  for (int j = 0; j < ATOMIC_ITEMS; ++j)
    if (j < k) add_pair(flux + 2 * (long long)b[j], v[j], sq);
}

__global__ void count_kernel(const int* __restrict__ bin, int m,
                             int* __restrict__ counts) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < m) atomicAdd(counts + bin[r], 1);
}

// count_kernel and place_kernel over all bins, for bins that repeat
// within a warp: the lanes of one bin make one atomic. The block size is
// a multiple of 32, so every warp is whole.
// The key of a record is its bin >> shift (the bin itself for shift 0).
__global__ void order_count(const int* __restrict__ bin, int m, int shift,
                            int* __restrict__ counts) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned live = __ballot_sync(0xffffffffu, r < m);
  if (r >= m) return;
  const int b = bin[r] >> shift;
  const unsigned same = __match_any_sync(live, b);
  if ((int)(threadIdx.x & 31) == __ffs(same) - 1)
    atomicAdd(counts + b, __popc(same));
}

// A slot in key b's range for each live lane of the warp that holds b:
// the lanes of one key take theirs with one atomic. Counts are spent as
// cursors: every key ends at 0.
__device__ __forceinline__ int claim_slot(int b, unsigned live,
                                          const int* __restrict__ offsets,
                                          int* __restrict__ counts) {
  const unsigned same = __match_any_sync(live, b);
  const int lane = threadIdx.x & 31, lead = __ffs(same) - 1;
  const int size = __popc(same);
  int left = 0;
  if (lane == lead) left = atomicSub(counts + b, size);
  left = __shfl_sync(same, left, lead);
  return offsets[b] + left - size + __popc(same & ((1u << lane) - 1u));
}

// A value's bits in the 8 B half of a placed record, and back.
__device__ __forceinline__ long long value_bits(float v) {
  return (long long)__float_as_uint(v);
}
__device__ __forceinline__ long long value_bits(double v) {
  return __double_as_longlong(v);
}
__device__ __forceinline__ void from_bits(long long x, float* v) {
  *v = __uint_as_float((unsigned)x);
}
__device__ __forceinline__ void from_bits(long long x, double* v) {
  *v = __longlong_as_double(x);
}

// Every record into its bucket's range as one 16 B store: the key
// (local bin << lshift) | ((order - omin) << ibits) | record index, whose
// order is (bin, order, index), and the value's bits.
template <typename T>
__global__ void bucket_place(const int* __restrict__ bin,
                             const long long* __restrict__ order,
                             const T* __restrict__ c, int m, int shift,
                             long long omin, int lshift, int ibits,
                             const int* __restrict__ offsets,
                             int* __restrict__ counts,
                             longlong2* __restrict__ rec) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned live = __ballot_sync(0xffffffffu, r < m);
  if (r >= m) return;
  const int b = bin[r];
  const int k = b >> shift;
  const long long key = (long long)(b - (k << shift)) << lshift |
                        (order[r] - omin) << ibits | r;
  rec[claim_slot(k, live, offsets, counts)] =
      make_longlong2(key, value_bits(c[r]));
}

// info[0] = the largest of counts[n] (info[0] zeroed), info[1] and
// info[2] = the least and the largest of order[m] (info[1] and info[2]
// set to the int64 maximum and minimum).
__global__ void bucket_stats(const int* __restrict__ counts, int n,
                             const long long* __restrict__ order, int m,
                             long long* __restrict__ info) {
  long long big = 0, lo = KEY_MAX, hi = -KEY_MAX - 1;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    big = max(big, (long long)counts[i]);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < m; i += stride) {
    const long long o = order[i];
    lo = min(lo, o);
    hi = max(hi, o);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    big = max(big, __shfl_xor_sync(0xffffffffu, big, d));
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, d));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, d));
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMax(info, big);
    atomicMin(info + 1, lo);
    atomicMax(info + 2, hi);
  }
}

// Exclusive scan of one int per thread over a block of whole warps;
// *total gets the block's sum.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int ex = x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[31];
  __syncthreads();
  return ex;
}

// Scans SCAN_TILE values of `in` starting at `base` into `out` (exclusive,
// plus `carry`); returns the tile's sum. In place is allowed.
__device__ int scan_tile(const int* in, int* out, long long base, int len,
                         int carry) {
  int v[SCAN_ITEMS];
  int s = 0;
  const long long first = base + (long long)threadIdx.x * SCAN_ITEMS;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    v[k] = first + k < len ? in[first + k] : 0;
    s += v[k];
  }
  int total;
  int ex = block_exclusive_scan(s, &total) + carry;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    if (first + k < len) out[first + k] = ex;
    ex += v[k];
  }
  return total;
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_tiles(const int* __restrict__ counts, int nbins, int* offsets,
           int* tile_sums) {
  const int total =
      scan_tile(counts, offsets, (long long)blockIdx.x * SCAN_TILE, nbins, 0);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_sums(int* tile_sums, int tiles, int* offsets, int nbins) {
  int carry = 0;
  for (long long base = 0; base < tiles; base += SCAN_TILE)
    carry += scan_tile(tile_sums, tile_sums, base, tiles, carry);
  if (threadIdx.x == 0) offsets[nbins] = carry;
}

__global__ void add_sums(int* __restrict__ offsets, int nbins,
                         const int* __restrict__ tile_sums) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < nbins) offsets[b] += tile_sums[b / SCAN_TILE];
}

// Places the index of every record whose bin lies in [lo, hi) in its
// bin's range. Counts are spent as cursors: every bin ends at 0.
__global__ void place_kernel(const int* __restrict__ bin, int m, int lo,
                             int hi, const int* __restrict__ offsets,
                             int* __restrict__ counts,
                             int* __restrict__ idx) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m) return;
  const int b = bin[r];
  if (b < lo || b >= hi) return;
  idx[offsets[b] + atomicSub(counts + b, 1) - 1] = r;
}

// Folds the bins of [lo, hi) that hold at most SMALL records. A larger
// bin is listed in large[] with the start of its records in the large
// bins' sort scratch (large_info: [0] listed bins, [1] their records).
template <typename T>
__global__ void fold_small(const int* __restrict__ offsets, int lo, int hi,
                           const long long* __restrict__ order,
                           const int* __restrict__ idx,
                           const T* __restrict__ c, T* __restrict__ flux,
                           int sq, int* __restrict__ large_info,
                           int* __restrict__ large,
                           int* __restrict__ large_beg) {
  const int b = lo + blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= hi) return;
  const int beg = offsets[b], cnt = offsets[b + 1] - beg;
  if (cnt == 0) return;
  if (cnt > SMALL) {
    const int L = atomicAdd(large_info, 1);
    large[L] = b;
    large_beg[L] = atomicAdd(large_info + 1, cnt);
    return;
  }
  T f = flux[2 * (long long)b];
  T f2 = sq ? flux[2 * (long long)b + 1] : f;
  if (cnt <= TINY) {
    // Keys read once into registers, ordered by an odd-even transposition
    // network, values loaded together, then folded.
    long long kk[TINY];
    int ii[TINY];
#pragma unroll
    for (int j = 0; j < TINY; ++j) {
      ii[j] = j < cnt ? idx[beg + j] : IDX_MAX;
      kk[j] = j < cnt ? order[ii[j]] : KEY_MAX;
    }
#pragma unroll
    for (int round = 0; round < TINY; ++round) {
#pragma unroll
      for (int j = round & 1; j + 1 < TINY; j += 2) {
        if (key_less(kk[j + 1], ii[j + 1], kk[j], ii[j])) {
          const long long tk = kk[j];
          kk[j] = kk[j + 1];
          kk[j + 1] = tk;
          const int ti = ii[j];
          ii[j] = ii[j + 1];
          ii[j + 1] = ti;
        }
      }
    }
    T v[TINY];
#pragma unroll
    for (int j = 0; j < TINY; ++j) v[j] = j < cnt ? c[ii[j]] : (T)0;
#pragma unroll
    for (int j = 0; j < TINY; ++j) {
      if (j < cnt) {
        f = f + v[j];
        if (sq) f2 = f2 + v[j] * v[j];
      }
    }
    flux[2 * (long long)b] = f;
    if (sq) flux[2 * (long long)b + 1] = f2;
    return;
  }
  long long lk = -KEY_MAX - 1;  // the last record taken; -1 is below all
  int li = -1;
  for (int step = 0; step < cnt; ++step) {
    long long bk = KEY_MAX;
    int bi = IDX_MAX;
    for (int j = beg; j < beg + cnt; ++j) {
      const int i = idx[j];
      const long long k = order[i];
      if (key_less(lk, li, k, i) && key_less(k, i, bk, bi)) {
        bk = k;
        bi = i;
      }
    }
    const T v = c[bi];
    f = f + v;
    if (sq) f2 = f2 + v * v;
    lk = bk;
    li = bi;
  }
  flux[2 * (long long)b] = f;
  if (sq) flux[2 * (long long)b + 1] = f2;
}

// Bytes of bucket_fold's dynamic shared memory for buckets of at most cap
// records and 2^shift bins.
template <typename T>
constexpr size_t bucket_smem(int cap, int shift) {
  return (size_t)cap * (sizeof(long long) + sizeof(T) +
                        2 * sizeof(unsigned short)) +
         (size_t)(2 * (1 << shift) + 1) * sizeof(int);
}

// Folds the bucket of bins [blockIdx.x << shift, ...): its records are
// [offsets[k], offsets[k+1]) of the placed ones, at most cap of them. The
// block loads them into shared memory once, counts and places them per
// bin there, and one thread folds each bin in key order, which within a
// bin is (order, index).
template <typename T>
__global__ void __launch_bounds__(BUCKET_THREADS)
bucket_fold(const int* __restrict__ offsets,
            const longlong2* __restrict__ rec, int nbins, int shift,
            int lshift, int cap, T* __restrict__ flux, int sq) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int nbig;
  __shared__ int big[BUCKET_CAP / (SMALL + 1)];
  const int base = blockIdx.x << shift;
  const int nb = min(1 << shift, nbins - base);
  const int beg = offsets[blockIdx.x], cnt = offsets[blockIdx.x + 1] - beg;
  if (cnt == 0) return;
  long long* sk = reinterpret_cast<long long*>(smem);  // [cap] keys
  T* sv = reinterpret_cast<T*>(sk + cap);              // [cap] values
  int* sbeg = reinterpret_cast<int*>(sv + cap);        // [nb + 1] bin starts
  int* scur = sbeg + (1 << shift) + 1;                 // [nb] counts, cursors
  unsigned short* slot = reinterpret_cast<unsigned short*>(
      scur + (1 << shift));                            // [cap] by bin
  unsigned short* ranked = slot + cap;                 // [cap] big bins' order
  const int t = threadIdx.x;

  for (int l = t; l < nb; l += blockDim.x) scur[l] = 0;
  if (t == 0) nbig = 0;
  __syncthreads();
  for (int j = t; j < cnt; j += blockDim.x) {
    const longlong2 x = rec[beg + j];
    sk[j] = x.x;
    from_bits(x.y, sv + j);
    atomicAdd(scur + (int)(x.x >> lshift), 1);
  }
  __syncthreads();
  // Bin starts: each thread scans a run of consecutive bins.
  const int per = (nb + blockDim.x - 1) / blockDim.x;
  const int l0 = min(t * per, nb), l1 = min(l0 + per, nb);
  int run = 0;
  for (int l = l0; l < l1; ++l) run += scur[l];
  int total;
  int at = block_exclusive_scan(run, &total);
  for (int l = l0; l < l1; ++l) {
    sbeg[l] = at;
    at += scur[l];
    scur[l] = 0;
  }
  if (t == 0) sbeg[nb] = cnt;
  __syncthreads();
  for (int j = t; j < cnt; j += blockDim.x) {
    const int l = (int)(sk[j] >> lshift);
    slot[sbeg[l] + atomicAdd(scur + l, 1)] = (unsigned short)j;
  }
  __syncthreads();

  for (int l = t; l < nb; l += blockDim.x) {
    const int b0 = sbeg[l], k = sbeg[l + 1] - b0;
    if (k == 0) continue;
    if (k > SMALL) {
      big[atomicAdd(&nbig, 1)] = l;
      continue;
    }
    const long long g = 2 * (long long)(base + l);
    T f = flux[g];
    T f2 = sq ? flux[g + 1] : f;
    if (k <= TINY) {
      // Keys and values into registers, ordered by an odd-even
      // transposition network, then folded.
      long long kk[TINY];
      T v[TINY];
#pragma unroll
      for (int j = 0; j < TINY; ++j) {
        const int q = j < k ? slot[b0 + j] : 0;
        kk[j] = j < k ? sk[q] : KEY_MAX;
        v[j] = j < k ? sv[q] : (T)0;
      }
#pragma unroll
      for (int round = 0; round < TINY; ++round) {
#pragma unroll
        for (int j = round & 1; j + 1 < TINY; j += 2) {
          if (kk[j + 1] < kk[j]) {
            const long long tk = kk[j];
            kk[j] = kk[j + 1];
            kk[j + 1] = tk;
            const T tv = v[j];
            v[j] = v[j + 1];
            v[j + 1] = tv;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < TINY; ++j) {
        if (j < k) {
          f = f + v[j];
          if (sq) f2 = f2 + v[j] * v[j];
        }
      }
    } else {
      long long last = -1;  // keys are not negative
      for (int step = 0; step < k; ++step) {
        long long best = KEY_MAX;
        int bq = 0;
        for (int j = b0; j < b0 + k; ++j) {
          const int q = slot[j];
          const long long kq = sk[q];
          if (kq > last && kq < best) {
            best = kq;
            bq = q;
          }
        }
        const T v = sv[bq];
        f = f + v;
        if (sq) f2 = f2 + v * v;
        last = best;
      }
    }
    flux[g] = f;
    if (sq) flux[g + 1] = f2;
  }
  __syncthreads();

  // Bins of more than SMALL records: the block ranks every record by the
  // keys below its own (keys are distinct), then one thread folds a bin.
  const int nl = nbig;
  for (int L = 0; L < nl; ++L) {
    const int l = big[L], b0 = sbeg[l], k = sbeg[l + 1] - b0;
    for (int j = t; j < k; j += blockDim.x) {
      const int q = slot[b0 + j];
      const long long kq = sk[q];
      int rank = 0;
      for (int x = b0; x < b0 + k; ++x) rank += sk[slot[x]] < kq;
      ranked[b0 + rank] = (unsigned short)q;
    }
  }
  __syncthreads();
  for (int L = t; L < nl; L += blockDim.x) {
    const int l = big[L], b0 = sbeg[l], k = sbeg[l + 1] - b0;
    const long long g = 2 * (long long)(base + l);
    T f = flux[g];
    T f2 = sq ? flux[g + 1] : f;
    for (int j = b0; j < b0 + k; ++j) {
      const T v = sv[ranked[j]];
      f = f + v;
      if (sq) f2 = f2 + v * v;
    }
    flux[g] = f;
    if (sq) flux[g + 1] = f2;
  }
}

// Bitonic sort of SORT_TILE (key, index) pairs in shared memory, one
// compare-exchange per thread per step.
__device__ void bitonic_tile(long long* sk, int* si) {
  const int t = threadIdx.x;
  for (int size = 2; size <= SORT_TILE; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int p = 2 * t - (t & (stride - 1));
      const int q = p + stride;
      const long long k0 = sk[p], k1 = sk[q];
      const int i0 = si[p], i1 = si[q];
      const bool up = (p & size) == 0;
      if (up ? key_less(k1, i1, k0, i0) : key_less(k0, i0, k1, i1)) {
        sk[p] = k1;
        sk[q] = k0;
        si[p] = i1;
        si[q] = i0;
      }
      __syncthreads();
    }
  }
}

// Orders and folds the nl listed bins. A bin's record indices are sorted
// in place in idx (its range at offsets[b]); key_a, key_b and idx_b hold
// only the listed bins' records, a bin's at large_beg[L].
template <typename T>
__global__ void __launch_bounds__(SORT_THREADS)
sort_fold_large(const int* __restrict__ offsets, int nl,
                const int* __restrict__ large,
                const int* __restrict__ large_beg,
                const long long* __restrict__ order, int* idx,
                long long* key_a, long long* key_b, int* idx_b,
                const T* __restrict__ c, T* __restrict__ flux, int sq) {
  __shared__ long long sk[SORT_TILE];
  __shared__ int si[SORT_TILE];
  __shared__ T sv[SORT_THREADS];
  for (int L = blockIdx.x; L < nl; L += gridDim.x) {
    const int b = large[L];
    const int beg = offsets[b], cnt = offsets[b + 1] - beg;
    const int sbeg = large_beg[L];
    long long* ka = key_a + sbeg;
    int* ia = idx + beg;
    // 1. Sorted tiles of SORT_TILE keys, padded with keys above all.
    for (int t0 = 0; t0 < cnt; t0 += SORT_TILE) {
      for (int j = threadIdx.x; j < SORT_TILE; j += SORT_THREADS) {
        const int g = t0 + j;
        const int i = g < cnt ? ia[g] : IDX_MAX;
        sk[j] = g < cnt ? order[i] : KEY_MAX;
        si[j] = i;
      }
      __syncthreads();
      bitonic_tile(sk, si);
      for (int j = threadIdx.x; j < SORT_TILE; j += SORT_THREADS) {
        const int g = t0 + j;
        if (g < cnt) {
          ka[g] = sk[j];
          ia[g] = si[j];
        }
      }
      __syncthreads();
    }
    // 2. Merge pairs of sorted runs, doubling their width.
    long long* sk_src = ka;
    int* si_src = ia;
    long long* sk_dst = key_b + sbeg;
    int* si_dst = idx_b + sbeg;
    for (long long w = SORT_TILE; w < cnt; w *= 2) {
      for (long long o0 = 0; o0 < cnt; o0 += SORT_THREADS * MERGE_ITEMS) {
        const long long k = o0 + (long long)threadIdx.x * MERGE_ITEMS;
        if (k < cnt) {
          const long long lo = k / (2 * w) * (2 * w);
          const int a_len = (int)min(w, cnt - lo);
          const int b_len = (int)min(w, cnt - lo - a_len);
          const long long* ak = sk_src + lo;
          const int* ai = si_src + lo;
          const long long* bk = ak + a_len;
          const int* bi = ai + a_len;
          const int d = (int)(k - lo);
          int ilo = d - b_len > 0 ? d - b_len : 0;
          int ihi = d < a_len ? d : a_len;
          while (ilo < ihi) {
            const int mid = (ilo + ihi) >> 1;
            if (key_less(ak[mid], ai[mid], bk[d - 1 - mid], bi[d - 1 - mid]))
              ilo = mid + 1;
            else
              ihi = mid;
          }
          int i = ilo, j = d - ilo;
          for (int q = 0; q < MERGE_ITEMS && k + q < cnt; ++q) {
            const bool take_a =
                j >= b_len ||
                (i < a_len && key_less(ak[i], ai[i], bk[j], bi[j]));
            if (take_a) {
              sk_dst[k + q] = ak[i];
              si_dst[k + q] = ai[i];
              ++i;
            } else {
              sk_dst[k + q] = bk[j];
              si_dst[k + q] = bi[j];
              ++j;
            }
          }
        }
      }
      __syncthreads();
      long long* tk = sk_src;
      sk_src = sk_dst;
      sk_dst = tk;
      int* ti = si_src;
      si_src = si_dst;
      si_dst = ti;
    }
    // 3. Fold in key order: the block stages values, one thread adds.
    T f = (T)0, f2 = (T)0;
    if (threadIdx.x == 0) {
      f = flux[2 * (long long)b];
      if (sq) f2 = flux[2 * (long long)b + 1];
    }
    for (int o0 = 0; o0 < cnt; o0 += SORT_THREADS) {
      const int j = o0 + threadIdx.x;
      if (j < cnt) sv[threadIdx.x] = c[si_src[j]];
      __syncthreads();
      if (threadIdx.x == 0) {
        const int e = min(SORT_THREADS, cnt - o0);
        for (int q = 0; q < e; ++q) {
          const T v = sv[q];
          f = f + v;
          if (sq) f2 = f2 + v * v;
        }
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      flux[2 * (long long)b] = f;
      if (sq) flux[2 * (long long)b + 1] = f2;
    }
  }
}

inline int cdiv(long long a, int b) { return (int)((a + b - 1) / b); }

#define PUMI_CHECK_LAUNCH()                          \
  do {                                               \
    const cudaError_t e = cudaGetLastError();        \
    if (e != cudaSuccess) return (int)e;             \
  } while (0)

template <typename T>
int atomic_launch(void* flux, const void* bin, const void* c, int m, int sq,
                  void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  const int grid = cdiv(cdiv(m, ATOMIC_ITEMS), 256);
  const cudaStream_t s = (cudaStream_t)stream;
  if (((uintptr_t)bin | (uintptr_t)c) % 16 == 0)
    atomic_kernel<T, true><<<grid, 256, 0, s>>>((T*)flux, (const int*)bin,
                                               (const T*)c, m, sq);
  else
    atomic_kernel<T, false><<<grid, 256, 0, s>>>((T*)flux, (const int*)bin,
                                                (const T*)c, m, sq);
  return (int)cudaGetLastError();
}

// The exclusive scan of counts[nbins] into offsets[nbins + 1].
int scan_launch(const int* counts, int nbins, int* offsets, int* tile_sums,
                cudaStream_t s) {
  const int tiles = cdiv(nbins, SCAN_TILE);
  scan_tiles<<<tiles, SCAN_THREADS, 0, s>>>(counts, nbins, offsets,
                                            tile_sums);
  PUMI_CHECK_LAUNCH();
  scan_sums<<<1, SCAN_THREADS, 0, s>>>(tile_sums, tiles, offsets, nbins);
  PUMI_CHECK_LAUNCH();
  add_sums<<<cdiv(nbins, 256), 256, 0, s>>>(offsets, nbins, tile_sums);
  return (int)cudaGetLastError();
}

// The bucket path's count: records per bucket of 2^shift bins into
// counts [nbuckets] (zeroed) and their exclusive scan into offsets
// [nbuckets + 1]; the largest count and the order keys' range into info
// (see bucket_stats).
int bucket_count_launch(const void* bin, const void* order, int m, int nbins,
                        int shift, void* counts, void* offsets,
                        void* tile_sums, void* info, void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  if (shift < 0 || shift > BUCKET_SHIFT_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nbuckets = (int)(((long long)nbins + (1 << shift) - 1) >> shift);
  order_count<<<cdiv(m, 256), 256, 0, s>>>((const int*)bin, m, shift,
                                           (int*)counts);
  PUMI_CHECK_LAUNCH();
  const int e = scan_launch((const int*)counts, nbuckets, (int*)offsets,
                            (int*)tile_sums, s);
  if (e != 0) return e;
  const int blocks = cdiv(m > nbuckets ? m : nbuckets, 256);
  bucket_stats<<<blocks < LARGE_BLOCKS ? blocks : LARGE_BLOCKS, 256, 0, s>>>(
      (const int*)counts, nbuckets, (const long long*)order, m,
      (long long*)info);
  return (int)cudaGetLastError();
}

// The bucket path's placement and fold, after bucket_count_launch found
// no bucket larger than cap (<= BUCKET_CAP) and keys of lshift + shift <=
// 63 bits, lshift = obits + ibits for an order range of obits bits from
// omin and record indices of ibits bits. counts are spent as cursors; rec
// holds 2m int64, 16 B aligned.
template <typename T>
int bucket_launch(void* flux, const void* bin, const void* order,
                  const void* c, int m, int nbins, int shift, long long omin,
                  int obits, int ibits, int cap, int sq, const void* offsets,
                  void* counts, void* rec, void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  const int lshift = obits + ibits;
  if (shift < 0 || shift > BUCKET_SHIFT_MAX || cap < 1 || cap > BUCKET_CAP ||
      obits < 0 || ibits < 1 || lshift + shift > 63 || (uintptr_t)rec % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nbuckets = (int)(((long long)nbins + (1 << shift) - 1) >> shift);
  bucket_place<T><<<cdiv(m, 256), 256, 0, s>>>(
      (const int*)bin, (const long long*)order, (const T*)c, m, shift, omin,
      lshift, ibits, (const int*)offsets, (int*)counts, (longlong2*)rec);
  PUMI_CHECK_LAUNCH();
  // Above 48 KB a block's dynamic shared memory must be asked for.
  const cudaError_t a = cudaFuncSetAttribute(
      bucket_fold<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bucket_smem<T>(BUCKET_CAP, BUCKET_SHIFT_MAX));
  if (a != cudaSuccess) return (int)a;
  bucket_fold<T><<<nbuckets, BUCKET_THREADS, bucket_smem<T>(cap, shift), s>>>(
      (const int*)offsets, (const longlong2*)rec, nbins, shift, lshift, cap,
      (T*)flux, sq);
  return (int)cudaGetLastError();
}

// Passes 1-4: every bin of at most SMALL records folded, the larger ones
// listed for large_launch.
template <typename T>
int ordered_launch(void* flux, const void* bin, const void* order,
                   const void* c, int m, int nbins, int sq, void* counts,
                   void* offsets, void* tile_sums, void* large_info,
                   void* large, void* large_beg, void* idx, void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  count_kernel<<<cdiv(m, 256), 256, 0, s>>>((const int*)bin, m, (int*)counts);
  PUMI_CHECK_LAUNCH();
  const int e = scan_launch((const int*)counts, nbins, (int*)offsets,
                            (int*)tile_sums, s);
  if (e != 0) return e;
  // Place and fold the bins range by range, each range's indices few
  // enough to stay in L2 while they are scattered and read back.
  const int ranges = cdiv(4LL * m, PLACE_BYTES);
  for (int k = 0; k < ranges; ++k) {
    const int lo = (int)((long long)nbins * k / ranges);
    const int hi = (int)((long long)nbins * (k + 1) / ranges);
    if (hi == lo) continue;
    place_kernel<<<cdiv(m, 256), 256, 0, s>>>((const int*)bin, m, lo, hi,
                                              (const int*)offsets,
                                              (int*)counts, (int*)idx);
    PUMI_CHECK_LAUNCH();
    fold_small<T><<<cdiv(hi - lo, 256), 256, 0, s>>>(
        (const int*)offsets, lo, hi, (const long long*)order,
        (const int*)idx, (const T*)c, (T*)flux, sq, (int*)large_info,
        (int*)large, (int*)large_beg);
    PUMI_CHECK_LAUNCH();
  }
  return (int)cudaSuccess;
}

// Pass 5: the nl bins that ordered_launch listed.
template <typename T>
int large_launch(void* flux, const void* order, const void* c, int sq,
                 const void* offsets, int nl, const void* large,
                 const void* large_beg, void* idx, void* key_a, void* key_b,
                 void* idx_b, void* stream) {
  if (nl <= 0) return (int)cudaSuccess;
  sort_fold_large<T>
      <<<nl < LARGE_BLOCKS ? nl : LARGE_BLOCKS, SORT_THREADS, 0,
         (cudaStream_t)stream>>>(
          (const int*)offsets, nl, (const int*)large, (const int*)large_beg,
          (const long long*)order, (int*)idx, (long long*)key_a,
          (long long*)key_b, (int*)idx_b, (const T*)c, (T*)flux, sq);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points. Pointers and the stream are void*; the return value is
// the cudaError_t of the launches.
//
// The bucket path: with nbuckets = ceil(nbins / 2^shift), the caller
// allocates counts [nbuckets] int32 zeroed, offsets [nbuckets+1] int32,
// tile_sums [ceil(nbuckets/4096)] int32 and info [3] int64 set to (0,
// int64 max, int64 min) for pumi_bucket_count; reads info (the largest
// bucket, the least and the largest order) and, if the largest bucket is
// at most 2048 and the keys fit 63 bits, passes it as cap to
// pumi_scatter_bucket_<t> with the least order, the bits of the order
// range and of the record indices, and rec [2m] int64 (16 B aligned).
//
// The crowded path: the caller allocates the scratch of
// pumi_scatter_ordered: counts [nbins] int32 zeroed, offsets [nbins+1]
// int32, tile_sums [ceil(nbins/4096)] int32, large_info [2] int32 zeroed,
// large and large_beg [m/33+1] int32, idx [m] int32; then, with nl and r
// read from large_info, the scratch of pumi_scatter_ordered_large (only
// when nl > 0): key_a and key_b [r] int64, idx_b [r] int32.
extern "C" int pumi_bucket_count(const void* bin, const void* order, int m,
                                 int nbins, int shift, void* counts,
                                 void* offsets, void* tile_sums, void* info,
                                 void* stream) {
  return bucket_count_launch(bin, order, m, nbins, shift, counts, offsets,
                             tile_sums, info, stream);
}

#define PUMI_SCATTER_ENTRIES(TAG, T)                                          \
  extern "C" int pumi_scatter_atomic_##TAG(void* flux, const void* bin,       \
                                           const void* c, int m, int sq,      \
                                           void* stream) {                    \
    return atomic_launch<T>(flux, bin, c, m, sq, stream);                     \
  }                                                                           \
  extern "C" int pumi_scatter_bucket_##TAG(                                   \
      void* flux, const void* bin, const void* order, const void* c, int m,   \
      int nbins, int shift, long long omin, int obits, int ibits, int cap,    \
      int sq, const void* offsets, void* counts, void* rec, void* stream) {   \
    return bucket_launch<T>(flux, bin, order, c, m, nbins, shift, omin,       \
                            obits, ibits, cap, sq, offsets, counts, rec,      \
                            stream);                                          \
  }                                                                           \
  extern "C" int pumi_scatter_ordered_##TAG(                                  \
      void* flux, const void* bin, const void* order, const void* c, int m,   \
      int nbins, int sq, void* counts, void* offsets, void* tile_sums,        \
      void* large_info, void* large, void* large_beg, void* idx,              \
      void* stream) {                                                         \
    return ordered_launch<T>(flux, bin, order, c, m, nbins, sq, counts,       \
                             offsets, tile_sums, large_info, large,           \
                             large_beg, idx, stream);                         \
  }                                                                           \
  extern "C" int pumi_scatter_ordered_large_##TAG(                            \
      void* flux, const void* order, const void* c, int sq,                   \
      const void* offsets, int nl, const void* large, const void* large_beg,  \
      void* idx, void* key_a, void* key_b, void* idx_b, void* stream) {       \
    return large_launch<T>(flux, order, c, sq, offsets, nl, large,            \
                           large_beg, idx, key_a, key_b, idx_b, stream);      \
  }

PUMI_SCATTER_ENTRIES(f32, float)
PUMI_SCATTER_ENTRIES(f64, double)

// pumi_scatter_smem_<t> gives the dynamic shared memory bytes a bucket
// fold launch passes for buckets of at most cap records and 2^shift bins
// (bucket_smem); the other kernels of this file pass none.
extern "C" long long pumi_scatter_smem_f32(int cap, int shift) {
  return (long long)bucket_smem<float>(cap, shift);
}
extern "C" long long pumi_scatter_smem_f64(int cap, int shift) {
  return (long long)bucket_smem<double>(cap, shift);
}
