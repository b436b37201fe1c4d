// The partitioned step's exchange round on Hopper: bucket each local
// part's emigrants by destination part into the send blocks, then adopt
// each part's immigrants into its free slots.
//
// Replaces the exchange of pumiumtally_tpu/ops/walk_partitioned.py::
// make_partitioned_step (:788-934), which the JAX package left to XLA (no
// pl.pallas_call). The plain PyTorch version is
// pumiumtally_tpu_torch/ops/walk_partitioned.py::_exchange_plain; the
// all_to_all between the two halves stays in Python (Collectives), as
// the JAX collective sits between the two halves of its program.
//
// What it computes, bit for bit what the plain exchange computes:
//  * bucket: a slot of local part p is an emigrant when valid and
//    target >= 0. Its rank among p's emigrants to part d = target, in
//    slot order, is its per-destination running count (the JAX step's
//    cumsum). A rank < E writes send row (p, d, rank) of E rows a
//    destination; later ranks stay resident for the next round. A row
//    is (8 + 3K) float columns cur(3) dest(3) weight pseg points(3K), then
//    8 int32 columns pid group material target_elem marker(1) done
//    back-code and the point count (0 without points). The back code is
//    canon[p * max_local + elem] with a halo, -2 - ((lo + p) * max_local
//    + elem) without one, and -1 where stuck >= 4. A sent slot's valid
//    and target are cleared. Per part: each block's row count
//    min(emigrants to d, E), the pending and sent counts;
//  * adopt: the rows that part q received, in sender order and then rank
//    (the blocks' counts travel beside them), go one for one into q's
//    free slots in slot order, for i < take = min(n_mine, n_free); a slot
//    takes cur, dest, weight, pseg, pid, group, material, elem (the
//    target_elem column), done, prev (the back code), stuck 0, valid,
//    and the points and their count. n_dropped += max(n_mine - n_free, 0);
//    per part the received, free and adopted counts.
// The send buffer is never cleared: a receiver reads rows [0, count) of a
// block only.
//
// What bounds it: bytes. Every slot's valid and target are read (twice:
// the count and the place pass), a sent slot's fields read and its row
// written, every slot's valid read again for the free slots and an
// adopted slot's row read and its fields written; nothing is computed
// but ranks. Design: a counting sort in slot order, as the walk's lane
// schedule (csrc/walk.cu lane_count / lane_scan / lane_place) but
// stable: three launches for the bucket (the emigrants a tile of 256
// slots sends each destination; one block a part scans the tiles; the
// place pass ranks its tile's emigrants with a warp match and the warps'
// counts in shared memory, writes the rows and counts its tile's free
// slots), two for the adopt (one block a part scans the free slots'
// tiles and the received counts; the place pass ranks its free slots the
// same way and pulls the row its rank names). No atomics on device
// memory, no host read, nothing allocated.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;           // slots a block of the tile passes
constexpr int WARPS = TILE / 32;
constexpr int SCAN_THREADS = 1024;  // the per-part scan passes
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_PARTS = 1024;     // the place pass's counts: 32 KB
constexpr int FLOAT_COLS = 8;       // cur dest weight pseg, then 3K points
constexpr int INT_COLS = 8;         // the int block of a row

// The dynamic shared memory of the bucket's place pass: each warp's
// emigrants to each destination (the count pass's is (P + 1) ints).
__host__ __device__ constexpr size_t place_smem(int n_parts) {
  return (size_t)WARPS * n_parts * sizeof(int);
}

// The slot state of the local parts, [P_l * cap] each (cur and dest
// [P_l * cap, 3], xp [P_l * cap, K, 3]); xp and kx null without points.
template <typename T>
struct Slots {
  uint8_t* valid;
  int* target;
  int* elem;
  int* stuck;
  T* cur;
  T* dest;
  T* weight;
  T* pseg;
  int* pid;
  int* group;
  int* mat;
  int* target_elem;
  uint8_t* done;
  int* prev;
  T* xp;
  int* kx;
};

template <typename T>
Slots<T> slots_of(void* const* p) {
  return Slots<T>{(uint8_t*)p[0], (int*)p[1],  (int*)p[2],  (int*)p[3],
                  (T*)p[4],       (T*)p[5],    (T*)p[6],    (T*)p[7],
                  (int*)p[8],     (int*)p[9],  (int*)p[10], (int*)p[11],
                  (uint8_t*)p[12], (int*)p[13], (T*)p[14],  (int*)p[15]};
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Exclusive scan of one int a thread over a block of SCAN_THREADS;
// returns the thread's prefix and sets *total to the block's sum.
__device__ int block_scan(int v, int* total) {
  __shared__ int warp_sums[SCAN_THREADS / 32];
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
    int s = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, s, d);
      if (lane >= d) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int ex = x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[SCAN_THREADS / 32 - 1];
  __syncthreads();
  return ex;
}

// row[0, len) turned into its exclusive prefix sums in place; returns
// the row's sum.
__device__ int scan_row(int* row, int len) {
  int carry = 0;
  for (int base = 0; base < len; base += SCAN_THREADS) {
    const int i = base + threadIdx.x;
    const int v = i < len ? row[i] : 0;
    int total;
    const int ex = block_scan(v, &total);
    if (i < len) row[i] = carry + ex;
    carry += total;
  }
  return carry;
}

// 1. Per (tile t, local part p): the emigrants to each destination d
// into counts[(p * (P + 1) + d) * tiles + t], the pending ones (valid,
// target >= 0, whatever its part) at d = P.
__global__ void __launch_bounds__(TILE)
exchange_count(const uint8_t* __restrict__ valid,
               const int* __restrict__ target, int P, int cap, int tiles,
               int* __restrict__ counts) {
  extern __shared__ int per_dest[];  // P + 1
  const int p = blockIdx.y, t = blockIdx.x;
  for (int d = threadIdx.x; d <= P; d += TILE) per_dest[d] = 0;
  __syncthreads();
  const int s = t * TILE + threadIdx.x;
  if (s < cap) {
    const long long i = (long long)p * cap + s;
    const int tg = target[i];
    if (valid[i] && tg >= 0) {
      atomicAdd(per_dest + P, 1);
      if (tg < P) atomicAdd(per_dest + tg, 1);
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d <= P; d += TILE)
    counts[((long long)p * (P + 1) + d) * tiles + t] = per_dest[d];
}

// 2. One block a local part: each destination's tile counts into the
// rank of the tile's first emigrant there; the block's row count
// min(emigrants, E) into rows[p * P + d]; pending and sent into stats.
__global__ void __launch_bounds__(SCAN_THREADS)
exchange_scan(int* __restrict__ counts, int P, int tiles, int E,
              int* __restrict__ rows, long long* __restrict__ stats) {
  const int p = blockIdx.x;
  long long sent = 0;
  for (int d = 0; d <= P; ++d) {
    const int total =
        scan_row(counts + ((long long)p * (P + 1) + d) * tiles, tiles);
    if (threadIdx.x == 0) {
      if (d < P) {
        const int k = min(total, E);
        rows[p * P + d] = k;
        sent += k;
      } else {
        stats[p * 5 + 0] = total;
      }
    }
  }
  if (threadIdx.x == 0) stats[p * 5 + 1] = sent;
}

// 3. Per (tile, local part): rank each emigrant in slot order (the
// tile's first rank, then the warps before its own, then the lanes
// before it with the same destination), write the rows of rank < E,
// free their slots, and count the tile's free slots afterwards.
template <typename T>
__global__ void __launch_bounds__(TILE)
exchange_place(Slots<T> s, const long long* __restrict__ canon, int P,
               int lo, int cap, int tiles, int E, int max_local, int K,
               const int* __restrict__ counts, uint8_t* __restrict__ buf,
               int row_bytes, int* __restrict__ free_counts) {
  extern __shared__ int warp_dest[];  // [WARPS][P]
  __shared__ int warp_free[WARPS];
  const int p = blockIdx.y, t = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < WARPS * P; k += TILE) warp_dest[k] = 0;
  __syncthreads();
  const int si = t * TILE + threadIdx.x;
  const bool in = si < cap;
  const long long i = (long long)p * cap + si;
  const bool v = in && s.valid[i];
  const int tg = in ? s.target[i] : -1;
  const bool em = v && tg >= 0 && tg < P;
  const unsigned peers = __match_any_sync(FULL, em ? tg : -1);
  const int before = __popc(peers & lanes_below());
  if (em && before == 0) warp_dest[warp * P + tg] = __popc(peers);
  __syncthreads();
  bool sent = false;
  if (em) {
    int rank = counts[((long long)p * (P + 1) + tg) * tiles + t] + before;
    for (int w = 0; w < warp; ++w) rank += warp_dest[w * P + tg];
    if (rank < E) {
      sent = true;
      const int K3 = 3 * K;
      uint8_t* row = buf + (((long long)p * P + tg) * E + rank) * row_bytes;
      T* f = reinterpret_cast<T*>(row);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        f[k] = s.cur[3 * i + k];
        f[3 + k] = s.dest[3 * i + k];
      }
      f[6] = s.weight[i];
      f[7] = s.pseg[i];
      for (int k = 0; k < K3; ++k) f[FLOAT_COLS + k] = s.xp[i * K3 + k];
      const int e = s.elem[i];
      long long back = canon != nullptr
                           ? canon[(long long)p * max_local + e]
                           : -2 - ((long long)(lo + p) * max_local + e);
      if (s.stuck[i] >= 4) back = -1;
      int* c = reinterpret_cast<int*>(row + (FLOAT_COLS + K3) * sizeof(T));
      c[0] = s.pid[i];
      c[1] = s.group[i];
      c[2] = s.mat[i];
      c[3] = s.target_elem[i];
      c[4] = 1;
      c[5] = s.done[i] ? 1 : 0;
      c[6] = (int)back;
      c[7] = K > 0 ? s.kx[i] : 0;
      s.valid[i] = 0;
      s.target[i] = -1;
    }
  }
  const unsigned fb = __ballot_sync(FULL, in && !(v && !sent));
  if (lane == 0) warp_free[warp] = __popc(fb);
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int w = 0; w < WARPS; ++w) n += warp_free[w];
    free_counts[(long long)p * tiles + t] = n;
  }
}

// 4. One block a local part q: the tiles' free counts into the rank of
// each tile's first free slot (their sum n_free); the rows received from
// each sender p (recv_rows[p * P_l + q]) into offsets info[q * (P + 2) +
// p], their sum n_mine at P and take = min(n_mine, n_free) at P + 1;
// the dropped rows and the received, free and adopted counts.
__global__ void __launch_bounds__(SCAN_THREADS)
adopt_scan(int* __restrict__ free_counts, int tiles, int P, int P_l,
           const int* __restrict__ recv_rows, int* __restrict__ info,
           long long* __restrict__ stats, long long* __restrict__ dropped) {
  const int q = blockIdx.x;
  const int n_free = scan_row(free_counts + (long long)q * tiles, tiles);
  if (threadIdx.x == 0) {
    int* o = info + (long long)q * (P + 2);
    int n_mine = 0;
    for (int p = 0; p < P; ++p) {
      o[p] = n_mine;
      n_mine += recv_rows[p * P_l + q];
    }
    const int take = min(n_mine, n_free);
    o[P] = n_mine;
    o[P + 1] = take;
    dropped[q] += max(n_mine - n_free, 0);
    stats[q * 5 + 2] = n_mine;
    stats[q * 5 + 3] = n_free;
    stats[q * 5 + 4] = take;
  }
}

// 5. Per (tile, local part q): the k-th free slot of q (slot order)
// takes immigrant k < take, row k - info[p] of sender p's block, p the
// last sender whose offset is <= k.
template <typename T>
__global__ void __launch_bounds__(TILE)
adopt_place(Slots<T> s, int P, int P_l, int cap, int tiles, int E, int K,
            const uint8_t* __restrict__ recv, int row_bytes,
            const int* __restrict__ free_counts,
            const int* __restrict__ info) {
  __shared__ int warp_free[WARPS];
  const int q = blockIdx.y, t = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int si = t * TILE + threadIdx.x;
  const long long i = (long long)q * cap + si;
  const bool fr = si < cap && !s.valid[i];
  const unsigned fb = __ballot_sync(FULL, fr);
  if (lane == 0) warp_free[warp] = __popc(fb);
  __syncthreads();
  if (!fr) return;
  int k = free_counts[(long long)q * tiles + t] + __popc(fb & lanes_below());
  for (int w = 0; w < warp; ++w) k += warp_free[w];
  const int* o = info + (long long)q * (P + 2);
  if (k >= o[P + 1]) return;
  int a = 0, b = P - 1;
  while (a < b) {
    const int mid = (a + b + 1) >> 1;
    if (o[mid] <= k) a = mid; else b = mid - 1;
  }
  const int K3 = 3 * K;
  const uint8_t* row =
      recv + (((long long)a * P_l + q) * E + (k - o[a])) * row_bytes;
  const T* f = reinterpret_cast<const T*>(row);
  const int* c =
      reinterpret_cast<const int*>(row + (FLOAT_COLS + K3) * sizeof(T));
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    s.cur[3 * i + j] = f[j];
    s.dest[3 * i + j] = f[3 + j];
  }
  s.weight[i] = f[6];
  s.pseg[i] = f[7];
  s.pid[i] = c[0];
  s.group[i] = c[1];
  s.mat[i] = c[2];
  s.elem[i] = c[3];
  s.done[i] = c[5] != 0;
  s.prev[i] = c[6];
  s.stuck[i] = 0;
  if (K > 0) {
    for (int j = 0; j < K3; ++j) s.xp[i * K3 + j] = f[FLOAT_COLS + j];
    s.kx[i] = c[7];
  }
  s.valid[i] = 1;
}

int row_bytes_of(int K, int item) {
  return (FLOAT_COLS + 3 * K) * item + INT_COLS * 4;
}

bool bad_shape(int P, int P_l, int cap, int E, int K) {
  return P < 1 || P > MAX_PARTS || P_l < 1 || P_l > 65535 || cap < 1 ||
         E < 1 || E > cap || K < 0;
}

template <typename T>
int bucket(void* const* fields, const void* canon, int P, int lo, int P_l,
           int cap, int E, int max_local, int K, void* counts, void* buf,
           void* rows, void* free_counts, void* stats, void* stream) {
  if (bad_shape(P, P_l, cap, E, K) || max_local < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Slots<T> s = slots_of<T>(fields);
  const int tiles = (cap + TILE - 1) / TILE;
  const dim3 grid(tiles, P_l);
  exchange_count<<<grid, TILE, (P + 1) * sizeof(int), st>>>(
      s.valid, s.target, P, cap, tiles, (int*)counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  exchange_scan<<<P_l, SCAN_THREADS, 0, st>>>(
      (int*)counts, P, tiles, E, (int*)rows, (long long*)stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  exchange_place<T><<<grid, TILE, place_smem(P), st>>>(
      s, (const long long*)canon, P, lo, cap, tiles, E, max_local, K,
      (const int*)counts, (uint8_t*)buf, row_bytes_of(K, sizeof(T)),
      (int*)free_counts);
  return (int)cudaGetLastError();
}

template <typename T>
int adopt(void* const* fields, int P, int P_l, int cap, int E, int K,
          const void* recv, const void* recv_rows, void* free_counts,
          void* info, void* stats, void* dropped, void* stream) {
  if (bad_shape(P, P_l, cap, E, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Slots<T> s = slots_of<T>(fields);
  const int tiles = (cap + TILE - 1) / TILE;
  adopt_scan<<<P_l, SCAN_THREADS, 0, st>>>(
      (int*)free_counts, tiles, P, P_l, (const int*)recv_rows, (int*)info,
      (long long*)stats, (long long*)dropped);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adopt_place<T><<<dim3(tiles, P_l), TILE, 0, st>>>(
      s, P, P_l, cap, tiles, E, K, (const uint8_t*)recv,
      row_bytes_of(K, sizeof(T)), (const int*)free_counts,
      (const int*)info);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points. fields: the 16 device pointers of Slots, in its order
// (xp and kx null without points). canon: the halo's int64 back
// codes [P_l * max_local], or null. Scratch (the wrapper's, reused every
// round): counts [P_l * (P + 1) * tiles], free_counts [P_l * tiles] and
// info [P_l * (P + 2)] int32, tiles = ceil(cap / 256); rows [P_l * P]
// int32 (the blocks' row counts, sent beside the buffer); buf [P_l * P *
// E] rows of pumi_exchange_row_bytes. stats [P_l, 5] int64 (pending,
// sent, received, free, adopted), dropped [P_l] int64 (added to).
// pumi_exchange_bucket_* launches 3 kernels, pumi_exchange_adopt_* 2
// (recv and recv_rows as the all_to_all returned them: [P, P_l, E] rows
// and [P, P_l] counts). Each returns the first launch's cudaError_t
// that is not cudaSuccess.
#define PUMI_EXCHANGE(TAG, T)                                                 \
  extern "C" int pumi_exchange_bucket_##TAG(                                 \
      void* const* fields, const void* canon, int P, int lo, int P_l,        \
      int cap, int E, int max_local, int K, void* counts, void* buf,         \
      void* rows, void* free_counts, void* stats, void* stream) {            \
    return bucket<T>(fields, canon, P, lo, P_l, cap, E, max_local, K,        \
                     counts, buf, rows, free_counts, stats, stream);         \
  }                                                                          \
  extern "C" int pumi_exchange_adopt_##TAG(                                  \
      void* const* fields, int P, int P_l, int cap, int E, int K,            \
      const void* recv, const void* recv_rows, void* free_counts,            \
      void* info, void* stats, void* dropped, void* stream) {                \
    return adopt<T>(fields, P, P_l, cap, E, K, recv, recv_rows, free_counts, \
                    info, stats, dropped, stream);                           \
  }
PUMI_EXCHANGE(f32, float)
PUMI_EXCHANGE(f64, double)
#undef PUMI_EXCHANGE

// The bytes of a send row: (8 + 3K) floats of item bytes, 8 int32.
extern "C" int pumi_exchange_row_bytes(int K, int item) {
  return row_bytes_of(K, item);
}

// The dynamic shared memory bytes the largest launch of a round passes
// at n_parts parts (the place pass's per-warp counts), for the resource
// contracts.
extern "C" long long pumi_exchange_smem(int n_parts) {
  return (long long)place_smem(n_parts);
}
