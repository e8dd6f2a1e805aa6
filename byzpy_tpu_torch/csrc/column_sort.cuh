// The column-sort engine: every column of a slot of rows sorted by the
// int32 total-order key and reduced in rank order, a block walking a run of
// column tiles of one slot through a ring of staged tiles.
//
// Three kernels are instantiations of it: B1 (csrc/sorted_reduce.cu, a
// slot is a round of a (K, n, d) stack), the ragged door's segmented
// sort-reduce (csrc/segmented_sort.cu, a slot is a cohort whose offset and
// length live in device memory) and B6, MeaMed (csrc/meamed.cu, a slot is a
// round). Each brings its slot layout and the finish of its reduce; the
// engine does the staging, the sort and the window it hands to the reduce,
// or, for a column reduce (B6), the sorted keys in shared memory and the
// column's place in x.
//
// Bound. The kernels read every row once and write one value a column:
// bytes. The compare-exchanges of Batcher's network come close to that:
// 543 a 64-row column, an int32 min and a max each, run at half the card's
// f32 FMA rate (chip_smoke.py's PEAK_INT_MINMAX_PER_S), so the sort of a
// tile costs about as long as its read, and the kernel comes near its
// bound only if a block's loads are in flight while it sorts. As built the
// sort bounds it: the kernel takes 1.1-1.2x its sort alone, the loads
// alone take 0.6-0.8x (chip_segmented_ablation.py). Design:
//   - grid (run, slot): block (r, s) takes column tiles [r T, (r + 1) T) of
//     slot s, T from ops/kernels.py:column_runs on the host (one wave of
//     resident blocks a slot). A slot's network width is the same for all
//     its tiles, so a block never changes width, and the card dispatches
//     one slot's blocks after another's: blocks of the four widths'
//     unrolled networks on one SM at once thrash its instruction cache
//     (chip_segmented_ablation.py's slots_interleaved);
//   - a block is 128 consumer threads and one producer warp. The producer
//     copies each row of a step into the ring with one bulk copy
//     (cp.async.bulk, completing on the stage's mbarrier), from the row's
//     16-byte-aligned start: a row of d = 421,642 f32 is only 8-byte
//     aligned, and a 16-bit row may start at an odd element, so a stage
//     row holds the row at its start's byte shift, which repeats every 4
//     rows (f32) or 8 (16-bit) and which the consumers add back. Starting
//     ~2,000 per-lane cp.async a step stalled the warps that started them
//     for most of the copy (chip_segmented_ablation.py), so no sorting
//     thread starts a copy;
//   - a consumer waits on a step's mbarrier, takes its column's keys into
//     registers, and releases the step's slot (a named barrier the producer
//     waits on before it copies a later step into it): the next steps'
//     copies run while it sorts. Two ~34 KB buffers (three blocks an SM)
//     hold two 64-row steps, or up to eight of a small slot's, so a small
//     slot keeps as many bytes in flight as a large one;
//   - up to 64 rows (the narrow path), a step is one tile of 128 columns
//     and one consumer sorts one column in registers at the smallest width
//     N that holds the slot (8, 16, 32 or 64). A column sits in one bank
//     column of the stage: no load conflicts. A consumer never sorts two
//     columns of a step: the registers of a second made ptxas spill;
//   - 65-128 rows (the wide path), a step holds 64 columns: two consumers
//     sort a column's two runs of 64 and write their keys back, then one
//     merges them by a bitonic merge whose first stage compares position i
//     with its mirror 127 - i, two 16-key chunks in registers at a time. No
//     thread holds more than 64 keys. The merge works in the stage, so the
//     stage is released after it;
//   - the stage's loads are explicit ld.shared at each row's shift;
//   - 16-bit inputs keep 16-bit keys (the f32 key of a bf16 or f16 value
//     orders as the value's own sign-magnitude key does, so the two sorts
//     give the same sequence), which the wide path writes back in place;
//   - positions at and past m hold PAD_KEY from start to end (a comparator
//     whose upper slot holds PAD_KEY leaves both), and are never stored;
//   - the reduce is fused: the keys reach it in rank order, and only the
//     result goes back to memory;
//   - a column reduce (Red::kColumn, B6) indexes the sorted keys at
//     run-time positions and walks the column in row order: the engine
//     writes the sorted keys back over the column in the stage (narrow
//     path: at the addresses it read them from; wide path: the merge's last
//     stage stores too), hands the reduce a view of them (and, on the
//     narrow path, the sorted keys in registers), releases the stage
//     once the reduce is done with it, and the reduce reads the column again
//     from device memory, where the producer's copy has just passed through
//     L2. A reduce sets its ring's buffers (kRingStages): B6 takes one.
#pragma once

#include <atomic>
#include <climits>

#include "common.cuh"

namespace colsort {

constexpr int kThreads = 128;  // consumer threads: one column each on the narrow path
constexpr int kBlockThreads = kThreads + 32;  // and one producer warp
constexpr int kTile = 128;     // columns of a tile, the unit of a run
constexpr int kWide = 64;      // keys a thread sorts in registers at most
constexpr int kChunk = 16;     // keys of each operand of a merge stage
constexpr int kShift = 16;     // bytes a stage row holds beyond its columns
// a stage: the widest step (128 rows of 64 f32 columns, or 64 of 128) with
// each row's shift
constexpr int kStageBytes = 2 * kWide * (kWide * 4 + kShift);
constexpr int kStages = 2;     // stage buffers of the ring (a kernel's reduce may take fewer)
constexpr int kMaxDepth = 8;   // steps in flight at most (a small slot's steps share a buffer)
constexpr int kRingOffset = 128;  // the stages' mbarriers come first
// registers for four blocks an SM (96 a thread; shared memory holds three):
// 128 ran no faster (chip_segmented_ablation.py's min_blocks_3)
constexpr int kMinBlocks = 4;

// The sort key of each element type, as an int32 in registers and as the
// element type in shared memory.
template <typename T> struct Keys;

template <> struct Keys<float> {
  using Elem = int32_t;
  __device__ static __forceinline__ int32_t raw(Elem e) { return float_sort_key(__int_as_float(e)); }
  __device__ static __forceinline__ int32_t key(Elem e) { return e; }
  __device__ static __forceinline__ Elem pack(int32_t k) { return k; }
  __device__ static __forceinline__ float value(int32_t k) { return key_to_float(k); }
};

// 16-bit floats: NaN to the canonical quiet NaN QNAN, then the magnitude
// bits of negatives flipped, sign-extended to int32. INF: the bits of +inf.
template <int INF, int QNAN> struct Keys16 {
  using Elem = int16_t;
  __device__ static __forceinline__ int32_t raw(Elem e) {
    int32_t v = e;
    if ((v & 0x7FFF) > INF) v = QNAN;
    return v < 0 ? (v ^ 0x7FFF) : v;
  }
  __device__ static __forceinline__ int32_t key(Elem e) { return e; }
  __device__ static __forceinline__ Elem pack(int32_t k) { return static_cast<Elem>(k); }
  __device__ static __forceinline__ unsigned short bits(int32_t k) {
    return static_cast<unsigned short>(k < 0 ? (k ^ 0x7FFF) : k);
  }
};

template <> struct Keys<__nv_bfloat16> : Keys16<0x7F80, 0x7FC0> {
  __device__ static __forceinline__ float value(int32_t k) {
    return __bfloat162float(__ushort_as_bfloat16(bits(k)));
  }
};

template <> struct Keys<__half> : Keys16<0x7C00, 0x7E00> {
  __device__ static __forceinline__ float value(int32_t k) {
    return __half2float(__ushort_as_half(bits(k)));
  }
};

// ---------------------------------------------------------------------------
// Shared memory, barriers and bulk copies
// ---------------------------------------------------------------------------

template <class E> __device__ __forceinline__ int32_t lds(unsigned a);
template <> __device__ __forceinline__ int32_t lds<int32_t>(unsigned a) {
  int32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}
template <> __device__ __forceinline__ int32_t lds<int16_t>(unsigned a) {
  int32_t v;
  asm volatile("ld.shared.s16 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}

// Named barriers (ids 1..; 0 is __syncthreads): the consumers among
// themselves, then an empty barrier a stage.
constexpr int kBarConsumers = 1, kBarEmpty = 2;

// Generic-proxy writes to shared memory before the async proxy writes there.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// The sort
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cx(int32_t& a, int32_t& b) {
  const int32_t x = a, y = b;
  a = min(x, y);
  b = max(x, y);
}

// Bitonic half-cleaners at distances J, J / 2, ..., 1 within N registers.
template <int N, int J>
__device__ __forceinline__ void clean(int32_t (&k)[N]) {
  if constexpr (J >= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if ((i & J) == 0) cx(k[i], k[i | J]);
    clean<N, J / 2>(k);
  }
}

// Keys of rows [0, N) of this thread's column of a step as staged (row r at
// byte base[r % P] + off + r RS, base[] holding each row residue's shift),
// PAD_KEY at and past m.
template <class K, int N, int RS, int P>
__device__ __forceinline__ void load_staged(int32_t (&k)[N], const unsigned (&base)[P], int off, int m) {
#pragma unroll
  for (int r = 0; r < N; ++r)
    k[r] = r < m ? K::raw(lds<typename K::Elem>(base[r % P] + off + r * RS)) : PAD_KEY;
}

// Write k[r] back over row r of this thread's column of a step as staged
// (the addresses load_staged read), r < m.
template <class K, int N, int RS, int P>
__device__ __forceinline__ void store_staged(const int32_t (&k)[N], const unsigned (&base)[P], int m) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    if (r < m) {
      if constexpr (sizeof(typename K::Elem) == 4) {
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(base[r % P] + r * RS), "r"(k[r]) : "memory");
      } else {
        asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(base[r % P] + r * RS), "h"((unsigned short)k[r])
                     : "memory");
      }
    }
  }
}

// Keys of sorted positions [base, base + N) of a column of keys written back
// to the stage (element p at col[p * STRIDE]), PAD_KEY at and past m.
template <class K, int N, int STRIDE>
__device__ __forceinline__ void load(int32_t (&k)[N], const typename K::Elem* col, int base, int m) {
#pragma unroll
  for (int r = 0; r < N; ++r) k[r] = base + r < m ? K::key(col[(base + r) * STRIDE]) : PAD_KEY;
}

template <class K, int N, int STRIDE>
__device__ __forceinline__ void store(const int32_t (&k)[N], typename K::Elem* col, int base, int m) {
#pragma unroll
  for (int r = 0; r < N; ++r)
    if (base + r < m) col[(base + r) * STRIDE] = K::pack(k[r]);
}

// The fused reduce's window over sorted positions handed to it in
// ascending order: a sum (`sum`), positions [lo, hi) added with __fadd_rn
// from +0.0; otherwise the keys at lo and hi (and, LAST, at last). The
// kind is a runtime flag, uniform over the grid, tested once a call of
// take(). A kernel's reduce derives from it and adds the finish.
template <class K, bool LAST = false>
struct Window {
  static constexpr bool kColumn = false;
  static constexpr int kRingStages = kStages;
  bool sum;
  int lo, hi, last;
  float acc = 0.0f;
  int32_t klo = 0, khi = 0, klast = 0;

  __device__ __forceinline__ Window(bool sum_, int lo_, int hi_, int last_)
      : sum(sum_), lo(lo_), hi(hi_), last(last_) {}

  template <int N>
  __device__ __forceinline__ void take(const int32_t (&k)[N], int base) {
    if (sum) {
#pragma unroll
      for (int r = 0; r < N; ++r)
        if (base + r >= lo && base + r < hi) acc = __fadd_rn(acc, K::value(k[r]));
    } else {
#pragma unroll
      for (int r = 0; r < N; ++r) {
        if (base + r == lo) klo = k[r];
        if (base + r == hi) khi = k[r];
        if constexpr (LAST) {
          if (base + r == last) klast = k[r];
        }
      }
    }
  }
};

// The sorted keys of one column as a column reduce sees them: key(p) for a
// run-time position p < m. Narrow path: written back over the column in the
// stage, position p at the byte shift of row p (a + p e mod 16, the ring's
// shift rule; e = d sizeof(T) mod 16) from the column's unshifted address.
template <class K, int RS>
struct StagedKeys {
  unsigned col;  // the column's address in the stage, before the row shifts
  unsigned a, e;
  __device__ __forceinline__ int32_t operator()(int p) const {
    return K::key(lds<typename K::Elem>(col + ((a + p * e) & 15u) + p * RS));
  }
};

// Wide path: the merged column in the stage, position p at col[p * STRIDE].
template <class K, int STRIDE>
struct TileKeys {
  const typename K::Elem* col;
  __device__ __forceinline__ int32_t operator()(int p) const { return K::key(col[p * STRIDE]); }
};

// ---------------------------------------------------------------------------
// The ring
// ---------------------------------------------------------------------------

// A run's layout in the ring: DEPTH slots of STEP bytes (as many steps of
// one width as its STAGES buffers hold, at most kMaxDepth), their mbarriers
// and the byte shift of each row residue (rows of d elements, `first` the
// run's first column of the slot's first row: a step starts a multiple of
// 16 bytes on, so the shifts are the same at every step).
template <typename T, int STEP, int STAGES>
struct Ring {
  static constexpr int P = 16 / sizeof(T);  // rows after which the shifts repeat
  static constexpr int DEPTH = STAGES * (kStageBytes / STEP) < kMaxDepth
                                   ? STAGES * (kStageBytes / STEP) : kMaxDepth;
  unsigned stages, mbars;
  unsigned shift[P];

  __device__ __forceinline__ Ring(unsigned char* smem, const T* first, long long d) {
    mbars = smem_addr(smem);
    stages = mbars + kRingOffset;
    const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(first)) & 15u;
    const unsigned e = static_cast<unsigned>(d * (long long)sizeof(T)) & 15u;
#pragma unroll
    for (int q = 0; q < P; ++q) shift[q] = (a + q * e) & 15u;
  }
  __device__ __forceinline__ unsigned stage(int j) const { return stages + (j % DEPTH) * STEP; }
  __device__ __forceinline__ unsigned full(int j) const { return mbars + (j % DEPTH) * 8; }
};

// The producer warp: step j (rows [row0, row0 + m) of columns [c0 + j SW,
// ...), at most SW of them, row stride RS bytes in the stage) into its
// slot once the consumers have released step j - DEPTH; each lane copies
// rows lane, lane + 32, ..., and lane 0 first tells the stage's mbarrier
// how many bytes are coming.
template <typename T, int SW, int RS, class R>
__device__ __forceinline__ void produce(const R& ring, const T* __restrict__ x, long long row0,
                                        int m, long long d, long long c0, long long c1) {
  const int lane = threadIdx.x & 31;
  const int steps = (int)((c1 - c0 + SW - 1) / SW);
#pragma unroll 1
  for (int j = 0; j < steps; ++j) {
    if (j >= R::DEPTH) bar_sync(kBarEmpty + j % R::DEPTH, kBlockThreads);
    const long long cs = c0 + (long long)j * SW;
    const unsigned bytes = (unsigned)min((long long)SW, c1 - cs) * (unsigned)sizeof(T);
    unsigned total = 0;
    for (int r = lane; r < m; r += 32) {
      const unsigned sh = static_cast<unsigned>(reinterpret_cast<uintptr_t>(x + (row0 + r) * d + cs)) & 15u;
      total += (sh + bytes + 15u) & ~15u;
    }
#pragma unroll
    for (int o = 16; o >= 1; o /= 2) total += __shfl_xor_sync(0xFFFFFFFFu, total, o);
    if (lane == 0) mbar_expect_tx(ring.full(j), total);
    __syncwarp();
    for (int r = lane; r < m; r += 32) {
      const char* src = reinterpret_cast<const char*>(x + (row0 + r) * d + cs);
      const unsigned sh = static_cast<unsigned>(reinterpret_cast<uintptr_t>(src)) & 15u;
      bulk_copy(ring.stage(j) + r * RS, src - sh, (sh + bytes + 15u) & ~15u, ring.full(j));
    }
  }
}

// A consumer: step j is in its stage.
template <class R>
__device__ __forceinline__ void consume_wait(const R& ring, int j) {
  while (!mbar_try_wait(ring.full(j), (unsigned)(j / R::DEPTH) & 1u)) {
  }
}

// A consumer is done with step j's slot (the producer waits for it only
// where a later step goes into it).
template <class R>
__device__ __forceinline__ void consume_release(const R&, int j, int steps) {
  if (j + R::DEPTH < steps) bar_arrive(kBarEmpty + j % R::DEPTH, kBlockThreads);
}

// Columns [c0, c1) of a slot of m <= 64 rows at network width N: a step is
// one tile, and each consumer takes its column's keys into registers,
// releases the stage, then sorts them while the next tile's copy runs.
template <typename T, int N, class Red, typename OutT>
__device__ __forceinline__ void narrow_run(const T* __restrict__ x, unsigned char* smem, long long row0,
                                           int m, long long d, long long c0, long long c1,
                                           OutT* __restrict__ out, const Red& red0) {
  using K = Keys<T>;
  constexpr int RS = kTile * (int)sizeof(T) + kShift;  // a stage row's bytes
  using R = Ring<T, N * RS, Red::kRingStages>;
  const R ring(smem, x + row0 * d + c0, d);
  const int tid = threadIdx.x;
  if (tid >= kThreads) return produce<T, kTile, RS>(ring, x, row0, m, d, c0, c1);
  const int steps = (int)((c1 - c0 + kTile - 1) / kTile);
#pragma unroll 1
  for (int j = 0; j < steps; ++j) {
    consume_wait(ring, j);
    unsigned base[R::P];
#pragma unroll
    for (int q = 0; q < R::P; ++q) base[q] = ring.stage(j) + ring.shift[q] + tid * (int)sizeof(T);
    int32_t k[N];
    load_staged<K, N, RS>(k, base, 0, m);
    const long long c = c0 + (long long)j * kTile + tid;
    if constexpr (Red::kColumn) {
      // the stage holds the sorted keys until the reduce has read them
      Red red = red0;
      if (c < c1) {
        batcher_sort<N>(k);
        store_staged<K, N, RS>(k, base, m);
        const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(x + row0 * d + c0)) & 15u;
        red.sorted(StagedKeys<K, RS>{ring.stage(j) + tid * (unsigned)sizeof(T), a,
                                     static_cast<unsigned>(d * (long long)sizeof(T)) & 15u},
                   k);
      }
      fence_proxy_async();  // the keys written back, before the next bulk copy lands
      consume_release(ring, j, steps);
      if (c < c1) out[c] = red.value(x + row0 * d + c, d);
    } else {
      consume_release(ring, j, steps);
      if (c < c1) {
        batcher_sort<N>(k);
        Red red = red0;
        red.take(k, 0);
        out[c] = red.value();
      }
    }
  }
}

// Sort each run of 64 rows of a 64-column step as staged (64 < m <= 128)
// in registers and write its keys back unshifted (row stride RS bytes):
// consumer t takes run t / 64 of column t % 64. Out of line: inlined, this
// second 64-key network makes ptxas give the whole kernel 168 registers and
// spills (chip_segmented_ablation.py's runs_inline variant).
template <class K, int RS, int P>
__device__ __noinline__ void sort_runs(const unsigned (&stage_base)[P], typename K::Elem* tile, int m) {
  constexpr int S = kThreads / 2, STRIDE = RS / (int)sizeof(typename K::Elem);
  int32_t k[kWide];
  const int c = threadIdx.x % S, rb = threadIdx.x < S ? 0 : kWide;
  unsigned base[P];
#pragma unroll
  for (int q = 0; q < P; ++q) base[q] = stage_base[q] + c * (int)sizeof(typename K::Elem);
  load_staged<K, kWide, RS>(k, base, rb * RS, m - rb);
  bar_sync(kBarConsumers, kThreads);  // every staged value is read before a key overwrites one
  batcher_sort<kWide>(k);
  store<K, kWide, STRIDE>(k, tile + c, rb, m);
}

// Merge the two sorted runs of one column (row stride STRIDE) and hand the
// keys to the reduce: one bitonic merge of 128 whose first stage compares
// position i with its mirror 127 - i, two 16-key chunks in registers at a
// time; its last stage hands the chunks to the reduce in rank order (a
// column reduce: stores them, so the column holds its sorted keys).
template <class K, int STRIDE, class Red>
__device__ __forceinline__ void merge_wide(typename K::Elem* col, int m, Red& red) {
  constexpr int W = 2 * kWide;
  for (int pa = 0; pa < kWide; pa += kChunk) {
    const int pb = W - kChunk - pa;
    int32_t a[kChunk], z[kChunk];
    load<K, kChunk, STRIDE>(a, col, pa, m);
    load<K, kChunk, STRIDE>(z, col, pb, m);
#pragma unroll
    for (int r = 0; r < kChunk; ++r) cx(a[r], z[kChunk - 1 - r]);
    store<K, kChunk, STRIDE>(a, col, pa, m);
    store<K, kChunk, STRIDE>(z, col, pb, m);
  }
  for (int j = W / 4; j >= 2 * kChunk; j /= 2) {
    for (int p = 0; p < m; p += kChunk) {
      if (p & j) continue;
      int32_t a[kChunk], z[kChunk];
      load<K, kChunk, STRIDE>(a, col, p, m);
      load<K, kChunk, STRIDE>(z, col, p + j, m);
#pragma unroll
      for (int r = 0; r < kChunk; ++r) cx(a[r], z[r]);
      store<K, kChunk, STRIDE>(a, col, p, m);
      store<K, kChunk, STRIDE>(z, col, p + j, m);
    }
  }
  for (int p = 0; p < m; p += 2 * kChunk) {
    int32_t a[kChunk], z[kChunk];
    load<K, kChunk, STRIDE>(a, col, p, m);
    load<K, kChunk, STRIDE>(z, col, p + kChunk, m);
#pragma unroll
    for (int r = 0; r < kChunk; ++r) cx(a[r], z[r]);
    clean<kChunk, kChunk / 2>(a);
    clean<kChunk, kChunk / 2>(z);
    if constexpr (Red::kColumn) {
      store<K, kChunk, STRIDE>(a, col, p, m);
      store<K, kChunk, STRIDE>(z, col, p + kChunk, m);
    } else {
      red.take(a, p);
      red.take(z, p + kChunk);
    }
  }
}

// Columns [c0, c1) of a slot of 65-128 rows: a step is 64 columns, sorted
// and merged in the stage, which a consumer releases once it is done with
// it (after its run sort, or after the merge).
template <typename T, class Red, typename OutT>
__device__ __forceinline__ void wide_run(const T* __restrict__ x, unsigned char* smem, long long row0,
                                         int m, long long d, long long c0, long long c1,
                                         OutT* __restrict__ out, const Red& red0) {
  using K = Keys<T>;
  using E = typename K::Elem;
  constexpr int SW = kThreads / 2;
  constexpr int RS = SW * (int)sizeof(T) + kShift;
  using R = Ring<T, 2 * kWide * RS, Red::kRingStages>;
  const R ring(smem, x + row0 * d + c0, d);
  const int tid = threadIdx.x;
  if (tid >= kThreads) return produce<T, SW, RS>(ring, x, row0, m, d, c0, c1);
  const int steps = (int)((c1 - c0 + SW - 1) / SW);
#pragma unroll 1
  for (int j = 0; j < steps; ++j) {
    consume_wait(ring, j);
    unsigned base[R::P];
#pragma unroll
    for (int q = 0; q < R::P; ++q) base[q] = ring.stage(j) + ring.shift[q];
    E* tile = reinterpret_cast<E*>(smem + kRingOffset + (j % R::DEPTH) * (2 * kWide * RS));
    sort_runs<K, RS>(base, tile, m);
    bar_sync(kBarConsumers, kThreads);
    const long long c = c0 + (long long)j * SW + tid;
    constexpr int STRIDE = RS / (int)sizeof(E);
    if constexpr (Red::kColumn) {
      Red red = red0;
      const bool mine = tid < SW && c < c1;
      if (mine) {
        merge_wide<K, STRIDE>(tile + tid, m, red);
        red.sorted(TileKeys<K, STRIDE>{tile + tid});
      }
      fence_proxy_async();
      consume_release(ring, j, steps);  // after the reduce has read the keys
      if (mine) out[c] = red.value(x + row0 * d + c, d);
    } else {
      if (tid < SW && c < c1) {
        Red red = red0;
        merge_wide<K, STRIDE>(tile + tid, m, red);
        out[c] = red.value();
      }
      fence_proxy_async();  // the keys written back, before the next bulk copy lands
      consume_release(ring, j, steps);  // after the merge
    }
  }
}

// Columns [c0, c1) of this block's run of tiles (blockIdx.x of run_tiles).
__device__ __forceinline__ void run_columns(long long d, int run_tiles, long long& c0, long long& c1) {
  c0 = (long long)blockIdx.x * run_tiles * kTile;
  c1 = min(d, c0 + (long long)run_tiles * kTile);
}

// This block's run of a slot of m rows starting at row0 of x (rows of d
// columns): sorted and reduced by red0's kind, one value a column to out
// (the slot's output row). smem: ring_bytes(Red::kRingStages) of dynamic
// shared memory.
// Network widths LO..HI are compiled in; m must need one of them. Every
// thread of the block calls it.
template <typename T, int LO, int HI, class Red, typename OutT>
__device__ __forceinline__ void sort_run(const T* __restrict__ x, unsigned char* smem, long long row0,
                                         int m, long long d, int run_tiles, OutT* __restrict__ out,
                                         const Red& red0) {
  long long c0, c1;
  run_columns(d, run_tiles, c0, c1);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxDepth; ++s) mbar_init(smem_addr(smem) + s * 8, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const int w = m <= 8 ? 8 : m <= 16 ? 16 : m <= 32 ? 32 : m <= 64 ? 64 : 128;
  if constexpr (LO <= 8 && 8 <= HI) {
    if (w == 8) return narrow_run<T, 8>(x, smem, row0, m, d, c0, c1, out, red0);
  }
  if constexpr (LO <= 16 && 16 <= HI) {
    if (w == 16) return narrow_run<T, 16>(x, smem, row0, m, d, c0, c1, out, red0);
  }
  if constexpr (LO <= 32 && 32 <= HI) {
    if (w == 32) return narrow_run<T, 32>(x, smem, row0, m, d, c0, c1, out, red0);
  }
  if constexpr (LO <= 64 && 64 <= HI) {
    if (w == 64) return narrow_run<T, 64>(x, smem, row0, m, d, c0, c1, out, red0);
  }
  if constexpr (HI == 128) {
    if (w == 128) return wide_run<T>(x, smem, row0, m, d, c0, c1, out, red0);
  }
}

// Write `v` to every column of this block's run of out (a slot that reads
// no rows).
template <typename OutT>
__device__ __forceinline__ void fill_run(OutT* __restrict__ out, long long d, int run_tiles, OutT v) {
  long long c0, c1;
  run_columns(d, run_tiles, c0, c1);
  for (long long c = c0 + threadIdx.x; c < c1; c += kBlockThreads) out[c] = v;
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

constexpr int ring_bytes(int stages = kStages) { return kRingOffset + stages * kStageBytes; }

// Launch KERNEL(args..., run_tiles) on grid (runs, slots), a run being
// run_tiles column tiles of a slot's d columns (ops/kernels.py:column_runs
// picks run_tiles), with a ring of STAGES buffers (its reduce's
// kRingStages) in dynamic shared memory. The kernel's shared-memory
// attributes are set once a device. Returns the first error of the set-up
// or launch.
template <auto KERNEL, int STAGES = kStages, typename... Args>
cudaError_t launch(int slots, long long d, int run_tiles, cudaStream_t stream, Args... args) {
  static std::atomic<unsigned long long> ready{0};  // a bit a device whose attributes are set
  constexpr int smem = ring_bytes(STAGES);
  const long long tiles = (d + kTile - 1) / kTile;
  const long long runs = run_tiles < 1 ? 0 : (tiles + run_tiles - 1) / run_tiles;
  if (runs < 1 || runs > INT_MAX || slots < 1 || slots > 65535) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(ready.load(std::memory_order_relaxed) & bit)) {
    const void* fn = reinterpret_cast<const void*>(KERNEL);
    if ((err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
      return err;
    if ((err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                    cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
      return err;
    ready.fetch_or(bit, std::memory_order_relaxed);
  }
  KERNEL<<<dim3((unsigned)runs, (unsigned)slots), kBlockThreads, smem, stream>>>(args..., run_tiles);
  return cudaGetLastError();
}

}  // namespace colsort
