// B4: fused score -> select -> weighted mean (Multi-Krum, CGE, MoNNA) over K
// stacked (n, d) rounds, phases 2 and 3; and B5, the same on one round
// whose Gram is given, in one launch.
//
// B4 replaces byzpy_tpu/ops/pallas_kernels.py:928
// _selection_mean_stream_kernel (pallas_call at :1036). The TPU kernel
// keeps the Gram and the weights in VMEM scratch across a (K, 2, C) grid.
// Here the same work is a sequence of launches; phase 1 (the Gram) is B3
// (gram.cu), and the two launches below take the Gram as an argument:
//   2. byz_selection_weights: one block per round. norms = diag(G), d2 =
//      max(n_i + n_j - 2 G_ij, 0) (:763-769); krum scores are the sum of
//      sorted-key rows [1, n - f) of each d2 column with pads at the max
//      key (:772-781, :843-859) -- the diagonal is not special-cased, the
//      sort drops it; cge scores are the norms, monna scores d2[ref]. Ranks
//      put NaN last, pads after NaN, ties by index; the q lowest get weight
//      1/q in f32 (:862-883).
//   3. byz_weighted_rows: out = sum_i (w_i != 0 ? x_i : 0) * w_i in f32,
//      rows ascending, cast to the input dtype (:967-971).
//
// Bound: memory for the sweep, which reads the q selected rows once; the
// weights touch only (n, n) data, and what bounds them is one SM's
// instructions and the latency of the block's barriers.
// Design of the weights: one block of up to 512 threads a round over
// the (n, n) problem (selection_block.cuh), where each thread used to own
// a node and run its own serial loops (a sort of its column in registers,
// n-long walks), with an instance for krum and one for cge and monna,
// picked on the host by mode. krum: up to 8 rows thread j forms, sorts and
// adds column j in registers; from 16 rows on every thread loads its tile
// of the Gram into registers while the block reads the diagonal, forms
// the distances' keys into a padded square buffer, the lanes of a warp
// sort each column, up to 16 consecutive keys a lane in registers
// (KeySort), and thread j adds its column's sorted positions in order.
// cge and monna read the diagonal (and monna row ref) from device memory
// and take no dynamic shared memory. The ranks are counted by parts of the
// block, a slice of the rows each. The finish (select_weights) is B9's and
// B10's. chip_selection_ablation.py --kinds b4 takes it apart.
// Design of the sweep: one thread per column with coalesced row loads and
// rows of weight 0 skipped, so it reads q / n of x instead of all of it.
//
// B5 replaces :1094 _selection_from_gram_kernel (pallas_call at :1187),
// whose grid step 0 writes the weights to scratch and every step sweeps its
// tile: byz_selection_mean_from_gram is one launch of
// selection_mean_from_gram_kernel (below), B4's weights block and a sweep
// of the selected rows whose loads are in flight, the blocks sharing the
// weights through a small scratch in device memory. It reads the Gram and
// the q selected rows once and writes the (d,) row, the bound's bytes.
//
// The sweep also serves B9 and B10 (nnm.cu, clip_selection.cu), whose
// weights are NaN everywhere when the selection took a non-finite row
// (pallas_kernels.py:1454, :1543). It therefore reads every row whose
// weight is not 0, NaN included, so such a weight poisons every column as
// the reference's sum does. B4's weights are 1/q or 0, so its output is
// the one the w > 0 rule gave. Rows the reference zeroes as tainted carry
// weight 0 or sit in an all-NaN weight vector, so the sweep needs no taint
// argument: skipping a weight-0 row drops a term that is exactly +-0.

#include <type_traits>

#include "selection_block.cuh"

namespace {

constexpr int kRowThreads = 256;

// B4's weights block: NPAD x NPAD problem, at most kSelThreads threads
// (512 ran every mode faster than 1,024 at 64 and 128 rows on the H100,
// chip_selection_ablation.py).
constexpr int kSelThreads = 512;

template <int NPAD>
using SelShape = selblock::Shape<NPAD, kSelThreads>;

template <int NPAD, bool KRUM>
__global__ void __launch_bounds__(SelShape<NPAD>::T, 1)
selection_weights_kernel(const float* __restrict__ gram, float* __restrict__ w, int n, int f,
                         int q, int mode, int ref) {
  using S = SelShape<NPAD>;
  extern __shared__ __align__(16) unsigned char dyn[];  // krum_score's keys
  __shared__ float nrm[NPAD];
  __shared__ selblock::Ranked<NPAD> r;
  const int t = threadIdx.x;
  const float* g = gram + (long long)blockIdx.x * n * n;
  // krum: this thread's tile of the Gram, its loads in flight with the diagonal's
  float tile[S::RA][S::RB];
  if constexpr (KRUM && NPAD > 8) selblock::load_tile<S>(DenseGram{g, n}, n, tile);
  if (t < NPAD) nrm[t] = t < n ? g[t * n + t] : __int_as_float(0x7FC00000);
  __syncthreads();
  const float wt = selblock::select_weights<S, NPAD, KRUM>(
      DenseGram{g, n}, [&](int rr, int cc, int, int) { return tile[rr][cc]; },
      reinterpret_cast<int32_t*>(dyn), nrm, n, f, q, mode, ref, r);
  if (t < n) w[(long long)blockIdx.x * n + t] = wt;
}

// One launch of B4's weights at width NPAD: a block a round, an instance
// for krum and one for cge and monna; krum's keys in dynamic shared
// memory, opted in above 48 KB once a device.
template <int NPAD>
cudaError_t launch_weights(const float* gram, float* w, int K, int n, int f, int q, int mode,
                           int ref, cudaStream_t s) {
  constexpr int T = SelShape<NPAD>::T;
  if (mode != kKrum) {
    selection_weights_kernel<NPAD, false><<<K, T, 0, s>>>(gram, w, n, f, q, mode, ref);
    return cudaGetLastError();
  }
  static std::atomic<unsigned long long> ready{0};
  constexpr int dyn = selblock::krum_smem_bytes<NPAD>();
  const cudaError_t err = selblock::raise_smem_once(
      reinterpret_cast<const void*>(&selection_weights_kernel<NPAD, true>), dyn, ready);
  if (err != cudaSuccess) return err;
  selection_weights_kernel<NPAD, true><<<K, T, dyn, s>>>(gram, w, n, f, q, mode, ref);
  return cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
weighted_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     T* __restrict__ out, int n, long long d) {
  __shared__ float ws[128];
  const int k = blockIdx.y;
  if (threadIdx.x < n) ws[threadIdx.x] = w[(long long)k * n + threadIdx.x];
  __syncthreads();
  const long long c = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  if (c >= d) return;
  const T* xk = x + (long long)k * n * d + c;
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) {
    const float wi = ws[i];
    // a weight-0 row adds exactly +-0 in the reference: skip its read
    if (wi != 0.0f) acc = __fadd_rn(acc, __fmul_rn(to_f32(xk[(long long)i * d]), wi));
  }
  out[(long long)k * d + c] = from_f32<T>(acc);
}

template <typename T>
void launch_rows(const void* x, const float* w, void* out, int K, int n,
                 long long d, cudaStream_t s) {
  const dim3 grid((unsigned)((d + kRowThreads - 1) / kRowThreads), (unsigned)K);
  weighted_rows_kernel<T><<<grid, kRowThreads, 0, s>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), n, d);
}

// B5: the weights and the sweep in one launch. The scratch, in device
// memory, is the wrapper's, one for each device and stream (calls on one
// stream run one after another); it starts zeroed, and the kernel leaves
// it zeroed. Each counter and each copy of the published selection has a
// 128-byte line of its own, so that the blocks' atomics and polls do not
// queue at one L2 slice. A copy is six 64-bit words, each a payload in its
// low half and kValid in its high half: a poll that reads all six valid
// has read the selection, with no flag to wait for first.
constexpr int kReplicas = 8;  // copies of the published selection
constexpr unsigned long long kValid = 1ull << 32;

struct alignas(128) Counter {
  unsigned v;
};

struct alignas(128) Published {
  unsigned long long word[6];  // the 4 words of the row mask, the weight's bits, and a pad
};

struct FromGramScratch {
  Counter ticket;  // blocks that took a ticket: the first computes the weights
  Counter exits;   // blocks that have the selection: the last zeroes the scratch
  Published pub[kReplicas];
};

// Rows of the sweep whose loads are in flight before their adds.
constexpr int kSweepRows = 4;
// Up to this many rows every block computes the weights itself: B4's block
// is then a few hundred instructions, less than the round trips through L2
// of a ticket and a published selection.
constexpr int kSelfWeightsRows = 8;

// 16-byte slots a thread takes at once: two where every block computes the
// weights (half the blocks, half the repeated weights), else one.
template <int NPAD>
constexpr int kSweepSlots = NPAD <= kSelfWeightsRows ? 2 : 1;

__device__ __forceinline__ ulonglong2 ld_volatile2(const unsigned long long* p) {
  ulonglong2 v;
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];" : "=l"(v.x), "=l"(v.y) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_volatile2(unsigned long long* p, unsigned long long a,
                                             unsigned long long b) {
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(a), "l"(b) : "memory");
}

// atomicAdd with release and acquire at the card's scope: what this block
// did before it (its barrier's threads included) is seen by whoever sees
// the add, and what it does after sees what they did before theirs.
__device__ __forceinline__ unsigned add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// The widest load, in bytes, that an address with these low bits allows
// (at least the element's size).
template <typename T>
__device__ __forceinline__ int load_width(unsigned low) {
  return (low & 15u) == 0 ? 16 : (low & 7u) == 0 ? 8 : (low & 3u) == 0 ? 4 : (int)sizeof(T);
}

// 16 bytes of a row from p, in pieces of `width` bytes (p is width-aligned).
__device__ __forceinline__ uint4 load_slot(const char* p, int width) {
  uint4 r;
  if (width == 16) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  } else if (width == 8) {
    const uint2 lo = __ldg(reinterpret_cast<const uint2*>(p));
    const uint2 hi = __ldg(reinterpret_cast<const uint2*>(p + 8));
    r = make_uint4(lo.x, lo.y, hi.x, hi.y);
  } else if (width == 4) {
    const unsigned* u = reinterpret_cast<const unsigned*>(p);
    r = make_uint4(__ldg(u), __ldg(u + 1), __ldg(u + 2), __ldg(u + 3));
  } else {  // a 16-bit row at an odd element offset
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
    unsigned v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = (unsigned)__ldg(h + 2 * e) | ((unsigned)__ldg(h + 2 * e + 1) << 16);
    r = make_uint4(v[0], v[1], v[2], v[3]);
  }
  return r;
}

// Element e of a 16-byte slot of T, as f32.
template <typename T>
__device__ __forceinline__ float slot_value(const uint4& r, int e) {
  const unsigned word = e * (int)sizeof(T) < 8 ? (e * (int)sizeof(T) < 4 ? r.x : r.y)
                                               : (e * (int)sizeof(T) < 12 ? r.z : r.w);
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word);
  } else {
    const unsigned short h = (unsigned short)(e & 1 ? word >> 16 : word & 0xFFFFu);
    if constexpr (std::is_same_v<T, __nv_bfloat16>) return __bfloat162float(__ushort_as_bfloat16(h));
    else return __half2float(__ushort_as_half(h));
  }
}

__device__ __forceinline__ unsigned short bits16(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ unsigned short bits16(__half v) { return __half_as_ushort(v); }

// The 16-byte slot of T holding v (f32 values, rounded as from_f32).
template <typename T>
__device__ __forceinline__ uint4 slot_of(const float (&v)[16 / sizeof(T)]) {
  unsigned w[4];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e] = __float_as_uint(from_f32<float>(v[e]));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e] = (unsigned)bits16(from_f32<T>(v[2 * e])) |
                                       ((unsigned)bits16(from_f32<T>(v[2 * e + 1])) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// out[c] = sum over the cnt selected rows p, ascending, of x[row[p]][c] *
// w in f32, from +0.0, one rounding a product and an add, cast to T: each
// thread P 16-byte slots of columns at a time, a grid's stride apart (so a
// warp's loads coalesce), the next kSweepRows rows' loads of them issued
// before their adds; the last d % (16 / sizeof(T)) columns one at a time.
template <typename T, int THREADS, int P>
__device__ __forceinline__ void sweep_selected(const T* __restrict__ x, T* __restrict__ out,
                                               const int* row, float w, int cnt, long long d) {
  constexpr int V = 16 / (int)sizeof(T), U = kSweepRows;
  const long long slots = d / V, stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  for (long long s0 = first; s0 < slots; s0 += P * stride) {
    float acc[P][V];
#pragma unroll
    for (int k = 0; k < P; ++k)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[k][e] = 0.0f;
    for (int p0 = 0; p0 < cnt; p0 += U) {
      uint4 raw[U][P];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (p0 + u < cnt) {
          const T* src = x + (long long)row[p0 + u] * d;
          const int width = load_width<T>(static_cast<unsigned>(reinterpret_cast<uintptr_t>(src)));
#pragma unroll
          for (int k = 0; k < P; ++k)
            if (s0 + k * stride < slots)
              raw[u][k] = load_slot(reinterpret_cast<const char*>(src + (s0 + k * stride) * V), width);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (p0 + u < cnt) {
#pragma unroll
          for (int k = 0; k < P; ++k)
            if (s0 + k * stride < slots) {
#pragma unroll
              for (int e = 0; e < V; ++e)
                acc[k][e] = __fadd_rn(acc[k][e], __fmul_rn(slot_value<T>(raw[u][k], e), w));
            }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (s0 + k * stride < slots) *reinterpret_cast<uint4*>(out + (s0 + k * stride) * V) = slot_of<T>(acc[k]);
  }
  for (long long c = slots * V + first; c < d; c += stride) {
    float acc = 0.0f;
    for (int p = 0; p < cnt; ++p) acc = __fadd_rn(acc, __fmul_rn(to_f32(x[(long long)row[p] * d + c]), w));
    out[c] = from_f32<T>(acc);
  }
}

// B5 in one launch (replaces _selection_from_gram_kernel, :1094): a
// persistent grid of weights-shaped blocks. Each block takes a ticket and,
// with it in flight, reads its copy of the published selection. The first
// ticket's block (a ticket, not blockIdx.x, so that no block waits on one
// that has not started) computes the weights with B4's block
// (selblock::select_weights) and publishes the rows whose weight is not 0
// (NaN included) as a bit mask with their weight into every copy; every
// other block reads its copy until it is valid (no grid barrier). Once a
// block has the selection it counts itself out, the count's
// round trip hidden behind its sweep; it lists the selected rows in
// ascending order and sweeps its slots of columns. The block that counts
// last zeroes the scratch for the next call. Up to kSelfWeightsRows rows
// every block computes the weights itself and the scratch is not touched.
// Built for two blocks an SM: without a block count, ptxas held the 16-bit
// cge/monna instances at 64 and 128 rows to 40 registers and spilled.
template <typename T, int NPAD, bool KRUM>
__global__ void __launch_bounds__(SelShape<NPAD>::T, 2)
selection_mean_from_gram_kernel(const T* __restrict__ x, const float* __restrict__ gram,
                                T* __restrict__ out, FromGramScratch* __restrict__ scr, int n,
                                long long d, int f, int q, int mode, int ref) {
  using S = SelShape<NPAD>;
  constexpr int WORDS = (NPAD + 31) / 32;
  extern __shared__ __align__(16) unsigned char dyn[];  // krum_score's keys
  __shared__ float nrm[NPAD];
  __shared__ selblock::Ranked<NPAD> r;
  __shared__ int row_s[NPAD];
  __shared__ unsigned picked[4];
  __shared__ float weight_s;
  __shared__ int first_s;
  constexpr bool SELF = NPAD <= kSelfWeightsRows;
  const int t = threadIdx.x;
  unsigned exits = 0;  // thread 0: the blocks counted out before this one
  if (!SELF && t == 0) {
    const unsigned ticket = atomicAdd(&scr->ticket.v, 1u);
    const Published* p = &scr->pub[blockIdx.x % kReplicas];
    ulonglong2 a = ld_volatile2(p->word), b = ld_volatile2(p->word + 2), c = ld_volatile2(p->word + 4);
    first_s = ticket == 0u;
    if (ticket != 0u) {
      while ((a.x & a.y & b.x & b.y & c.x & c.y & kValid) == 0ull) {
        __nanosleep(32);
        a = ld_volatile2(p->word);
        b = ld_volatile2(p->word + 2);
        c = ld_volatile2(p->word + 4);
      }
      picked[0] = (unsigned)a.x;
      picked[1] = (unsigned)a.y;
      picked[2] = (unsigned)b.x;
      picked[3] = (unsigned)b.y;
      weight_s = __uint_as_float((unsigned)c.x);
      exits = add_acq_rel(&scr->exits.v, 1u);
    }
  }
  if (!SELF) __syncthreads();
  if (SELF || first_s) {
    float tile[S::RA][S::RB];
    if constexpr (KRUM && NPAD > 8) selblock::load_tile<S>(DenseGram{gram, n}, n, tile);
    if (t < NPAD) nrm[t] = t < n ? gram[t * n + t] : __int_as_float(0x7FC00000);
    __syncthreads();
    const float wt = selblock::select_weights<S, NPAD, KRUM>(
        DenseGram{gram, n}, [&](int rr, int cc, int, int) { return tile[rr][cc]; },
        reinterpret_cast<int32_t*>(dyn), nrm, n, f, q, mode, ref, r);
    const bool take = t < n && wt != 0.0f;
    const unsigned bits = __ballot_sync(0xFFFFFFFFu, take);
    if ((t & 31) == 0 && t < NPAD) picked[t >> 5] = bits;
    if (t >= WORDS && t < 4) picked[t] = 0u;
    if (take) weight_s = wt;  // B4's weights: every selected row has the same, 1/q
    __syncthreads();
    if constexpr (!SELF) {
      if (t < kReplicas) {
        unsigned long long* w = scr->pub[t].word;
        st_volatile2(w, kValid | picked[0], kValid | picked[1]);
        st_volatile2(w + 2, kValid | picked[2], kValid | picked[3]);
        st_volatile2(w + 4, kValid | __float_as_uint(weight_s), kValid);
      }
      __syncthreads();
      if (t == 0) exits = add_acq_rel(&scr->exits.v, 1u);
    }
  }
  // the selected rows, ascending: row t's place is the count of selected rows before it
  int cnt = 0;
#pragma unroll
  for (int v = 0; v < WORDS; ++v) cnt += __popc(picked[v]);
  if (t < n) {
    const unsigned word = picked[t >> 5];
    if ((word >> (t & 31)) & 1u) {
      int pos = __popc(word & ((1u << (t & 31)) - 1u));
#pragma unroll
      for (int v = 0; v < WORDS; ++v) pos += v < (t >> 5) ? __popc(picked[v]) : 0;
      row_s[pos] = t;
    }
  }
  __syncthreads();
  sweep_selected<T, S::T, kSweepSlots<NPAD>>(x, out, row_s, weight_s, cnt, d);
  if (!SELF && t == 0 && exits == gridDim.x - 1) {
    scr->ticket.v = 0u;
    scr->exits.v = 0u;
#pragma unroll
    for (int c = 0; c < kReplicas; ++c)
#pragma unroll
      for (int e = 0; e < 6; ++e) scr->pub[c].word[e] = 0ull;
  }
}

// One launch of B5 at width NPAD: as many blocks as fit on the card at
// once (the occupancy of this instance, found once a device) and no more
// than the slots need; krum's keys in dynamic shared memory, opted in
// above 48 KB once a device.
template <typename T, int NPAD, bool KRUM>
cudaError_t launch_from_gram_instance(const T* x, const float* gram, T* out, FromGramScratch* scr,
                                      int n, long long d, int f, int q, int mode, int ref,
                                      cudaStream_t s) {
  constexpr int threads = SelShape<NPAD>::T;
  constexpr int dyn = KRUM ? selblock::krum_smem_bytes<NPAD>() : 0;
  static std::atomic<unsigned long long> ready{0};
  static std::atomic<int> resident[64];  // blocks resident at once, by device (0: not known)
  const void* fn = reinterpret_cast<const void*>(&selection_mean_from_gram_kernel<T, NPAD, KRUM>);
  cudaError_t err = selblock::raise_smem_once(fn, dyn, ready);
  if (err != cudaSuccess) return err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  int cap = dev < 64 ? resident[dev].load(std::memory_order_relaxed) : 0;
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, dyn)) != cudaSuccess)
      return err;
    cap = per_sm > 0 ? per_sm * sms : 1;
    if (dev < 64) resident[dev].store(cap, std::memory_order_relaxed);
  }
  constexpr int per_thread = kSweepSlots<NPAD> * 16 / (int)sizeof(T);  // columns a thread sweeps at once
  const long long need = (d / per_thread + threads - 1) / threads;
  const int grid = (int)(need < 1 ? 1 : need < cap ? need : cap);
  selection_mean_from_gram_kernel<T, NPAD, KRUM><<<grid, threads, dyn, s>>>(x, gram, out, scr, n, d, f,
                                                                            q, mode, ref);
  return cudaGetLastError();
}

template <typename T, int NPAD>
cudaError_t launch_from_gram(const void* x, const float* gram, void* out, FromGramScratch* scr, int n,
                             long long d, int f, int q, int mode, int ref, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (mode == kKrum) return launch_from_gram_instance<T, NPAD, true>(xt, gram, ot, scr, n, d, f, q, mode, ref, s);
  return launch_from_gram_instance<T, NPAD, false>(xt, gram, ot, scr, n, d, f, q, mode, ref, s);
}

template <typename T>
cudaError_t launch_from_gram_dtype(const void* x, const float* gram, void* out, FromGramScratch* scr,
                                   int n, long long d, int f, int q, int mode, int ref,
                                   cudaStream_t s) {
  switch (network_width(n)) {
    case 8: return launch_from_gram<T, 8>(x, gram, out, scr, n, d, f, q, mode, ref, s);
    case 16: return launch_from_gram<T, 16>(x, gram, out, scr, n, d, f, q, mode, ref, s);
    case 32: return launch_from_gram<T, 32>(x, gram, out, scr, n, d, f, q, mode, ref, s);
    case 64: return launch_from_gram<T, 64>(x, gram, out, scr, n, d, f, q, mode, ref, s);
    case 128: return launch_from_gram<T, 128>(x, gram, out, scr, n, d, f, q, mode, ref, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// gram: (K, n, n) f32; w: (K, n) f32 out. Returns the launch's cudaError_t
// (a refused shared-memory opt-in included).
extern "C" int byz_selection_weights(const float* gram, float* w, int K, int n,
                                     int f, int q, int mode, int ref,
                                     void* stream) {
  if (K <= 0) return cudaSuccess;
  if (mode < kKrum || mode > kMonna || ref < 0 || ref >= n) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (network_width(n)) {
    case 8: return launch_weights<8>(gram, w, K, n, f, q, mode, ref, s);
    case 16: return launch_weights<16>(gram, w, K, n, f, q, mode, ref, s);
    case 32: return launch_weights<32>(gram, w, K, n, f, q, mode, ref, s);
    case 64: return launch_weights<64>(gram, w, K, n, f, q, mode, ref, s);
    case 128: return launch_weights<128>(gram, w, K, n, f, q, mode, ref, s);
    default: return cudaErrorInvalidValue;
  }
}

// x: (K, n, d) contiguous; w: (K, n) f32; out: (K, d) of x's dtype.
extern "C" int byz_weighted_rows(const void* x, const float* w, void* out, int K,
                                 int n, long long d, int dtype, void* stream) {
  if (K <= 0 || d <= 0) return cudaSuccess;
  if (n < 1 || n > 128) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: launch_rows<float>(x, w, out, K, n, d, s); break;
    case kBF16: launch_rows<__nv_bfloat16>(x, w, out, K, n, d, s); break;
    case kF16: launch_rows<__half>(x, w, out, K, n, d, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// x: (n, d) of dtype `dtype`, rows contiguous from any element-aligned
// start; gram: (n, n) f32; out: (d,) of x's dtype, 16-byte aligned;
// scratch: a zeroed FromGramScratch (byz_from_gram_scratch_bytes bytes),
// owned by the calling stream. Returns the launch's cudaError_t (a refused
// shared-memory opt-in included).
extern "C" int byz_selection_mean_from_gram(const void* x, const float* gram, void* out,
                                            void* scratch, int n, long long d, int f, int q,
                                            int mode, int ref, int dtype, void* stream) {
  if (d <= 0) return cudaSuccess;
  if (mode < kKrum || mode > kMonna || ref < 0 || ref >= n || q < 1 || q > n)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) & 15u) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FromGramScratch* scr = static_cast<FromGramScratch*>(scratch);
  switch (dtype) {
    case kF32: return launch_from_gram_dtype<float>(x, gram, out, scr, n, d, f, q, mode, ref, s);
    case kBF16: return launch_from_gram_dtype<__nv_bfloat16>(x, gram, out, scr, n, d, f, q, mode, ref, s);
    case kF16: return launch_from_gram_dtype<__half>(x, gram, out, scr, n, d, f, q, mode, ref, s);
    default: return cudaErrorInvalidValue;
  }
}

// The bytes of B5's scratch.
extern "C" int byz_from_gram_scratch_bytes() { return (int)sizeof(FromGramScratch); }
