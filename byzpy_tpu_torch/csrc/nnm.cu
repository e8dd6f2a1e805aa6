// B8: Nearest-Neighbour Mixing over K stacked (n, d) rounds, and B9: NNM
// feeding a selection mean (Multi-Krum, CGE, MoNNA) through the collapsed
// Gram, the mixed matrix never built.
//
// B8 replaces byzpy_tpu/ops/pallas_kernels.py:1245 _nnm_stream_kernel
// (pallas_call at :1332). The TPU kernel keeps the Gram and the selection
// state in VMEM across a (K, 2, C) grid and forms the mixed rows with an
// MXU dot at HIGHEST precision (:1282-1287). Here, after B3's Gram
// (gram.cu):
//   byz_nnm_weights: one block per round (nnm_weights_kernel below).
//     taint_j = the squared norm G_jj is not finite; row i's k = n - f
//     nearest rows by the stable k-select (take_bits) give column i of
//     mask_clean (0/1 f32, tainted rows cleared) and sel_taint_i = a tainted
//     row was selected (_nnm_weights :1216-1242).
//   byz_mix_rows: out[i] = (sum_j mask_clean[j][i] * x_j) / k in f32, rows j
//     ascending, NaN where sel_taint_i, cast to x's dtype (:1272-1290).
//     mask_clean is 0/1 and clear on tainted rows, so each term is x_j or
//     an exact +-0, and the sweep adds the selected rows only.
// B9 replaces :1380 _nnm_selection_stream_kernel (pallas_call at :1806):
//   byz_nnm_selection_weights: one block per round. The same selection A
//     (= mask_clean); G~ = G with tainted rows and columns zeroed; GA = G~ A
//     and Gm = A^T GA / k^2 in f32, sums ascending; rows and columns of Gm
//     whose mixer selected a tainted row set to NaN; the selection weights
//     w_sel of Gm; w_eff = A w_sel / k, all NaN when a tainted mixer was
//     selected (:1415-1455).
//   then selection.cu's weighted-row sweep, which reads the rows whose
//     w_eff is not 0 (NaN included).
// The (n, n) products multiply by 0/1 entries of A only, so each FFMA of
// the reference is an exact add of a selected term (or of +-0), and the
// kernels add the selected terms in index order.
// Design of nnm_selection_weights_kernel: the (n, n) problem is 16 KB at n
// = 64, so nothing streams; what bounds it is the work of its steps on one
// SM: GA and Gm are n^2 k adds each, NNM's selection and Krum's scores n
// sorts of n keys. One block of up to 1,024 threads a round holds G in
// shared memory and spreads each step over the whole block
// (selection_block.cuh): every thread a tile of the (n, n) products, each
// loaded value serving the tile's other row or column; a warp a column to
// sort, across its lanes. NNM takes, for mixer i, the keys below the k-th
// smallest of column i, then keys equal to it in row order
// (B8's set, read off the sorted column with ballots); A is
// a bit mask a mixer, in registers across the products, whose unselected
// adds are predicated off; GA, then Gm, overwrite dead buffers; Krum adds
// each sorted column's positions in order, one thread a column. Tensor
// cores are not used: a TF32 product would change the bits.
// chip_selection_ablation.py takes it apart (thread counts, NNM's
// selection by stable ranks, the launch alone).
//
// The mixing sweep is an (n x n)^T (n x d) product with 0/1 weights and n
// <= 128: at 64 x 2^20 f32 it reads and writes 512 MB (0.16 ms at 3.35
// TB/s; a plain copy of x takes 0.18 ms on the H100) and does 64 * 56 *
// 2^20 = 3.8 G selected adds, 4.3 G issued with the unselected ones
// predicated off, ~0.15 ms of the FP32 pipe's issue slots. Tensor cores
// are not used: wgmma in TF32 truncates x to a 10-bit mantissa, and a
// 3xTF32 split is not an ascending f32 chain (the reference asks for
// HIGHEST precision on this dot for that reason, :1276-1287).
// Design of mix_rows_kernel:
//   - persistent blocks of 256 threads, kMixBlocksPerSm a SM, stride over
//     (round, column tile); each tile of all n rows is staged by cp.async
//     in a ring of kMixStages shared buffers, the next tile in flight
//     while one is summed;
//   - output-stationary register micro-tiles: a thread owns I output rows
//     x C columns (8 x 4; 16 x 2 at NPAD 128); a warp's lanes share the
//     rows and take the columns at a stride of 32, so shared loads are
//     conflict-free and global stores coalesce; the block covers all NPAD
//     output rows of its tile. A value of x_j loaded from shared memory
//     into a register serves up to I adds;
//   - the selection as bits: on entering a round the block builds the
//     0/1 mask as a bit matrix, one word of I bits per (source row j, row
//     group): bit ii says whether output row rg I + ii takes row j. The
//     test is the same for every lane of a warp, so an unselected row is a
//     predicated-off add and never enters a sum (an inf or NaN row that is
//     not selected cannot poison one; 0 * inf would). Source-row-major
//     words put the I predicates of one x_j in one word, which the card
//     ran faster than one word per output row over the j (same bits);
//   - alignment: row j of round r starts at byte (r n + j) d sizeof(T), so
//     each row is copied in the widest of 16, 8 or 4-byte pieces that its
//     start allows (a 16-bit row at an odd element offset is copied by
//     plain loads); the last piece of a row zero-fills past d; outputs are
//     scalar stores, masked at the ragged last tile.
// What bounds it (chip_mix_ablation.py on the H100, 64 x 2^20 f32): the
// adds' issue slots. Stripped to its copies and stores the sweep runs
// within ~1.15x of a plain copy of x; stripped to its adds it takes ~0.9x
// of the whole sweep (each j costs C shared loads and a few predicate
// moves beside its I C adds, unselected adds issue too, and the IEEE
// division adds ~6%). Wider micro-tiles (8 x 8, 3 stages, one block a
// SM) hide less latency and run slower.
// Bits: each output starts at +0.0 and adds the selected x_j in ascending
// j, one __fadd_rn each (no --use_fast_math), then __fdiv_rn by k, and the
// canonical NaN where sel_taint is set, cast to x's dtype: the plain
// version's function, bit for bit.
// The weights blocks touch only (n, n) data; B9's two square buffers and
// masks take 132 KB of dynamic shared memory at NPAD = 128, above the 48 KB
// a block gets without opting in, so the launcher raises the block's limit
// once a device (selblock::raise_smem_once), as the sweep's launcher does
// for its ring.

#include <type_traits>

#include "selection_block.cuh"

namespace {

constexpr int kMixThreads = 256;
constexpr int kMixWarps = kMixThreads / 32;
constexpr int kMixStages = 2;
constexpr int kMixBlocksPerSm = 3;  // 2 stages of 32 KB (f32) a block

// The sweep's micro-tile at network width NPAD: I output rows x C columns
// a thread, 32 accumulators; row groups of I rows, each taken by
// kMixWarps / RGS warps that split the tile's TW columns. A stage holds
// NPAD x TW values: 32 KB of f32 at every width.
template <int NPAD>
struct MixShape {
  static constexpr int I = NPAD == 128 ? 16 : 8;
  static constexpr int C = 32 / I;
  static constexpr int RGS = NPAD / I;
  static constexpr int CGS = kMixWarps / RGS;
  static constexpr int TW = CGS * 32 * C;
  using Word = std::conditional_t<I == 8, unsigned char, unsigned short>;
  static_assert(RGS * CGS == kMixWarps, "row groups must tile the warps");
};

__device__ __forceinline__ float canonical_nan() { return __int_as_float(0x7FC00000); }

// B8's selection state: one block of up to kNnmThreads threads a round
// (selection_block.cuh), as B9's weights start. Every thread forms the
// keys of its tile of the Gram (held in registers, its loads in flight
// with the diagonal's) into KeySort's padded buffer; the lanes of a warp
// sort a mixer's column (a lane a column up to 16 rows, 8 lanes from 32)
// and read the cut, the quota and the taken rows off it with shuffles
// (take_bits), a bit a row. Up to 16 rows each lane then writes its
// mixer's column of the mask straight from its bits; above, the block
// writes the f32 mask in rows, consecutive mixers across the lanes, each
// lane from a word of 32 rows' bits in a register. Pad rows carry NaN
// norms: their keys tie with a NaN row's and come after every real row in
// row order, so no key needs a bounds test and no pad is taken (k <= n).
// What bounds it is the sort on one SM's integer pipe (n columns of NPAD
// keys), then the mask's n^2 stores. chip_selection_ablation.py --kinds
// b8 takes it apart.
constexpr int kNnmThreads = 512;

template <int NPAD>
using NnmShape = selblock::Shape<NPAD, kNnmThreads>;

// Dynamic shared memory of B8's block: the keys.
template <int NPAD>
constexpr int nnm_smem_bytes() {
  return NPAD * selblock::KeySort<NPAD>::SP * (int)sizeof(int32_t);
}

// The rows a lane of KeySort<NPAD>'s column group takes: v its sorted run,
// o its unsorted one (rows le R + r, r < R, of the column). The cut is
// the column's k-th smallest key; a row is taken if its key is below the
// cut, or equal to it while fewer than quota = k - (keys below the cut)
// equal keys come before it in row order (nnm_weights_plain's set, the
// stable-argsort rule of _stable_threshold_select :784). Returns bit r
// for row le R + r. Every lane of the warp calls it.
template <int NPAD>
__device__ __forceinline__ unsigned take_bits(const int32_t (&v)[selblock::KeySort<NPAD>::R],
                                              const int32_t (&o)[selblock::KeySort<NPAD>::R], int k,
                                              int lane) {
  using KS = selblock::KeySort<NPAD>;
  constexpr int R = KS::R, G = KS::G, LG = ilog2(G);
  const int le = lane % G;
  int32_t cut = select_key<R>(v, (k - 1) % R);
  if constexpr (G > 1) cut = __shfl_sync(0xFFFFFFFFu, cut, lane - le + (k - 1) / R);
  int below = 0, eq = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    below += o[r] < cut ? 1 : 0;
    eq += o[r] == cut ? 1 : 0;
  }
  int seen = eq;  // keys equal to the cut in this lane and the lanes before it
#pragma unroll
  for (int ls = 0; ls < LG; ++ls) {
    below += __shfl_xor_sync(0xFFFFFFFFu, below, 1 << ls);
    const int up = __shfl_up_sync(0xFFFFFFFFu, seen, 1 << ls);
    if (le >= (1 << ls)) seen += up;
  }
  const int quota = k - below;
  int before = seen - eq;
  unsigned bits = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool at = o[r] == cut;
    if (o[r] < cut || (at && before < quota)) bits |= 1u << r;
    before += at ? 1 : 0;
  }
  return bits;
}

template <int NPAD>
__global__ void __launch_bounds__(NnmShape<NPAD>::T, 1)
nnm_weights_kernel(const float* __restrict__ gram, float* __restrict__ mask,
                   float* __restrict__ sel_taint, int n, int k) {
  using S = NnmShape<NPAD>;
  using KS = selblock::KeySort<NPAD>;
  constexpr int W = S::W, WP = W | 1;  // words of a row mask, and their odd stride
  extern __shared__ __align__(16) unsigned char dyn[];  // the keys
  __shared__ float nrm[NPAD];
  __shared__ unsigned tmask[W];        // rows whose squared norm is not finite
  __shared__ unsigned sel[NPAD * WP];  // sel[i * WP + w]: rows mixer i took
  const int t = threadIdx.x;
  const float* g = gram + (long long)blockIdx.x * n * n;
  float* m = mask + (long long)blockIdx.x * n * n;
  int32_t* keys = reinterpret_cast<int32_t*>(dyn);
  float tile[S::RA][S::RB];
  selblock::load_tile<S>(DenseGram{g, n}, n, tile);
  if (t < NPAD) nrm[t] = t < n ? g[t * n + t] : __int_as_float(0x7FC00000);
  if (t < 32 * W) {
    const unsigned bits = __ballot_sync(0xFFFFFFFFu, t < n && !isfinite(g[t * n + t]));
    if ((t & 31) == 0) tmask[t >> 5] = bits;
  }
  __syncthreads();
  // column i (a mixer) holds the keys of d2[j][i], rows j
  const int a = t / S::TB, b = t % S::TB;
#pragma unroll
  for (int r = 0; r < S::RA; ++r)
#pragma unroll
    for (int c = 0; c < S::RB; ++c) {
      const int j = a + S::TA * r, i = b + S::TB * c;
      keys[KS::addr(i, j)] = float_sort_key(sq_dist(nrm[j], nrm[i], tile[r][c]));
    }
  __syncthreads();
  // the lanes of a column group sort mixer i's column, then take its rows
  const int lane = t & 31, le = lane % KS::G;
  for (int c0 = (t >> 5) * KS::CPW; c0 < NPAD; c0 += (S::T / 32) * KS::CPW) {
    const int i = KS::column(c0 + lane / KS::G);
    if constexpr (KS::CPW > NPAD) if (i >= NPAD) continue;  // a lane a column: no shuffles
    const int32_t* run = keys + KS::run(i, le);
    int32_t v[KS::R], o[KS::R];
#pragma unroll
    for (int r = 0; r < KS::R; ++r) {
      o[r] = run[r];
      v[r] = o[r];
    }
    KS::sort(v, lane);
    const unsigned bits = take_bits<NPAD>(v, o, k, lane);
    if constexpr (KS::G == 1) {
      // a lane a mixer (up to 16 rows): its column of the mask and its
      // sel_taint straight from its bits, consecutive mixers across the lanes
      if (i < n) {
        const unsigned taint = tmask[0];
#pragma unroll
        for (int j = 0; j < NPAD; ++j)
          if (j < n) m[j * n + i] = ((bits & ~taint) >> j) & 1u ? 1.0f : 0.0f;
        sel_taint[(long long)blockIdx.x * n + i] = bits & taint ? 1.0f : 0.0f;
      }
    } else {
      // this lane's R bits at their place in the word of rows; the lanes
      // that share a word join their bits
      unsigned word = bits << ((le * KS::R) & 31);
#pragma unroll
      for (int ls = 0; (1 << ls) < 32 / KS::R && (1 << ls) < KS::G; ++ls)
        word |= __shfl_xor_sync(0xFFFFFFFFu, word, 1 << ls);
      if (((le * KS::R) & 31) == 0 && i < n) sel[i * WP + ((le * KS::R) >> 5)] = word;
    }
  }
  if constexpr (KS::G == 1) return;
  __syncthreads();
  // mask[j][i] from the bits: lane l of a warp takes mixer i = 32 ib + l and
  // rows 32 jw ... 32 jw + 31 from one word in a register (tainted rows
  // cleared), a store a row, consecutive mixers across the lanes; a word's
  // rows go in CH chunks, so that every warp has some
  constexpr int WARPS = S::T / 32, CH = WARPS > W * W ? WARPS / (W * W) : 1, RPC = S::U / CH;
  static_assert(RPC * CH == S::U, "the chunks must tile a word");
  for (int task = t >> 5; task < W * W * CH; task += WARPS) {
    const int blk = task / CH, j0 = task % CH * RPC;
    const int i = blk / W * 32 + lane, jw = blk % W;
    const unsigned word = i < n ? sel[i * WP + jw] & ~tmask[jw] : 0u;
    float* col = m + (jw * 32 + j0) * n + i;
#pragma unroll
    for (int jj = 0; jj < RPC; ++jj)
      if (i < n && jw * 32 + j0 + jj < n) col[jj * n] = (word >> (j0 + jj)) & 1u ? 1.0f : 0.0f;
  }
  if (t < n) {
    unsigned any = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) any |= sel[t * WP + w] & tmask[w];
    sel_taint[(long long)blockIdx.x * n + t] = any ? 1.0f : 0.0f;
  }
}

// One launch of B8's selection state at width NPAD: a block a round, its
// keys in dynamic shared memory, opted in above 48 KB (70 KB at NPAD =
// 128) once a device.
template <int NPAD>
cudaError_t launch_nnm_weights(const float* gram, float* mask, float* sel_taint, int K, int n,
                               int k, cudaStream_t s) {
  static std::atomic<unsigned long long> ready{0};
  constexpr int dyn = nnm_smem_bytes<NPAD>();
  const cudaError_t err = selblock::raise_smem_once(
      reinterpret_cast<const void*>(&nnm_weights_kernel<NPAD>), dyn, ready);
  if (err != cudaSuccess) return err;
  nnm_weights_kernel<NPAD><<<K, NnmShape<NPAD>::T, dyn, s>>>(gram, mask, sel_taint, n, k);
  return cudaGetLastError();
}

// Stage tile t (its round's n rows x TW columns) into ring buffer `buf`.
// Each warp copies whole rows, so a row's copy width is warp-uniform.
template <typename T, int NPAD>
__device__ __forceinline__ void stage_tile(const T* __restrict__ x, T* buf, int n, long long d,
                                           long long tiles_per_round, long long t) {
  constexpr int TW = MixShape<NPAD>::TW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long kr = t / tiles_per_round, c0 = (t % tiles_per_round) * TW;
  const int valid = (int)min((long long)TW, d - c0);
  const int bytes = valid * (int)sizeof(T);
  const T* xk = x + kr * n * d + c0;
  for (int j = warp; j < n; j += kMixWarps) {
    const T* row = xk + (long long)j * d;
    char* dst = reinterpret_cast<char*>(buf + j * TW);
    const char* src = reinterpret_cast<const char*>(row);
    const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(src));
    if ((a & 15u) == 0) {
      copy_row<16>(dst, src, bytes, lane);
    } else if ((a & 7u) == 0) {
      copy_row<8>(dst, src, bytes, lane);
    } else if ((a & 3u) == 0) {
      copy_row<4>(dst, src, bytes, lane);
    } else {  // a 16-bit row at an odd element offset: below cp.async's 4 bytes
      for (int e = lane; e < valid; e += 32) buf[j * TW + e] = row[e];
    }
  }
}

template <typename T, int NPAD>
__global__ void __launch_bounds__(kMixThreads, kMixBlocksPerSm)
mix_rows_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                const float* __restrict__ sel_taint, T* __restrict__ out, int n, int k,
                long long d, long long tiles_per_round, long long total_tiles) {
  using S = MixShape<NPAD>;
  constexpr int I = S::I, C = S::C, TW = S::TW;
  extern __shared__ __align__(16) unsigned char ring_raw[];  // kMixStages x NPAD x TW of T
  T* ring = reinterpret_cast<T*>(ring_raw);
  // sel[g][rg][u]: bit ii set iff output row rg I + ii selected source row
  // 8 g + u (I bits a word)
  __shared__ __align__(16) typename S::Word sel[NPAD / 8][S::RGS][8];
  __shared__ int poisoned[NPAD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp % S::RGS, cg = warp / S::RGS;
  const int col_off = cg * 32 * C + lane;  // this thread's first column in the tile
  const float kf = (float)k;
  const long long step = gridDim.x;

  // prologue: the first kMixStages - 1 tiles in flight, one group each
#pragma unroll
  for (int s = 0; s < kMixStages - 1; ++s) {
    const long long t = blockIdx.x + s * step;
    if (t < total_tiles) stage_tile<T, NPAD>(x, ring + s * NPAD * TW, n, d, tiles_per_round, t);
    cp_async_commit();
  }
  int cur_round = -1, buf = 0;
  for (long long t = blockIdx.x; t < total_tiles; t += step) {
    cp_async_wait<kMixStages - 2>();  // this thread's pieces of tile t have landed
    __syncthreads();  // everyone's have; the buffer of the last tile is free
    {
      const long long tn = t + (kMixStages - 1) * step;
      const int nb = (buf + kMixStages - 1) % kMixStages;
      if (tn < total_tiles) stage_tile<T, NPAD>(x, ring + nb * NPAD * TW, n, d, tiles_per_round, tn);
      cp_async_commit();
    }
    const int kr = (int)(t / tiles_per_round);
    if (kr != cur_round) {  // the same for the whole block
      const float* m = mask + (long long)kr * n * n;
      for (int e = tid; e < NPAD * S::RGS; e += kMixThreads) {
        const int j = e / S::RGS, r = e % S::RGS;
        unsigned bits = 0;
        if (j < n) {
          for (int ii = 0; ii < I; ++ii) {
            const int i = r * I + ii;
            if (i < n && m[j * n + i] != 0.0f) bits |= 1u << ii;
          }
        }
        sel[j >> 3][r][j & 7] = (typename S::Word)bits;
      }
      for (int i = tid; i < NPAD; i += kMixThreads)
        poisoned[i] = i < n && sel_taint[(long long)kr * n + i] != 0.0f;
      cur_round = kr;
      __syncthreads();
    }

    float acc[I][C];
#pragma unroll
    for (int ii = 0; ii < I; ++ii)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[ii][c] = 0.0f;
    const T* tile = ring + buf * NPAD * TW + col_off;
    const int groups = (n + 7) >> 3;
    constexpr int PER = 32 / I;  // bit words of 8 source rows, PER to a 32-bit word
    for (int g = 0; g < groups; ++g) {
      unsigned w[8 / PER];
      if constexpr (I == 8) {
        const uint2 v = *reinterpret_cast<const uint2*>(&sel[g][rg][0]);
        w[0] = v.x;
        w[1] = v.y;
      } else {
        const uint4 v = *reinterpret_cast<const uint4*>(&sel[g][rg][0]);
        w[0] = v.x;
        w[1] = v.y;
        w[2] = v.z;
        w[3] = v.w;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const T* row = tile + (8 * g + u) * TW;
        float xv[C];
#pragma unroll
        for (int c = 0; c < C; ++c) xv[c] = to_f32(row[c * 32]);
#pragma unroll
        for (int ii = 0; ii < I; ++ii) {
          if ((w[u / PER] >> (I * (u % PER) + ii)) & 1u) {
#pragma unroll
            for (int c = 0; c < C; ++c) acc[ii][c] = __fadd_rn(acc[ii][c], xv[c]);
          }
        }
      }
    }

    const long long c0 = (t % tiles_per_round) * TW;
    const int valid = (int)min((long long)TW, d - c0);
    T* ok = out + (long long)kr * n * d + c0 + col_off;
#pragma unroll
    for (int ii = 0; ii < I; ++ii) {
      const int i = rg * I + ii;
      if (i < n) {
        const bool p = poisoned[i] != 0;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (col_off + c * 32 < valid) {
            const float v = p ? canonical_nan() : __fdiv_rn(acc[ii][c], kf);
            ok[(long long)i * d + c * 32] = from_f32<T>(v);
          }
        }
      }
    }
    buf = (buf + 1) % kMixStages;
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// B9's finish: Krum's scores by a warp's sort of each column, then the
// weights. B4 and B10 share selblock::select_weights; in this kernel that
// finish raised the allocation to the 64 registers a thread that 1,024
// threads leave and spilled 1 KB at NPAD = 128, twice the kernel's time
// (chip_selection_ablation.py on the H100), so B9 keeps its own.
//
// The selection weights of scores held in shared memory (score[j], bad[j]
// for j < n: NaN scores flagged): 1/q for the q lowest, NaN last, ties by
// index (the ranks of selblock::select_weights), into w_sel[j]. rank_s
// (NPAD ints) must be zero on entry. Every thread of the block calls it;
// it synchronizes the block and returns with w_sel written.
template <class S, int NPAD>
__device__ __forceinline__ void weights_of_scores(const float* score, const int* bad, int* rank_s,
                                                  float* w_sel, int n, int q) {
  constexpr int PARTS = S::T / NPAD, CHUNK = NPAD / PARTS;
  const int j = threadIdx.x % NPAD, part = threadIdx.x / NPAD;
  if (j < n) {
    const float sj = score[j];
    const int bj = bad[j];
    int cnt = 0;
    for (int c = part * CHUNK; c < min(n, part * CHUNK + CHUNK); ++c) {
      const int bc = bad[c];
      const float sc = score[c];
      cnt += ((!bc && bj) || (bc == bj && (sc < sj || (sc == sj && c < j)))) ? 1 : 0;
    }
    if (cnt) atomicAdd(&rank_s[j], cnt);
  }
  __syncthreads();
  if (threadIdx.x < n) w_sel[threadIdx.x] = rank_s[threadIdx.x] < q ? 1.0f / (float)q : 0.0f;
  __syncthreads();
}

// Krum scores of the (n, n) Gram gm (row stride SP; NaN entries allowed):
// score[j] = the sum, ascending, of sorted positions [1, n - f) of column
// j's squared distances (the sort drops the diagonal). keys is a square
// buffer for the distances' keys; gm is overwritten with the sorted keys,
// a warp sorting a column (WarpSort). Every thread calls it; it synchronizes the block and returns
// with score[j] written by thread j < n.
template <class S, int NPAD>
__device__ __forceinline__ void krum_scores(float* gm, int32_t* keys, const float* nrm, int n,
                                            int f, float* score) {
  using WS = selblock::WarpSort<NPAD>;
  const int t = threadIdx.x, a = t / S::TB, b = t % S::TB;
#pragma unroll
  for (int r = 0; r < S::RA; ++r)
#pragma unroll
    for (int c = 0; c < S::RB; ++c) {
      const int i = a + S::TA * r, j = b + S::TB * c;
      if (i < n && j < n) keys[j * S::SP + i] = float_sort_key(sq_dist(nrm[i], nrm[j], gm[i * S::SP + j]));
    }
  __syncthreads();
  int32_t* sorted = reinterpret_cast<int32_t*>(gm);
  const int lane = t & 31, le = lane % WS::G;
  for (int j0 = (t >> 5) * WS::CPW; j0 < n; j0 += (S::T / 32) * WS::CPW) {
    const int j = j0 + lane / WS::G;
    int32_t v[WS::R];
#pragma unroll
    for (int r = 0; r < WS::R; ++r) {
      const int e = r * WS::G + le;
      v[r] = j < n && e < n ? keys[j * S::SP + e] : PAD_KEY;
    }
    WS::sort(v, lane);
#pragma unroll
    for (int r = 0; r < WS::R; ++r) {
      const int e = r * WS::G + le;
      if (j < n && e < n) sorted[j * S::SP + e] = v[r];
    }
  }
  __syncthreads();
  if (t < n) {
    float acc = 0.0f;
    for (int p = 1; p < n - f; ++p) acc = __fadd_rn(acc, key_to_float(sorted[t * S::SP + p]));
    score[t] = acc;
  }
}

// B9's weights block: NPAD x NPAD problem, at most kSelThreads threads.
constexpr int kSelThreads = 1024;

template <int NPAD>
using SelShape = selblock::Shape<NPAD, kSelThreads>;

// Dynamic shared memory of a block: two square f32 buffers and the
// selection masks.
template <int NPAD>
constexpr int sel_smem_bytes() {
  using S = SelShape<NPAD>;
  return (2 * NPAD * S::SP + NPAD * S::W) * (int)sizeof(float);
}

template <int NPAD>
__global__ void __launch_bounds__(SelShape<NPAD>::T, 1)
nnm_selection_weights_kernel(const float* __restrict__ gram, float* __restrict__ w, int n,
                             int k, int f, int q, int mode, int ref) {
  using S = SelShape<NPAD>;
  constexpr int SP = S::SP, W = S::W, U = S::U;
  extern __shared__ __align__(16) unsigned char dyn[];
  float* X = reinterpret_cast<float*>(dyn);  // G, then Gm, then Krum's sorted keys
  float* Y = X + NPAD * SP;                  // NNM's keys, then GA, then Krum's keys
  int32_t* keys = reinterpret_cast<int32_t*>(Y);
  unsigned* sel = reinterpret_cast<unsigned*>(Y + NPAD * SP);  // sel[i * W + w]: rows mixer i took
  __shared__ unsigned tmask[W];  // rows whose squared norm is not finite
  __shared__ int sel_taint[NPAD];
  __shared__ float nrm[NPAD];    // Gm's diagonal
  __shared__ float score[NPAD];
  __shared__ int bad[NPAD];
  __shared__ int rank_s[NPAD];
  __shared__ float w_sel[NPAD];
  __shared__ int picked_tainted;
  const int t = threadIdx.x, a = t / S::TB, b = t % S::TB;
  const float* g = gram + (long long)blockIdx.x * n * n;

  // G into shared memory; the taint mask from its diagonal
  for (int e = t; e < n * n; e += S::T) {
    const int j = e / n;
    X[j * SP + e - j * n] = g[e];
  }
  for (int e = t; e < NPAD * W; e += S::T) sel[e] = 0u;
  if (t < NPAD) rank_s[t] = 0;
  if (t == 0) picked_tainted = 0;
  if (t < 32 * W) {
    const unsigned bits = __ballot_sync(0xFFFFFFFFu, t < n && !isfinite(g[(long long)t * n + t]));
    if ((t & 31) == 0) tmask[t >> 5] = bits;
  }
  __syncthreads();

  // NNM's keys: keys[i * SP + j] = key of d2[j][i], row j seen from mixer i
#pragma unroll
  for (int r = 0; r < S::RA; ++r)
#pragma unroll
    for (int c = 0; c < S::RB; ++c) {
      const int j = a + S::TA * r, i = b + S::TB * c;
      if (j < n && i < n)
        keys[i * SP + j] = float_sort_key(sq_dist(X[j * SP + j], X[i * SP + i], X[j * SP + i]));
    }
  __syncthreads();

  // mixer i takes row j iff fewer than k keys of column i come before it
  // (below it, or equal and in an earlier row): one warp sorts the column,
  // reads the k-th smallest key, and takes the keys below it, then keys
  // equal to it in row order (B8's set, take_bits)
  {
    using WS = selblock::WarpSort<NPAD>;
    const int lane = t & 31, le = lane % WS::G, grp = lane / WS::G;
    const unsigned mine = WS::G == 32 ? 0xFFFFFFFFu : ((1u << WS::G) - 1u) << (grp * WS::G);
    for (int i0 = (t >> 5) * WS::CPW; i0 < n; i0 += (S::T / 32) * WS::CPW) {
      const int i = i0 + grp;
      int32_t v[WS::R], o[WS::R];
#pragma unroll
      for (int r = 0; r < WS::R; ++r) {
        const int j = r * WS::G + le;
        o[r] = i < n && j < n ? keys[i * SP + j] : PAD_KEY;
        v[r] = o[r];
      }
      WS::sort(v, lane);
      int32_t at = v[0];
#pragma unroll
      for (int r = 1; r < WS::R; ++r)
        if (r == (k - 1) / WS::G) at = v[r];
      const int32_t cut = __shfl_sync(0xFFFFFFFFu, at, grp * WS::G + (k - 1) % WS::G);
      int quota = k;  // places left for keys equal to the cut
#pragma unroll
      for (int r = 0; r < WS::R; ++r) quota -= __popc(__ballot_sync(0xFFFFFFFFu, o[r] < cut) & mine);
#pragma unroll
      for (int r = 0; r < WS::R; ++r) {
        const unsigned eq = __ballot_sync(0xFFFFFFFFu, o[r] == cut) & mine;
        const bool take = o[r] < cut || (o[r] == cut && __popc(eq & ((1u << lane) - 1u)) < quota);
        quota -= __popc(eq);
        const unsigned bits = __ballot_sync(0xFFFFFFFFu, take) & mine;
        if (le == 0 && i < n) sel[i * W + r] = bits >> (grp * WS::G);
      }
    }
  }
  __syncthreads();

  // GA[j][i] = sum over the clean rows l mixer i took of G[j][l], l
  // ascending (0 for a tainted row j); sel_taint[i]: mixer i took a
  // tainted row
  if (t < n) {
    int any = 0;
#pragma unroll
    for (int v = 0; v < W; ++v) any |= (sel[t * W + v] & tmask[v]) != 0u;
    sel_taint[t] = any;
  }
  {
    float acc[S::RA][S::RB];
#pragma unroll
    for (int r = 0; r < S::RA; ++r)
#pragma unroll
      for (int c = 0; c < S::RB; ++c) acc[r][c] = 0.0f;
    for (int v = 0; v * U < n; ++v) {
      unsigned m[S::RB];
#pragma unroll
      for (int c = 0; c < S::RB; ++c) m[c] = sel[(b + S::TB * c) * W + v] & ~tmask[v];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float x[S::RA];
#pragma unroll
        for (int r = 0; r < S::RA; ++r) x[r] = X[(a + S::TA * r) * SP + v * U + u];
#pragma unroll
        for (int c = 0; c < S::RB; ++c)
          if ((m[c] >> u) & 1u) {
#pragma unroll
            for (int r = 0; r < S::RA; ++r) acc[r][c] = __fadd_rn(acc[r][c], x[r]);
          }
      }
    }
#pragma unroll
    for (int r = 0; r < S::RA; ++r)
#pragma unroll
      for (int c = 0; c < S::RB; ++c) {
        const int j = a + S::TA * r;
        Y[j * SP + b + S::TB * c] = (tmask[j >> 5] >> (j & 31)) & 1u ? 0.0f : acc[r][c];
      }
  }
  __syncthreads();

  // Gm[m][i] = (sum over the clean rows l mixer m took of GA[l][i]) / k^2,
  // NaN in the rows and columns of a mixer that took a tainted row
  {
    float acc[S::RA][S::RB];
#pragma unroll
    for (int r = 0; r < S::RA; ++r)
#pragma unroll
      for (int c = 0; c < S::RB; ++c) acc[r][c] = 0.0f;
    for (int v = 0; v * U < n; ++v) {
      unsigned m[S::RA];
#pragma unroll
      for (int r = 0; r < S::RA; ++r) m[r] = sel[(a + S::TA * r) * W + v] & ~tmask[v];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float y[S::RB];
#pragma unroll
        for (int c = 0; c < S::RB; ++c) y[c] = Y[(v * U + u) * SP + b + S::TB * c];
#pragma unroll
        for (int r = 0; r < S::RA; ++r)
          if ((m[r] >> u) & 1u) {
#pragma unroll
            for (int c = 0; c < S::RB; ++c) acc[r][c] = __fadd_rn(acc[r][c], y[c]);
          }
      }
    }
    const float kk = (float)(k * k);
#pragma unroll
    for (int r = 0; r < S::RA; ++r)
#pragma unroll
      for (int c = 0; c < S::RB; ++c) {
        const int mm = a + S::TA * r, i = b + S::TB * c;
        if (mm < n && i < n) {
          const float v = (sel_taint[mm] || sel_taint[i]) ? canonical_nan() : __fdiv_rn(acc[r][c], kk);
          X[mm * SP + i] = v;
          if (mm == i) nrm[i] = v;
        }
      }
  }
  __syncthreads();

  // the selection's scores and weights
  if (mode == kKrum) {
    krum_scores<S, NPAD>(X, keys, nrm, n, f, score);
  } else if (t < n) {
    score[t] = mode == kCge ? nrm[t] : sq_dist(nrm[ref], nrm[t], X[ref * SP + t]);
  }
  if (t < n) {
    const int nan_score = isnan(score[t]) ? 1 : 0;
    bad[t] = nan_score;
    if (nan_score) score[t] = 0.0f;
  }
  __syncthreads();
  weights_of_scores<S, NPAD>(score, bad, rank_s, w_sel, n, q);
  if (t < n && w_sel[t] > 0.0f && sel_taint[t]) atomicOr(&picked_tainted, 1);
  __syncthreads();

  // w_eff[i] = (sum over the mixers m that took clean row i of w_sel[m], m
  // ascending) / k, all NaN when a mixer that took a tainted row was picked
  if (t < n) {
    float acc = 0.0f;
    const unsigned bit = 1u << (t & 31);
    if (!(tmask[t >> 5] & bit)) {
      for (int mm = 0; mm < n; ++mm)
        if (sel[mm * W + (t >> 5)] & bit) acc = __fadd_rn(acc, w_sel[mm]);
    }
    w[(long long)blockIdx.x * n + t] = picked_tainted ? canonical_nan() : __fdiv_rn(acc, (float)k);
  }
}

// One launch of the sweep at width NPAD: the ring is dynamic shared
// memory, opted in above 48 KB; at most `blocks` blocks, and no more than
// fit on the card at once, since each strides over the tiles.
template <typename T, int NPAD>
cudaError_t launch_mix_width(const T* x, const float* mask, const float* sel_taint, T* out, int K,
                             int n, int k, long long d, int blocks, cudaStream_t s) {
  constexpr int TW = MixShape<NPAD>::TW;
  const long long tiles = (d + TW - 1) / TW;
  const long long total = tiles * K;
  const int dyn = kMixStages * NPAD * TW * (int)sizeof(T);
  const void* fn = reinterpret_cast<const void*>(&mix_rows_kernel<T, NPAD>);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kMixThreads, dyn)) !=
      cudaSuccess)
    return err;
  long long grid = per_sm > 0 ? (long long)per_sm * sms : 1;
  if (grid > blocks) grid = blocks;
  if (grid > total) grid = total;
  mix_rows_kernel<T, NPAD><<<(unsigned)grid, kMixThreads, dyn, s>>>(x, mask, sel_taint, out, n, k,
                                                                   d, tiles, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mix(const void* x, const float* mask, const float* sel_taint, void* out, int K,
                       int n, int k, long long d, int blocks, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  switch (network_width(n)) {
    case 8: return launch_mix_width<T, 8>(xt, mask, sel_taint, ot, K, n, k, d, blocks, s);
    case 16: return launch_mix_width<T, 16>(xt, mask, sel_taint, ot, K, n, k, d, blocks, s);
    case 32: return launch_mix_width<T, 32>(xt, mask, sel_taint, ot, K, n, k, d, blocks, s);
    case 64: return launch_mix_width<T, 64>(xt, mask, sel_taint, ot, K, n, k, d, blocks, s);
    case 128: return launch_mix_width<T, 128>(xt, mask, sel_taint, ot, K, n, k, d, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

// One launch of B9's weights at width NPAD: a block a round, its buffers
// in dynamic shared memory, opted in above 48 KB (132 KB at NPAD = 128)
// once a device.
template <int NPAD>
cudaError_t launch_nnm_selection(const float* gram, float* w, int K, int n, int k, int f,
                                 int q, int mode, int ref, cudaStream_t s) {
  static std::atomic<unsigned long long> ready{0};
  constexpr int dyn = sel_smem_bytes<NPAD>();
  const cudaError_t err = selblock::raise_smem_once(
      reinterpret_cast<const void*>(&nnm_selection_weights_kernel<NPAD>), dyn, ready);
  if (err != cudaSuccess) return err;
  nnm_selection_weights_kernel<NPAD><<<K, SelShape<NPAD>::T, dyn, s>>>(gram, w, n, k, f, q, mode,
                                                                      ref);
  return cudaGetLastError();
}

}  // namespace

// gram: (K, n, n) f32; mask: (K, n, n) f32 out (mask[j][i]: row i mixes row
// j); sel_taint: (K, n) f32 out. k = n - f in [1, n]. Returns the launch's
// cudaError_t.
extern "C" int byz_nnm_weights(const float* gram, float* mask, float* sel_taint, int K, int n,
                               int k, void* stream) {
  if (K <= 0) return cudaSuccess;
  if (k < 1 || k > n) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (network_width(n)) {
    case 8: return launch_nnm_weights<8>(gram, mask, sel_taint, K, n, k, s);
    case 16: return launch_nnm_weights<16>(gram, mask, sel_taint, K, n, k, s);
    case 32: return launch_nnm_weights<32>(gram, mask, sel_taint, K, n, k, s);
    case 64: return launch_nnm_weights<64>(gram, mask, sel_taint, K, n, k, s);
    case 128: return launch_nnm_weights<128>(gram, mask, sel_taint, K, n, k, s);
    default: return cudaErrorInvalidValue;
  }
}

// x: (K, n, d) contiguous; mask: (K, n, n) f32; sel_taint: (K, n) f32; out:
// (K, n, d) of x's dtype. blocks: at most this many blocks stride over the
// tiles (the launcher also caps them at what fits on the card at once).
// Returns the launch's cudaError_t (a refused shared-memory opt-in
// included).
extern "C" int byz_mix_rows(const void* x, const float* mask, const float* sel_taint, void* out,
                            int K, int n, int k, long long d, int blocks, int dtype,
                            void* stream) {
  if (K <= 0 || d <= 0) return cudaSuccess;
  if (k < 1 || k > n || blocks < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_mix<float>(x, mask, sel_taint, out, K, n, k, d, blocks, s);
    case kBF16: return launch_mix<__nv_bfloat16>(x, mask, sel_taint, out, K, n, k, d, blocks, s);
    case kF16: return launch_mix<__half>(x, mask, sel_taint, out, K, n, k, d, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

// gram: (K, n, n) f32; w: (K, n) f32 out, the source-row weights w_eff.
// k = n - f_nnm. Returns the launch's cudaError_t (a refused shared-memory
// opt-in included).
extern "C" int byz_nnm_selection_weights(const float* gram, float* w, int K, int n, int k,
                                         int f, int q, int mode, int ref, void* stream) {
  if (K <= 0) return cudaSuccess;
  if (k < 1 || k > n || mode < kKrum || mode > kMonna || ref < 0 || ref >= n)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (network_width(n)) {
    case 8: return launch_nnm_selection<8>(gram, w, K, n, k, f, q, mode, ref, s);
    case 16: return launch_nnm_selection<16>(gram, w, K, n, k, f, q, mode, ref, s);
    case 32: return launch_nnm_selection<32>(gram, w, K, n, k, f, q, mode, ref, s);
    case 64: return launch_nnm_selection<64>(gram, w, K, n, k, f, q, mode, ref, s);
    case 128: return launch_nnm_selection<128>(gram, w, K, n, k, f, q, mode, ref, s);
    default: return cudaErrorInvalidValue;
  }
}
