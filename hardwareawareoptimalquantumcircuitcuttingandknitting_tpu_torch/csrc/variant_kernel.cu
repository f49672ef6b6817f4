// Whole-variant statevector kernel for the engine="pallas" label scan.
//
// Replaces the JAX package's ops/pallas_variant.py::_build_call (the
// pl.pallas_call at :577), reached through make_folded_chunk_kernel :699
// (fold epilogue) and make_chunk_kernel :647 (full-row epilogue).  For
// each QPD label of a chunk it starts from the host-computed shared prefix
// state, applies the suffix (fixed gates, slot gates from the label's own
// complex entries), and writes either the fold-weighted, z-signed, summed
// knit row [2^d] or the full |psi|^2 row [2^n].
//
// One generic interpreter over the op table rewritten by ops/op_rewrite.py
// (dense 1q / 2q gates from the pool or the label's entry row, diagonal
// runs, signed permutations; the row machinery is statevec_common.cuh,
// shared with the collapse kernel): a single nvcc build serves every
// circuit.  Plain C interface, loaded with ctypes.
//
// Design, and what bounds it on an H100:
//  * Runs and stages.  A first, one-CTA kernel (variant_schedule_kernel)
//    sorts a chunk's labels by their slot digits in chain order (a key
//    the wrapper computes; bitonic, ties by index, so stable), so labels
//    that share the early slots sit side by side, and gives each label
//    its stage: the first slot whose digit differs from the previous
//    label's.  Segment i (slot i and the fixed rows up to the next slot)
//    re-runs only when the stage is <= i.  It cuts the chunk into runs, at
//    label groups (labels that share every digit but the chain's last),
//    at every stage 0, and at most `cap` labels long; a CTA, or a
//    cluster, of the second kernel owns a run and walks its labels in
//    sorted order, reading each label's entries and weights and writing
//    its row where the label sits in the chunk.  A run's first label
//    replays from the prefix (its checkpoints belong to another CTA);
//    every other label resumes at its stage.  One launch of each, no host
//    wait and no torch op between them: the host, not the card, set the
//    pace of the main path when the sort and runs were torch ops.
//  * The state on chip (variant_rows_kernel).  A complex64 state is
//    8 * 2^n bytes.  Up to n = 14 (128 KB) one CTA holds it in shared
//    memory.  At n = 15 (256 KB, past a CTA's 227 KB) a cluster of two
//    CTAs holds it, split on the top flat bit; a gate on that bit reads
//    and writes the partner's half through distributed shared memory
//    between two cluster barriers, every other row is local.  Each
//    segment's start is kept in a global slice of the CTA's share
//    (L2-resident: 66 clusters x 128 KB a segment at n = 15), written once
//    when its segment starts and read once on resume.  A register
//    checkpoint of the last segment's start (32 amplitudes a thread at
//    512 threads, as the collapse kernel keeps) made ptxas spill the gate
//    loops and was no faster on the card, so every start goes to the
//    slice.
//  * Rows in shared memory.  Every row is one pass over the state (or a
//    tile) and one barrier, so the rewritten table cuts passes:
//    identities go, a run of diagonal gates (cz, rz, cp) is one pass, a
//    signed permutation (x, cx) a move.  The rows are bound by the
//    instructions issued for each amplitude, so they run the local loops
//    (apply_row<true>: 32-bit shared-memory addressing) wherever no row
//    crosses a split.  Several rows a pass in registers (a group of 8
//    amplitudes across the rows on its 3 bits) halved sup-20's passes
//    but not its time, and slowed hwe-16: in shared memory a row's bytes
//    cost little, its instructions the same, so it is not kept.  The row
//    table and the coefficient pool sit in shared memory, where they fit,
//    and each label's entry row too.
//  * The state in global memory, in tiles (variant_rows_kernel_tiled,
//    n = 16 to 20).  Applying each row to the whole state in global
//    memory cost one HBM read and write of the [2, 2^n] state a row (and
//    one more each checkpoint save, restore and prefix copy): 1216 GB a
//    request of sup25-full, at the HBM limit.  Instead the host cuts each
//    segment into passes (TilePlan in the wrapper): a pass's rows pair
//    amplitudes on at most w flat bits, its window, padded with the
//    lowest other bits (bits 0 and 1 always, so a tile moves in 16-byte
//    pieces, most often in whole lines); a segment's rows take one pass
//    unless their bits overflow a window, when they split in row order.
//    w is the widest up to 14 whose tile (8 * 2^w bytes), fold sums and
//    offsets fit a CTA's shared memory with the tables.  A tile is the
//    2^w amplitudes that share the bits outside the window, in layout
//    order (window bits below, ascending); the host gives every row its
//    layout bits, and a diagonal run its own copy in the pool, so a
//    diagonal row reads its bits from the layout index (tile << w) | x,
//    View's rank and split.  A cluster's CTAs split each pass's tiles;
//    each loads a tile with asynchronous copies (cp.async: no register on
//    the way and every copy in flight at once, where a global row's
//    dependent loads held a CTA to about 20 GB/s), applies the pass's
//    rows with the local loops, and writes the tile where the next pass
//    reads it.  The last pass of segment i writes segment i + 1's
//    checkpoint slot, so the checkpoint costs nothing more; the passes
//    of a segment between its first and last go through slot 0.  The
//    last pass of the last segment never writes the state back: the
//    epilogue reads its tile (below).  A label equal to the previous one
//    (stage n_seg) replays the last segment from its checkpoint, the
//    same arithmetic, so its row is the same bits.  A cluster barrier
//    ends each pass (its release and acquire at cluster scope order one
//    CTA's global writes before another's reads).  State traffic: one
//    read and one write a pass, the last a read: 76 GB a request of
//    sup25-full (23 ms at 3.35 TB/s), 44 GB of syc32-rcs, so the
//    shared-memory row loops, not HBM, bound the path: of sup25's 138 ms
//    of kernel a request the rows took about 100, the copies 13 (with
//    the rows cut out, or the copies, on one H100).  Neither their
//    barriers (about 7 ms) nor loops that issue every load of a few
//    pairs before their stores (6 ms) moved them much.  One tile a CTA:
//    a second, its copies in flight under the rows, fits only at w = 13,
//    and lost to one at w = 14 in both cells (a request's rows calls:
//    sup25 193-195 against 169-175 ms, syc32 85-89 against 82-86).  Each
//    pair update does the same arithmetic as a row over the whole state,
//    so full rows equal that design's bit for bit, whatever the cluster.
//  * The epilogues.  Fold: out[k] = sum_h w(h) sign(h) |psi[h << d | k]|^2.
//    In shared memory the factor w(h) sign(h) is tabulated once a label
//    (up to 1024 h); the split bit n - 1 is never a kept bit when d < n,
//    so each CTA of a cluster sums its own share of the h range (a
//    1/csize slice) and the partials are added in rank order through
//    distributed shared memory, each CTA writing a 1/csize share of the
//    outputs.  In tiles, the last pass folds each tile as it leaves the
//    rows: its kin kept bits inside the window are the low bits of its
//    layout index, the kout = d - kin outside it the low bits of its
//    tile number, so the tiles of one value of those (a group) add into
//    the same 2^kin sums, kept in shared memory in tile order.  A factor
//    is the product of its window bits' part, tabulated once a label,
//    and its tile's (a table a tile took 25 of syc32's 63 ms a request).
//    A CTA takes whole groups and writes their outputs; with fewer
//    groups than CTAs, each CTA takes a share of each group's tiles and
//    the partials are added in rank order, as above.
//    Full rows: each CTA writes its own share (a tile's |psi|^2 at its
//    flat indices).
//  * Sums in a fixed order (per-thread partial in double, a shared-memory
//    tree, tiles in order, the CTAs in rank order), no float atomics: a
//    launch repeats bit for bit.  f32 state, IEEE arithmetic (no
//    fast-math), no tensor cores, so no TF32.
//
// Layout: planar [2, 2^n] (re then im); flat bit j of the amplitude index
// is the kernel's qubit j (the host maps circuit qubits to flat bits, with
// the fold's kept clbits on bits 0..d-1).  Gate index m = 2*bit(ja)+bit(jb).

#include <climits>

#include "statevec_common.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxQubits = 20;
constexpr int kMaxSmemQubits = 15;  // 15: two CTAs of 128 KB
constexpr int kMaxCluster = 8;      // the portable cluster
constexpr int kMaxW = 64;           // fold weights
constexpr int kMaxEntry = 1024;     // entry floats a label stages on chip
constexpr int kMaxFac = 1024;       // fold factors a label tabulates on chip
constexpr int kMinTile = 4;         // a tile's bits: bits 0 and 1, a 2q row
constexpr int kMaxTile = 14;        // 128 KB of shared memory

struct Params {
  const float* prefix;     // [2, N]
  const int* rows;         // [n_rows, 6] rewritten op table (tiles: each
                           //   row's bits at its pass's layout positions)
  const float* pool;       // fixed coefficients, diagonal runs
  const int* seg_start;    // [n_seg + 1] first row (tiles: first pass) of
                           //   each segment
  const int* passes;       // tiles: [n_pass, 3] first row, end row, window
  const float* entries;    // [C, entry_stride] per-label slot coefficients
  const int* stage;        // [C] first segment to replay
  const float* wstack;     // [C, n_w, 2] fold weights (w0, w1)
  const int* wbits;        // [n_wbits] flat bit per weight, -1 = scalar w0
  const int* order;        // [C] sorted position -> row of entries, wstack
                           //   and out (null: the same row)
  const int* runs;         // [C, 2]: first label, length
  const int* count;        // [1]: runs in the table
  float* scratch;          // [owners, n_slots, 2, L] checkpoints: a CTA's
                           //   (shared memory) or a cluster's (tiles)
  float* out;              // [C, 2^d] (fold) or [C, N] (full rows)
  int n, d, fold, C, n_seg, entry_stride, n_w, n_wbits, zmask;
  int csize;               // CTAs a state is split over: 1, 2 at n = 15
                           //   (shared memory), up to 8 (tiles)
  int n_slots;             // global [2, L] slots an owner has
  int n_rows, pool_len;    // staged in shared memory after the state (or
  int stage_tables;        //   the tile's space) when stage_tables
  int w, n_pass;           // tiles: a tile's bits, the passes
  int tab_at;              // tiles: floats of shared memory before tables
};

// dst[0, L) = re[0, L) and dst[L, 2L) = im[0, L) by the CTA's threads.
// One side is in device memory, where a load waits about a microsecond,
// so each thread issues a batch of 16-byte loads before its stores (the
// compiler may not hoist a load past a store it cannot prove apart).
__device__ __forceinline__ void copy_planes(float* dst, const float* re,
                                            const float* im, int L, int t,
                                            int T) {
  if (L & 3) {
    for (int x = t; x < L; x += T) {
      dst[x] = re[x];
      dst[L + x] = im[x];
    }
    return;
  }
  constexpr int kBatch = 4;
  const int L4 = L >> 2;
  float4* d4 = reinterpret_cast<float4*>(dst);
  const float4* r4 = reinterpret_cast<const float4*>(re);
  const float4* i4 = reinterpret_cast<const float4*>(im);
  for (int x0 = t; x0 < L4; x0 += kBatch * T) {
    float4 a[kBatch], b[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int x = x0 + k * T;
      if (x < L4) {
        a[k] = r4[x];
        b[k] = i4[x];
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int x = x0 + k * T;
      if (x < L4) {
        d4[x] = a[k];
        d4[L4 + x] = b[k];
      }
    }
  }
}

// The fold's factor of amplitude f: its vgate weights and z sign, which
// read only bits at or above d (the host lays out kept bits below).
__device__ __forceinline__ float fold_fac(int f, const float* ws,
                                          const int* wb, int n_wbits,
                                          int zmask) {
  float fac = 1.f;
  for (int t = 0; t < n_wbits; ++t) {
    const int fb = wb[t];
    fac *= (fb >= 0 && ((f >> fb) & 1)) ? ws[2 * t + 1] : ws[2 * t];
  }
  return (__popc(f & zmask) & 1) ? -fac : fac;
}

// out[k] = sum_h w(h) * sign(h) * |psi[h << d | k]|^2 over this CTA's
// share of h, then (a cluster) the CTAs' partials in rank order.  The
// outputs go in tiles of min(K, T), G = T / tile threads each.  A factor
// depends on h alone, so up to kMaxFac of this CTA's h values have theirs
// computed once a label, into fac.  Every thread of the cluster calls it.
__device__ void epilogue_fold(const Params& p, const View& v, const float* ws,
                              const int* wb, float* orow, float* red,
                              float* fac) {
  const int n = p.n, d = p.d, K = 1 << d, cs = p.csize;
  const int T = blockDim.x, t = threadIdx.x;  // the CTA's own threads
  const int H = (1 << n) >> d;
  const bool pair = v.split >= 0;
  // a cluster splits h (a pair with d < n: the split bit is an h bit) or,
  // a pair with every bit kept, the outputs themselves (each CTA owns the
  // k on its side); one CTA takes every h with no division (a label's
  // epilogue is short at narrow widths)
  int hbase = 0, Hc = H;
  if (cs > 1 && !(pair && d == n)) {
    hbase = H * v.rank / cs;
    Hc = H * (v.rank + 1) / cs - hbase;
  }
  const bool table = Hc <= kMaxFac;
  if (table) {
    for (int hh = t; hh < Hc; hh += T)
      fac[hh] = fold_fac((hbase + hh) << d, ws, wb, p.n_wbits, p.zmask);
    __syncthreads();
  }
  const int KT = K < T ? K : T, G = T / KT;
  const int kk = t % KT, g = t / KT;
  const float* st = v.own;
  const int L = v.L;
  for (int k0 = 0; k0 < K; k0 += KT) {
    const int k = k0 + kk;
    double acc = 0.0;  // up to 2^20 / 512 terms a thread
    for (int hh = g; hh < Hc; hh += G) {
      const int f = ((hbase + hh) << d) | k;
      if (pair && ((f >> v.split) & 1) != v.rank) continue;
      const int x = f & (L - 1);
      const float sq = st[x] * st[x] + st[L + x] * st[L + x];
      acc += sq * (table ? fac[hh]
                         : fold_fac(f, ws, wb, p.n_wbits, p.zmask));
    }
    red[t] = (float)acc;
    __syncthreads();
    for (int s = G >> 1; s > 0; s >>= 1) {
      if (g < s) red[t] += red[t + s * KT];
      __syncthreads();
    }
    if (cs == 1) {
      if (t < KT) orow[k0 + t] = red[t];
    } else {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      // each CTA writes its share of the tile, the partials in rank order
      const int lo = KT * v.rank / cs, hi = KT * (v.rank + 1) / cs;
      if (t < hi - lo) {
        float* r = red + lo + t;
        float s = *cluster.map_shared_rank(r, 0);
        for (int q = 1; q < cs; ++q) s += *cluster.map_shared_rank(r, q);
        orow[k0 + lo + t] = s;
      }
      cluster.sync();  // the others have read red
    }
    __syncthreads();
  }
}

__device__ void epilogue_rows(const View& v, float* orow) {
  const float* st = v.own;
  const int L = v.L, top = v.split >= 0 ? v.rank << v.split : 0;
  for (int x = v.t; x < L; x += v.T)
    orow[top + x] = st[x] * st[x] + st[L + x] * st[L + x];
}

// The state in shared memory: one CTA's (n <= 14) or split over a
// cluster of two (n = 15).  512 threads and one CTA an SM: 128 registers
// a thread for the interpreter (a dense 2q gate holds its 32
// coefficients).
__global__ void __launch_bounds__(kMaxThreads, 1)
variant_rows_kernel(Params p) {
  extern __shared__ __align__(16) float smem_state[];
  __shared__ float red[kMaxThreads];
  __shared__ float s_erow[kMaxEntry];
  __shared__ float s_fac[kMaxFac];
  __shared__ float s_ws[2 * kMaxW];
  __shared__ int s_wb[kMaxW];

  const int N = 1 << p.n;
  const int T = blockDim.x, t = threadIdx.x;
  int cluster_id = blockIdx.x, n_clusters = gridDim.x;
  View v;
  v.rank = 0;
  if (p.csize > 1) {
    v.rank = (int)cg::this_cluster().block_rank();
    cluster_id = blockIdx.x / p.csize;
    n_clusters = gridDim.x / p.csize;
  }
  v.L = N / p.csize;
  v.t = t;
  v.T = T;
  v.split = p.csize == 2 ? p.n - 1 : -1;
  const int L = v.L;
  // the CTA's checkpoint slots: slot i - 1 holds segment i's start
  float* slots =
      p.n_slots ? p.scratch + (size_t)blockIdx.x * p.n_slots * 2 * L : nullptr;
  if (v.split >= 0) {
    cg::cluster_group cluster = cg::this_cluster();
    v.base[0] = cluster.map_shared_rank(smem_state, 0);
    v.base[1] = cluster.map_shared_rank(smem_state, 1);
  } else {
    v.base[0] = v.base[1] = smem_state;
  }
  v.own = smem_state;
  float* st = smem_state;
  const int top = v.split >= 0 ? v.rank << v.split : 0;
  for (int i = t; i < p.n_wbits; i += T) s_wb[i] = p.wbits[i];
  // the tables every row reads: on chip where they fit
  const int* rows = p.rows;
  const float* pool = p.pool;
  if (p.stage_tables) {
    float* tab = smem_state + 2 * L;
    for (int i = t; i < p.pool_len; i += T) tab[i] = p.pool[i];
    int* rtab = reinterpret_cast<int*>(tab + p.pool_len);
    for (int i = t; i < kRow * p.n_rows; i += T) rtab[i] = p.rows[i];
    rows = rtab;
    pool = tab;
  }
  const bool stage_entries = p.entry_stride <= kMaxEntry;
  if (p.csize > 1) cg::this_cluster().sync();  // every CTA has started
  __syncthreads();

  const int R = *p.count;
  for (int ri = cluster_id; ri < R; ri += n_clusters) {
    const long long first = p.runs[2 * ri];
    const int len = p.runs[2 * ri + 1];
    for (int j = 0; j < len; ++j) {
      const long long lab = first + j;
      const long long row = p.order ? p.order[lab] : lab;
      const int s = j == 0 ? 0 : p.stage[lab];  // a run opens from the prefix
      const float* erow = p.entries + (size_t)row * p.entry_stride;
      if (s == 0 || s < p.n_seg) {
        if (stage_entries) {
          // the previous label's rows have read s_erow (a barrier ends
          // every row and every epilogue)
          for (int i = t; i < p.entry_stride; i += T) s_erow[i] = erow[i];
          erow = s_erow;
        }
        // the state at the start of segment s
        if (s == 0) {
          copy_planes(st, p.prefix + top, p.prefix + N + top, L, t, T);
        } else {
          const float* src = slots + (size_t)(s - 1) * 2 * L;
          copy_planes(st, src, src + L, L, t, T);
        }
        __syncthreads();
        for (int i = s; i < p.n_seg; ++i) {
          if (i > s) {
            // segment i starts: keep its state for the labels after
            float* dst = slots + (size_t)(i - 1) * 2 * L;
            copy_planes(dst, st, st + L, L, t, T);
            __syncthreads();  // saved before the next row rewrites it
          }
          for (int o = p.seg_start[i]; o < p.seg_start[i + 1]; ++o)
            apply_row<true>(v, rows + kRow * o, pool, erow, smem_state);
        }
      }
      if (p.fold) {
        const float* ws = p.wstack + (size_t)row * p.n_w * 2;
        for (int i = t; i < 2 * p.n_wbits; i += T) s_ws[i] = ws[i];
        __syncthreads();
        epilogue_fold(p, v, s_ws, s_wb, p.out + ((size_t)row << p.d), red,
                      s_fac);
      } else {
        epilogue_rows(v, p.out + (size_t)row * N);
        __syncthreads();  // read before the next label rewrites the state
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The state in global memory, in tiles (n = 16 to 20)
// ---------------------------------------------------------------------------

// The low bits of v, one each, on the set bits of mask, lowest first.
__device__ __forceinline__ int deposit(int v, int mask) {
  int r = 0;
  while (mask) {
    const int low = mask & -mask;
    if (v & 1) r |= low;
    v >>= 1;
    mask ^= low;
  }
  return r;
}

// 16 bytes from global to shared memory, no register on the way;
// copies_wait() waits for the thread's copies (a barrier, the CTA's).
__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// A pass's tiles in a flat [2, N] state: amplitude x (layout order) of
// the tile at offset off = deposit(tile, rest) is at flat index
// (x & low) | hi[x >> r] | off, r the window's low run of bits 0, 1, ...
struct Tiles {
  int mask, rest, r, low, W, N;
  const int* hi;  // [W >> r] the window's bits above the run
};

__device__ __forceinline__ int flat_of(const Tiles& m, int x, int off) {
  return (x & m.low) | m.hi[x >> m.r] | off;
}

// The tile at off from the state src into tile [2, W]; ends with the
// CTA's barrier.
__device__ void load_tile(float* tile, const float* src, const Tiles& m,
                          int off) {
  for (int u = threadIdx.x; u < (m.W >> 2); u += blockDim.x) {
    const int x = u << 2, f = flat_of(m, x, off);
    copy16_async(tile + x, src + f);
    copy16_async(tile + m.W + x, src + m.N + f);
  }
  copies_wait();
  __syncthreads();
}

__device__ void store_tile(float* dst, const float* tile, const Tiles& m,
                           int off) {
  for (int u = threadIdx.x; u < (m.W >> 2); u += blockDim.x) {
    const int x = u << 2, f = flat_of(m, x, off);
    *reinterpret_cast<float4*>(dst + f) =
        *reinterpret_cast<const float4*>(tile + x);
    *reinterpret_cast<float4*>(dst + m.N + f) =
        *reinterpret_cast<const float4*>(tile + m.W + x);
  }
}

// Full rows: the tile's |psi|^2 at its amplitudes' flat indices.
__device__ void rows_tile(float* orow, const float* tile, const Tiles& m,
                          int off) {
  for (int u = threadIdx.x; u < (m.W >> 2); u += blockDim.x) {
    const int x = u << 2, f = flat_of(m, x, off);
    const float4 a = *reinterpret_cast<const float4*>(tile + x);
    const float4 b = *reinterpret_cast<const float4*>(tile + m.W + x);
    float4 o;
    o.x = a.x * a.x + b.x * b.x;
    o.y = a.y * a.y + b.y * b.y;
    o.z = a.z * a.z + b.z * b.z;
    o.w = a.w * a.w + b.w * b.w;
    *reinterpret_cast<float4*>(orow + f) = o;
  }
}

// Rows [lo, hi) of a pass on the tile numbered tt: the local loops, a
// diagonal row reading its bits from the layout index (tt << w) | x
// (View's rank and split; no other row touches bit w or above).
__device__ void tile_rows(float* tile, int tt, int w, const int* rows,
                          const float* pool, const float* erow, int lo,
                          int hi) {
  View v;
  v.base[0] = v.base[1] = v.own = tile;
  v.L = 1 << w;
  v.rank = tt;
  v.split = w;
  v.t = threadIdx.x;
  v.T = blockDim.x;
  for (int o = lo; o < hi; ++o)
    apply_row<true>(v, rows + kRow * o, pool, erow, tile);
}

// The part of amplitude f's fold factor that the flat bits in sel give:
// the weights on those bits (with scalars, also the weights of no bit),
// and the z sign of f & sel.
__device__ __forceinline__ float fold_fac_part(int f, const float* ws,
                                               const int* wb, int n_wbits,
                                               int zmask, int sel,
                                               bool scalars) {
  float fac = 1.f;
  for (int t = 0; t < n_wbits; ++t) {
    const int fb = wb[t];
    if (fb >= 0 ? ((sel >> fb) & 1) : scalars)
      fac *= (fb >= 0 && ((f >> fb) & 1)) ? ws[2 * t + 1] : ws[2 * t];
  }
  return (__popc(f & zmask & sel) & 1) ? -fac : fac;
}

// acc[k] += fo * sum_h fac[h] * |psi[h << kin | k]|^2 over one tile (k <
// 2^kin, h < 2^hin; fo the tile's factor): per-thread partials in double,
// a tree in red when several threads share an output.  Every thread of
// the CTA calls it.
__device__ void fold_tile(const float* tile, int W, float* acc,
                          const float* fac, float fo, float* red, int kin,
                          int hin) {
  const int T = blockDim.x, t = threadIdx.x, Kn = 1 << kin, Hn = 1 << hin;
  const int KT = Kn < T ? Kn : T, G = T / KT, kk = t % KT, g = t / KT;
  for (int k0 = 0; k0 < Kn; k0 += KT) {
    const int k = k0 + kk;
    double a = 0.0;
    for (int h = g; h < Hn; h += G) {
      const int x = (h << kin) | k;
      const float sq = tile[x] * tile[x] + tile[W + x] * tile[W + x];
      a += sq * fac[h];
    }
    if (G == 1) {  // the thread's own output
      acc[k] += (float)(a * fo);
      continue;
    }
    red[t] = (float)a;
    __syncthreads();
    for (int s = G >> 1; s > 0; s >>= 1) {
      if (g < s) red[t] += red[t + s * KT];
      __syncthreads();
    }
    if (t < KT) acc[k0 + t] += red[t] * fo;
    __syncthreads();
  }
}

// The last pass of a label, folded: out[k] of its row orow from each
// tile as it leaves the rows (see the design notes).  The kin kept bits
// in the window are the tile's low bits, the kout outside it the low
// bits of the tile number; a group is the tiles of one value of those,
// summed into acc [2^kin] in tile order.  An amplitude's factor is its
// window bits' (fac [2^hin], tabulated once a label) times its tile's.
// Every thread of the cluster calls it; it ends with the CTA's barrier.
__device__ void fold_pass(const Params& p, const Tiles& m, float* tile,
                          float* acc, float* fac, float* red,
                          const float* src, const int* rows,
                          const float* pool, const float* erow, int lo,
                          int hi, const float* ws, const int* wb,
                          float* orow, int rank) {
  const int T = blockDim.x, t = threadIdx.x, cs = p.csize, K = 1 << p.d;
  const int kmask = m.mask & (K - 1), gmask = m.rest & (K - 1);
  const int kin = __popc(kmask), kout = p.d - kin, hin = p.w - kin;
  const int G = 1 << kout, H = 1 << (p.n - p.w - kout);
  const int Kn = 1 << kin, Hn = 1 << hin;
  // whole groups a CTA, or, fewer groups than CTAs, a share of each
  // group's tiles a CTA and the partials added in rank order
  const bool share = G < cs;
  const int g0 = share ? 0 : G * rank / cs, g1 = share ? G : G * (rank + 1) / cs;
  const int h0 = share ? H * rank / cs : 0, h1 = share ? H * (rank + 1) / cs : H;
  for (int h = t; h < Hn; h += T)
    fac[h] = fold_fac_part(deposit(h << kin, m.mask), ws, wb, p.n_wbits,
                           p.zmask, m.mask, false);
  for (int g = g0; g < g1; ++g) {
    for (int x = t; x < Kn; x += T) acc[x] = 0.f;
    for (int hh = h0; hh < h1; ++hh) {
      const int tt = g | (hh << kout), off = deposit(tt, m.rest);
      // its barrier orders fac and acc's zeros too
      load_tile(tile, src, m, off);
      tile_rows(tile, tt, p.w, rows, pool, erow, lo, hi);
      const float fo =
          fold_fac_part(off, ws, wb, p.n_wbits, p.zmask, m.rest, true);
      fold_tile(tile, m.W, acc, fac, fo, red, kin, hin);
      __syncthreads();  // read before the next tile's copies
    }
    const int base = deposit(g, gmask);
    if (!share) {
      for (int x = t; x < Kn; x += T) orow[base | deposit(x, kmask)] = acc[x];
      __syncthreads();
      continue;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int x1 = Kn * (rank + 1) / cs;
    for (int x = Kn * rank / cs + t; x < x1; x += T) {
      float s = *cluster.map_shared_rank(acc + x, 0);
      for (int q = 1; q < cs; ++q) s += *cluster.map_shared_rank(acc + x, q);
      orow[base | deposit(x, kmask)] = s;
    }
    cluster.sync();  // the others have read acc
  }
}

// The state in global scratch that a cluster of csize CTAs shares (n =
// 16 to 20), a segment a pass over tiles of 2^w amplitudes in shared
// memory.  Slot 0 of the cluster's scratch holds the state between the
// passes of a segment that takes several, slot i (i >= 1) segment i's
// start.
__global__ void __launch_bounds__(kMaxThreads, 1)
variant_rows_kernel_tiled(Params p) {
  extern __shared__ __align__(16) float smem_state[];
  __shared__ float red[kMaxThreads];
  __shared__ float s_erow[kMaxEntry];
  __shared__ float s_ws[2 * kMaxW];
  __shared__ int s_wb[kMaxW];

  const int N = 1 << p.n, W = 1 << p.w;
  const int T = blockDim.x, t = threadIdx.x, cs = p.csize;
  const int n_seg = p.n_seg > 1 ? p.n_seg : 1;  // no slot: a pass of no row
  int rank = 0, cluster_id = blockIdx.x, n_clusters = gridDim.x;
  if (cs > 1) {
    rank = (int)cg::this_cluster().block_rank();
    cluster_id = blockIdx.x / cs;
    n_clusters = gridDim.x / cs;
  }
  // shared memory: the tile, the fold's sums and factors (of the last
  // pass's window), a pass's offsets, then the tables
  const int last = p.passes[3 * (p.n_pass - 1) + 2];
  const int kin = p.fold ? __popc(last & ((1 << p.d) - 1)) : 0;
  float* tile = smem_state;
  float* acc = tile + 2 * W;
  float* fac = acc + (p.fold ? 1 << kin : 0);
  int* hi = reinterpret_cast<int*>(fac + (p.fold ? 1 << (p.w - kin) : 0));
  const int* rows = p.rows;
  const float* pool = p.pool;
  if (p.stage_tables) {
    float* tab = smem_state + p.tab_at;
    for (int i = t; i < p.pool_len; i += T) tab[i] = p.pool[i];
    int* rtab = reinterpret_cast<int*>(tab + p.pool_len);
    for (int i = t; i < kRow * p.n_rows; i += T) rtab[i] = p.rows[i];
    rows = rtab;
    pool = tab;
  }
  for (int i = t; i < p.n_wbits; i += T) s_wb[i] = p.wbits[i];
  const bool stage_entries = p.entry_stride <= kMaxEntry;
  float* slots = p.scratch + (size_t)cluster_id * p.n_slots * 2 * N;
  const int n_tiles = N >> p.w;
  Tiles m;
  m.W = W;
  m.N = N;
  m.hi = hi;
  if (cs > 1) cg::this_cluster().sync();  // every CTA has started
  __syncthreads();

  const int R = *p.count;
  for (int ri = cluster_id; ri < R; ri += n_clusters) {
    const long long first = p.runs[2 * ri];
    const int len = p.runs[2 * ri + 1];
    for (int j = 0; j < len; ++j) {
      const long long lab = first + j;
      const long long row = p.order ? p.order[lab] : lab;
      // a run opens from the prefix; a label equal to the previous one
      // replays the last segment from its start
      int s = j == 0 ? 0 : p.stage[lab];
      if (s > n_seg - 1) s = n_seg - 1;
      const float* erow = p.entries + (size_t)row * p.entry_stride;
      // the previous label's passes have read s_erow and s_ws (a barrier
      // ends each); the offsets' barrier below orders these writes
      if (stage_entries) {
        for (int i = t; i < p.entry_stride; i += T) s_erow[i] = erow[i];
        erow = s_erow;
      }
      if (p.fold) {
        const float* ws = p.wstack + (size_t)row * p.n_w * 2;
        for (int i = t; i < 2 * p.n_wbits; i += T) s_ws[i] = ws[i];
      }
      int i = s;
      for (int q = p.seg_start[s]; q < p.n_pass; ++q) {
        if (q == p.seg_start[i + 1]) ++i;
        const int lo = p.passes[3 * q], end = p.passes[3 * q + 1];
        m.mask = p.passes[3 * q + 2];
        m.rest = ~m.mask & (N - 1);
        m.r = __ffs(~m.mask) - 1;
        m.low = (1 << m.r) - 1;
        for (int e = t; e < (W >> m.r); e += T)
          hi[e] = deposit(e << m.r, m.mask);
        __syncthreads();
        // from segment i's start (the prefix, or its slot) or slot 0; to
        // segment i + 1's slot, slot 0, or, the last pass, the row
        const float* src = q > p.seg_start[i]
                               ? slots
                               : (i == 0 ? p.prefix : slots + (size_t)i * 2 * N);
        float* dst = nullptr;
        if (q + 1 < p.seg_start[i + 1])
          dst = slots;
        else if (i + 1 < n_seg)
          dst = slots + (size_t)(i + 1) * 2 * N;
        if (dst == nullptr && p.fold) {
          fold_pass(p, m, tile, acc, fac, red, src, rows, pool, erow, lo, end,
                    s_ws, s_wb, p.out + ((size_t)row << p.d), rank);
        } else {
          for (int tt = rank; tt < n_tiles; tt += cs) {
            const int off = deposit(tt, m.rest);
            load_tile(tile, src, m, off);
            tile_rows(tile, tt, p.w, rows, pool, erow, lo, end);
            if (dst != nullptr)
              store_tile(dst, tile, m, off);
            else
              rows_tile(p.out + (size_t)row * N, tile, m, off);
            __syncthreads();  // read before the next tile's copies
          }
        }
        // the pass is written before any CTA reads it
        if (cs > 1) cg::this_cluster().sync();
      }
    }
  }
}

constexpr int kSchedThreads = 1024;
constexpr int kMaxSched = 8192;  // labels one schedule launch sorts

// Inclusive scan of a[0..n) in shared memory, the max (kMax) or the sum,
// by every thread of the CTA; tmp holds blockDim.x ints.
template <bool kMax>
__device__ void block_scan(int* a, int n, int* tmp) {
  const int T = blockDim.x, t = threadIdx.x;
  const int id = kMax ? INT_MIN : 0;
  const int per = (n + T - 1) / T, lo = min(n, t * per), hi = min(n, lo + per);
  int acc = id;
  for (int i = lo; i < hi; ++i) {
    acc = kMax ? max(acc, a[i]) : acc + a[i];
    a[i] = acc;
  }
  tmp[t] = acc;
  __syncthreads();
  for (int o = 1; o < T; o <<= 1) {
    const int v = t >= o ? tmp[t - o] : id;
    __syncthreads();
    tmp[t] = kMax ? max(tmp[t], v) : tmp[t] + v;
    __syncthreads();
  }
  const int off = t > 0 ? tmp[t - 1] : id;
  for (int i = lo; i < hi; ++i) a[i] = kMax ? max(a[i], off) : a[i] + off;
  __syncthreads();
}

// What the schedule kernel reads and writes.  key [C] (null: keep the
// order, stage_in gives the stages) is the labels' slot digits as one
// mixed-radix number, chain order most significant, strides [k] its place
// values.  It writes order [C] and stage [C] (with a key; else the rows
// kernel reads stage_in), runs [count, 2] and count.
struct Schedule {
  const long long* key;
  const long long* strides;
  int k;
  const int* stage_in;
  int C, n_seg, cap;
  int* order;
  int* stage;
  int* runs;
  int* count;
};

// One CTA: the launch order, stages and runs of a chunk (see the design
// notes).
__global__ void __launch_bounds__(kSchedThreads)
variant_schedule_kernel(Schedule q) {
  extern __shared__ __align__(8) unsigned char sched_smem[];
  const long long* key = q.key;
  const int C = q.C, k = q.k, cap = q.cap;
  const int T = blockDim.x, t = threadIdx.x;
  int P = 1;
  while (P < C) P <<= 1;
  long long* skey = reinterpret_cast<long long*>(sched_smem);
  int* sidx = reinterpret_cast<int*>(skey + P);
  int* sst = sidx + P;
  int* sa = sst + P;
  int* tmp = sa + P;
  if (key != nullptr) {
    for (int i = t; i < P; i += T) {
      skey[i] = i < C ? key[i] : LLONG_MAX;
      sidx[i] = i < C ? i : INT_MAX;
    }
    __syncthreads();
    // bitonic sort of (key, index), ascending
    for (int size = 2; size <= P; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = t; i < P / 2; i += T) {
          const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
          const bool up = (lo & size) == 0;
          const bool gt = skey[lo] > skey[hi] ||
                          (skey[lo] == skey[hi] && sidx[lo] > sidx[hi]);
          if (gt == up) {
            const long long kk = skey[lo];
            skey[lo] = skey[hi];
            skey[hi] = kk;
            const int ii = sidx[lo];
            sidx[lo] = sidx[hi];
            sidx[hi] = ii;
          }
        }
        __syncthreads();
      }
    }
    // the first slot whose digit differs from the previous label's: the
    // first place value at which the two keys' leading digits differ
    for (int j = t; j < C; j += T) {
      int s = 0;
      if (j > 0) {
        s = k;
        for (int i = 0; i < k; ++i)
          if (skey[j] / q.strides[i] != skey[j - 1] / q.strides[i]) {
            s = i;
            break;
          }
      }
      sst[j] = s;
      q.stage[j] = s;
      q.order[j] = sidx[j];
    }
  } else {
    for (int j = t; j < C; j += T) sst[j] = q.stage_in[j];
  }
  __syncthreads();
  // a label group starts where the stage is below n_seg - 1 (or is 0);
  // sa: the group each row belongs to, by its first row
  const int lim = q.n_seg - 1 > 1 ? q.n_seg - 1 : 1;
  for (int j = t; j < C; j += T) sa[j] = (j == 0 || sst[j] < lim) ? j : 0;
  __syncthreads();
  block_scan<true>(sa, C, tmp);
  // heads into sidx (its order is written out): row 0, every stage 0, the
  // first group in each new span of cap rows, every cap rows in a group
  for (int j = t; j < C; j += T) {
    const bool group = j == 0 || sst[j] < lim;
    const int prev = j > 0 ? sa[j - 1] : 0;
    sidx[j] = j == 0 || sst[j] == 0 || (group && j / cap != prev / cap) ||
              (!group && (j - sa[j]) % cap == 0);
  }
  __syncthreads();
  block_scan<false>(sidx, C, tmp);
  for (int j = t; j < C; j += T)
    if (sidx[j] != (j > 0 ? sidx[j - 1] : 0)) q.runs[2 * (sidx[j] - 1)] = j;
  __syncthreads();
  const int R = sidx[C - 1];
  for (int r = t; r < R; r += T)
    q.runs[2 * r + 1] = (r + 1 < R ? q.runs[2 * (r + 1)] : C) - q.runs[2 * r];
  if (t == 0) *q.count = R;
}

}  // namespace

extern "C" int variant_kernel_max_weights() { return kMaxW; }
extern "C" int variant_kernel_max_schedule() { return kMaxSched; }

// The schedule of one launch (variant_schedule_kernel); a cudaError_t.
// Refused with cudaErrorInvalidValue: C outside [1, 8192], a cap below 1,
// neither a key nor stages.
extern "C" int variant_schedule_launch(const long long* key,
                                       const long long* strides, int k,
                                       const int* stage_in, int C, int n_seg,
                                       int cap, int* order, int* stage,
                                       int* runs, int* count, void* stream) {
  if (C < 1 || C > kMaxSched || cap < 1 || (key == nullptr && !stage_in) ||
      (key != nullptr && (k < 1 || strides == nullptr)))
    return (int)cudaErrorInvalidValue;
  int P = 1;
  while (P < C) P <<= 1;
  const size_t smem = (size_t)P * (8 + 3 * 4) + kSchedThreads * 4;
  Schedule q{key, strides, k, stage_in, C, n_seg, cap, order, stage, runs,
             count};
  return (int)launch_clustered(variant_schedule_kernel, q, 1, kSchedThreads,
                               smem, 1, stream);
}

// CTAs (csize 1) or clusters of csize CTAs the card runs at once for a
// launch of this shape (tiled: the global path's kernel); 0 when it
// cannot run at all.
extern "C" int variant_kernel_capacity(int threads, int smem, int csize,
                                       int tiled) {
  return tiled ? launch_capacity(variant_rows_kernel_tiled, threads, smem,
                                 csize)
               : launch_capacity(variant_rows_kernel, threads, smem, csize);
}

// Returns a cudaError_t: 0 on success.  Refused with cudaErrorInvalidValue:
// a width outside [0, 20], a block size that is not a power of two in
// [32, 512], a grid that is not a multiple of the cluster, a cluster
// other than 2 at n = 15 and 1 below it in shared memory, a shared-memory
// state past n = 15, more than 64 fold weights, fewer scratch slots than
// the checkpoints need; in global memory (use_smem 0): a cluster outside
// [1, 8], no scratch or no pass table, a tile outside [4, 14] bits or not
// narrower than the state, or a tile's shared memory below its planes.
// Dynamic shared memory: the state (use_smem) or tile_smem bytes (the
// tile, the fold's sums and factors, a pass's offsets), then the pool
// and the row table (when stage_tables).
extern "C" int variant_rows_launch(
    const float* prefix, const int* rows, const float* pool,
    const int* seg_start, const int* passes, const float* entries,
    const int* stage, const float* wstack, const int* wbits,
    const int* order, const int* runs, const int* count, float* scratch,
    float* out, int n, int d, int fold, int C, int n_seg, int entry_stride,
    int n_w, int n_wbits, int zmask, int csize, int use_smem, int n_slots,
    int n_rows, int pool_len, int stage_tables, int w, int n_pass,
    int tile_smem, int grid, int threads, void* stream) {
  if (n < 0 || n > kMaxQubits || threads < 32 || threads > kMaxThreads ||
      (threads & (threads - 1)) || C < 1 || grid < 1 || n_seg < 0 ||
      d < 0 || d > n || n_wbits < 0 || n_wbits > kMaxW || n_wbits > n_w ||
      n_rows < 0 || pool_len < 0)
    return (int)cudaErrorInvalidValue;
  if (csize < 1 || csize > kMaxCluster || grid % csize)
    return (int)cudaErrorInvalidValue;
  if (use_smem &&
      (n > kMaxSmemQubits || csize != (n == kMaxSmemQubits ? 2 : 1)))
    return (int)cudaErrorInvalidValue;
  if (!use_smem &&
      (passes == nullptr || n_pass < 1 || w < kMinTile || w > kMaxTile ||
       w >= n || tile_smem < (int)(2 * sizeof(float)) << w ||
       (tile_smem & 3)))
    return (int)cudaErrorInvalidValue;
  const int need = use_smem ? (n_seg > 1 ? n_seg - 1 : 0)
                             : (n_seg > 1 ? n_seg : 1);
  if (n_slots < need || (n_slots > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (use_smem ? ((size_t)2 * sizeof(float) << n) / csize
                : (size_t)tile_smem) +
      (stage_tables ? 4 * ((size_t)pool_len + kRow * (size_t)n_rows) : 0);
  Params p{prefix, rows, pool, seg_start, passes, entries, stage, wstack,
           wbits, order, runs, count, scratch, out, n, d, fold, C, n_seg,
           entry_stride, n_w, n_wbits, zmask, csize, n_slots, n_rows,
           pool_len, stage_tables, w, n_pass, tile_smem / 4};
  return (int)(use_smem ? launch_clustered(variant_rows_kernel, p, grid,
                                           threads, smem, csize, stream)
                        : launch_clustered(variant_rows_kernel_tiled, p,
                                           grid, threads, smem, csize,
                                           stream));
}

extern "C" const char* variant_kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
