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
//  * The state on chip.  A complex64 state is 8 * 2^n bytes.  Up to n = 14
//    (128 KB) one CTA holds it in shared memory.  At n = 15 (256 KB, past a
//    CTA's 227 KB) a cluster of two CTAs holds it, split on the top flat
//    bit; a gate on that bit reads and writes the partner's half through
//    distributed shared memory between two cluster barriers, every other
//    row is local.  From n = 16 to 20 the state lives in global scratch
//    (mostly L2-resident at n = 16, HBM-bound above), where one CTA
//    streams it at about 20 GB/s, bound by the latency of its loads and
//    not by HBM.  A chunk there has few runs (a 64-label chunk at n = 20
//    has 10-11), so a cluster of csize CTAs (up to 8, the wrapper's
//    choice) owns a run and shares one state: View's t and T count the
//    cluster's threads, and every step (the prefix copy, a checkpoint's
//    save or restore, each row, the epilogue) is split over all of them.
//    A cluster barrier ends each step where one CTA's barrier would: its
//    release and acquire at cluster scope order the global writes of one
//    CTA before another's reads.  Each pair update does the same
//    arithmetic whichever CTA runs it, so full rows equal csize 1's bit
//    for bit.
//  * Checkpoints that cost a pass.  Each segment's start is kept in a
//    global slice (L2-resident: 66 clusters x 128 KB a CTA a segment at
//    n = 15), written once when its segment starts and read once on
//    resume, a copy of the CTA's share of the state either way.  The
//    slices are per CTA on the shared-memory paths and per cluster on the
//    global one (the working state in slot 0, then one slot a segment),
//    so scratch shrinks with the cluster.
//    A register checkpoint of the last segment's start (32 amplitudes a
//    thread at 512 threads, as the collapse kernel keeps) made ptxas
//    spill the gate loops (128 registers, 500 bytes) and was no faster
//    on the card, so every start goes to the slice.
//  * Every row is one pass over the state and one barrier, so the
//    rewritten table cuts passes: identities go, a run of diagonal gates
//    (cz, rz, cp) is one pass, a signed permutation (x, cx) a move.  The
//    rows take most of the time and are bound by the instructions issued
//    for each amplitude, not by shared-memory bytes or barriers: through
//    View's generic pointers a pair update pays 64-bit addresses and a
//    split test, so a row that does not cross the split runs the local
//    loops (apply_row<true>: 32-bit shared-memory addressing on
//    smem_state).  Several rows a pass (a group of 8 amplitudes in
//    registers across the rows on its 3 bits) halved sup-20's passes but
//    not its time, and slowed hwe-16, so it is not kept.  The row table
//    and the coefficient pool sit in shared memory, where they fit beside
//    the state, and each label's entry row too.
//  * State copies (the prefix at a run's start, a checkpoint's save and
//    restore) issue a batch of 16-byte loads before their stores.
//  * The epilogues.  Fold: out[k] = sum_h w(h) sign(h) |psi[h << d | k]|^2;
//    the factor w(h) sign(h) is tabulated once a label (up to 1024 h).
//    The split bit n - 1 is never a kept bit when d < n, so each CTA of a
//    cluster sums its own share of the h range (a 1/csize slice) and the
//    partials are added in rank order through distributed shared memory,
//    each CTA writing a 1/csize share of the outputs.  Full rows: each
//    CTA writes its own share of the row.
//  * Sums in a fixed order (per-thread partial in double, a shared-memory
//    tree, the CTAs in rank order), no float atomics: a launch repeats bit
//    for bit.  f32 state, IEEE arithmetic (no fast-math), no tensor cores,
//    so no TF32.
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

struct Params {
  const float* prefix;     // [2, N]
  const int* rows;         // [n_rows, 6] rewritten op table
  const float* pool;       // fixed coefficients, diagonal runs
  const int* seg_start;    // [n_seg + 1] first row of each segment
  const float* entries;    // [C, entry_stride] per-label slot coefficients
  const int* stage;        // [C] first segment to replay
  const float* wstack;     // [C, n_w, 2] fold weights (w0, w1)
  const int* wbits;        // [n_wbits] flat bit per weight, -1 = scalar w0
  const int* order;        // [C] sorted position -> row of entries, wstack
                           //   and out (null: the same row)
  const int* runs;         // [C, 2]: first label, length
  const int* count;        // [1]: runs in the table
  float* scratch;          // [owners, n_slots, 2, L] checkpoints: a CTA's
                           //   (use_smem) or a cluster's
  float* out;              // [C, 2^d] (fold) or [C, N] (full rows)
  int n, d, fold, C, n_seg, entry_stride, n_w, n_wbits, zmask;
  int csize;               // CTAs a state is split over: 1, 2 at n = 15
                           //   (use_smem), up to 8 in global memory
  int use_smem;            // state in shared memory (n <= 15)
  int n_slots;             // global [2, L] slots a CTA owns
  int n_rows, pool_len;    // staged in shared memory after the state when
  int stage_tables;        //   stage_tables (they fit)
};

// The global slot of segment i's start (i >= 1): slot i - 1 on the
// shared-memory paths, slot i on the global path, after the working state
// in slot 0.
__device__ __forceinline__ int slot_of(const Params& p, int i) {
  return p.use_smem ? i - 1 : i;
}

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

__device__ void epilogue_rows(const Params& p, const View& v, float* orow) {
  const float* st = v.own;
  const int L = v.L, top = v.split >= 0 ? v.rank << v.split : 0;
  for (int x = v.t; x < L; x += v.T)
    orow[top + x] = st[x] * st[x] + st[L + x] * st[L + x];
}

// The barrier that ends a step on the state: the cluster's where its CTAs
// share a global state (wide), else the CTA's.
__device__ __forceinline__ void state_sync(bool wide) {
  if (wide)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// 512 threads and one CTA an SM: 128 registers a thread for the
// interpreter (a dense 2q gate holds its 32 coefficients).
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
  // a cluster on the global path shares one state, split over its threads
  const bool wide = !p.use_smem && p.csize > 1;
  int cluster_id = blockIdx.x, n_clusters = gridDim.x;
  View v;
  v.rank = 0;
  if (p.csize > 1) {
    v.rank = (int)cg::this_cluster().block_rank();
    cluster_id = blockIdx.x / p.csize;
    n_clusters = gridDim.x / p.csize;
  }
  v.L = wide ? N : N / p.csize;
  v.t = wide ? v.rank * T + t : t;
  v.T = wide ? p.csize * T : T;
  v.split = p.use_smem && p.csize == 2 ? p.n - 1 : -1;
  const int L = v.L;
  // the checkpoint slots: a cluster's on the global path, else a CTA's
  const size_t owner = wide ? cluster_id : blockIdx.x;
  float* slots = p.n_slots ? p.scratch + owner * p.n_slots * 2 * L : nullptr;
  if (v.split >= 0) {
    cg::cluster_group cluster = cg::this_cluster();
    v.base[0] = cluster.map_shared_rank(smem_state, 0);
    v.base[1] = cluster.map_shared_rank(smem_state, 1);
    v.own = smem_state;
  } else {
    v.base[0] = v.base[1] = p.use_smem ? smem_state : slots;
    v.own = v.base[0];
  }
  float* st = v.own;
  const int top = v.split >= 0 ? v.rank << v.split : 0;
  for (int i = t; i < p.n_wbits; i += T) s_wb[i] = p.wbits[i];
  // the tables every row reads: on chip where they fit
  const int* rows = p.rows;
  const float* pool = p.pool;
  if (p.stage_tables) {
    float* tab = smem_state + (p.use_smem ? 2 * L : 0);
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
          copy_planes(st, p.prefix + top, p.prefix + N + top, L, v.t, v.T);
        } else {
          const float* src = slots + (size_t)slot_of(p, s) * 2 * L;
          copy_planes(st, src, src + L, L, v.t, v.T);
        }
        state_sync(wide);
        for (int i = s; i < p.n_seg; ++i) {
          if (i > s) {
            // segment i starts: keep its state for the labels after
            float* dst = slots + (size_t)slot_of(p, i) * 2 * L;
            copy_planes(dst, st, st + L, L, v.t, v.T);
            state_sync(wide);  // saved before the next row rewrites it
          }
          for (int o = p.seg_start[i]; o < p.seg_start[i + 1]; ++o) {
            if (p.use_smem)  // the local loops address smem_state directly
              apply_row<true>(v, rows + kRow * o, pool, erow, smem_state);
            else if (wide)
              apply_row<false, true>(v, rows + kRow * o, pool, erow);
            else
              apply_row(v, rows + kRow * o, pool, erow);
          }
        }
      }
      if (p.fold) {
        const float* ws = p.wstack + (size_t)row * p.n_w * 2;
        for (int i = t; i < 2 * p.n_wbits; i += T) s_ws[i] = ws[i];
        __syncthreads();
        epilogue_fold(p, v, s_ws, s_wb, p.out + ((size_t)row << p.d), red,
                      s_fac);
      } else {
        epilogue_rows(p, v, p.out + (size_t)row * N);
        state_sync(wide);  // read before the next label rewrites the state
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
// launch of this shape; 0 when it cannot run at all.
extern "C" int variant_kernel_capacity(int threads, int smem, int csize) {
  return launch_capacity(variant_rows_kernel, threads, smem, csize);
}

// Returns a cudaError_t: 0 on success.  Refused with cudaErrorInvalidValue:
// a width outside [0, 20], a block size that is not a power of two in
// [32, 512], a grid that is not a multiple of the cluster, a cluster
// outside [1, 8] in global memory or other than 2 at n = 15 and 1 below
// it in shared memory, a shared-memory state past n = 15, a global one
// without scratch, more than 64 fold weights, or fewer scratch slots than
// the checkpoints need.  Dynamic shared memory: the state
// (when use_smem), then the pool and the row table (when stage_tables).
extern "C" int variant_rows_launch(
    const float* prefix, const int* rows, const float* pool,
    const int* seg_start, const float* entries, const int* stage,
    const float* wstack, const int* wbits, const int* order, const int* runs,
    const int* count, float* scratch, float* out, int n, int d, int fold,
    int C, int n_seg, int entry_stride, int n_w, int n_wbits, int zmask,
    int csize, int use_smem, int n_slots, int n_rows, int pool_len,
    int stage_tables, int grid, int threads, void* stream) {
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
  const int need = use_smem ? (n_seg > 1 ? n_seg - 1 : 0)
                             : (n_seg > 1 ? n_seg : 1);
  if (n_slots < need || (n_slots > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (use_smem ? ((size_t)2 * sizeof(float) << n) / csize : 0) +
      (stage_tables ? 4 * ((size_t)pool_len + kRow * (size_t)n_rows) : 0);
  Params p{prefix, rows, pool, seg_start, entries, stage, wstack, wbits,
           order, runs, count, scratch, out, n, d, fold, C, n_seg,
           entry_stride, n_w, n_wbits, zmask, csize, use_smem, n_slots,
           n_rows, pool_len, stage_tables};
  return (int)launch_clustered(variant_rows_kernel, p, grid, threads, smem,
                               csize, stream);
}

extern "C" const char* variant_kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
