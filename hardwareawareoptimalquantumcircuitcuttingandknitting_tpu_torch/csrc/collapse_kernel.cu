// Collapse-mode whole-variant kernel for the sampled engine.
//
// Replaces the JAX package's ops/pallas_variant.py::_build_call_collapse
// (the pl.pallas_call at :1165), reached through make_collapse_chunk_kernel
// :1183.  For each sampled QPD label of a block it starts from the shared
// prefix state and runs the suffix in order: fixed gates, slot gates with
// the label's own entries, and collapse sites.  A collapse site on flat bit
// j measures that qubit in the simulation: tot = sum |psi|^2, p1 = sum
// |psi|^2 [bit j = 1], p0 = tot - p1, the branch b = (u * tot >= p0) from the
// label's uniform draw u, the other half zeroed, the rest scaled by
// sqrt(tot / max(p_b, 1e-30)), and the label's weight multiplied by
// w0 + b (w1 - w0).  A site whose mflag <= 0 (the label's variant does not
// measure there) leaves state and weight alone.  The epilogue writes
// |psi|^2 * weight as full rows [2^n], or summed onto the kept bits (the
// marginal, <= 128 outcomes), or as n_z signed parity sums plus the plain
// total.  The picked bits come back too ([C, n_sites], -1 where mflag <= 0)
// so a caller can tell a flipped branch from a rounding difference.
//
// One generic interpreter over the op table rewritten by ops/op_rewrite.py
// (rows kind, ja, jb, a0, a1, a2: dense gates from the pool or the label's
// entry row, diagonal runs, signed permutations, and each collapse site as
// two rows, SITE_A = its slot's pre gate and the Born sums, SITE_B = the
// projection, rescale and post gate): a single nvcc build serves every
// circuit.  Plain C interface, loaded with ctypes.
//
// Design, and what bounds it on an H100:
//  * Replica runs.  The sampled engine repeats a measuring label once per
//    sample, side by side; the replicas differ only in their draws u.  The
//    wrapper cuts the block into runs (adjacent rows with equal entries and
//    site scalars but u; at most 64 rows, fewer when that leaves too few
//    runs to fill the card) on the device, and a block, or a cluster, owns
//    a run: it runs the chain once up to the SITE_B row of the run's first
//    measuring site (the Born sums there are the same for every replica),
//    keeps that state as a checkpoint, and runs only the rest per replica,
//    restoring the checkpoint each time.  A run that measures nowhere here
//    is computed once and its row written for every replica.  Runs are
//    handed out largest first, with a grid stride; rows that are not
//    grouped give runs of one.
//  * The state on chip.  A complex64 state is 8 * 2^n bytes.  Up to n = 14
//    (128 KB) one CTA holds it in shared memory.  At n = 15 (256 KB, past a
//    CTA's 227 KB) a cluster of two CTAs holds it, split on the top flat
//    bit: rank r owns the amplitudes whose bit n-1 is r.  A gate on a lower
//    bit, a diagonal run and the parts of the Born sums are local; a gate
//    on the split bit reads and writes the partner's half through
//    distributed shared memory, between two cluster barriers.  The sums are
//    reduced in each CTA and then added in rank order, so both CTAs hold
//    the identical tot, p1 and branch.  In these two cases the checkpoint
//    sits in registers (at most 32 amplitudes a thread at 512 threads) and
//    nothing is allocated in device memory.  From n = 16 to 20 the state
//    and the checkpoint live in a per-CTA slice of a global scratch.
//  * Fewer passes.  Every row is a pass over the state with a barrier, and
//    the rewrite cuts rows: identities go, a run of diagonal gates (qft's
//    cp ladders) is one pass, a site with its slot gates is two passes
//    when the label measures there and one (the composed post * pre gate)
//    when it does not.
//  * Sums in a fixed order (per-thread strided partial, warp shuffle tree,
//    the warp partials in order, the CTAs in rank order), no float atomics:
//    a launch repeats bit for bit and a pick does not depend on scheduling.
//  * A CTA gives a thread 8 amplitudes of its share (32 at n = 14 and 15),
//    so narrow fragments (n = 1 has two amplitudes) get small blocks (32
//    threads) and many of them per SM.
//  * f32 throughout, IEEE sqrt and division (no fast-math), no tensor
//    cores, so no TF32.
//
// Layout: planar [2, 2^n] (re then im); flat bit j of the amplitude index
// is the kernel's qubit j (the host puts active qubit i on bit n-1-i).
// Gate index m = 2*bit(ja)+bit(jb).  Offsets across labels are 64-bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxQubits = 20;
constexpr int kMaxSmemQubits = 15;   // 15: two CTAs of 128 KB
constexpr int kMaxEpi = 128;         // outcomes of the marginal, z columns
constexpr int kCk = 32;              // checkpoint amplitudes a thread
constexpr int kRow = 6;
constexpr int kDiagFloats = 10;

enum OpKind {
  kGate1 = 1, kGate2 = 2, kDiag = 3, kPerm1 = 4, kPerm2 = 5,
  kSiteA = 6, kSiteB = 7
};

struct Params {
  const float* prefix;     // [2, N]
  const int* rows;         // [n_rows, 6] rewritten op table
  const float* pool;       // fixed coefficients, diagonal runs
  const float* entries;    // [C, entry_stride] per-label slot coefficients
  const float* cscal;      // [C, n_sites, 4]: u, mflag, w0, w1
  const int* epi;          // marginal: kept flat bits [r] then the other
                           //   bits [n - r], ascending; z: masks [n_epi]
  const int* runs;         // [C, 3]: first row, length, resume row
  const int* count;        // [1]: runs in the table (R <= C)
  float* scratch;          // [grid, 4, N] state and checkpoint (n > 15)
  float* out;              // [C, out_width]
  int* bits;               // [C, n_sites] picked branches
  int n, n_rows, C, entry_stride, n_sites;
  int mode;                // 0 full rows, 1 marginal, 2 z columns
  int n_epi;               // marginal: r kept bits; z: number of masks
  int csize;               // CTAs a state is split over: 1 or 2
  int use_smem;
};

__device__ __forceinline__ int insert_zero(int p, int j) {
  return ((p >> j) << (j + 1)) | (p & ((1 << j) - 1));
}

__device__ __forceinline__ int insert_bit(int p, int j, int v) {
  return insert_zero(p, j) | (v << j);
}

// Where one op's amplitudes live: local (one CTA or the split is not
// touched) or across the cluster's two halves.  base[r] is rank r's plane
// pair (re at base[r][x], im at base[r][L + x]).
struct View {
  float* base[2];
  float* own;  // this CTA's planes (base[rank])
  int L;      // amplitudes a CTA holds
  int rank;   // this CTA's rank (its half's top bit)
  int split;  // the split bit (n - 1), or -1 for one CTA
  int t, T;   // this thread's index in the cluster's work, their count
};

// 2x2 complex matrix (re[4] then im[4]) applied to the pair (a, b).
__device__ __forceinline__ void mat2(const float* c, float& ar, float& ai,
                                     float& br, float& bi) {
  const float nar = c[0] * ar - c[4] * ai + c[1] * br - c[5] * bi;
  const float nai = c[0] * ai + c[4] * ar + c[1] * bi + c[5] * br;
  const float nbr = c[2] * ar - c[6] * ai + c[3] * br - c[7] * bi;
  const float nbi = c[2] * ai + c[6] * ar + c[3] * bi + c[7] * br;
  ar = nar;
  ai = nai;
  br = nbr;
  bi = nbi;
}

__device__ __forceinline__ void rotate(float& re, float& im, int ph) {
  const float r = re, i = im;
  if (ph == 1) {
    re = -i;
    im = r;
  } else if (ph == 2) {
    re = -r;
    im = -i;
  } else if (ph == 3) {
    re = i;
    im = -r;
  }
}

__device__ __forceinline__ float pick4(float x0, float x1, float x2, float x3,
                                       int c) {
  return c == 0 ? x0 : (c == 1 ? x1 : (c == 2 ? x2 : x3));
}

// Addresses of a pair on bit j: amplitude p of the pairs, its two members
// (v = 0, 1) as (plane pointer, offset).
struct Pair {
  float* pa;
  float* pb;
  int xa, xb;
};

__device__ __forceinline__ Pair pair_at(const View& v, int j, int p) {
  Pair q;
  if (j == v.split) {
    q.pa = v.base[0];
    q.pb = v.base[1];
    q.xa = q.xb = p;
  } else {
    q.pa = q.pb = v.own;
    q.xa = insert_zero(p, j);
    q.xb = q.xa | (1 << j);
  }
  return q;
}

// Pairs on bit j this thread handles: local ones over the CTA, split ones
// over the cluster (each CTA takes half of them).
__device__ __forceinline__ void pair_range(const View& v, int j, int& p0,
                                           int& p1, int& step) {
  if (j == v.split) {
    const int h = v.L >> 1;
    p0 = v.rank * h + v.t;
    p1 = (v.rank + 1) * h;
  } else {
    p0 = v.t;
    p1 = v.L >> 1;
  }
  step = v.T;
}

// A 1q gate (re[4], im[4]; null: none) on bit j; with sums: tot and p1
// of the result.  The coefficients are read once, into registers (the
// state's stores could alias them).
__device__ void apply_1q(const View& v, int j, const float* c, bool sums,
                         float& tot, float& p1) {
  int p0, pe, step;
  pair_range(v, j, p0, pe, step);
  const int L = v.L;
  float cr[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) cr[i] = c != nullptr ? c[i] : 0.f;
  for (int p = p0; p < pe; p += step) {
    const Pair q = pair_at(v, j, p);
    float ar = q.pa[q.xa], ai = q.pa[L + q.xa];
    float br = q.pb[q.xb], bi = q.pb[L + q.xb];
    if (c != nullptr) mat2(cr, ar, ai, br, bi);
    q.pa[q.xa] = ar;
    q.pa[L + q.xa] = ai;
    q.pb[q.xb] = br;
    q.pb[L + q.xb] = bi;
    if (sums) {
      const float sb = br * br + bi * bi;
      tot += ar * ar + ai * ai + sb;
      p1 += sb;
    }
  }
}

// The four members of a quad on bits (ja, jb), in gate-index order.
__device__ __forceinline__ void quad_at(const View& v, int ja, int jb, int p,
                                        float** pl, int* x) {
  const int ma = 1 << ja, mb = 1 << jb;
  if (ja == v.split || jb == v.split) {
    const int o = ja == v.split ? jb : ja;
    const int xl = insert_zero(p, o), xh = xl | (1 << o);
    if (ja == v.split) {  // ja the gate-index MSB
      pl[0] = pl[1] = v.base[0];
      pl[2] = pl[3] = v.base[1];
      x[0] = x[2] = xl;
      x[1] = x[3] = xh;
    } else {
      pl[0] = pl[2] = v.base[0];
      pl[1] = pl[3] = v.base[1];
      x[0] = x[1] = xl;
      x[2] = x[3] = xh;
    }
    return;
  }
  const int lo = min(ja, jb), hi = max(ja, jb);
  const int base = insert_zero(insert_zero(p, lo), hi);
  pl[0] = pl[1] = pl[2] = pl[3] = v.own;
  x[0] = base;
  x[1] = base | mb;
  x[2] = base | ma;
  x[3] = base | ma | mb;
}

__device__ __forceinline__ void quad_range(const View& v, int ja, int jb,
                                           int& p0, int& p1, int& step) {
  if (ja == v.split || jb == v.split) {
    const int h = v.L >> 2;  // of the L / 2 quads, each CTA takes half
    p0 = v.rank * h + v.t;
    p1 = (v.rank + 1) * h;
  } else {
    p0 = v.t;
    p1 = v.L >> 2;
  }
  step = v.T;
}

// A 2q gate: dense (c = re[16], im[16], read once into registers) or a
// signed permutation (code).
__device__ void apply_2q(const View& v, int ja, int jb, const float* c,
                         int code, bool perm) {
  int p0, pe, step;
  quad_range(v, ja, jb, p0, pe, step);
  const int L = v.L;
  float u[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) u[i] = perm ? 0.f : c[i];
  for (int p = p0; p < pe; p += step) {
    float* pl[4];
    int x[4];
    quad_at(v, ja, jb, p, pl, x);
    const float x0r = pl[0][x[0]], x1r = pl[1][x[1]], x2r = pl[2][x[2]],
                x3r = pl[3][x[3]];
    const float x0i = pl[0][L + x[0]], x1i = pl[1][L + x[1]],
                x2i = pl[2][L + x[2]], x3i = pl[3][L + x[3]];
    float yr[4], yi[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (perm) {
        const int s = (code >> (4 * r)) & 3;
        yr[r] = pick4(x0r, x1r, x2r, x3r, s);
        yi[r] = pick4(x0i, x1i, x2i, x3i, s);
        rotate(yr[r], yi[r], (code >> (4 * r + 2)) & 3);
      } else {
        const float* ur = u + 4 * r;
        const float* ui = u + 16 + 4 * r;
        yr[r] = ur[0] * x0r - ui[0] * x0i + ur[1] * x1r - ui[1] * x1i +
                ur[2] * x2r - ui[2] * x2i + ur[3] * x3r - ui[3] * x3i;
        yi[r] = ur[0] * x0i + ui[0] * x0r + ur[1] * x1i + ui[1] * x1r +
                ur[2] * x2i + ui[2] * x2r + ur[3] * x3i + ui[3] * x3r;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pl[r][x[r]] = yr[r];
      pl[r][L + x[r]] = yi[r];
    }
  }
}

__device__ void apply_perm1(const View& v, int j, int code) {
  int p0, pe, step;
  pair_range(v, j, p0, pe, step);
  const int L = v.L;
  for (int p = p0; p < pe; p += step) {
    const Pair q = pair_at(v, j, p);
    const float ar = q.pa[q.xa], ai = q.pa[L + q.xa];
    const float br = q.pb[q.xb], bi = q.pb[L + q.xb];
    float y0r = (code & 3) ? br : ar, y0i = (code & 3) ? bi : ai;
    float y1r = ((code >> 4) & 3) ? br : ar;
    float y1i = ((code >> 4) & 3) ? bi : ai;
    rotate(y0r, y0i, (code >> 2) & 3);
    rotate(y1r, y1i, (code >> 6) & 3);
    q.pa[q.xa] = y0r;
    q.pa[L + q.xa] = y0i;
    q.pb[q.xb] = y1r;
    q.pb[L + q.xb] = y1i;
  }
}

// A run of diagonal gates: per amplitude the product of the entries its
// bits select, in the run's order.  Always local.  A thread takes its
// amplitudes kDiagChunk at a time, so each gate's entries are read once
// per chunk, not once per amplitude.
constexpr int kDiagChunk = 8;

__device__ void apply_diag(const View& v, const float* el, int count) {
  float* st = v.own;
  const int L = v.L, T = v.T, top = v.split >= 0 ? v.rank << v.split : 0;
  for (int x0 = v.t; x0 < L; x0 += T * kDiagChunk) {
    float pr[kDiagChunk], pi[kDiagChunk];
#pragma unroll
    for (int k = 0; k < kDiagChunk; ++k) {
      pr[k] = 1.f;
      pi[k] = 0.f;
    }
    for (int e = 0; e < count; ++e) {
      const float* d = el + kDiagFloats * e;
      const int ja = (int)d[0], jb = (int)d[1];
      const float e0r = d[2], e0i = d[3], e1r = d[4], e1i = d[5];
      const float e2r = d[6], e2i = d[7], e3r = d[8], e3i = d[9];
#pragma unroll
      for (int k = 0; k < kDiagChunk; ++k) {
        const int f = top | (x0 + k * T);
        const int m = 2 * ((f >> ja) & 1) + ((f >> jb) & 1);
        const float er = pick4(e0r, e1r, e2r, e3r, m);
        const float ei = pick4(e0i, e1i, e2i, e3i, m);
        const float nr = pr[k] * er - pi[k] * ei;
        pi[k] = pr[k] * ei + pi[k] * er;
        pr[k] = nr;
      }
    }
#pragma unroll
    for (int k = 0; k < kDiagChunk; ++k) {
      const int x = x0 + k * T;
      if (x < L) {
        const float re = st[x], im = st[L + x];
        st[x] = re * pr[k] - im * pi[k];
        st[L + x] = re * pi[k] + im * pr[k];
      }
    }
  }
}

// SITE_B on bit j with branch B: the kept half scaled, the post gate (or
// the plain projection) on each pair.
__device__ void project(const View& v, int j, int B, float scale,
                        const float* post) {
  int p0, pe, step;
  pair_range(v, j, p0, pe, step);
  const int L = v.L;
  const float c0r = post ? post[B] : (B ? 0.f : 1.f);
  const float c0i = post ? post[4 + B] : 0.f;
  const float c1r = post ? post[2 + B] : (B ? 1.f : 0.f);
  const float c1i = post ? post[6 + B] : 0.f;
  for (int p = p0; p < pe; p += step) {
    const Pair q = pair_at(v, j, p);
    float vr, vi;
    if (B) {
      vr = scale * q.pb[q.xb];
      vi = scale * q.pb[L + q.xb];
    } else {
      vr = scale * q.pa[q.xa];
      vi = scale * q.pa[L + q.xa];
    }
    q.pa[q.xa] = c0r * vr - c0i * vi;
    q.pa[L + q.xa] = c0r * vi + c0i * vr;
    q.pb[q.xb] = c1r * vr - c1i * vi;
    q.pb[L + q.xb] = c1r * vi + c1i * vr;
  }
}

// CTA-wide sums of two values in a fixed order; every thread returns the
// same pair.  red holds 64 floats.  All threads of the CTA must call it.
__device__ float2 block_sum2(float a, float b, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  __syncthreads();  // the previous call's readers are done with red
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  float sa = 0.f, sb = 0.f;
  for (int w = 0; w < n_warps; ++w) {
    sa += red[w];
    sb += red[32 + w];
  }
  return make_float2(sa, sb);
}

// Cluster-wide sums: each CTA's, then the CTAs' in rank order, so every
// thread of both CTAs holds the same bits.
__device__ float2 cluster_sum2(float a, float b, float* red, float* xch,
                               int csize) {
  const float2 s = block_sum2(a, b, red);
  if (csize == 1) return s;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) {
    xch[0] = s.x;
    xch[1] = s.y;
  }
  cluster.sync();
  const float* x0 = cluster.map_shared_rank(xch, 0);
  const float* x1 = cluster.map_shared_rank(xch, 1);
  const float2 r = make_float2(x0[0] + x1[0], x0[1] + x1[1]);
  cluster.sync();  // the partner has read xch
  return r;
}

__device__ __forceinline__ int deposit(int v, const int* pos, int count) {
  int f = 0;
  for (int i = 0; i < count; ++i) f |= ((v >> i) & 1) << pos[i];
  return f;
}

// Barrier after a row: the CTA's, or the cluster's around a row that
// crosses the split.
__device__ __forceinline__ void row_barrier(bool cross) {
  if (cross)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

__device__ __forceinline__ bool touches_split(int kind, int ja, int jb,
                                              int split) {
  if (split < 0 || kind == kDiag) return false;
  if (ja == split) return true;
  return (kind == kGate2 || kind == kPerm2) && jb == split;
}

// |psi|^2 * weight of this CTA's amplitudes onto one label's output row.
// Every CTA of the cluster calls it.
__device__ void epilogue(const Params& p, const View& v, const int* s_epi,
                         float weight, long long lab, int copies,
                         float* tree, float* part, float* red, float* xch) {
  const int N = 1 << p.n, L = v.L, T = v.T, t = v.t;
  const float* st = v.own;
  const int top = v.split >= 0 ? v.rank << v.split : 0;
  if (p.mode == 0) {
    for (int c = 0; c < copies; ++c) {
      float* orow = p.out + (size_t)(lab + c) * N + top;
      for (int x = t; x < L; x += T)
        orow[x] = (st[x] * st[x] + st[L + x] * st[L + x]) * weight;
    }
    return;
  }
  if (p.mode == 1) {
    const int r = p.n_epi, K = 1 << r;
    const int* kept = s_epi;
    const int* rest = s_epi + r;
    // the split bit among the kept bits (this CTA owns those outcomes) or
    // among the others (each CTA sums half of them)
    int in_kept = -1, in_rest = -1;
    if (v.split >= 0) {
      for (int i = 0; i < r; ++i)
        if (kept[i] == v.split) in_kept = i;
      for (int i = 0; i < p.n - r; ++i)
        if (rest[i] == v.split) in_rest = i;
    }
    const int Kc = in_kept >= 0 ? K >> 1 : K;
    const int Hc = in_rest >= 0 ? (N >> r) >> 1 : N >> r;
    const int G = T >= Kc ? T / Kc : 1;
    for (int kk0 = 0; kk0 < Kc; kk0 += T / G) {
      const int kk = kk0 + t % (T / G), g = t / (T / G);
      double acc = 0.0;  // up to 2^20 / 512 terms a thread
      const int k = in_kept >= 0 ? insert_bit(kk, in_kept, v.rank) : kk;
      if (kk < Kc) {
        const int fk = deposit(k, kept, r);
        for (int hh = g; hh < Hc; hh += G) {
          const int h = in_rest >= 0 ? insert_bit(hh, in_rest, v.rank) : hh;
          const int x = (fk | deposit(h, rest, p.n - r)) & (L - 1);
          acc += st[x] * st[x] + st[L + x] * st[L + x];
        }
      }
      tree[t] = (float)acc;
      __syncthreads();
      for (int s = G >> 1; s > 0; s >>= 1) {
        if (g < s) tree[t] += tree[t + s * (T / G)];
        __syncthreads();
      }
      if (g == 0 && kk < Kc) part[k] = tree[t];
      __syncthreads();
    }
    float* other = part;
    if (in_rest >= 0) {
      cg::this_cluster().sync();
      other = cg::this_cluster().map_shared_rank(part, 1);
    }
    for (int k = t; k < K; k += T) {
      const bool mine =
          in_kept >= 0 ? ((k >> in_kept) & 1) == v.rank : v.rank == 0;
      if (!mine) continue;
      const float val = in_rest >= 0 ? part[k] + other[k] : part[k];
      for (int c = 0; c < copies; ++c)
        p.out[((size_t)(lab + c) << r) + k] = val * weight;
    }
    if (in_rest >= 0) cg::this_cluster().sync();  // the partner has read
    return;
  }
  // z columns: column zi sums |psi|^2 signed by the parity of mask zi's
  // bits; the last column is the plain total
  for (int zi = 0; zi <= p.n_epi; ++zi) {
    const int mask = zi < p.n_epi ? s_epi[zi] : 0;
    double acc = 0.0;  // up to 2^20 / 512 terms a thread
    for (int x = t; x < L; x += T) {
      const float s = st[x] * st[x] + st[L + x] * st[L + x];
      acc += (__popc((top | x) & mask) & 1) ? -s : s;
    }
    const float2 sums = block_sum2((float)acc, 0.f, red);
    if (t == 0) part[zi] = sums.x;
  }
  __syncthreads();
  float* other = part;
  if (v.split >= 0) {
    cg::this_cluster().sync();
    other = cg::this_cluster().map_shared_rank(part, 1);
  }
  if (v.rank == 0) {
    for (int zi = t; zi <= p.n_epi; zi += T) {
      const float val = v.split >= 0 ? part[zi] + other[zi] : part[zi];
      for (int c = 0; c < copies; ++c)
        p.out[(size_t)(lab + c) * (p.n_epi + 1) + zi] = val * weight;
    }
  }
  if (v.split >= 0) cg::this_cluster().sync();
  __syncthreads();
}

// One CTA of 512 threads an SM may use 128 registers a thread: room for
// the register checkpoint beside the interpreter.
__global__ void __launch_bounds__(kMaxThreads, 1)
collapse_rows_kernel(Params p) {
  extern __shared__ float smem_state[];
  __shared__ float red[64];
  __shared__ float xch[2];
  __shared__ float tree[kMaxThreads];
  __shared__ float part[kMaxEpi];
  __shared__ int s_epi[kMaxEpi];

  const int N = 1 << p.n;
  const int T = blockDim.x, t = threadIdx.x;
  View v;
  v.L = N / p.csize;
  v.T = T;
  v.t = t;
  v.split = p.csize == 2 ? p.n - 1 : -1;
  int cluster_id = blockIdx.x, n_clusters = gridDim.x;
  float* ckg = nullptr;  // global checkpoint (n > 15)
  if (p.csize == 2) {
    cg::cluster_group cluster = cg::this_cluster();
    v.rank = (int)cluster.block_rank();
    v.base[0] = cluster.map_shared_rank(smem_state, 0);
    v.base[1] = cluster.map_shared_rank(smem_state, 1);
    v.own = smem_state;
    cluster_id = blockIdx.x / 2;
    n_clusters = gridDim.x / 2;
  } else {
    v.rank = 0;
    v.base[0] = v.base[1] =
        p.use_smem ? smem_state : p.scratch + (size_t)blockIdx.x * 4 * N;
    if (!p.use_smem) ckg = v.base[0] + 2 * N;
    v.own = v.base[0];
  }
  float* st = v.own;
  const int L = v.L, top = v.split >= 0 ? v.rank << v.split : 0;
  const int n_tab = p.mode == 1 ? p.n : (p.mode == 2 ? p.n_epi : 0);
  for (int i = t; i < n_tab; i += T) s_epi[i] = p.epi[i];
  if (p.csize == 2) cg::this_cluster().sync();  // both CTAs have started
  __syncthreads();

  float ck[2 * kCk];  // register checkpoint (shared-memory states)
  float ck_tot = 0.f, ck_p1 = 0.f;  // and the Born sums it resumes with

  const int R = *p.count;
  for (int ri = cluster_id; ri < R; ri += n_clusters) {
    const long long start = p.runs[3 * ri];
    const int len = p.runs[3 * ri + 1];
    const int resume = p.runs[3 * ri + 2];  // n_rows: no measuring site

    for (int x = t; x < L; x += T) {
      st[x] = p.prefix[top + x];
      st[L + x] = p.prefix[N + top + x];
    }
    __syncthreads();

    float tot = 0.f, p1 = 0.f;  // the last SITE_A's sums
    for (int rep = 0; rep < (resume < p.n_rows ? len : 1); ++rep) {
      const long long lab = start + rep;
      const float* erow = p.entries + (size_t)lab * p.entry_stride;
      const float* srow = p.cscal + (size_t)lab * p.n_sites * 4;
      float weight = 1.f;
      int o0 = 0;
      if (rep == 0) {
        o0 = 0;
      } else {
        // the checkpoint: the state after the shared rows
        if (p.use_smem) {
#pragma unroll
          for (int i = 0; i < kCk; ++i) {
            const int x = t + i * T;
            if (x < L) {
              st[x] = ck[2 * i];
              st[L + x] = ck[2 * i + 1];
            }
          }
        } else {
          for (int x = t; x < 2 * N; x += T) st[x] = ckg[x];
        }
        __syncthreads();
        tot = ck_tot;
        p1 = ck_p1;
        o0 = resume;
      }
      for (int o = o0; o < p.n_rows; ++o) {
        if (rep == 0 && o == resume && len > 1) {
          // the rows before are the run's own: keep their state
          ck_tot = tot;
          ck_p1 = p1;
          if (p.use_smem) {
#pragma unroll
            for (int i = 0; i < kCk; ++i) {
              const int x = t + i * T;
              if (x < L) {
                ck[2 * i] = st[x];
                ck[2 * i + 1] = st[L + x];
              }
            }
          } else {
            for (int x = t; x < 2 * N; x += T) ckg[x] = st[x];
          }
          __syncthreads();  // saved before the next row rewrites it
        }
        const int* row = p.rows + kRow * o;
        const int kind = row[0], ja = row[1], jb = row[2], a0 = row[3];
        const bool cross = touches_split(kind, ja, jb, v.split);
        if (kind == kSiteA || kind == kSiteB) {
          const float mflag = srow[4 * jb + 1];
          const float* pre = row[3] >= 0 ? erow + row[3] : nullptr;
          const float* post = row[4] >= 0 ? erow + row[4] : nullptr;
          const bool xs = ja == v.split;
          if (kind == kSiteA) {
            if (mflag > 0.f) {
              if (xs) cg::this_cluster().sync();
              float a = 0.f, b = 0.f;
              apply_1q(v, ja, pre, true, a, b);
              const float2 s = cluster_sum2(a, b, red, xch, p.csize);
              tot = s.x;
              p1 = s.y;
            } else if (pre != nullptr || post != nullptr) {
              // not measured here: the composed post * pre in one pass
              float c[8];
              if (pre != nullptr && post != nullptr) {
#pragma unroll
                for (int r = 0; r < 2; ++r)
#pragma unroll
                  for (int q = 0; q < 2; ++q) {
                    float sr = 0.f, si = 0.f;
#pragma unroll
                    for (int k = 0; k < 2; ++k) {
                      const float ar = post[2 * r + k], ai = post[4 + 2 * r + k];
                      const float br = pre[2 * k + q], bi = pre[4 + 2 * k + q];
                      sr += ar * br - ai * bi;
                      si += ar * bi + ai * br;
                    }
                    c[2 * r + q] = sr;
                    c[4 + 2 * r + q] = si;
                  }
              } else {
                const float* one = pre != nullptr ? pre : post;
#pragma unroll
                for (int i = 0; i < 8; ++i) c[i] = one[i];
              }
              if (xs) cg::this_cluster().sync();
              float a = 0.f, b = 0.f;
              apply_1q(v, ja, c, false, a, b);
              row_barrier(xs);
            }
            continue;
          }
          // SITE_B
          if (!(mflag > 0.f)) continue;
          const float u = srow[4 * jb];
          const float w0 = srow[4 * jb + 2], w1 = srow[4 * jb + 3];
          const float p0 = tot - p1;
          const int B = (u * tot >= p0) ? 1 : 0;
          const float bf = (float)B;
          const float pb = p0 + bf * (p1 - p0);
          const float scale = sqrtf(tot / fmaxf(pb, 1e-30f));
          if (xs) cg::this_cluster().sync();
          project(v, ja, B, scale, post);
          weight *= w0 + bf * (w1 - w0);
          if (t == 0 && v.rank == 0)
            p.bits[(size_t)lab * p.n_sites + jb] = B;
          row_barrier(xs);
          continue;
        }
        if (cross) cg::this_cluster().sync();
        if (kind == kGate1) {
          const float* c = a0 >= 0 ? p.pool + a0 : erow + (-1 - a0);
          float a = 0.f, b = 0.f;
          apply_1q(v, ja, c, false, a, b);
        } else if (kind == kGate2) {
          const float* c = a0 >= 0 ? p.pool + a0 : erow + (-1 - a0);
          apply_2q(v, ja, jb, c, 0, false);
        } else if (kind == kDiag) {
          apply_diag(v, p.pool + a0, ja);
        } else if (kind == kPerm1) {
          apply_perm1(v, ja, a0);
        } else {
          apply_2q(v, ja, jb, nullptr, a0, true);
        }
        row_barrier(cross);
      }
      const int copies = resume < p.n_rows ? 1 : len;
      epilogue(p, v, s_epi, weight, lab, copies, tree, part, red, xch);
      if (p.csize == 2) cg::this_cluster().sync();
    }
    __syncthreads();  // the state is reused by the next run
  }
}

}  // namespace

// CTAs (csize 1) or clusters (csize 2) the card runs at once for a launch
// of this shape; 0 when it cannot run at all.
extern "C" int collapse_kernel_capacity(int threads, int smem, int csize) {
  cudaFuncSetAttribute(collapse_rows_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (csize == 1) {
    int per_sm = 0, dev = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, collapse_rows_kernel, threads, smem) != cudaSuccess)
      return 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return per_sm * sms;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize * sms);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = csize;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, collapse_rows_kernel, &cfg) !=
      cudaSuccess)
    return 0;
  return clusters;
}

// Returns a cudaError_t: 0 on success.  Refused with cudaErrorInvalidValue:
// a width outside [0, 20], a block size that is not a power of two in
// [32, 512], a cluster other than 1 or 2 (2 only at n = 15), an unknown
// epilogue, more than 128 marginal outcomes or z masks, a shared-memory
// state past n = 15 or a global one without scratch.
extern "C" int collapse_rows_launch(
    const float* prefix, const int* rows, const float* pool,
    const float* entries, const float* cscal, const int* epi,
    const int* runs, const int* count, float* scratch, float* out,
    int* bits, int n, int n_rows, int C, int entry_stride, int n_sites,
    int mode, int n_epi, int csize, int use_smem, int grid, int threads,
    void* stream) {
  if (n < 0 || n > kMaxQubits || threads < 32 || threads > kMaxThreads ||
      (threads & (threads - 1)) || mode < 0 || mode > 2 || C < 1 ||
      grid < 1 || n_sites < 1 || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (mode == 1 && (n_epi < 0 || n_epi > n || (1 << n_epi) > kMaxEpi))
    return (int)cudaErrorInvalidValue;
  if (mode == 2 && (n_epi < 0 || n_epi + 1 > kMaxEpi))
    return (int)cudaErrorInvalidValue;
  if (csize != 1 && csize != 2) return (int)cudaErrorInvalidValue;
  if (csize == 2 && (n != kMaxSmemQubits || !use_smem || grid % 2))
    return (int)cudaErrorInvalidValue;
  if (use_smem && (n > kMaxSmemQubits || (n == kMaxSmemQubits && csize != 2)))
    return (int)cudaErrorInvalidValue;
  if (use_smem && ((1 << n) / csize) > kCk * threads)
    return (int)cudaErrorInvalidValue;
  if (!use_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem =
      use_smem ? ((size_t)2 * sizeof(float) << n) / csize : 0;
  cudaError_t err = cudaFuncSetAttribute(
      collapse_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  Params p{prefix, rows, pool, entries, cscal, epi, runs, count, scratch,
           out, bits, n, n_rows, C, entry_stride, n_sites, mode, n_epi,
           csize, use_smem};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = csize;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, collapse_rows_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* collapse_kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
