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

#include "statevec_common.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxQubits = 20;
constexpr int kMaxSmemQubits = 15;   // 15: two CTAs of 128 KB
constexpr int kMaxEpi = 128;         // outcomes of the marginal, z columns
constexpr int kCk = 32;              // checkpoint amplitudes a thread

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

__device__ __forceinline__ int deposit(int v, const int* pos, int count) {
  int f = 0;
  for (int i = 0; i < count; ++i) f |= ((v >> i) & 1) << pos[i];
  return f;
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
        const int kind = row[0], ja = row[1], jb = row[2];
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
        apply_row(v, row, p.pool, erow);
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
  return launch_capacity(collapse_rows_kernel, threads, smem, csize);
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
  Params p{prefix, rows, pool, entries, cscal, epi, runs, count, scratch,
           out, bits, n, n_rows, C, entry_stride, n_sites, mode, n_epi,
           csize, use_smem};
  return (int)launch_clustered(collapse_rows_kernel, p, grid, threads, smem,
                               csize, stream);
}

extern "C" const char* collapse_kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
