// Shared machinery of the state-vector interpreters: the collapse kernel
// (collapse_kernel.cu), the whole-variant kernel (variant_kernel.cu) and
// the blocked kernel (blocked_kernel.cu, on one gathered tile).
//
// A state is planar [2, L] f32 (re then im) in one CTA's shared memory
// (or a tile of a state in global memory there), in a per-CTA slice of
// global memory, or split over a cluster of two CTAs on the top flat bit
// (rank r holds the amplitudes whose bit n-1 is r; View says which).  The
// row kinds are those of ops/op_rewrite.py: dense 1q / 2q gates
// (coefficients from the pool or the label's entry row), diagonal runs,
// signed permutations, and the collapse kernel's sites.  Every thread of a
// CTA runs every row; the barriers are the caller's, except in apply_row,
// which brackets a row that crosses the split with cluster barriers and
// ends every other row with the CTA's.  The row functions
// take kLocal: true for a state in the CTA's own shared memory (`own`,
// which the caller passes as its __shared__ array) and a row below the
// split, so the loops address shared memory with 32-bit offsets and no
// split test; false for any state (View's generic pointers).  The
// arithmetic is the same either way.  Sums run in a fixed order
// (per-thread partial, warp shuffle tree, warp partials in order, CTAs in
// rank order) with no float atomics.  f32, IEEE arithmetic (no
// fast-math), no tensor cores.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRow = 6;
constexpr int kDiagFloats = 10;

enum OpKind {
  kGate1 = 1, kGate2 = 2, kDiag = 3, kPerm1 = 4, kPerm2 = 5,
  kSiteA = 6, kSiteB = 7
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

// The pair p on bit j below the split, in the CTA's own state.
__device__ __forceinline__ Pair local_pair(float* own, int j, int p) {
  Pair q;
  q.pa = q.pb = own;
  q.xa = insert_zero(p, j);
  q.xb = q.xa | (1 << j);
  return q;
}

// A 1q gate (re[4], im[4]; null: none) on bit j; with sums: tot and p1
// of the result.  The coefficients are read once, into registers (the
// state's stores could alias them).
template <bool kLocal = false>
__device__ void apply_1q(const View& v, int j, const float* c, bool sums,
                         float& tot, float& p1, float* own = nullptr) {
  int p0, pe, step;
  if (kLocal) {
    p0 = v.t;
    pe = v.L >> 1;
    step = v.T;
  } else {
    pair_range(v, j, p0, pe, step);
  }
  const int L = v.L;
  float cr[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) cr[i] = c != nullptr ? c[i] : 0.f;
  for (int p = p0; p < pe; p += step) {
    const Pair q = kLocal ? local_pair(own, j, p) : pair_at(v, j, p);
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

// The four members of a quad on bits (ja, jb), in gate-index order; with
// kLocal, both below the split in the CTA's own state.
template <bool kLocal>
__device__ __forceinline__ void quad_at(const View& v, int ja, int jb, int p,
                                        float** pl, int* x, float* own) {
  const int ma = 1 << ja, mb = 1 << jb;
  if (!kLocal && (ja == v.split || jb == v.split)) {
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
  pl[0] = pl[1] = pl[2] = pl[3] = kLocal ? own : v.own;
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
template <bool kLocal = false>
__device__ void apply_2q(const View& v, int ja, int jb, const float* c,
                         int code, bool perm, float* own = nullptr) {
  int p0, pe, step;
  if (kLocal) {
    p0 = v.t;
    pe = v.L >> 2;
    step = v.T;
  } else {
    quad_range(v, ja, jb, p0, pe, step);
  }
  const int L = v.L;
  float u[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) u[i] = perm ? 0.f : c[i];
  for (int p = p0; p < pe; p += step) {
    float* pl[4];
    int x[4];
    quad_at<kLocal>(v, ja, jb, p, pl, x, own);
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

template <bool kLocal = false>
__device__ void apply_perm1(const View& v, int j, int code,
                            float* own = nullptr) {
  int p0, pe, step;
  if (kLocal) {
    p0 = v.t;
    pe = v.L >> 1;
    step = v.T;
  } else {
    pair_range(v, j, p0, pe, step);
  }
  const int L = v.L;
  for (int p = p0; p < pe; p += step) {
    const Pair q = kLocal ? local_pair(own, j, p) : pair_at(v, j, p);
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

template <bool kLocal = false>
__device__ void apply_diag(const View& v, const float* el, int count,
                           float* own = nullptr) {
  float* st = kLocal ? own : v.own;
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

// One row of kind kGate1, kGate2, kDiag, kPerm1 or kPerm2 (a gate's
// coefficients from the pool, a0 >= 0, or at -1 - a0 of the label's entry
// row), with its barriers: a cluster barrier before a row that crosses the
// split, and after it the CTA's barrier or, around a crossing row, the
// cluster's.  kLocal: the state is in the CTA's own shared memory `own`,
// so every row that does not cross the split runs the local loops.
template <bool kLocal = false>
__device__ void apply_row(const View& v, const int* row, const float* pool,
                          const float* erow, float* own = nullptr) {
  const int kind = row[0], ja = row[1], jb = row[2], a0 = row[3];
  const bool cross = touches_split(kind, ja, jb, v.split);
  if (kLocal && !cross) {
    if (kind == kGate1) {
      const float* c = a0 >= 0 ? pool + a0 : erow + (-1 - a0);
      float a = 0.f, b = 0.f;
      apply_1q<true>(v, ja, c, false, a, b, own);
    } else if (kind == kGate2) {
      const float* c = a0 >= 0 ? pool + a0 : erow + (-1 - a0);
      apply_2q<true>(v, ja, jb, c, 0, false, own);
    } else if (kind == kDiag) {
      apply_diag<true>(v, pool + a0, ja, own);
    } else if (kind == kPerm1) {
      apply_perm1<true>(v, ja, a0, own);
    } else {
      apply_2q<true>(v, ja, jb, nullptr, a0, true, own);
    }
    __syncthreads();
    return;
  }
  if (cross) cg::this_cluster().sync();
  if (kind == kGate1) {
    const float* c = a0 >= 0 ? pool + a0 : erow + (-1 - a0);
    float a = 0.f, b = 0.f;
    apply_1q(v, ja, c, false, a, b);
  } else if (kind == kGate2) {
    const float* c = a0 >= 0 ? pool + a0 : erow + (-1 - a0);
    apply_2q(v, ja, jb, c, 0, false);
  } else if (kind == kDiag) {
    apply_diag(v, pool + a0, ja);
  } else if (kind == kPerm1) {
    apply_perm1(v, ja, a0);
  } else {
    apply_2q(v, ja, jb, nullptr, a0, true);
  }
  row_barrier(cross);
}

// CTAs (csize 1) or clusters of csize CTAs the card runs at once for a
// launch of this kernel and shape; 0 when it cannot run at all.
template <typename Kernel>
int launch_capacity(Kernel kernel, int threads, int smem, int csize) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (csize == 1) {
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem) !=
        cudaSuccess)
      return 0;
    return per_sm * sms;
  }
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
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess)
    return 0;
  return clusters;
}

// Launches kernel(p) on a grid of CTAs in clusters of csize, with smem
// bytes of dynamic shared memory; the launch's error, or the last error.
template <typename Kernel, typename P>
cudaError_t launch_clustered(Kernel kernel, const P& p, int grid, int threads,
                             size_t smem, int csize, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
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
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
