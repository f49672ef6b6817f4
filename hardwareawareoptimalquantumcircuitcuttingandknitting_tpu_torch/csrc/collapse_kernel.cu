// Collapse-mode whole-variant kernel for the sampled engine.
//
// Replaces the JAX package's ops/pallas_variant.py::_build_call_collapse
// (the pl.pallas_call at :1165), reached through make_collapse_chunk_kernel
// :1183.  For each sampled QPD label of a block it starts from the shared
// prefix state and runs the suffix in order: fixed 1q/2q gates, 1q slot
// gates with the label's own entries, and collapse sites.  A collapse site
// on flat bit j measures that qubit in the simulation: tot = sum |psi|^2,
// p1 = sum |psi|^2 [bit j = 1], p0 = tot - p1, the branch b = (u * tot >=
// p0) from the label's uniform draw u, the other half zeroed, the rest
// scaled by sqrt(tot / max(p_b, 1e-30)), and the label's weight multiplied
// by w0 + b (w1 - w0).  A site whose mflag <= 0 (the label's variant does
// not measure there) leaves state and weight alone.  The epilogue writes
// |psi|^2 * weight as full rows [2^n], or summed onto the kept bits (the
// marginal, <= 128 outcomes), or as n_z signed parity sums plus the plain
// total.  The picked bits come back too ([C, n_sites], -1 where mflag <= 0)
// so a caller can tell a flipped branch from a rounding difference.
//
// One generic interpreter over the op table of ops/variant_kernel.OpTable
// (rows nq, ja, jb, coef; nq == 0 marks a collapse site on bit ja with its
// scalars at site index jb): a single nvcc build serves every circuit.
// Plain C interface, loaded with ctypes.
//
// Design, and what bounds it on an H100:
//  * The Born sums need every amplitude of a label, so one block (CTA)
//    owns a label at a time and loops over a contiguous run of labels;
//    nothing crosses blocks.  Sums are reduced in a fixed order (per-thread
//    strided partial, warp shuffle tree, then the warp partials in order),
//    with no float atomics, so a run repeats bit for bit and the branch
//    pick does not depend on scheduling.
//  * A complex64 state is 8 * 2^n bytes.  Up to n = 14 (128 KB) it lives in
//    the block's shared memory; from n = 15 (256 KB, past the 227 KB a
//    block can have) it lives in a per-block slice of a global scratch that
//    L2 mostly holds (132 blocks x 256 KB = 34 MB at n = 15).  Every gate
//    and every collapse site is a pass over that state with a block barrier
//    after it, so the kernel is bound by state traffic per pass, not by
//    arithmetic.  Spreading a label over a cluster, and several gates per
//    pass on a tile, are later performance work.
//  * Narrow fragments (n = 1 has two amplitudes) get small blocks (32
//    threads) and many of them per SM instead of 1024 mostly idle threads.
//  * f32 throughout, IEEE sqrt and division (no fast-math), no tensor
//    cores, so no TF32.
//
// Layout: planar [2, 2^n] (re then im); flat bit j of the amplitude index
// is the kernel's qubit j (the host puts active qubit i on bit n-1-i).
// Gate index m = 2*bit(ja)+bit(jb).  Offsets across labels are 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxQubits = 20;
constexpr int kMaxSmemQubits = 14;   // 8 * 2^14 B = 128 KB of a block's 227 KB
constexpr int kMaxEpi = 128;         // outcomes of the marginal, z columns

struct Params {
  const float* prefix;     // [2, N]
  const int* ops;          // [n_ops, 4]: nq, ja, jb, coef
  const float* fixed;      // fixed-gate coefficients: re[m*m] then im[m*m]
  const float* entries;    // [C, entry_stride] per-label slot coefficients
  const float* cscal;      // [C, n_sites, 4]: u, mflag, w0, w1
  const int* epi;          // marginal: kept flat bits [r] then the other
                           //   bits [n - r], ascending; z: masks [n_epi]
  float* scratch;          // [grid, 2, N] per-block state (n > 14)
  float* out;              // [C, out_width]
  int* bits;               // [C, n_sites] picked branches
  int n, n_ops, C, labels_per_cta, entry_stride, n_sites;
  int mode;                // 0 full rows, 1 marginal, 2 z columns
  int n_epi;               // marginal: r kept bits; z: number of masks
  int use_smem;
};

__device__ __forceinline__ int insert_zero(int p, int j) {
  return ((p >> j) << (j + 1)) | (p & ((1 << j) - 1));
}

// In place: a thread owns whole pairs (quads), so no second buffer.
__device__ void apply_1q(float* st, int N, int j, const float* cs) {
  const float r00 = cs[0], r01 = cs[1], r10 = cs[2], r11 = cs[3];
  const float i00 = cs[4], i01 = cs[5], i10 = cs[6], i11 = cs[7];
  const int half = N >> 1, bit = 1 << j;
  for (int p = threadIdx.x; p < half; p += blockDim.x) {
    const int a = insert_zero(p, j), b = a | bit;
    const float ar = st[a], ai = st[N + a];
    const float br = st[b], bi = st[N + b];
    st[a] = r00 * ar - i00 * ai + r01 * br - i01 * bi;
    st[N + a] = r00 * ai + i00 * ar + r01 * bi + i01 * br;
    st[b] = r10 * ar - i10 * ai + r11 * br - i11 * bi;
    st[N + b] = r10 * ai + i10 * ar + r11 * bi + i11 * br;
  }
}

__device__ void apply_2q(float* st, int N, int ja, int jb, const float* cs) {
  const int lo = min(ja, jb), hi = max(ja, jb);
  const int ma = 1 << ja, mb = 1 << jb;
  const int quarter = N >> 2;
  for (int p = threadIdx.x; p < quarter; p += blockDim.x) {
    const int base = insert_zero(insert_zero(p, lo), hi);
    const int idx[4] = {base, base | mb, base | ma, base | ma | mb};
    float xr[4], xi[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      xr[c] = st[idx[c]];
      xi[c] = st[N + idx[c]];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float accr = 0.f, acci = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float ur = cs[4 * r + c], ui = cs[16 + 4 * r + c];
        accr += ur * xr[c] - ui * xi[c];
        acci += ur * xi[c] + ui * xr[c];
      }
      st[idx[r]] = accr;
      st[N + idx[r]] = acci;
    }
  }
}

// Block-wide sums of two values in a fixed order; every thread returns the
// same pair.  red holds 64 floats.  All threads of the block must call it.
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

__device__ __forceinline__ int deposit(int v, const int* pos, int count) {
  int f = 0;
  for (int i = 0; i < count; ++i) f |= ((v >> i) & 1) << pos[i];
  return f;
}

// out[k] = weight * sum_h |psi[kept bits = k, other bits = h]|^2, one pass
// over the state: G threads share an output, then a tree sum in shared
// memory (K, T and G are powers of two).
__device__ void epilogue_marginal(const float* st, int N, int n, int r,
                                  const int* s_epi, float weight, float* orow,
                                  float* tree) {
  const int K = 1 << r, H = N >> r, T = blockDim.x;
  const int* kept = s_epi;
  const int* rest = s_epi + r;
  if (K >= T) {
    for (int k = threadIdx.x; k < K; k += T) {
      const int fk = deposit(k, kept, r);
      float acc = 0.f;
      for (int h = 0; h < H; ++h) {
        const int f = fk | deposit(h, rest, n - r);
        acc += st[f] * st[f] + st[N + f] * st[N + f];
      }
      orow[k] = acc * weight;
    }
    return;
  }
  const int G = T / K, k = threadIdx.x % K, g = threadIdx.x / K;
  const int fk = deposit(k, kept, r);
  float acc = 0.f;
  for (int h = g; h < H; h += G) {
    const int f = fk | deposit(h, rest, n - r);
    acc += st[f] * st[f] + st[N + f] * st[N + f];
  }
  tree[threadIdx.x] = acc;
  __syncthreads();
  for (int s = G >> 1; s > 0; s >>= 1) {
    if (g < s) tree[threadIdx.x] += tree[threadIdx.x + s * K];
    __syncthreads();
  }
  if (g == 0) orow[k] = tree[threadIdx.x] * weight;
}

__global__ void __launch_bounds__(kMaxThreads)
collapse_rows_kernel(Params p) {
  extern __shared__ float smem_state[];
  __shared__ float cs[32];
  __shared__ float red[64];
  __shared__ float tree[kMaxThreads];
  __shared__ int s_epi[kMaxEpi];

  const int N = 1 << p.n;
  const int T = blockDim.x;
  const int r0 = blockIdx.x * p.labels_per_cta;
  const int r1 = min(p.C, r0 + p.labels_per_cta);
  float* st = p.use_smem ? smem_state
                         : p.scratch + (size_t)blockIdx.x * 2 * N;
  const int n_tab = p.mode == 1 ? p.n : (p.mode == 2 ? p.n_epi : 0);
  for (int i = threadIdx.x; i < n_tab; i += T) s_epi[i] = p.epi[i];
  __syncthreads();

  for (int lab = r0; lab < r1; ++lab) {
    for (int f = threadIdx.x; f < 2 * N; f += T) st[f] = p.prefix[f];
    __syncthreads();
    const float* erow = p.entries + (size_t)lab * p.entry_stride;
    const float* srow = p.cscal + (size_t)lab * p.n_sites * 4;
    float weight = 1.f;

    for (int o = 0; o < p.n_ops; ++o) {
      const int nq = p.ops[4 * o], ja = p.ops[4 * o + 1];
      const int jb = p.ops[4 * o + 2], coef = p.ops[4 * o + 3];
      if (nq == 0) {
        // collapse site on flat bit ja, scalars at site jb
        const float u = srow[4 * jb], mflag = srow[4 * jb + 1];
        const float w0 = srow[4 * jb + 2], w1 = srow[4 * jb + 3];
        if (mflag > 0.f) {  // the same for every thread of the block
          float tot = 0.f, p1 = 0.f;
          for (int f = threadIdx.x; f < N; f += T) {
            const float re = st[f], im = st[N + f];
            const float s = re * re + im * im;
            tot += s;
            if ((f >> ja) & 1) p1 += s;
          }
          const float2 sums = block_sum2(tot, p1, red);
          tot = sums.x;
          p1 = sums.y;
          const float p0 = tot - p1;
          const int b = (u * tot >= p0) ? 1 : 0;
          const float bf = (float)b;
          const float pb = p0 + bf * (p1 - p0);
          const float scale = sqrtf(tot / fmaxf(pb, 1e-30f));
          for (int f = threadIdx.x; f < N; f += T) {
            const float fac = (((f >> ja) & 1) == b) ? scale : 0.f;
            st[f] *= fac;
            st[N + f] *= fac;
          }
          weight *= w0 + bf * (w1 - w0);
          if (threadIdx.x == 0) p.bits[(size_t)lab * p.n_sites + jb] = b;
          __syncthreads();
        }
        continue;
      }
      const float* csrc = coef >= 0 ? p.fixed + coef : erow + (-1 - coef);
      if (threadIdx.x < (nq == 1 ? 8 : 32)) cs[threadIdx.x] = csrc[threadIdx.x];
      __syncthreads();
      if (nq == 1)
        apply_1q(st, N, ja, cs);
      else
        apply_2q(st, N, ja, jb, cs);
      __syncthreads();
    }

    if (p.mode == 0) {
      float* orow = p.out + (size_t)lab * N;
      for (int f = threadIdx.x; f < N; f += T)
        orow[f] = (st[f] * st[f] + st[N + f] * st[N + f]) * weight;
    } else if (p.mode == 1) {
      epilogue_marginal(st, N, p.n, p.n_epi, s_epi, weight,
                        p.out + ((size_t)lab << p.n_epi), tree);
    } else {
      // column zi: sum |psi|^2 signed by the parity of mask zi's bits;
      // the last column is the plain total
      float* orow = p.out + (size_t)lab * (p.n_epi + 1);
      for (int zi = 0; zi <= p.n_epi; ++zi) {
        const int mask = zi < p.n_epi ? s_epi[zi] : 0;
        float acc = 0.f;
        for (int f = threadIdx.x; f < N; f += T) {
          const float s = st[f] * st[f] + st[N + f] * st[N + f];
          acc += (__popc(f & mask) & 1) ? -s : s;
        }
        const float2 sums = block_sum2(acc, 0.f, red);
        if (threadIdx.x == 0) orow[zi] = sums.x * weight;
      }
    }
    __syncthreads();  // the state and the shared buffers are reused
  }
}

}  // namespace

extern "C" int collapse_kernel_max_smem_qubits() { return kMaxSmemQubits; }

// Returns a cudaError_t: 0 on success.  Refused with cudaErrorInvalidValue:
// a width outside [0, 20], a block size that is not a multiple of 32 in
// [32, 1024], an unknown epilogue, more than 128 marginal outcomes or z
// masks, or a shared-memory state past n = 14.
extern "C" int collapse_rows_launch(
    const float* prefix, const int* ops, const float* fixed,
    const float* entries, const float* cscal, const int* epi, float* scratch,
    float* out, int* bits, int n, int n_ops, int C, int labels_per_cta,
    int entry_stride, int n_sites, int mode, int n_epi, int use_smem,
    int grid, int threads, void* stream) {
  if (n < 0 || n > kMaxQubits || threads < 32 || threads > kMaxThreads ||
      (threads & 31) || (threads & (threads - 1)) || mode < 0 || mode > 2 ||
      C < 1 || labels_per_cta < 1 || grid < 1 || n_sites < 1)
    return (int)cudaErrorInvalidValue;
  if (mode == 1 && (n_epi < 0 || n_epi > n || (1 << n_epi) > kMaxEpi))
    return (int)cudaErrorInvalidValue;
  if (mode == 2 && (n_epi < 0 || n_epi + 1 > kMaxEpi))
    return (int)cudaErrorInvalidValue;
  if (use_smem && n > kMaxSmemQubits) return (int)cudaErrorInvalidValue;
  const size_t smem = use_smem ? ((size_t)2 * sizeof(float) << n) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        collapse_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  Params p{prefix, ops, fixed, entries, cscal, epi, scratch, out, bits,
           n, n_ops, C, labels_per_cta, entry_stride, n_sites, mode, n_epi,
           use_smem};
  collapse_rows_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* collapse_kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
