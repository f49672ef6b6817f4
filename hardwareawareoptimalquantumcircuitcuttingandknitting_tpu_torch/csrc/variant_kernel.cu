// Whole-variant statevector kernel for the engine="pallas" label scan.
//
// Replaces the JAX package's ops/pallas_variant.py::_build_call (the
// pl.pallas_call at :577), reached through make_folded_chunk_kernel :699
// (fold epilogue) and make_chunk_kernel :647 (full-row epilogue).  For
// each QPD label of a chunk it starts from the host-computed shared prefix
// state, applies the fused suffix (fixed 1q/2q gates from a host-built op
// table, slot gates from the label's own complex entries), and writes
// either the fold-weighted, z-signed, summed knit row [2^d] or the full
// |psi|^2 row [2^n].
//
// One generic interpreter over the op table: a single nvcc build serves
// every circuit.  Plain C interface, loaded with ctypes.
//
// Design, and what bounds it on an H100:
//  * A TPU grid runs in order with VMEM scratch kept between steps; CUDA
//    blocks do not.  So each block (CTA) owns a contiguous run of labels
//    and loops over them, keeping its own per-slot-segment checkpoints in
//    a global-memory scratch slice.  The first label of every run replays
//    in full (stage 0), whatever the stage array says.
//  * At n = 15 a state is 256 KB (more than a block's 227 KB of shared
//    memory) and five checkpoints add 1.25 MB per block, so state and
//    checkpoints live in global memory (mostly L2-resident: 132 working
//    states of 256 KB fit the 50 MB L2).  Every gate is one pass over the
//    state by all 1024 threads, each owning whole XOR-pair/quad groups
//    (so in-place updates need no second buffer), with a block barrier
//    between gates.  The kernel is bound by memory traffic per gate pass,
//    not by arithmetic; shared-memory-resident states for n <= 14 and
//    thread-block clusters are later performance work.
//  * Staging: segment i (a slot plus the fixed gates up to the next slot)
//    re-runs only when the label's stage <= i, so most labels replay just
//    the chain-late segments of the minor-most vgates.
//  * f32 throughout; no tensor cores, so no TF32.  Zero coefficients are
//    not skipped (multiplying by an exact zero leaves results unchanged).
//
// Layout: planar [2, 2^n] (re then im); flat bit j of the amplitude index
// is the kernel's qubit j (the host maps circuit qubits to flat bits, with
// the fold's kept clbits on bits 0..d-1).  Gate index m = 2*bit(ja)+bit(jb).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxW = 64;

struct Params {
  const float* prefix;     // [2, N]
  const int* ops;          // [n_ops, 4]: nq, ja, jb, coef (>=0 fixed offset,
                           //   <0: -1 - offset into the label's entry row)
  const float* fixed;      // fixed-gate coefficients: re[m*m] then im[m*m]
  const int* seg_start;    // [n_seg + 1]
  const float* entries;    // [C, entry_stride] per-label slot coefficients
  const int* stage;        // [C] first segment to replay
  const float* wstack;     // [C, n_w, 2] fold weights (w0, w1)
  const int* wbits;        // [n_wbits] flat bit per weight, -1 = scalar w0
  float* scratch;          // [grid, n_seg, 2, N] per-CTA checkpoints
  float* out;              // [C, 2^d] (fold) or [C, N] (full rows)
  int n, d, fold, C, labels_per_cta, n_seg, entry_stride, n_w, n_wbits;
  int zmask;
};

__device__ __forceinline__ int insert_zero(int p, int j) {
  return ((p >> j) << (j + 1)) | (p & ((1 << j) - 1));
}

__device__ void apply_1q(const float* src, float* dst, int N, int j,
                         const float* cs) {
  const float r00 = cs[0], r01 = cs[1], r10 = cs[2], r11 = cs[3];
  const float i00 = cs[4], i01 = cs[5], i10 = cs[6], i11 = cs[7];
  const int half = N >> 1, bit = 1 << j;
  for (int p = threadIdx.x; p < half; p += blockDim.x) {
    const int a = insert_zero(p, j), b = a | bit;
    const float ar = src[a], ai = src[N + a];
    const float br = src[b], bi = src[N + b];
    dst[a] = r00 * ar - i00 * ai + r01 * br - i01 * bi;
    dst[N + a] = r00 * ai + i00 * ar + r01 * bi + i01 * br;
    dst[b] = r10 * ar - i10 * ai + r11 * br - i11 * bi;
    dst[N + b] = r10 * ai + i10 * ar + r11 * bi + i11 * br;
  }
}

__device__ void apply_2q(const float* src, float* dst, int N, int ja, int jb,
                         const float* cs) {
  const int lo = min(ja, jb), hi = max(ja, jb);
  const int ma = 1 << ja, mb = 1 << jb;
  const int quarter = N >> 2;
  for (int p = threadIdx.x; p < quarter; p += blockDim.x) {
    const int base = insert_zero(insert_zero(p, lo), hi);
    const int idx[4] = {base, base | mb, base | ma, base | ma | mb};
    float xr[4], xi[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      xr[c] = src[idx[c]];
      xi[c] = src[N + idx[c]];
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
      dst[idx[r]] = accr;
      dst[N + idx[r]] = acci;
    }
  }
}

__device__ __forceinline__ float fold_term(const float* st, int N, int f,
                                           const float* ws, const int* wb,
                                           int n_wbits, int zmask) {
  const float re = st[f], im = st[N + f];
  float fac = 1.f;
  for (int t = 0; t < n_wbits; ++t) {
    const int fb = wb[t];
    fac *= (fb >= 0 && ((f >> fb) & 1)) ? ws[2 * t + 1] : ws[2 * t];
  }
  if (__popc(f & zmask) & 1) fac = -fac;
  return (re * re + im * im) * fac;
}

// out[k] = sum_h w(h) * sign(h) * |psi[h << d | k]|^2: weighted and z bits
// sit above the d kept bits by construction of the host layout.
__device__ void epilogue_fold(const float* st, int N, int d, const float* ws,
                              const int* wb, int n_wbits, int zmask,
                              float* orow, float* red) {
  const int K = 1 << d, H = N >> d, T = blockDim.x;
  if (K >= T) {
    for (int k = threadIdx.x; k < K; k += T) {
      float acc = 0.f;
      for (int h = 0; h < H; ++h)
        acc += fold_term(st, N, (h << d) | k, ws, wb, n_wbits, zmask);
      orow[k] = acc;
    }
    return;
  }
  // fewer outputs than threads: G threads share each output, then a
  // shared-memory tree sum (T and K are powers of two)
  const int G = T / K, k = threadIdx.x % K, g = threadIdx.x / K;
  float acc = 0.f;
  for (int h = g; h < H; h += G)
    acc += fold_term(st, N, (h << d) | k, ws, wb, n_wbits, zmask);
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = G >> 1; s > 0; s >>= 1) {
    if (g < s) red[threadIdx.x] += red[threadIdx.x + s * K];
    __syncthreads();
  }
  if (g == 0) orow[k] = red[threadIdx.x];
}

__global__ void __launch_bounds__(kThreads)
variant_rows_kernel(Params p) {
  __shared__ float cs[32];
  __shared__ float red[kThreads];
  __shared__ float s_ws[2 * kMaxW];
  __shared__ int s_wb[kMaxW];

  const int N = 1 << p.n;
  const int r0 = blockIdx.x * p.labels_per_cta;
  const int r1 = min(p.C, r0 + p.labels_per_cta);
  float* ck = p.scratch + (size_t)blockIdx.x * p.n_seg * 2 * N;

  for (int lab = r0; lab < r1; ++lab) {
    // the first label of this block's run has no valid checkpoints
    const int s = (lab == r0) ? 0 : p.stage[lab];
    const float* erow = p.entries + (size_t)lab * p.entry_stride;
    for (int i = s; i < p.n_seg; ++i) {
      const float* src = (i == 0) ? p.prefix : ck + (size_t)(i - 1) * 2 * N;
      float* dst = ck + (size_t)i * 2 * N;
      for (int o = p.seg_start[i]; o < p.seg_start[i + 1]; ++o) {
        const int nq = p.ops[4 * o], ja = p.ops[4 * o + 1];
        const int jb = p.ops[4 * o + 2], coef = p.ops[4 * o + 3];
        const float* csrc = coef >= 0 ? p.fixed + coef : erow + (-1 - coef);
        if (threadIdx.x < (nq == 1 ? 8 : 32)) cs[threadIdx.x] = csrc[threadIdx.x];
        __syncthreads();
        if (nq == 1)
          apply_1q(src, dst, N, ja, cs);
        else
          apply_2q(src, dst, N, ja, jb, cs);
        __syncthreads();
        src = dst;
      }
    }
    const float* fin =
        p.n_seg ? ck + (size_t)(p.n_seg - 1) * 2 * N : p.prefix;
    if (p.fold) {
      const float* ws = p.wstack + (size_t)lab * p.n_w * 2;
      if (threadIdx.x < 2 * p.n_wbits) s_ws[threadIdx.x] = ws[threadIdx.x];
      if (threadIdx.x < p.n_wbits) s_wb[threadIdx.x] = p.wbits[threadIdx.x];
      __syncthreads();
      epilogue_fold(fin, N, p.d, s_ws, s_wb, p.n_wbits, p.zmask,
                    p.out + ((size_t)lab << p.d), red);
    } else {
      float* orow = p.out + (size_t)lab * N;
      for (int f = threadIdx.x; f < N; f += blockDim.x)
        orow[f] = fin[f] * fin[f] + fin[N + f] * fin[N + f];
    }
    __syncthreads();  // checkpoints and shared buffers are reused next label
  }
}

}  // namespace

extern "C" int variant_kernel_max_weights() { return kMaxW; }

extern "C" int variant_rows_launch(
    const float* prefix, const int* ops, const float* fixed,
    const int* seg_start, const float* entries, const int* stage,
    const float* wstack, const int* wbits, float* scratch, float* out, int n,
    int d, int fold, int C, int labels_per_cta, int n_seg, int entry_stride,
    int n_w, int n_wbits, int zmask, int grid, void* stream) {
  Params p{prefix, ops, fixed, seg_start, entries, stage, wstack, wbits,
           scratch, out, n, d, fold, C, labels_per_cta, n_seg, entry_stride,
           n_w, n_wbits, zmask};
  variant_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* variant_kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
