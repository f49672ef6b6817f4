// Segmented blocked statevector kernel: one gate segment over shared-memory
// tiles of a batch of states that live in global memory.
//
// Replaces the JAX package's ops/pallas_blocked.py::_segment_call (the
// pl.pallas_call at :168), driven by make_blocked_chunk_kernel :184 for
// fragments of 21..24 simulated qubits.  The host planner lays every qubit
// that a segment's gates touch on the low w flat bits of the state, so each
// aligned run of 2^w amplitudes (a tile) is closed under all gates of the
// segment.  One launch applies one segment to every tile of every label of
// a chunk; between segments the host re-tiles the states with a bit
// permutation outside this kernel.
//
// One generic interpreter over the op table: a single nvcc build serves
// every circuit.  Plain C interface, loaded with ctypes.
//
// Design, and what bounds it on an H100:
//  * Grid = labels x 2^(n-w) tiles, one CTA per tile, in no order: tiles are
//    independent within a segment.  (The TPU kernel walks the blocks of ONE
//    label in a sequential grid and scans over labels; here a whole chunk's
//    states are alive at once and one launch covers them.)
//  * A CTA loads its tile (re and im planes, 2 * 2^w floats) into dynamic
//    shared memory with 16-byte loads, applies every op of the segment there
//    (each thread owns whole XOR pairs or quads, so updates are in place; a
//    block barrier between ops), and writes the tile back once.  Per segment
//    the state crosses device memory once in each direction whatever the
//    number of gates: the kernel is bound by those bytes, 2 * 8 * 2^n per
//    label and segment, not by its f32 arithmetic.
//  * The window is bounded by shared memory: 8 * 2^w bytes, 128 KB at
//    w = 14 (one CTA per SM), 64 KB at w = 13 (two).  Above 48 KB the
//    launch raises the kernel's dynamic shared memory limit first.
//  * The first segment reads the host-computed prefix state shared by every
//    label (label stride 0) and writes the per-label states; later segments
//    run in place.
//  * Offsets into the batch are 64-bit: 36 labels of 2^24 complex
//    amplitudes pass 2^31 floats.
//  * f32 FFMA throughout; no tensor cores, so no TF32.
//
// Layout: planar [labels, 2, 2^n] (re then im); tile t holds flat indices
// [t * 2^w, (t + 1) * 2^w).  Op rows are (nq, ja, jb, coef) over flat bits
// below w; gate index m = 2*bit(ja)+bit(jb); coef >= 0 is an offset into the
// fixed pool, coef < 0 is -1 - offset into the label's entry row.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWindow = 14;

struct Params {
  const float* src;        // [labels or 1, 2, N]
  float* dst;              // [labels, 2, N]
  long long src_stride;    // floats between labels in src (0: shared prefix)
  const int* ops;          // [n_ops, 4]
  const float* fixed;      // fixed-gate coefficients: re[m*m] then im[m*m]
  const float* entries;    // [labels, entry_stride] slot coefficients
  int op_start, op_end;    // this segment's rows of ops
  int entry_stride, n, w;
};

__device__ __forceinline__ int insert_zero(int p, int j) {
  return ((p >> j) << (j + 1)) | (p & ((1 << j) - 1));
}

__device__ void tile_1q(float* re, float* im, int W, int j, const float* cs) {
  const float r00 = cs[0], r01 = cs[1], r10 = cs[2], r11 = cs[3];
  const float i00 = cs[4], i01 = cs[5], i10 = cs[6], i11 = cs[7];
  const int half = W >> 1, bit = 1 << j;
  for (int p = threadIdx.x; p < half; p += blockDim.x) {
    const int a = insert_zero(p, j), b = a | bit;
    const float ar = re[a], ai = im[a], br = re[b], bi = im[b];
    re[a] = r00 * ar - i00 * ai + r01 * br - i01 * bi;
    im[a] = r00 * ai + i00 * ar + r01 * bi + i01 * br;
    re[b] = r10 * ar - i10 * ai + r11 * br - i11 * bi;
    im[b] = r10 * ai + i10 * ar + r11 * bi + i11 * br;
  }
}

__device__ void tile_2q(float* re, float* im, int W, int ja, int jb,
                        const float* cs) {
  const int lo = min(ja, jb), hi = max(ja, jb);
  const int ma = 1 << ja, mb = 1 << jb;
  const int quarter = W >> 2;
  for (int p = threadIdx.x; p < quarter; p += blockDim.x) {
    const int base = insert_zero(insert_zero(p, lo), hi);
    const int idx[4] = {base, base | mb, base | ma, base | ma | mb};
    float xr[4], xi[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      xr[c] = re[idx[c]];
      xi[c] = im[idx[c]];
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
      re[idx[r]] = accr;
      im[idx[r]] = acci;
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
blocked_segment_kernel(Params p) {
  extern __shared__ float4 tile4[];  // re plane [W], then im plane [W]
  __shared__ float cs[32];

  const int W = 1 << p.w;
  const long long N = 1LL << p.n;
  const int tile_bits = p.n - p.w;
  const long long lab = (long long)blockIdx.x >> tile_bits;
  const long long t = (long long)blockIdx.x & ((1LL << tile_bits) - 1);
  const float* s = p.src + lab * p.src_stride + t * W;
  float* d = p.dst + lab * 2 * N + t * W;
  float* re = reinterpret_cast<float*>(tile4);
  float* im = re + W;

  // W >= 4 and every plane offset is a multiple of W floats, so the tile
  // is 16-byte aligned in global and in shared memory
  const int W4 = W >> 2;
  const float4* s_re = reinterpret_cast<const float4*>(s);
  const float4* s_im = reinterpret_cast<const float4*>(s + N);
  for (int i = threadIdx.x; i < W4; i += blockDim.x) {
    tile4[i] = s_re[i];
    tile4[W4 + i] = s_im[i];
  }

  const float* erow = p.entries + lab * p.entry_stride;
  for (int o = p.op_start; o < p.op_end; ++o) {
    const int nq = p.ops[4 * o], ja = p.ops[4 * o + 1];
    const int jb = p.ops[4 * o + 2], coef = p.ops[4 * o + 3];
    const float* csrc = coef >= 0 ? p.fixed + coef : erow + (-1 - coef);
    if (threadIdx.x < (nq == 1 ? 8 : 32)) cs[threadIdx.x] = csrc[threadIdx.x];
    __syncthreads();  // coefficients and the previous op's tile are visible
    if (nq == 1)
      tile_1q(re, im, W, ja, cs);
    else
      tile_2q(re, im, W, ja, jb, cs);
    __syncthreads();  // cs is free for the next op
  }
  __syncthreads();

  float4* d_re = reinterpret_cast<float4*>(d);
  float4* d_im = reinterpret_cast<float4*>(d + N);
  for (int i = threadIdx.x; i < W4; i += blockDim.x) {
    d_re[i] = tile4[i];
    d_im[i] = tile4[W4 + i];
  }
}

}  // namespace

extern "C" int blocked_kernel_max_window() { return kMaxWindow; }

// Returns a cudaError_t: 0 on success.  The launch is refused with
// cudaErrorInvalidValue for a window outside [2, kMaxWindow] or n, and
// with cudaErrorInvalidConfiguration for a grid past 2^31 - 1 blocks.
extern "C" int blocked_segment_launch(
    const float* src, float* dst, long long src_stride, const int* ops,
    const float* fixed, const float* entries, int op_start, int op_end,
    int entry_stride, int n, int w, int labels, int threads, void* stream) {
  if (w < 2 || w > kMaxWindow || w > n || n > 30 || labels < 1 ||
      threads < 1 || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)labels << (n - w);
  if (grid > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)2 * sizeof(float) << w;
  cudaError_t err = cudaFuncSetAttribute(
      blocked_segment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  Params p{src, dst, src_stride, ops, fixed, entries, op_start, op_end,
           entry_stride, n, w};
  blocked_segment_kernel<<<(unsigned)grid, threads, smem,
                           (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* blocked_kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
