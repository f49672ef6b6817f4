// Whole-fragment statevector kernel: every QPD variant of a fragment from
// one launch.
//
// Replaces the JAX package's ops/pallas_sv.py::build_fragment_kernel (the
// pl.pallas_call at :347), driven by run_fragment_pallas :388.  A lane is a
// (variant, branch code) pair of one fragment.  Per lane the kernel starts
// from |0..0> on the fragment's data qubits and runs the op table in order:
// fixed 1q and 2q gates (the same matrices for every lane) and slots.  A
// slot on flat bit j applies the lane's own pre 2x2, then the projector
// mask (m0 on bit j = 0, m1 on bit j = 1: a measuring endpoint's (1-b, b),
// or (0, 0) on the lanes whose branch no endpoint takes), then the lane's
// post 2x2, all from 18 floats of the lane's row of the lane table.  The
// epilogue writes |psi|^2 summed over the flat bits k..n-1 (the qubits no
// terminal measure reads) as the lane's row [2^k]; the rows of all lanes,
// in lane order, are the fragment's result as it lies in memory.
//
// One generic interpreter over the op table of ops/sv_kernel.build_plan
// (rows kind, ja, jb, off): a single nvcc build serves every circuit.  Plain
// C interface, loaded with ctypes.
//
// Design, and what bounds it on an H100:
//  * On the TPU the variants sit on 128 lanes side by side and every gate is
//    a row mix.  Here a lane's whole state (8 * 2^n bytes, 64 KB at the width
//    gate n = 13) fits in shared memory, so a group of threads owns a lane
//    for its whole chain and the state never touches device memory: the
//    lane table is read once and the rows are written once.  With dense
//    matrices that leaves the function bound by operations (a 13-qubit chain
//    of a hundred dense gates is some 10^7 FLOP per lane against 90 bytes in
//    and a row out).  A chain of permutations and unit entries (CX, and a
//    rotation at a multiple of pi) needs next to none, and the function is
//    then bound by its bytes; this interpreter still runs every such op.
//    What it pays in either case is one pass over shared memory and one
//    block barrier per op.
//  * A group is 2^n / 8 threads (at least a warp, at most 1024).  Narrow
//    fragments would leave a block mostly idle, so a block of 256 threads
//    runs 256 / group lanes side by side, each group on its own state.  All
//    lanes run the same op sequence, so the block's barriers stay uniform: a
//    group past the end of the lane table skips the work and keeps the
//    barriers.  Blocks walk the lane table with a grid stride.
//  * A 1q gate or a slot gives each thread whole amplitude pairs, a 2q gate
//    whole quads, so gates work in place.  A slot's pre, mask and post act
//    on the same pair and run in registers in that order.  Zero entries of a
//    fixed matrix (a CX has four of sixteen) are skipped by a branch that is
//    uniform over the block.
//  * The op table and the coefficient pool are staged in shared memory once
//    per block when they fit beside the states (48 KB at most), else they
//    are read from device memory through the cache.
//  * The sum over dropped bits halves the probability vector in place, the
//    top bit first: a fixed order, no atomics, so a launch repeats bit for
//    bit.
//  * f32 throughout, no fast-math, no tensor cores, so no TF32.
//
// Layout: planar [2, 2^n] per lane (re then im); flat bit j of the amplitude
// index is the kernel's qubit j (the host puts the qubit read by the i-th
// data clbit on bit i).  Gate index m = 2*bit(ja)+bit(jb).  Offsets across
// lanes are 64-bit (248832 lanes x 1024 outcomes pass 2^31 bytes).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxQubits = 13;             // 8 * 2^13 B = 64 KB a lane
constexpr int kMaxTableBytes = 48 * 1024;  // staged op table + pool
constexpr int kSlotParams = 18;

struct Params {
  const int* ops;        // [n_ops, 4]: kind, ja, jb, off
  const float* fixed;    // fixed-gate coefficients: re[m*m] then im[m*m]
  const float* params;   // [lanes, p_cols] lane table
  float* out;            // [lanes, 2^k]
  long long lanes;
  int n, k, n_ops, n_fixed, p_cols, group, stage;
};

__device__ __forceinline__ int insert_zero(int p, int j) {
  return ((p >> j) << (j + 1)) | (p & ((1 << j) - 1));
}

// Fixed 1q gate, planar coefficients cs = re[4] then im[4].
__device__ void apply_1q(float* st, int N, int j, const float* cs, int t,
                         int S) {
  const float r00 = cs[0], r01 = cs[1], r10 = cs[2], r11 = cs[3];
  const float i00 = cs[4], i01 = cs[5], i10 = cs[6], i11 = cs[7];
  const int half = N >> 1, bit = 1 << j;
  for (int p = t; p < half; p += S) {
    const int a = insert_zero(p, j), b = a | bit;
    const float ar = st[a], ai = st[N + a];
    const float br = st[b], bi = st[N + b];
    st[a] = r00 * ar - i00 * ai + r01 * br - i01 * bi;
    st[N + a] = r00 * ai + i00 * ar + r01 * bi + i01 * br;
    st[b] = r10 * ar - i10 * ai + r11 * br - i11 * bi;
    st[N + b] = r10 * ai + i10 * ar + r11 * bi + i11 * br;
  }
}

// Fixed 2q gate, planar coefficients cs = re[16] then im[16]; an entry that
// is exactly zero is skipped (the same branch for every thread).
__device__ void apply_2q(float* st, int N, int ja, int jb, const float* cs,
                         int t, int S) {
  const int lo = min(ja, jb), hi = max(ja, jb);
  const int ma = 1 << ja, mb = 1 << jb;
  const int quarter = N >> 2;
  for (int p = t; p < quarter; p += S) {
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
        if (ur == 0.f && ui == 0.f) continue;
        accr += ur * xr[c] - ui * xi[c];
        acci += ur * xi[c] + ui * xr[c];
      }
      st[idx[r]] = accr;
      st[N + idx[r]] = acci;
    }
  }
}

// A slot on flat bit j: pre, mask, post from the lane's 18 floats (entries
// interleaved: 00 re, 00 im, 01 re, 01 im, 10 re, 10 im, 11 re, 11 im).
__device__ void apply_slot(float* st, int N, int j, const float* q, int t,
                           int S) {
  float c[kSlotParams];
#pragma unroll
  for (int i = 0; i < kSlotParams; ++i) c[i] = q[i];
  const float m0 = c[8], m1 = c[9];
  const int half = N >> 1, bit = 1 << j;
  for (int p = t; p < half; p += S) {
    const int a = insert_zero(p, j), b = a | bit;
    float ar = st[a], ai = st[N + a];
    float br = st[b], bi = st[N + b];
    float nar = c[0] * ar - c[1] * ai + c[2] * br - c[3] * bi;
    float nai = c[0] * ai + c[1] * ar + c[2] * bi + c[3] * br;
    float nbr = c[4] * ar - c[5] * ai + c[6] * br - c[7] * bi;
    float nbi = c[4] * ai + c[5] * ar + c[6] * bi + c[7] * br;
    ar = nar * m0;
    ai = nai * m0;
    br = nbr * m1;
    bi = nbi * m1;
    st[a] = c[10] * ar - c[11] * ai + c[12] * br - c[13] * bi;
    st[N + a] = c[10] * ai + c[11] * ar + c[12] * bi + c[13] * br;
    st[b] = c[14] * ar - c[15] * ai + c[16] * br - c[17] * bi;
    st[N + b] = c[14] * ai + c[15] * ar + c[16] * bi + c[17] * br;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
sv_rows_kernel(Params p) {
  extern __shared__ float smem[];
  const int N = 1 << p.n, K = 1 << p.k;
  const int S = p.group, G = blockDim.x / S;
  const int g = threadIdx.x / S, t = threadIdx.x % S;
  float* st = smem + (size_t)g * 2 * N;

  const int* ops = p.ops;
  const float* fixed = p.fixed;
  if (p.stage) {
    int* s_ops = reinterpret_cast<int*>(smem + (size_t)G * 2 * N);
    float* s_fixed = reinterpret_cast<float*>(s_ops + 4 * p.n_ops);
    for (int i = threadIdx.x; i < 4 * p.n_ops; i += blockDim.x)
      s_ops[i] = p.ops[i];
    for (int i = threadIdx.x; i < p.n_fixed; i += blockDim.x)
      s_fixed[i] = p.fixed[i];
    ops = s_ops;
    fixed = s_fixed;
  }
  __syncthreads();

  for (long long base = (long long)blockIdx.x * G; base < p.lanes;
       base += (long long)gridDim.x * G) {
    const long long lane = base + g;
    const bool live = lane < p.lanes;
    const float* prow = p.params + (size_t)(live ? lane : 0) * p.p_cols;

    if (live) {
      for (int f = t; f < 2 * N; f += S) st[f] = (f == 0) ? 1.f : 0.f;
    }
    __syncthreads();

    for (int o = 0; o < p.n_ops; ++o) {
      const int kind = ops[4 * o], ja = ops[4 * o + 1];
      const int jb = ops[4 * o + 2], off = ops[4 * o + 3];
      if (live) {
        if (kind == 1)
          apply_1q(st, N, ja, fixed + off, t, S);
        else if (kind == 2)
          apply_2q(st, N, ja, jb, fixed + off, t, S);
        else
          apply_slot(st, N, ja, prow + off, t, S);
      }
      __syncthreads();
    }

    // |psi|^2 into the re plane, then fold the dropped bits away
    if (live) {
      for (int f = t; f < N; f += S)
        st[f] = st[f] * st[f] + st[N + f] * st[N + f];
    }
    __syncthreads();
    for (int half = N >> 1; half >= K; half >>= 1) {
      if (live) {
        for (int f = t; f < half; f += S) st[f] += st[f + half];
      }
      __syncthreads();
    }
    if (live) {
      float* orow = p.out + ((size_t)lane << p.k);
      for (int d = t; d < K; d += S) orow[d] = st[d];
    }
    __syncthreads();  // the state is reused by the next lane
  }
}

// Bytes of the staged tables, or 0 when they are read from device memory.
int table_bytes(int n_ops, int n_fixed) {
  const long long b = 4LL * (4LL * n_ops + n_fixed);
  return b <= kMaxTableBytes ? (int)b : 0;
}

}  // namespace

extern "C" int sv_kernel_max_qubits() { return kMaxQubits; }

// Dynamic shared memory of a launch: the block's lane states and, when they
// fit, the staged tables.
extern "C" int sv_kernel_smem_bytes(int n, int threads, int group, int n_ops,
                                    int n_fixed) {
  const int lanes_per_block = threads / group;
  return lanes_per_block * (int)(2 * sizeof(float) << n) +
         table_bytes(n_ops, n_fixed);
}

// Returns a cudaError_t: 0 on success.  Refused with cudaErrorInvalidValue:
// a width outside [1, 13], more kept bits than qubits, a group that is not
// a power of two in [32, 1024] or does not divide the block, a block past
// 1024 threads, an empty lane table.
extern "C" int sv_rows_launch(const int* ops, const float* fixed,
                              const float* params, float* out,
                              long long lanes, int n, int k, int n_ops,
                              int n_fixed, int p_cols, int group, int grid,
                              int threads, void* stream) {
  if (n < 1 || n > kMaxQubits || k < 0 || k > n || group < 32 ||
      group > kMaxThreads || (group & (group - 1)) || threads < group ||
      threads > kMaxThreads || threads % group || lanes < 1 || grid < 1 ||
      n_ops < 0 || n_fixed < 0 || p_cols < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = sv_kernel_smem_bytes(n, threads, group, n_ops, n_fixed);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sv_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  Params p{ops,  fixed, params, out,   lanes,  n,
           k,    n_ops, n_fixed, p_cols, group,
           table_bytes(n_ops, n_fixed) > 0 ? 1 : 0};
  sv_rows_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* sv_kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
