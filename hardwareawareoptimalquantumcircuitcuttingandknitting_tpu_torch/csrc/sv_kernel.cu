// Whole-fragment statevector kernel: every QPD variant of a fragment from
// one launch.
//
// Replaces the JAX package's ops/pallas_sv.py::build_fragment_kernel (the
// pl.pallas_call at :347), driven by run_fragment_pallas :388.  A lane is a
// (variant, branch code) pair of one fragment: lane = variant << m | code.
// Per lane the kernel starts from the prefix state (the fixed gates before
// the first slot, applied once on the host) and runs the rewritten op table
// of ops/op_rewrite.py in order: dense fixed 1q and 2q gates, runs of
// diagonal gates, signed permutations, and slots.  A slot on flat bit j
// applies the lane's pre 2x2, then the projector mask (m0 on bit j = 0, m1
// on bit j = 1: a measuring endpoint's (1-b, b), or (0, 0) on the lanes
// whose branch no endpoint takes), then the lane's post 2x2.  Those 18
// floats are not read from a lane table: the kernel derives the lane's
// variant digit for the slot's vgate, digit = (variant / stride) % n_inst,
// and its branch bit b = (code >> branch_bit) & 1, and reads row
// off + 2 * digit + b of the slot's small table (ops/sv_kernel.py
// _slot_tables, staged in shared memory).  The epilogue writes |psi|^2
// summed over the flat bits k..n-1 (the qubits no terminal measure reads)
// as the lane's row [2^k]; the rows of all lanes, in lane order (or in the
// order of the given lane indices), are the fragment's result as it lies in
// memory.
//
// One generic interpreter over the rewritten op table (rows kind, ja, jb,
// a0, a1, a2): a single nvcc build serves every circuit.  Plain C
// interface, loaded with ctypes.
//
// Design, and what bounds it on an H100:
//  * A lane's whole state (8 * 2^n bytes, 64 KB at the width gate n = 13)
//    fits in shared memory, so a group of threads owns a lane for its whole
//    chain and the state never touches device memory: the tables are read
//    once per block and the rows written once.  With dense matrices the
//    function is bound by operations; a chain of permutations and unit
//    entries (hwe's CX and rotations by pi) needs next to none, and the
//    function is then bound by the bytes of its rows.
//  * What the interpreter pays is one pass over shared memory and one
//    barrier per row, so the host rewrite cuts rows: identities go, a run
//    of diagonal gates is one pass (per amplitude the product of the run's
//    entries in registers), a signed permutation is a move with no
//    multiply, and the gates before the first slot run once per fragment
//    instead of once per lane.
//  * No lane table: a [lanes, 18 * slots] table built on the host and read
//    per lane would be 90 MB a fragment on hwe-16, and building it most of
//    that route's wall time.  A slot has only 2 * n_inst distinct rows;
//    they sit in shared memory.
//  * A group is 2^n / 8 threads (at least a warp, at most 1024).  Narrow
//    fragments would leave a block mostly idle, so a block of 256 threads
//    runs 256 / group lanes side by side, each group on its own state.  A
//    group of one warp synchronises with __syncwarp; wider groups with the
//    block barrier (all lanes run the same rows, so it stays uniform: a
//    group past the end of the lanes skips the work and keeps the
//    barriers).  Blocks walk the lanes with a grid stride.
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
constexpr int kMaxTableBytes = 48 * 1024;  // staged tables
constexpr int kSlotParams = 18;
constexpr int kRow = 6;                    // ints per op row
constexpr int kDiagFloats = 10;            // floats per diagonal gate

enum OpKind {
  kGate1 = 1, kGate2 = 2, kDiag = 3, kPerm1 = 4, kPerm2 = 5, kSlot = 8
};

struct Params {
  const int* rows;         // [n_rows, 6] rewritten op table
  const float* pool;       // fixed coefficients and diagonal runs
  const float* prefix;     // [2, 2^n] state after the pre-slot gates
  const float* slot_tab;   // [slot rows, 18]
  const int* slot_meta;    // [n_slots, 4]: stride, n_inst, branch bit, off
  const long long* lane_idx;  // [lanes] lane indices, or null: 0..lanes-1
  float* out;              // [lanes, 2^k]
  long long lanes;
  int n, k, m, n_rows, n_pool, n_slot, n_slots, group, stage;
};

__device__ __forceinline__ int insert_zero(int p, int j) {
  return ((p >> j) << (j + 1)) | (p & ((1 << j) - 1));
}

__device__ __forceinline__ void group_sync(int S) {
  if (S <= 32)
    __syncwarp();
  else
    __syncthreads();
}

// Dense fixed 1q gate, planar coefficients cs = re[4] then im[4].
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

// Dense fixed 2q gate, planar coefficients cs = re[16] then im[16]; an entry
// that is exactly zero is skipped (the same branch for every thread).
__device__ void apply_2q(float* st, int N, int ja, int jb, const float* cs,
                         int t, int S) {
  const int lo = min(ja, jb), hi = max(ja, jb);
  const int ma = 1 << ja, mb = 1 << jb;
  const int quarter = N >> 2;
  float u[32];  // read once: the state's stores could alias cs
#pragma unroll
  for (int i = 0; i < 32; ++i) u[i] = cs[i];
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
        const float ur = u[4 * r + c], ui = u[16 + 4 * r + c];
        if (ur == 0.f && ui == 0.f) continue;
        accr += ur * xr[c] - ui * xi[c];
        acci += ur * xi[c] + ui * xr[c];
      }
      st[idx[r]] = accr;
      st[N + idx[r]] = acci;
    }
  }
}

// (re, im) times 1, i, -1 or -i: a move and a sign, no multiply.
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

// Signed permutation on one or two bits: output row r takes source column
// (code >> 4r) & 3 times the phase (code >> 4r + 2) & 3.  jb < 0: 1q.
__device__ void apply_perm(float* st, int N, int ja, int jb, int code, int t,
                           int S) {
  if (jb < 0) {
    const int half = N >> 1, bit = 1 << ja;
    for (int p = t; p < half; p += S) {
      const int a = insert_zero(p, ja), b = a | bit;
      const float ar = st[a], ai = st[N + a], br = st[b], bi = st[N + b];
      float y0r = (code & 3) ? br : ar, y0i = (code & 3) ? bi : ai;
      float y1r = ((code >> 4) & 3) ? br : ar;
      float y1i = ((code >> 4) & 3) ? bi : ai;
      rotate(y0r, y0i, (code >> 2) & 3);
      rotate(y1r, y1i, (code >> 6) & 3);
      st[a] = y0r;
      st[N + a] = y0i;
      st[b] = y1r;
      st[N + b] = y1i;
    }
    return;
  }
  const int lo = min(ja, jb), hi = max(ja, jb);
  const int ma = 1 << ja, mb = 1 << jb;
  const int quarter = N >> 2;
  for (int p = t; p < quarter; p += S) {
    const int base = insert_zero(insert_zero(p, lo), hi);
    const int idx[4] = {base, base | mb, base | ma, base | ma | mb};
    const float x0r = st[idx[0]], x1r = st[idx[1]], x2r = st[idx[2]],
                x3r = st[idx[3]];
    const float x0i = st[N + idx[0]], x1i = st[N + idx[1]],
                x2i = st[N + idx[2]], x3i = st[N + idx[3]];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = (code >> (4 * r)) & 3;
      float yr = pick4(x0r, x1r, x2r, x3r, c);
      float yi = pick4(x0i, x1i, x2i, x3i, c);
      rotate(yr, yi, (code >> (4 * r + 2)) & 3);
      st[idx[r]] = yr;
      st[N + idx[r]] = yi;
    }
  }
}

// A run of `count` diagonal gates: per amplitude, the product of the
// entries its bits select, in the run's order, then one complex multiply.
// A thread takes its amplitudes 8 at a time, so each gate's entries are
// read once per 8 amplitudes.
__device__ void apply_diag(float* st, int N, const float* el, int count,
                           int t, int S) {
  constexpr int kChunk = 8;
  for (int f0 = t; f0 < N; f0 += S * kChunk) {
    float pr[kChunk], pi[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      pr[k] = 1.f;
      pi[k] = 0.f;
    }
    for (int e = 0; e < count; ++e) {
      const float* d = el + kDiagFloats * e;
      const int ja = (int)d[0], jb = (int)d[1];
      const float e0r = d[2], e0i = d[3], e1r = d[4], e1i = d[5];
      const float e2r = d[6], e2i = d[7], e3r = d[8], e3i = d[9];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int f = f0 + k * S;
        const int m = 2 * ((f >> ja) & 1) + ((f >> jb) & 1);
        const float er = pick4(e0r, e1r, e2r, e3r, m);
        const float ei = pick4(e0i, e1i, e2i, e3i, m);
        const float nr = pr[k] * er - pi[k] * ei;
        pi[k] = pr[k] * ei + pi[k] * er;
        pr[k] = nr;
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int f = f0 + k * S;
      if (f < N) {
        const float re = st[f], im = st[N + f];
        st[f] = re * pr[k] - im * pi[k];
        st[N + f] = re * pi[k] + im * pr[k];
      }
    }
  }
}

// A slot on flat bit j: pre, mask, post from the 18 floats q (entries
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

  const int* rows = p.rows;
  const float* pool = p.pool;
  const float* slot_tab = p.slot_tab;
  const int* slot_meta = p.slot_meta;
  if (p.stage) {
    int* s_rows = reinterpret_cast<int*>(smem + (size_t)G * 2 * N);
    int* s_meta = s_rows + kRow * p.n_rows;
    float* s_pool = reinterpret_cast<float*>(s_meta + 4 * p.n_slots);
    float* s_slot = s_pool + p.n_pool;
    for (int i = threadIdx.x; i < kRow * p.n_rows; i += blockDim.x)
      s_rows[i] = p.rows[i];
    for (int i = threadIdx.x; i < 4 * p.n_slots; i += blockDim.x)
      s_meta[i] = p.slot_meta[i];
    for (int i = threadIdx.x; i < p.n_pool; i += blockDim.x)
      s_pool[i] = p.pool[i];
    for (int i = threadIdx.x; i < p.n_slot; i += blockDim.x)
      s_slot[i] = p.slot_tab[i];
    rows = s_rows;
    slot_meta = s_meta;
    pool = s_pool;
    slot_tab = s_slot;
  }
  __syncthreads();

  const long long code_mask = (1LL << p.m) - 1;
  for (long long base = (long long)blockIdx.x * G; base < p.lanes;
       base += (long long)gridDim.x * G) {
    const long long pos = base + g;
    const bool live = pos < p.lanes;
    const long long lane =
        live ? (p.lane_idx ? p.lane_idx[pos] : pos) : 0;
    const long long variant = lane >> p.m;
    const long long code = lane & code_mask;

    if (live) {
      for (int f = t; f < 2 * N; f += S) st[f] = p.prefix[f];
    }
    group_sync(S);

    for (int o = 0; o < p.n_rows; ++o) {
      const int* row = rows + kRow * o;
      const int kind = row[0], ja = row[1], jb = row[2], a0 = row[3];
      if (live) {
        if (kind == kGate1) {
          apply_1q(st, N, ja, pool + a0, t, S);
        } else if (kind == kGate2) {
          apply_2q(st, N, ja, jb, pool + a0, t, S);
        } else if (kind == kDiag) {
          apply_diag(st, N, pool + a0, ja, t, S);
        } else if (kind == kPerm1 || kind == kPerm2) {
          apply_perm(st, N, ja, kind == kPerm1 ? -1 : jb, a0, t, S);
        } else {  // kSlot: slot jb on bit ja
          const int* meta = slot_meta + 4 * jb;
          const long long digit = (variant / meta[0]) % meta[1];
          const int b = meta[2] >= 0 ? (int)((code >> meta[2]) & 1) : 0;
          apply_slot(st, N, ja,
                     slot_tab + (size_t)(meta[3] + 2 * digit + b) *
                                    kSlotParams,
                     t, S);
        }
      }
      group_sync(S);
    }

    // |psi|^2 into the re plane, then fold the dropped bits away
    if (live) {
      for (int f = t; f < N; f += S)
        st[f] = st[f] * st[f] + st[N + f] * st[N + f];
    }
    group_sync(S);
    for (int half = N >> 1; half >= K; half >>= 1) {
      if (live) {
        for (int f = t; f < half; f += S) st[f] += st[f + half];
      }
      group_sync(S);
    }
    if (live) {
      float* orow = p.out + ((size_t)pos << p.k);
      for (int d = t; d < K; d += S) orow[d] = st[d];
    }
    group_sync(S);  // the state is reused by the next lane
  }
}

// Bytes of the staged tables, or 0 when they are read from device memory.
int table_bytes(int n_rows, int n_pool, int n_slot, int n_slots) {
  const long long b =
      4LL * (kRow * (long long)n_rows + n_pool + n_slot + 4LL * n_slots);
  return b <= kMaxTableBytes ? (int)b : 0;
}

}  // namespace

extern "C" int sv_kernel_max_qubits() { return kMaxQubits; }

// Dynamic shared memory of a launch: the block's lane states and, when they
// fit, the staged tables.
extern "C" int sv_kernel_smem_bytes(int n, int threads, int group,
                                    int n_rows, int n_pool, int n_slot,
                                    int n_slots) {
  const int lanes_per_block = threads / group;
  return lanes_per_block * (int)(2 * sizeof(float) << n) +
         table_bytes(n_rows, n_pool, n_slot, n_slots);
}

// Returns a cudaError_t: 0 on success.  Refused with cudaErrorInvalidValue:
// a width outside [1, 13], more kept bits than qubits, a group that is not
// a power of two in [32, 1024] or does not divide the block, a block past
// 1024 threads, no lane, more branch bits than 40.
extern "C" int sv_rows_launch(const int* rows, const float* pool,
                              const float* prefix, const float* slot_tab,
                              const int* slot_meta,
                              const long long* lane_idx, float* out,
                              long long lanes, int n, int k, int m,
                              int n_rows, int n_pool, int n_slot,
                              int n_slots, int group, int grid,
                              int threads, void* stream) {
  if (n < 1 || n > kMaxQubits || k < 0 || k > n || group < 32 ||
      group > kMaxThreads || (group & (group - 1)) || threads < group ||
      threads > kMaxThreads || threads % group || lanes < 1 || grid < 1 ||
      n_rows < 0 || n_pool < 0 || n_slot < 0 || n_slots < 0 || m < 0 ||
      m > 40)
    return (int)cudaErrorInvalidValue;
  const int smem = sv_kernel_smem_bytes(n, threads, group, n_rows, n_pool,
                                        n_slot, n_slots);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sv_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  Params p{rows,   pool,   prefix, slot_tab, slot_meta, lane_idx,
           out,    lanes,  n,      k,        m,         n_rows,
           n_pool, n_slot, n_slots, group,
           table_bytes(n_rows, n_pool, n_slot, n_slots) > 0 ? 1 : 0};
  sv_rows_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* sv_kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
