// Segmented blocked statevector kernel: one gate segment over tiles of a
// batch of states that live in global memory, gathered into shared memory.
//
// Replaces the JAX package's ops/pallas_blocked.py::_segment_call (the
// pl.pallas_call at :168), driven by make_blocked_chunk_kernel :184 and
// plan_segments :59, for fragments of 21..24 simulated qubits.  One launch
// applies one segment to every tile of every label of a chunk; the shared
// prefix runs through the same launches on one state.
//
// One generic interpreter over the op table rewritten by ops/op_rewrite.py
// (dense 1q / 2q gates from the pool or the label's entry row, diagonal
// runs, signed permutations; the row machinery is statevec_common.cuh,
// shared with kernels 1-3): a single nvcc build serves every circuit.
// Plain C interface, loaded with ctypes.
//
// Design, and what bounds it on an H100 (times: chip_smoke.py's blocked
// phases, hwe-40's 22-qubit fragments, PERF.md):
//  * One storage layout, no re-tile.  A state keeps the canonical layout
//    (qubit q on flat bit n-1-q) for the whole run.  The host planner
//    gives each segment a window of w storage bits closed under its gates;
//    a tile is the 2^w amplitudes that differ only in those bits.  A CTA
//    gathers its tile (tile-local index i from base ^ gather(i)), works on
//    it in shared memory and scatters it back (to base ^ scatter(i)); both
//    maps are affine in i's bits, so each is a two-halves XOR table of 2 x
//    128 ints (bits 0-6 of i, bits 7-13) in shared memory, and the base is
//    the tile number deposited into the other bits.  Gather and scatter
//    touch the same addresses, so a segment runs in place and the state
//    crosses device memory once in each direction a segment, with no torch
//    pass between segments.
//  * Moves cost no pass.  The host folds a segment's leading and trailing
//    signed permutations (x, cx, swap, y: hwe's cx chains) into the
//    gather and scatter maps, their phases (powers of i) into a byte a
//    tile-local index, applied as each thread's copies land and in the
//    store; hwe-40 is left with at most one row a segment.  A swap inside
//    a segment moves two members of each pair or quad, not all.
//  * Whole sectors.  The planner pins the 3 lowest storage bits into every
//    window as tile bits 0..2, so a tile is read in runs of 8 floats a
//    plane: each 16-byte copy lies in a 32-byte sector the tile reads
//    whole; the scatter keeps every aligned group of 4 whole (its order
//    flipped in registers).
//  * Loads in flight.  The gather is cp.async (LDGSTS, 16 bytes a copy
//    where tile bits 0 and 1 are storage bits 0 and 1, else 4): no
//    registers held, the whole tile requested before the first wait.  A
//    64 KB tile (w = 13) and 256 threads leave two CTAs an SM, so one
//    CTA's copies overlap the other's.  Measured and not taken (PERF.md):
//    128 or 512 threads, w = 14 (one 128 KB CTA an SM, or a cluster of
//    two CTAs splitting the tile), 4 or 5 pinned bits (more segments),
//    one label a launch (its state left in L2 between segments).  With
//    the moves folded the kernel runs at the speed of the same launches
//    with no rows: the copies, ~2.2 TB/s on 32-byte runs, bound it.
//  * The last segment writes |psi|^2 (one plane) in place of the state.
//  * 64-bit offsets into the batch (36 labels of 2^24 complex amplitudes
//    pass 2^31 floats).  f32, IEEE arithmetic (no fast-math), no tensor
//    cores, no atomics: a launch repeats bit for bit.
//
// Layout: planar [labels, 2, 2^n] (re then im).  Rows (kRow ints) address
// tile-local bits below w; a gate's coefficients at a0 >= 0 of this
// segment's pool slice or at -1 - a0 of the label's entry row.

#include "statevec_common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 pairs or 8 quads a thread at w = 13
constexpr int kMaxWindow = 14;
constexpr int kDepBits = 7;
constexpr int kDepHalf = 1 << kDepBits;

struct Params {
  const float* src;        // [labels or 1, 2, N]
  float* dst;              // [labels, 2, N]
  float* probs;            // [labels, N] |psi|^2 rows in place of dst
  long long src_stride;    // floats between labels in src (0: shared state)
  const int* rows;         // [R, kRow] rewritten rows
  const float* pool;       // this segment's coefficient pool slice
  const float* entries;    // [labels, entry_stride] slot coefficients
  const int* tables;       // [2, 2 * kDepHalf] gather, scatter tables
  const unsigned char* phase_in;   // [2^w] gather phases (null: none)
  const unsigned char* phase_out;  // [2^w] scatter phases (null: none)
  int row_start, row_end;  // this segment's rows
  int entry_stride, n, w;
  int free_mask;           // the storage bits that number the tiles
  int vec;                 // floats a copy: 4 or 1
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// A tile-local index's offset from the tile's base: an affine map of its
// bits, so the XOR of its two 7-bit halves' entries.
__device__ __forceinline__ int offset_of(const int* tab, int i) {
  return tab[i & (kDepHalf - 1)] ^ tab[kDepHalf + (i >> kDepBits)];
}

// v's floats in the order that puts float k at k ^ c.
__device__ __forceinline__ float4 flip4(float4 v, int c) {
  if (c & 1) v = make_float4(v.y, v.x, v.w, v.z);
  if (c & 2) v = make_float4(v.z, v.w, v.x, v.y);
  return v;
}

// A signed permutation of a pair or a quad that swaps two members and
// leaves the others in place, with no phase (x, cx, swap): its two
// members a, b.  Uniform over the CTA (the code is the row's).
__device__ __forceinline__ bool swap_of(int code, int m, int& a, int& b) {
  a = b = -1;
  for (int r = 0; r < m; ++r) {
    const int nib = (code >> (4 * r)) & 15;
    if (nib >> 2) return false;  // a phase
    if ((nib & 3) == r) continue;
    if (b >= 0) return false;
    (a < 0 ? a : b) = r;
  }
  return b >= 0 && ((code >> (4 * a)) & 3) == b &&
         ((code >> (4 * b)) & 3) == a;
}

// The swap of members a and b of every pair (bit ja; mb = 0) or quad
// (bits ja, jb, ja the gate-index MSB) of the CTA's own tile: two loads
// and two stores a plane, where the generic permutation moves all
// members.
__device__ __forceinline__ void apply_swap(const View& v, float* own,
                                           int ja, int jb, bool quad, int a,
                                           int b) {
  const int ma = 1 << ja, mb = quad ? 1 << jb : 0;
  const int oa = ((a >> (quad ? 1 : 0)) & 1) * ma + (quad ? (a & 1) * mb : 0);
  const int ob = ((b >> (quad ? 1 : 0)) & 1) * ma + (quad ? (b & 1) * mb : 0);
  const int lo = quad ? min(ja, jb) : ja, hi = quad ? max(ja, jb) : ja;
  const int count = v.L >> (quad ? 2 : 1);
  const int L = v.L;
  for (int p = v.t; p < count; p += v.T) {
    const int base = quad ? insert_zero(insert_zero(p, lo), hi)
                          : insert_zero(p, lo);
    const int xa = base | oa, xb = base | ob;
    const float ar = own[xa], ai = own[L + xa];
    own[xa] = own[xb];
    own[L + xa] = own[L + xb];
    own[xb] = ar;
    own[L + xb] = ai;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
blocked_segment_kernel(Params p) {
  extern __shared__ __align__(16) float smem_tile[];  // re [L], then im [L]
  __shared__ int s_tab[4 * kDepHalf];  // gather table, then scatter

  const int T = kThreads, t = threadIdx.x;
  const long long N = 1LL << p.n;
  View v;  // the whole tile in this CTA
  v.L = 1 << p.w;
  v.T = T;
  v.t = t;
  v.split = -1;
  v.rank = 0;
  v.base[0] = v.base[1] = v.own = smem_tile;
  const long long tile = blockIdx.x;
  const int L = v.L;

  const int tile_bits = p.n - p.w;
  const long long lab = tile >> tile_bits;
  int tn = (int)(tile & ((1LL << tile_bits) - 1));
  int base = 0;  // the tile number's bits deposited into free_mask's
  for (int m = p.free_mask; m; m &= m - 1, tn >>= 1)
    if (tn & 1) base |= m & -m;
  for (int i = t; i < 4 * kDepHalf; i += T) s_tab[i] = p.tables[i];
  __syncthreads();
  const int* gather = s_tab;
  const int* scatter = s_tab + 2 * kDepHalf;

  const float* s = p.src + lab * p.src_stride + base;
  float* d = p.dst + lab * 2 * N + base;
  float* re = smem_tile;
  float* im = smem_tile + L;
  if (p.vec == 4) {
    for (int x = 4 * t; x < L; x += 4 * T) {
      const int off = offset_of(gather, x);
      cp_async16(re + x, s + off);
      cp_async16(im + x, s + N + off);
    }
  } else {
    for (int x = t; x < L; x += T) {
      const int off = offset_of(gather, x);
      cp_async4(re + x, s + off);
      cp_async4(im + x, s + N + off);
    }
  }
  cp_async_wait_all();
  if (p.phase_in != nullptr) {  // each thread its own copies' floats
    if (p.vec == 4) {
      for (int x = 4 * t; x < L; x += 4 * T) {
        const uchar4 ph =
            *reinterpret_cast<const uchar4*>(p.phase_in + x);
        rotate(re[x], im[x], ph.x);
        rotate(re[x + 1], im[x + 1], ph.y);
        rotate(re[x + 2], im[x + 2], ph.z);
        rotate(re[x + 3], im[x + 3], ph.w);
      }
    } else {
      for (int x = t; x < L; x += T) rotate(re[x], im[x], p.phase_in[x]);
    }
  }
  __syncthreads();

  const float* erow = p.entries + lab * p.entry_stride;
  for (int r = p.row_start; r < p.row_end; ++r) {
    const int* row = p.rows + kRow * r;
    const int kind = row[0], ja = row[1], jb = row[2];
    int a, b;
    if ((kind == kPerm1 || kind == kPerm2) &&
        swap_of(row[3], kind == kPerm1 ? 2 : 4, a, b)) {
      apply_swap(v, smem_tile, ja, jb, kind == kPerm2, a, b);
      __syncthreads();
      continue;
    }
    apply_row<true>(v, row, p.pool, erow, smem_tile);
  }

  // every row ended in a barrier: the tile is final
  if (p.probs != nullptr) {  // |psi|^2: a phase changes nothing
    float* pr = p.probs + lab * N + base;
    if (p.vec == 4) {
      for (int x = 4 * t; x < L; x += 4 * T) {
        const int off = offset_of(scatter, x), c = off & 3;
        const float4 a = *reinterpret_cast<const float4*>(re + x);
        const float4 b = *reinterpret_cast<const float4*>(im + x);
        *reinterpret_cast<float4*>(pr + (off ^ c)) = flip4(
            make_float4(a.x * a.x + b.x * b.x, a.y * a.y + b.y * b.y,
                        a.z * a.z + b.z * b.z, a.w * a.w + b.w * b.w),
            c);
      }
    } else {
      for (int x = t; x < L; x += T)
        pr[offset_of(scatter, x)] = re[x] * re[x] + im[x] * im[x];
    }
  } else if (p.vec == 4) {
    // float k of the 4 at x goes to off ^ k: one aligned group
    for (int x = 4 * t; x < L; x += 4 * T) {
      const int off = offset_of(scatter, x), c = off & 3;
      float4 a = *reinterpret_cast<const float4*>(re + x);
      float4 b = *reinterpret_cast<const float4*>(im + x);
      if (p.phase_out != nullptr) {
        const uchar4 ph =
            *reinterpret_cast<const uchar4*>(p.phase_out + x);
        rotate(a.x, b.x, ph.x);
        rotate(a.y, b.y, ph.y);
        rotate(a.z, b.z, ph.z);
        rotate(a.w, b.w, ph.w);
      }
      *reinterpret_cast<float4*>(d + (off ^ c)) = flip4(a, c);
      *reinterpret_cast<float4*>(d + N + (off ^ c)) = flip4(b, c);
    }
  } else {
    for (int x = t; x < L; x += T) {
      const int off = offset_of(scatter, x);
      float a = re[x], b = im[x];
      if (p.phase_out != nullptr) rotate(a, b, p.phase_out[x]);
      d[off] = a;
      d[N + off] = b;
    }
  }
}

size_t tile_smem(int w) { return (size_t)2 * sizeof(float) << w; }

}  // namespace

extern "C" int blocked_kernel_max_window() { return kMaxWindow; }

// Returns a cudaError_t: 0 on success.  The launch is refused with
// cudaErrorInvalidValue for a window outside [2, kMaxWindow] or n, or a
// copy width other than 4 or 1, and with cudaErrorInvalidConfiguration
// for a grid past 2^31 - 1 blocks.
extern "C" int blocked_segment_launch(
    const float* src, float* dst, float* probs, long long src_stride,
    const int* rows,
    const float* pool, const float* entries, const int* tables,
    const unsigned char* phase_in, const unsigned char* phase_out,
    int row_start, int row_end, int entry_stride, int n, int w,
    int free_mask, int vec, int labels, void* stream) {
  if (w < 2 || w > kMaxWindow || w > n || n > 30 || labels < 1 ||
      (vec != 4 && vec != 1) || row_start > row_end)
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)labels << (n - w);
  if (grid > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  Params p{src,     dst,       probs,     src_stride, rows,
           pool,    entries,   tables,    phase_in,   phase_out,
           row_start, row_end, entry_stride, n,       w,
           free_mask, vec};
  return (int)launch_clustered(blocked_segment_kernel, p, (int)grid, kThreads,
                               tile_smem(w), 1, stream);
}

extern "C" const char* blocked_kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
