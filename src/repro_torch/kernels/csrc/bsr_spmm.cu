// Hand-written Hopper (sm_90a) kernels of the port's accelerated-HITS sweep.
//
// bsr_spmm (K1) replaces the Pallas TPU kernel _bsr_kernel
// (src/repro/kernels/bsr_spmm.py, launched by _bsr_scaled_matvec):
//     y = (A_bsr @ (x * cin)) * mask
// over the nonzero (BS x BS) blocks of A, sorted by block row.
// links_spmm (K1's link form) takes K1's place on the whole-crawl sweep
// (kernels/ops.py::hits_sweep_bsr), whose operators are 0/1 link lists in
// the crawl's own numbering: see its note below K1.
//
// The sweep epilogue (ep_slice_kernel + ep_finish_kernel) is the per-sweep
// body of the TPU loop bsr_converge_cols (same file) after its two K1
// calls: per column, L1-normalize the new hub vector (eps 1e-30), take the
// residual against the old one, apply the optional top-k rank-stability
// rule, and update conv / the sweep count / the stop flag. K2 runs the
// whole loop as one CUDA graph (k2_graph_build, at the end of this file).
// pm_graph_build puts the same kind of WHILE node around a caller's
// captured sweeps: core.power.power_method_jit on the card.
//
// What bounds them on the H100: K1 reads every stored block once per call
// (an f64 main-path operator is ~43 MB against 50 MB of L2), so it is
// memory bound; x * cin is tiny by comparison. The TPU walked a block
// row's blocks in grid order. A port that gives one CTA a block row (the
// first version) keeps one tile in flight per SM and is bound by latency
// and by its densest block row: the blocking permutation packs the graph's
// hubs into a few block rows. The epilogue touches O(n_pad * V) values and
// is launch/latency bound: it runs one CTA per slice of rows.
//
// K1 design: parallel over blocks, then an in-order fold.
// * One CTA of 128 threads per (nonzero block, slice of RB = 32 rows). It
//   copies its RB x BS slice of the block (contiguous in the row-major
//   block, 32 KB in f64) into shared memory with 16-byte cp.async copies
//   and stages x * cin of the block's columns (as f64) meanwhile. Shared
//   memory is kept to ~40 KB (f64, V 8), so several CTAs, each with a
//   tile in flight, share an SM.
// * Each row's product with the block is G = 4 partial f64 sums of 32
//   columns in column order, added in a fixed order: the same order for
//   every row, so equal rows give equal sums and exact ties in the
//   authority vector stay ties (the rank-stability rule reads them). The
//   tile's 16-byte chunks are swizzled by row as they land, so the 32 rows
//   of a warp that read one column read different banks.
// * Rounding follows the Pallas kernel, not the f32 oracle: x * cin is
//   rounded to x's dtype, the block product accumulates in f64 (f64) or
//   f32 (f32, bf16), and each block's product P_k is rounded to y's dtype.
//   The f32 accumulator's value is the f32 rounding of a sum kept in f64
//   (products of f32 or bf16 values are exact in f64). No tensor cores, so
//   no TF32.
// * P_k goes to the workspace ws (nblocks, VT, BS) in y's dtype (rows
//   fastest, so the stores and the fold's loads are coalesced). The last
//   CTA to finish a (block row, slice) - __threadfence, then an atomicAdd
//   on cnt[brow * slices + slice], and the CTA that sees nb - 1 - adds the
//   row's P_k in idx order into 0, each add rounded to y's dtype (a bf16
//   running sum in the ladder's bulk phase), applies the mask, writes y
//   once and resets the counter to 0. No CTA waits for another. A block
//   row of one block writes y directly. Each P_k is rounded before the
//   in-order add, so the parallel schedule changes no bit of the result.
// * Block rows without blocks come out 0 * mask: the CTAs of the first
//   block after them (and of the last block) write them.
// * K1 takes an optional device flag `active`; with *active == 0 every CTA
//   returns at once and leaves the counters at 0 (null inside the K2 graph).
//   Inside the K2 graph, where the host launches nothing itself, each launch
//   adds one to a device counter `launches` (null outside the graph).
//
// Plain C interface (loaded with ctypes); every launcher launches on the
// stream it is given, allocates nothing, and returns its CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

enum DType { kF64 = 0, kF32 = 1, kBF16 = 2 };

template <typename T> struct Num;
template <> struct Num<double> {
  using Acc = double;
  __device__ static double to_acc(double v) { return v; }
  __device__ static double from_acc(double v) { return v; }
};
template <> struct Num<float> {
  using Acc = float;
  __device__ static float to_acc(float v) { return v; }
  __device__ static float from_acc(float v) { return v; }
};
template <> struct Num<__nv_bfloat16> {
  using Acc = float;
  __device__ static float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 from_acc(float v) { return __float2bfloat16_rn(v); }
};

// an accumulator value rounded to T's precision (and widened back)
template <typename T>
__device__ __forceinline__ typename Num<T>::Acc rnd(typename Num<T>::Acc v) {
  return Num<T>::to_acc(Num<T>::from_acc(v));
}

// ------------------------------------------------------------------- K1

constexpr int K1_THREADS = 128;

template <typename T, int BS, int VT>
struct K1Shape {
  using A = typename Num<T>::Acc;
  static constexpr int RB = BS < 32 ? BS : 32;   // output rows per CTA
  static constexpr int G = K1_THREADS / RB;      // partial sums per row
  static constexpr int JG = BS / G;              // block columns per partial
  static constexpr int EC = 16 / (int)sizeof(T);  // elements of a 16-byte chunk
  static constexpr int RC = BS / EC;               // chunks of a tile row
  static constexpr int SW = (RC < 8 ? RC : 8) - 1;  // chunk swizzle of a row
  static constexpr size_t tile_bytes = sizeof(T) * RB * BS;
  static constexpr size_t red_bytes = sizeof(double) * G * RB * VT;
  static constexpr size_t region = tile_bytes > red_bytes ? tile_bytes : red_bytes;
  // the tile and the partial sums share a region (one after the other);
  // then x * cin as f64
  static constexpr size_t smem = region + sizeof(double) * BS * VT;
  // where column j of tile row r lies: 16-byte chunks of a row swapped by
  // (r & SW), so the rows of a warp that read one column hit different banks
  __device__ static int at(int r, int j) {
    return r * BS + (((j / EC) ^ (r & SW)) * EC) + j % EC;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

template <typename T> __device__ __forceinline__ T ldcg1(const T* p) { return __ldcg(p); }
template <> __device__ __forceinline__ __nv_bfloat16 ldcg1(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// (row, column) of y: the row's sum rounded, masked and stored
template <typename T>
__device__ __forceinline__ void k1_store(typename Num<T>::Acc out, const T* mask,
                                         T* y, long e) {
  if (mask != nullptr) out = rnd<T>(out * Num<T>::to_acc(mask[e]));
  y[e] = Num<T>::from_acc(out);
}

// one CTA per (nonzero block kk, slice of RB rows): P = rnd_T(block rows
// @ xs) into the workspace; the last CTA of (block row, slice) adds its
// row's P in idx order and writes y
template <typename T, int BS, int VT>
__global__ void __launch_bounds__(K1_THREADS)
bsr_spmm_kernel(const T* __restrict__ blocks, const int* __restrict__ idx,
                const int* __restrict__ row_ptr, int nblocks, int n_brows,
                const T* __restrict__ x, const T* __restrict__ cin,
                int cin_cols, const T* __restrict__ mask, T* __restrict__ y,
                int ld, int col0, int v, T* __restrict__ ws,
                int* __restrict__ cnt, const int* __restrict__ active,
                unsigned long long* __restrict__ launches) {
  using S = K1Shape<T, BS, VT>;
  using A = typename S::A;
  constexpr int RB = S::RB, G = S::G, JG = S::JG, EC = S::EC, RC = S::RC;
  constexpr int SLICES = BS / RB;
  if (active != nullptr && *active == 0) return;
  if (launches != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    atomicAdd(launches, 1ULL);
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);            // [RB][BS], swizzled
  double* red = reinterpret_cast<double*>(smem_raw);   // [G][VT][RB], after the tile
  double* xs = reinterpret_cast<double*>(smem_raw + S::region);  // [BS][VT]
  __shared__ bool is_last;

  const int slice = blockIdx.y;
  const int row0 = slice * RB;  // first row of the block this CTA takes
  const int t = threadIdx.x;

  if (nblocks == 0) {  // no block at all: every row is 0 * mask
    for (int e = t; e < n_brows * RB * VT; e += K1_THREADS) {
      const int br = e / (RB * VT), r = (e / VT) % RB, c = e % VT;
      if (c < v) k1_store<T>(A(0), mask, y, ((long)br * BS + row0 + r) * ld + col0 + c);
    }
    return;
  }
  const int kk = blockIdx.x;
  // the block's RB x BS slice is contiguous: 16-byte cp.async copies,
  // issued first
  const T* blk = blocks + (long)kk * BS * BS + (long)row0 * BS;
  for (int q = t; q < RB * RC; q += K1_THREADS) {
    const int r = q / RC;
    cp_async16(tile + S::at(r, (q % RC) * EC), blk + (long)q * EC);
  }
  asm volatile("cp.async.commit_group;\n");
  const int brow = idx[2 * kk];
  const long bc = idx[2 * kk + 1];
  const int kb = row_ptr[brow], nb = row_ptr[brow + 1] - kb;
  // meanwhile x * cin of the block's columns, rounded to x's dtype (all
  // loads in flight at once; 16 bytes a load where the columns allow it)
  constexpr int EV = VT % EC == 0 ? EC : 1;  // values of x per 16 bytes
  if (EV > 1 && v == VT && ld % EV == 0 && col0 % EV == 0 && aligned16(x) &&
      (cin_cols == 1 || aligned16(cin))) {
    constexpr int NP = VT / EV;  // loads per row
#pragma unroll
    for (int e = t; e < BS * NP; e += K1_THREADS) {
      const int j = e / NP, c0 = (e % NP) * EV;
      const long row = bc * BS + j;
      const uint4 xr = *reinterpret_cast<const uint4*>(x + row * ld + col0 + c0);
      const T* xv = reinterpret_cast<const T*>(&xr);
      if (cin_cols == 1) {
        const A cv = Num<T>::to_acc(cin[row]);
#pragma unroll
        for (int u = 0; u < EV; ++u) xs[j * VT + c0 + u] = (double)rnd<T>(Num<T>::to_acc(xv[u]) * cv);
      } else {
        const uint4 cr = *reinterpret_cast<const uint4*>(cin + row * ld + col0 + c0);
        const T* cv = reinterpret_cast<const T*>(&cr);
#pragma unroll
        for (int u = 0; u < EV; ++u) {
          xs[j * VT + c0 + u] = (double)rnd<T>(Num<T>::to_acc(xv[u]) * Num<T>::to_acc(cv[u]));
        }
      }
    }
  } else {
#pragma unroll
    for (int e = t; e < BS * VT; e += K1_THREADS) {
      const int j = e / VT, c = e % VT;
      A val = A(0);
      if (c < v) {
        const long row = bc * BS + j;
        const A xv = Num<T>::to_acc(x[row * ld + col0 + c]);
        const A cv = Num<T>::to_acc(cin[cin_cols == 1 ? row : row * ld + col0 + c]);
        val = rnd<T>(xv * cv);
      }
      xs[e] = (double)val;
    }
  }
  asm volatile("cp.async.wait_all;\n");
  __syncthreads();

  // thread (r, g): partial dot product of row r over block columns
  // g*JG .. g*JG+JG-1 in column order, the same order for every row (rows
  // that are equal give equal sums, so exact ties stay ties)
  const int r = t % RB, g = t / RB;
  double part[VT];
#pragma unroll
  for (int c = 0; c < VT; ++c) part[c] = 0.0;
  if constexpr (JG % EC == 0) {  // a 16-byte chunk per read
#pragma unroll 2
    for (int jc = 0; jc < JG; jc += EC) {
      const int j0 = g * JG + jc;
      const uint4 raw = *reinterpret_cast<const uint4*>(tile + S::at(r, j0));
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < EC; ++u) {
        const double bv = (double)Num<T>::to_acc(vals[u]);
        if constexpr (VT % 2 == 0) {  // x * cin of column j0 + u, 16 bytes a read
          const double2* xr = reinterpret_cast<const double2*>(xs + (j0 + u) * VT);
#pragma unroll
          for (int c = 0; c < VT; c += 2) {
            const double2 xv = xr[c / 2];
            part[c] = fma(bv, xv.x, part[c]);
            part[c + 1] = fma(bv, xv.y, part[c + 1]);
          }
        } else {
#pragma unroll
          for (int c = 0; c < VT; ++c) part[c] = fma(bv, xs[(j0 + u) * VT + c], part[c]);
        }
      }
    }
  } else {
    for (int jj = 0; jj < JG; ++jj) {
      const int j = g * JG + jj;
      const double bv = (double)Num<T>::to_acc(tile[S::at(r, j)]);
#pragma unroll
      for (int c = 0; c < VT; ++c) part[c] = fma(bv, xs[j * VT + c], part[c]);
    }
  }
  __syncthreads();  // the tile's space becomes red
#pragma unroll
  for (int c = 0; c < VT; ++c) red[(g * VT + c) * RB + r] = part[c];
  __syncthreads();
  // (row rr, column c) of the slice per thread, rows fastest: the G
  // partial sums added in order, rounded once to y's dtype
  for (int e = t; e < RB * VT; e += K1_THREADS) {
    const int rr = e % RB, c = e / RB;
    double s = red[c * RB + rr];
#pragma unroll
    for (int q = 1; q < G; ++q) s += red[(q * VT + c) * RB + rr];
    const A p = rnd<T>((A)s);  // the block's product P_k
    if (nb == 1) {
      if (c < v) k1_store<T>(rnd<T>(A(0) + p), mask, y, ((long)brow * BS + row0 + rr) * ld + col0 + c);
    } else {
      ws[((long)kk * VT + c) * BS + row0 + rr] = Num<T>::from_acc(p);
    }
  }
  // blocks rows without blocks: 0 * mask, written by the CTAs of the
  // first block after them (and of the last block for the rows after it)
  const int gap0 = kk == kb ? (kk > 0 ? idx[2 * (kk - 1)] + 1 : 0) : brow;
  const int gap1 = kk == nblocks - 1 ? n_brows : 0;
  for (int br = gap0; br < brow; ++br) {
    for (int e = t; e < RB * VT; e += K1_THREADS) {
      if (e % VT < v) k1_store<T>(A(0), mask, y, ((long)br * BS + row0 + e / VT) * ld + col0 + e % VT);
    }
  }
  for (int br = brow + 1; br < gap1; ++br) {
    for (int e = t; e < RB * VT; e += K1_THREADS) {
      if (e % VT < v) k1_store<T>(A(0), mask, y, ((long)br * BS + row0 + e / VT) * ld + col0 + e % VT);
    }
  }
  if (nb == 1) return;

  // the last CTA of (block row, slice) adds the row's products in idx
  // order into 0, each add in y's dtype, and writes y once
  __threadfence();
  __syncthreads();
  int* counter = cnt + (long)brow * SLICES + slice;
  if (t == 0) is_last = atomicAdd(counter, 1) == nb - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // (row rr, column c) per thread, rows fastest (coalesced), eight
  // blocks' loads in flight, each add in order
  const long step = (long)VT * BS;  // from one block's P to the next
  for (int e = t; e < RB * VT; e += K1_THREADS) {
    const int rr = e % RB, c = e / RB;
    if (c >= v) continue;
    const T* wp = ws + ((long)kb * VT + c) * BS + row0 + rr;
    A out = A(0);
    int q = 0;
    for (; q + 8 <= nb; q += 8) {
      T p8[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) p8[w] = ldcg1(wp + (q + w) * step);
#pragma unroll
      for (int w = 0; w < 8; ++w) out = rnd<T>(out + Num<T>::to_acc(p8[w]));
    }
    for (; q < nb; ++q) out = rnd<T>(out + Num<T>::to_acc(ldcg1(wp + q * step)));
    k1_store<T>(out, mask, y, ((long)brow * BS + row0 + rr) * ld + col0 + c);
  }
  if (t == 0) *counter = 0;
}


// K1's dynamic shared memory above the 48 KB default is an attribute of the
// kernel, set once outside any stream capture
template <typename T, int BS, int VT>
cudaError_t k1_attr() {
  using S = K1Shape<T, BS, VT>;
  if (S::smem + 1024 <= 48 * 1024) return cudaSuccess;  // the static is_last flag counts too
  return cudaFuncSetAttribute(bsr_spmm_kernel<T, BS, VT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::smem);
}

template <typename T, int BS, int VT>
cudaError_t launch_k1(const void* blocks, const int* idx, const int* row_ptr,
                      int nblocks, int n_brows, const void* x, const void* cin,
                      int cin_cols, const void* mask, void* y, int ld,
                      int col0, int v, void* ws, int* cnt, const int* active,
                      unsigned long long* launches, cudaStream_t stream) {
  using S = K1Shape<T, BS, VT>;
  dim3 grid(nblocks > 0 ? nblocks : 1, BS / S::RB);
  bsr_spmm_kernel<T, BS, VT><<<grid, K1_THREADS, S::smem, stream>>>(
      static_cast<const T*>(blocks), idx, row_ptr, nblocks, n_brows,
      static_cast<const T*>(x), static_cast<const T*>(cin), cin_cols,
      static_cast<const T*>(mask), static_cast<T*>(y), ld, col0, v,
      static_cast<T*>(ws), cnt, active, launches);
  return cudaGetLastError();
}

template <typename T> struct Tag { using type = T; };
template <int N> using Int = std::integral_constant<int, N>;

// f(Tag<T>, Int<BS>, Int<VT>) for the K1 instance of (dtype, bs, vt)
template <typename T, int BS, typename F>
cudaError_t k1_vt(int vt, F&& f) {
  switch (vt) {
    case 1: return f(Tag<T>(), Int<BS>(), Int<1>());
    case 2: return f(Tag<T>(), Int<BS>(), Int<2>());
    case 4: return f(Tag<T>(), Int<BS>(), Int<4>());
    case 8: return f(Tag<T>(), Int<BS>(), Int<8>());
    case 16: return f(Tag<T>(), Int<BS>(), Int<16>());
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename F>
cudaError_t k1_bs(int bs, int vt, F&& f) {
  switch (bs) {
    case 16: return k1_vt<T, 16>(vt, f);
    case 32: return k1_vt<T, 32>(vt, f);
    case 64: return k1_vt<T, 64>(vt, f);
    case 128: return k1_vt<T, 128>(vt, f);
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t k1_dispatch(int dtype, int bs, int vt, F&& f) {
  switch (dtype) {
    case kF64: return k1_bs<double>(bs, vt, f);
    case kF32: return k1_bs<float>(bs, vt, f);
    case kBF16: return k1_bs<__nv_bfloat16>(bs, vt, f);
    default: return cudaErrorInvalidValue;
  }
}

constexpr int V_GROUP = 16;  // widest column group of one K1 launch

int vt_of(int v) {
  int vt = 1;
  while (vt < v) vt *= 2;
  return vt;
}

// one K1 column group: set the shared-memory attribute (attr_only) or launch
int k1_group(int dtype, int bs, const void* blocks, const int* idx,
             const int* row_ptr, int nblocks, int n_brows, const void* x,
             const void* cin, int cin_cols, const void* mask, void* y, int ld,
             int col0, int v, void* ws, int* cnt, const int* active,
             unsigned long long* launches, cudaStream_t s, bool attr_only) {
  if (nblocks < 0 || n_brows <= 0) return cudaErrorInvalidValue;
  return k1_dispatch(dtype, bs, vt_of(v), [&](auto tag, auto b, auto w) {
    using T = typename decltype(tag)::type;
    constexpr int BS = decltype(b)::value, VT = decltype(w)::value;
    if (attr_only) return k1_attr<T, BS, VT>();
    return launch_k1<T, BS, VT>(blocks, idx, row_ptr, nblocks, n_brows, x,
                                cin, cin_cols, mask, y, ld, col0, v, ws, cnt,
                                active, launches, s);
  });
}

// ------------------------------------------------------ K1, link form
//
// links_spmm_kernel replaces, on the whole-crawl sweep only, what the
// reference runs there: _bsr_kernel through its hits_sweep_bsr, over the
// crawl's 0/1 link matrix stored as dense 128 x 128 blocks. Its operand
// is the matrix as what it is, a list of links in the crawl's own
// numbering: ptr (n + 1) int32 offsets and cols, one int32 column a link,
// sorted by row and by column within a row. It computes
//     y[i, c] = sum over the links (i, j) of rnd_T(x[j, c] * cin[j, c'])
// (c' = c, or 0 for a shared (n, 1) cin). It is no block kernel: the
// sweep's operators carry no values (Ca, Ch are vectors), a block of a
// whole crawl is ~0.5 % full, and a sparse product uses no tensor cores.
//
// Bound: bytes. The index stream (4 B a link, plus ptr) is read once; the
// gathered x and cin (169 KB and 272 KB each on the crawl cells) stay in
// the 50 MB L2. No workspace, no fold, no atomics. On an H100 it takes
// ~20 us a launch on britannica-bb's 1.84 M links (12 % of the byte bound:
// two 8-byte gathers a link from L2) and ~8.5 us on yahoo-bb's.
//
// Work split, fixed by the operator at build time (ops.link_operand):
// `lanes` (1 to 32, a power of two) lanes take a row; a CTA of
// KL_THREADS takes KL_THREADS / lanes consecutive rows. A row with more
// than KL_ROUNDS * lanes links (a hub) is "long": its own CTA takes it, all
// KL_THREADS threads (long_rows lists them), and the row's group of lanes
// skips it. So a row's lanes add at most KL_ROUNDS (32) links each, a long
// row's threads links / KL_THREADS each (31 for the largest hub of the
// crawl cells, 7,790 links), and no hub holds a wave back.
//
// Order: a thread adds its links (every lanes-th, or KL_THREADS-th, of
// the row) in link order into an f64 sum; the lanes then add by a fixed
// xor butterfly, a long row's warps in warp order. The order depends on
// the row's length and the operator alone, so two launches give the same
// bits and rows with equal links give equal sums (ties in the authority
// vector stay ties). Each term is x * cin rounded to T (x's dtype), as
// K1 rounds it; the sum is kept in f64 and rounded once to T.
// kernels/bsr_spmm.py::links_scaled_matvec_plain repeats this order.

constexpr int KL_THREADS = 256;
constexpr int KL_ROUNDS = 32;  // links a lane takes at most (long rows aside)

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }

// a value of T from the f64 sum, rounded once (bf16 through f32, as
// torch's conversion from f64 goes)
template <typename T> __device__ __forceinline__ T from_f64(double s) { return (T)s; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f64(double s) {
  return __float2bfloat16_rn((float)s);
}

// rnd_T(x[j, c] * cin[j, c']) as f64; the product is not fused into the sum
template <typename T>
__device__ __forceinline__ double kl_term(const T* __restrict__ x, const T* __restrict__ cin,
                                          int cin_cols, int v, long j, int c) {
  const typename Num<T>::Acc xv = Num<T>::to_acc(x[j * v + c]);
  const typename Num<T>::Acc cv = Num<T>::to_acc(cin[cin_cols == 1 ? j : j * v + c]);
  return (double)rnd<T>(mul_rn(xv, cv));
}

// the f64 sum of links [k0, k1) of every step-th link from k0, in link
// order, four loads in flight
template <typename T>
__device__ __forceinline__ double kl_sum(const int* __restrict__ cols, int k0, int k1, int step,
                                         const T* __restrict__ x, const T* __restrict__ cin,
                                         int cin_cols, int v, int c) {
  double s = 0.0;
  int k = k0;
  for (; k + 3 * step < k1; k += 4 * step) {
    const int j0 = __ldg(cols + k), j1 = __ldg(cols + k + step);
    const int j2 = __ldg(cols + k + 2 * step), j3 = __ldg(cols + k + 3 * step);
    const double t0 = kl_term(x, cin, cin_cols, v, j0, c);
    const double t1 = kl_term(x, cin, cin_cols, v, j1, c);
    const double t2 = kl_term(x, cin, cin_cols, v, j2, c);
    const double t3 = kl_term(x, cin, cin_cols, v, j3, c);
    s += t0;
    s += t1;
    s += t2;
    s += t3;
  }
  for (; k < k1; k += step) s += kl_term(x, cin, cin_cols, v, __ldg(cols + k), c);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(KL_THREADS)
links_spmm_kernel(const int* __restrict__ ptr, const int* __restrict__ cols,
                  const int* __restrict__ long_rows, int n_long, int n, int lanes,
                  const T* __restrict__ x, const T* __restrict__ cin, int cin_cols,
                  T* __restrict__ y, int v) {
  __shared__ double red[KL_THREADS / 32];
  const int t = threadIdx.x;
  if ((int)blockIdx.x < n_long) {  // one long row, the whole CTA
    const int row = long_rows[blockIdx.x];
    const int k0 = ptr[row], k1 = ptr[row + 1];
    for (int c = 0; c < v; ++c) {
      double s = kl_sum(cols, k0 + t, k1, KL_THREADS, x, cin, cin_cols, v, c);
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (t % 32 == 0) red[t / 32] = s;
      __syncthreads();
      if (t == 0) {
        double tot = 0.0;
        for (int w = 0; w < KL_THREADS / 32; ++w) tot += red[w];
        y[(long)row * v + c] = from_f64<T>(tot);
      }
      __syncthreads();
    }
    return;
  }
  // rows of `lanes` lanes each; every lane of the warp reaches the shuffles
  const int row = (blockIdx.x - n_long) * (KL_THREADS / lanes) + t / lanes;
  const int lane = t % lanes;
  int k0 = 0, k1 = 0;
  if (row < n) {
    k0 = ptr[row];
    k1 = ptr[row + 1];
  }
  const bool mine = row < n && k1 - k0 <= KL_ROUNDS * lanes;  // else its own CTA writes it
  if (!mine) k1 = k0;
  for (int c = 0; c < v; ++c) {
    double s = kl_sum(cols, k0 + lane, k1, lanes, x, cin, cin_cols, v, c);
    for (int o = lanes / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (mine && lane == 0) y[(long)row * v + c] = from_f64<T>(s);
  }
}

template <typename T>
cudaError_t launch_links(const int* ptr, const int* cols, const int* long_rows, int n_long,
                         int n, int lanes, const void* x, const void* cin, int cin_cols, void* y,
                         int v, cudaStream_t s) {
  const int per_cta = KL_THREADS / lanes;
  const int grid = n_long + (n + per_cta - 1) / per_cta;
  if (grid == 0) return cudaSuccess;
  links_spmm_kernel<T><<<grid, KL_THREADS, 0, s>>>(
      ptr, cols, long_rows, n_long, n, lanes, static_cast<const T*>(x),
      static_cast<const T*>(cin), cin_cols, static_cast<T*>(y), v);
  return cudaGetLastError();
}

// ------------------------------------------------------- sweep epilogue
//
// One sweep's epilogue (mode 0) or the certificate (mode 1) as two
// launches, each one CTA per slice of `rows` rows covering all V columns:
// (a) ep_slice_kernel writes the slice's f64 sums of |hr| (and of |a| for
//     the certificate) per column, and with rank_k > 0 its local top-k of a
//     per column in the order (value descending, index ascending);
// (b) ep_finish_kernel adds (a)'s sums over the slices in a fixed order (the
//     denominator), writes hn = hr / den into h (mode 0; mode 1 normalizes a
//     instead) and the slice's sums of |hn - h|. The last CTA to finish
//     (__threadfence + a counter it resets) adds those over the slices,
//     merges the slices' top-k lists (a total order, so the schedule cannot
//     change the result) and updates stab/top/stop/conv/k, the stop flag
//     and, inside the K2 graph, the WHILE node's condition. Inside the
//     graph each launch adds one to a device counter (`launches`).
// The (n, V) arrays are row-major, so a slice is one contiguous run of
// rows * V values: 16-byte loads, a thread's EC slots keep their columns
// from one chunk to the next (ep_loaders). Sums stay in f64 and are rounded
// once through the accumulator type, so they do not depend on the slicing
// beyond f64 rounding, and the plain versions in bsr_spmm.py are the oracle.

constexpr int EP_THREADS = 256;
constexpr int EP_WARPS = EP_THREADS / 32;
constexpr int EP_MAXV = 256;  // columns the epilogue takes
constexpr int EP_HEADS = 4;   // slices per lane in the top-k merge (<= 128 slices)
constexpr int EP_RL = 4;      // rows of a slice per lane kept in registers for its top-k

struct EpArgs {
  const void* hr;
  void* h;
  void* a;
  int* ctl;           // [stop flag, sweep count k]; mode 0 only
  int* cnt;           // finished CTAs of (b), 0 between launches
  int* conv;
  int* stop;
  int* stab;
  int* top;           // (V, rank_k)
  double* delta;      // (V,) this sweep's residual / the certificate
  double* part;       // (3, nslices, V) slice sums of |hr|, |a|, |hn - h|
  double* cand_v;     // (nslices, V, rank_k) slice top-k: values
  int* cand_i;        //   and indices
  unsigned long long* launches;  // kernels launched (null: not counted)
  unsigned long long cond;  // the WHILE node's handle (has_cond)
  double tol;
  long long max_iter, stable;
  int n, V, rows, nslices, rank_k, mode, has_cond;
};

__device__ __forceinline__ void ep_count(const EpArgs& p) {
  if (p.launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(p.launches, 1ULL);
}

__device__ __forceinline__ int gcd_i(int a, int b) {
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

// threads that load: the largest multiple of V / gcd(V, EC) up to
// EP_THREADS, so that B * EC is a multiple of V and slot u of thread t holds
// column (t * EC + u) % V in every chunk t, t + B, ...
template <int EC>
__device__ __forceinline__ int ep_loaders(int V) {
  const int m = V / gcd_i(V, EC);
  return (EP_THREADS / m) * m;
}

template <typename T, int EC>
__device__ __forceinline__ void ld_chunk(const T* p, int rel, int count,
                                         bool vec, T (&v)[EC]) {
  if (vec && rel + EC <= count) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + rel);
    const T* r = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < EC; ++u) v[u] = r[u];
  } else {
#pragma unroll
    for (int u = 0; u < EC; ++u) {
      v[u] = rel + u < count ? p[rel + u] : Num<T>::from_acc(typename Num<T>::Acc(0));
    }
  }
}

template <typename T, int EC>
__device__ __forceinline__ void st_chunk(T* p, int rel, int count, bool vec,
                                         const T (&v)[EC]) {
  if (vec && rel + EC <= count) {
    uint4 raw;
    T* r = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int u = 0; u < EC; ++u) r[u] = v[u];
    *reinterpret_cast<uint4*>(p + rel) = raw;
  } else {
#pragma unroll
    for (int u = 0; u < EC; ++u) {
      if (rel + u < count) p[rel + u] = v[u];
    }
  }
}

// (value, index) ordered by value descending, then index ascending: the
// order lax.top_k returns, lowest index first among equal values
template <typename A>
__device__ __forceinline__ bool before(A v, int i, A bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// the first of a warp's (value, index) pairs in that total order, on every lane
template <typename A>
__device__ __forceinline__ void warp_first(A& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const A ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// per column c, the sum of the CTA's slot partials red[c + j * V]: warp w
// takes columns w, w + EP_WARPS, ...; lane l adds j = l, l + 32, ... in order,
// then a fixed shuffle tree; lane 0 writes out[c]
__device__ void ep_column_sums(const double* red, int slots, int V, double* out) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int per = slots / V;
  for (int c = w; c < V; c += EP_WARPS) {
    double s = 0.0;
    for (int j = lane; j < per; j += 32) s += red[c + j * V];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) out[c] = s;
  }
}

// the same over the slices' sums part[s * V + c], written by other CTAs;
// every lane of the warp gets the total
__device__ double ep_slices_sum(const double* part, int nslices, int V, int c) {
  const int lane = threadIdx.x % 32;
  double s = 0.0;
  for (int j = lane; j < nslices; j += 32) s += __ldcg(part + (long)j * V + c);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  return __shfl_sync(0xffffffffu, s, 0);
}

template <typename T>
__global__ void __launch_bounds__(EP_THREADS) ep_slice_kernel(EpArgs p) {
  using A = typename Num<T>::Acc;
  constexpr int EC = 16 / (int)sizeof(T);
  if (p.mode == 0 && !p.has_cond && p.ctl[0] == 0) return;
  ep_count(p);
  __shared__ double red[EP_THREADS * EC];
  const int s = blockIdx.x, t = threadIdx.x, V = p.V;
  const int r0 = s * p.rows, r1 = min(p.n, r0 + p.rows);
  const int count = (r1 - r0) * V;
  const long base = (long)r0 * V;
  const int B = ep_loaders<EC>(V);
  for (int pass = 0; pass < (p.mode == 1 ? 2 : 1); ++pass) {
    const T* x = static_cast<const T*>(pass == 0 ? p.hr : p.a) + base;
    const bool vec = aligned16(x);
    double acc[EC];
#pragma unroll
    for (int u = 0; u < EC; ++u) acc[u] = 0.0;
    if (t < B) {
      for (int q = t; q * EC < count; q += B) {
        T v[EC];
        ld_chunk<T, EC>(x, q * EC, count, vec, v);
#pragma unroll
        for (int u = 0; u < EC; ++u) acc[u] += fabs((double)Num<T>::to_acc(v[u]));
      }
    }
    __syncthreads();  // red may still be read by the previous pass
    if (t < B) {
#pragma unroll
      for (int u = 0; u < EC; ++u) red[t * EC + u] = acc[u];
    }
    __syncthreads();
    ep_column_sums(red, B * EC, V, p.part + ((long)pass * p.nslices + s) * V);
  }
  if (p.mode == 1 || p.rank_k == 0) return;
  // the slice's top-k of a per column, as its list (value descending,
  // index ascending; (-inf, INT_MAX) past the slice's rows): k rounds of
  // the warp's first row strictly after the previous pick, a lane holding
  // its first EP_RL rows in registers
  const T* a = static_cast<const T*>(p.a);
  const int lane = t % 32, w = t / 32;
  for (int c = w; c < V; c += EP_WARPS) {
    A av[EP_RL];
#pragma unroll
    for (int j = 0; j < EP_RL; ++j) {
      const int r = r0 + lane + 32 * j;
      av[j] = r < r1 ? Num<T>::to_acc(a[(long)r * V + c]) : A(0);
    }
    A pv = INFINITY;
    int pi = -1;
    for (int q = 0; q < p.rank_k; ++q) {
      A bv = -INFINITY;
      int bi = INT_MAX;
#pragma unroll
      for (int j = 0; j < EP_RL; ++j) {
        const int r = r0 + lane + 32 * j;
        const bool after = av[j] < pv || (av[j] == pv && r > pi);
        if (r < r1 && after && before(av[j], r, bv, bi)) {
          bv = av[j];
          bi = r;
        }
      }
      for (int r = r0 + 32 * EP_RL + lane; r < r1; r += 32) {
        const A v = Num<T>::to_acc(a[(long)r * V + c]);
        const bool after = v < pv || (v == pv && r > pi);
        if (after && before(v, r, bv, bi)) {
          bv = v;
          bi = r;
        }
      }
      warp_first(bv, bi);
      if (lane == 0) {
        const long e = ((long)s * V + c) * p.rank_k + q;
        p.cand_v[e] = (double)bv;
        p.cand_i[e] = bi;
      }
      pv = bv;
      pi = bi;
    }
  }
}

// entry q of slice s's candidate list for column c, (-inf, INT_MAX) past
// the lists
__device__ __forceinline__ void ep_cand(const EpArgs& p, int s, int c, int q,
                                        double& v, int& i) {
  v = -INFINITY;
  i = INT_MAX;
  if (s < p.nslices && q < p.rank_k) {
    const long e = ((long)s * p.V + c) * p.rank_k + q;
    v = __ldcg(p.cand_v + e);
    i = __ldcg(p.cand_i + e);
  }
}

// column c's top-k over the slices' sorted candidate lists (a k-way merge:
// lane l holds the heads of slices l, l + 32, ... and the entry after each
// head, loaded a round ahead), written to top[c]; returns (on every lane)
// whether it equals the previous top-k
__device__ bool ep_merge_topk(const EpArgs& p, int c) {
  const int lane = threadIdx.x % 32, k = p.rank_k;
  int* top = p.top + (long)c * k;
  const int old = lane < k ? top[lane] : 0;  // the previous top-k's first 32
  int pos[EP_HEADS], hi[EP_HEADS], ni[EP_HEADS];
  double hv[EP_HEADS], nv[EP_HEADS];
#pragma unroll
  for (int j = 0; j < EP_HEADS; ++j) {
    pos[j] = 0;
    ep_cand(p, lane + 32 * j, c, 0, hv[j], hi[j]);
    ep_cand(p, lane + 32 * j, c, 1, nv[j], ni[j]);
  }
  bool same = true;
  for (int q = 0; q < k; ++q) {
    double bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < EP_HEADS; ++j) {
      if (before(hv[j], hi[j], bv, bi)) {
        bv = hv[j];
        bi = hi[j];
      }
    }
    warp_first(bv, bi);
#pragma unroll
    for (int j = 0; j < EP_HEADS; ++j) {
      if (bi != INT_MAX && hi[j] == bi) {  // indices are unique: the winner's list moves on
        hv[j] = nv[j];
        hi[j] = ni[j];
        ep_cand(p, lane + 32 * j, c, ++pos[j] + 1, nv[j], ni[j]);
      }
    }
    const int prev = q < 32 ? __shfl_sync(0xffffffffu, old, q) : top[q];
    same = same && prev == bi;
    __syncwarp();
    if (lane == 0) top[q] = bi;
  }
  return same;
}

template <typename T>
__global__ void __launch_bounds__(EP_THREADS) ep_finish_kernel(EpArgs p) {
  using A = typename Num<T>::Acc;
  constexpr int EC = 16 / (int)sizeof(T);
  if (p.mode == 0 && !p.has_cond && p.ctl[0] == 0) return;
  ep_count(p);
  __shared__ double red[EP_THREADS * EC];
  __shared__ A den[EP_MAXV], dena[EP_MAXV];
  __shared__ bool is_last;
  __shared__ int running;
  const int s = blockIdx.x, t = threadIdx.x, V = p.V, ns = p.nslices;
  const int lane = t % 32, w = t / 32;
  const A eps = rnd<T>(A(1e-30));
  for (int c = w; c < V; c += EP_WARPS) {
    const double sh = ep_slices_sum(p.part, ns, V, c);
    if (lane == 0) den[c] = rnd<T>(rnd<T>((A)sh) + eps);
    if (p.mode == 1) {
      const double sa = ep_slices_sum(p.part + (long)ns * V, ns, V, c);
      if (lane == 0) dena[c] = rnd<T>(rnd<T>((A)sa) + eps);
    }
  }
  __syncthreads();

  const int r0 = s * p.rows, r1 = min(p.n, r0 + p.rows);
  const int count = (r1 - r0) * V;
  const long base = (long)r0 * V;
  const int B = ep_loaders<EC>(V);
  const T* hr = static_cast<const T*>(p.hr) + base;
  T* h = static_cast<T*>(p.h) + base;
  T* a = static_cast<T*>(p.a) + base;
  const bool vec = aligned16(hr) && aligned16(h) && aligned16(a);
  double acc[EC];
#pragma unroll
  for (int u = 0; u < EC; ++u) acc[u] = 0.0;
  if (t < B) {
    for (int q = t; q * EC < count; q += B) {
      T x[EC], y[EC];
      ld_chunk<T, EC>(hr, q * EC, count, vec, x);
      ld_chunk<T, EC>(h, q * EC, count, vec, y);
#pragma unroll
      for (int u = 0; u < EC; ++u) {
        const A hn = rnd<T>(Num<T>::to_acc(x[u]) / den[(q * EC + u) % V]);
        acc[u] += fabs((double)rnd<T>(hn - Num<T>::to_acc(y[u])));
        y[u] = Num<T>::from_acc(hn);
      }
      if (p.mode == 0) {
        st_chunk<T, EC>(h, q * EC, count, vec, y);
      } else {
        T z[EC];
        ld_chunk<T, EC>(a, q * EC, count, vec, z);
#pragma unroll
        for (int u = 0; u < EC; ++u) {
          z[u] = Num<T>::from_acc(Num<T>::to_acc(z[u]) / dena[(q * EC + u) % V]);
        }
        st_chunk<T, EC>(a, q * EC, count, vec, z);
      }
    }
#pragma unroll
    for (int u = 0; u < EC; ++u) red[t * EC + u] = acc[u];
  }
  __syncthreads();
  ep_column_sums(red, B * EC, V, p.part + (2L * ns + s) * V);

  // one thread publishes the CTA's sums and counts it, as a grid barrier
  // does; the last CTA's thread fences again before the CTA reads the rest
  __syncthreads();
  if (t == 0) {
    __threadfence();
    is_last = atomicAdd(p.cnt, 1) == ns - 1;
    if (is_last) __threadfence();
  }
  __syncthreads();
  if (!is_last) return;
  const int k1 = p.mode == 0 ? p.ctl[1] + 1 : 0;
  if (t == 0) running = 0;
  __syncthreads();
  // per column (a warp each): residual, rank stability, stop, conv
  for (int c = w; c < V; c += EP_WARPS) {
    const A dT = rnd<T>((A)ep_slices_sum(p.part + 2L * ns * V, ns, V, c));
    if (p.mode == 1) {
      if (lane == 0) p.delta[c] = (double)dT;
      continue;
    }
    bool stp = (double)dT <= p.tol;
    if (p.rank_k > 0) {
      const bool same = ep_merge_topk(p, c);
      const int sb = same ? p.stab[c] + 1 : 0;
      stp = stp || sb >= p.stable;
      __syncwarp();
      if (lane == 0) p.stab[c] = sb;
    }
    if (lane == 0) {
      p.stop[c] = stp ? 1 : 0;
      p.delta[c] = (double)dT;
      if (p.conv[c] < 0) {
        if (stp) {
          p.conv[c] = k1;
        } else {
          running = 1;  // every writer stores 1
        }
      }
    }
  }
  __syncthreads();
  if (t == 0) {
    if (p.mode == 0) {
      const int flag = (k1 < p.max_iter && running) ? 1 : 0;
      p.ctl[1] = k1;
      p.ctl[0] = flag;
      if (p.has_cond) cudaGraphSetConditional(p.cond, flag);
    }
    *p.cnt = 0;
  }
}

template <typename T>
cudaError_t ep_launch(const EpArgs& p, cudaStream_t s) {
  ep_slice_kernel<T><<<p.nslices, EP_THREADS, 0, s>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ep_finish_kernel<T><<<p.nslices, EP_THREADS, 0, s>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_epilogue(int dtype, const EpArgs& p, cudaStream_t s) {
  if (p.V < 1 || p.V > EP_MAXV || p.nslices < 1 || p.nslices > 32 * EP_HEADS ||
      p.rows % 16 != 0 || (long)p.rows * p.nslices < p.n) {
    return cudaErrorInvalidValue;
  }
  switch (dtype) {
    case kF64: return ep_launch<double>(p, s);
    case kF32: return ep_launch<float>(p, s);
    case kBF16: return ep_launch<__nv_bfloat16>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------- K2
//
// K2 replaces the TPU loop bsr_converge_cols (src/repro/kernels/bsr_spmm.py,
// a lax.while_loop around the Pallas K1) with one CUDA graph per plan. The
// graph follows a step list (k2_steps in bsr_spmm.py, encoded as (op,
// phase, arg) triples): a control kernel starts a phase and sets the WHILE
// condition to k < max_iter; a conditional WHILE node runs the sweep (K1 on
// L^T, K1 on L, the epilogue, whose last CTA sets the condition); the
// ladder's bulk phase is cast to the full precision in between; a control
// kernel sets conv = where(conv < 0, k, conv); one more sweep gives the
// certificate. A graph is built for one call on that call's buffers (tol,
// bulk tol, max_iter and stable_sweeps are kernel arguments), launched once
// and destroyed. K1 and the epilogue count their launches on the device,
// which the host reads once with the results. A sweep is bound by K1
// re-reading both operators (together larger than L2); the graph removes
// the host's launches between the kernels and the no-op sweeps a chunked
// loop enqueued.

enum StepOp { kReset = 0, kWhile = 1, kSpmm = 2, kEpilogue = 3, kCast = 4,
              kFinish = 5, kCertificate = 6 };

struct K2Operand {
  const void* blocks;
  const int* idx;
  const int* row_ptr;
  long long nblocks;
};

struct K2Phase {  // 0: full precision; 1: the ladder's bulk phase
  K2Operand lt, lf;
  void* h;
  void* a;
  void* hr;
  const void* ca;
  const void* ch;
  const void* mask;
  long long dtype;
};

struct K2Args {
  K2Phase phase[2];
  const long long* steps;  // n_steps (op, phase, arg) triples, on the host
  long long n_steps;
  int* ctl;
  int* conv;
  int* stop;
  int* stab;
  int* top;
  double* delta;
  double* res;
  double* part;
  double* cand_v;
  int* cand_i;
  int* ep_cnt;        // the epilogue's CTA counter
  void* ws;           // K1's Scratch
  int* cnt;
  unsigned long long* launches;  // [K1 phase 0, epilogue, K1 phase 1]
  long long n_pad, V, bs, rank_k, ep_rows, ep_slices, max_iter, stable_sweeps;
  double tol, bulk_tol;
};

// a phase's start (mode 0; mode 1 also sets k = 0): conv -1, stab 0, top
// -1, and the stop flag and the WHILE condition k < max_iter; mode 2 closes
// the loop: conv = where(conv < 0, k, conv)
__global__ void k2_control_kernel(int* ctl, int* conv, int* stab, int* top,
                                  int V, int k_eff, long long max_iter,
                                  int mode, unsigned long long cond) {
  const int t = threadIdx.x;
  if (mode == 2) {
    for (int c = t; c < V; c += blockDim.x) {
      if (conv[c] < 0) conv[c] = ctl[1];
    }
    return;
  }
  for (int e = t; e < V * k_eff; e += blockDim.x) top[e] = -1;
  for (int c = t; c < V; c += blockDim.x) {
    conv[c] = -1;
    stab[c] = 0;
  }
  if (t == 0) {
    if (mode == 1) ctl[1] = 0;
    const int flag = ctl[1] < max_iter ? 1 : 0;
    ctl[0] = flag;
    cudaGraphSetConditional(cond, flag);
  }
}

// the bulk phase's h, widened to the full precision (exact)
template <typename Tlo, typename Thi>
__global__ void k2_cast_kernel(const Tlo* lo, Thi* hi, long n) {
  for (long e = (long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long)gridDim.x * blockDim.x) {
    hi[e] = Num<Thi>::from_acc((typename Num<Thi>::Acc)(double)Num<Tlo>::to_acc(lo[e]));
  }
}

template <typename Tlo>
cudaError_t launch_cast(int hi_dtype, const void* lo, void* hi, long n, cudaStream_t s) {
  const int grid = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  const Tlo* l = static_cast<const Tlo*>(lo);
  switch (hi_dtype) {
    case kF64: k2_cast_kernel<<<grid, 256, 0, s>>>(l, static_cast<double*>(hi), n); break;
    case kF32: k2_cast_kernel<<<grid, 256, 0, s>>>(l, static_cast<float*>(hi), n); break;
    case kBF16: k2_cast_kernel<<<grid, 256, 0, s>>>(l, static_cast<__nv_bfloat16*>(hi), n); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

struct K2Builder {
  const K2Args& g;
  cudaGraphConditionalHandle cond[2] = {0, 0};

  // K1 on L^T (h -> a, which 0) or L (a -> hr, which 1) of phase ph, every
  // column group; attr_only sets the shared-memory attribute instead
  cudaError_t spmm(int ph, int which, cudaStream_t s, bool attr_only) const {
    const K2Phase& P = g.phase[ph];
    const K2Operand& op = which == 0 ? P.lt : P.lf;
    const int V = (int)g.V;
    for (int col0 = 0; col0 < V; col0 += V_GROUP) {
      const int v = V - col0 < V_GROUP ? V - col0 : V_GROUP;
      const cudaError_t err = (cudaError_t)k1_group(
          (int)P.dtype, (int)g.bs, op.blocks, op.idx, op.row_ptr,
          (int)op.nblocks, (int)(g.n_pad / g.bs), which == 0 ? P.h : P.a,
          which == 0 ? P.ch : P.ca, V, P.mask, which == 0 ? P.a : P.hr, V,
          col0, v, g.ws, g.cnt, nullptr, g.launches + (ph == 0 ? 0 : 2), s,
          attr_only);
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  }

  cudaError_t epilogue(int ph, int mode, cudaStream_t s) const {
    const K2Phase& P = g.phase[ph];
    EpArgs p{};
    p.hr = P.hr;
    p.h = P.h;
    p.a = P.a;
    p.ctl = g.ctl;
    p.cnt = g.ep_cnt;
    p.conv = g.conv;
    p.stop = g.stop;
    p.stab = g.stab;
    p.top = g.top;
    p.delta = mode == 0 ? g.delta : g.res;
    p.part = g.part;
    p.cand_v = g.cand_v;
    p.cand_i = g.cand_i;
    p.launches = g.launches + 1;
    p.cond = cond[ph];
    p.tol = ph == 0 ? g.tol : g.bulk_tol;
    p.max_iter = g.max_iter;
    p.stable = g.stable_sweeps;
    p.n = (int)g.n_pad;
    p.V = (int)g.V;
    p.rows = (int)g.ep_rows;
    p.nslices = (int)g.ep_slices;
    p.rank_k = mode == 0 ? (int)g.rank_k : 0;
    p.mode = mode;
    p.has_cond = mode == 0 ? 1 : 0;
    return launch_epilogue((int)P.dtype, p, s);
  }

  cudaError_t control(int mode, unsigned long long c, cudaStream_t s) const {
    k2_control_kernel<<<1, 256, 0, s>>>(g.ctl, g.conv, g.stab, g.top, (int)g.V,
                                        (int)g.rank_k, g.max_iter, mode, c);
    return cudaGetLastError();
  }

  cudaError_t record(long long op, int ph, long long arg, cudaStream_t s) const {
    switch (op) {
      case kReset: return control(arg ? 1 : 0, cond[ph], s);
      case kSpmm: return spmm(ph, (int)arg, s, false);
      case kEpilogue: return epilogue(ph, 0, s);
      case kFinish: return control(2, cond[0], s);
      case kCertificate: return epilogue(0, 1, s);
      case kCast: {
        const long n = (long)(g.n_pad * g.V);
        const void* lo = g.phase[1].h;
        void* hi = g.phase[0].h;
        const int hd = (int)g.phase[0].dtype;
        switch (g.phase[1].dtype) {
          case kF64: return launch_cast<double>(hd, lo, hi, n, s);
          case kF32: return launch_cast<float>(hd, lo, hi, n, s);
          case kBF16: return launch_cast<__nv_bfloat16>(hd, lo, hi, n, s);
          default: return cudaErrorInvalidValue;
        }
      }
      default: return cudaErrorInvalidValue;
    }
  }

  // the step list captured on s (thread-local capture), each WHILE body
  // captured on s2 into the conditional node's body graph
  cudaError_t capture(cudaStream_t s, cudaStream_t s2) {
    cudaStreamCaptureStatus st;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps;
    size_t nd;
    cudaError_t err = cudaStreamGetCaptureInfo(s, &st, nullptr, &graph, &deps, &nd);
    for (int ph = 0; ph < 2 && err == cudaSuccess; ++ph) {
      if (g.phase[ph].h != nullptr) err = cudaGraphConditionalHandleCreate(&cond[ph], graph, 0, 0);
    }
    for (long long i = 0; i < g.n_steps && err == cudaSuccess; ++i) {
      const long long* step = g.steps + 3 * i;
      const int ph = (int)step[1];
      if (ph < 0 || ph > 1) return cudaErrorInvalidValue;
      if (step[0] != kWhile) {
        err = record(step[0], ph, step[2], s);
        continue;
      }
      const long long body = step[2];
      if (body < 1 || i + body >= g.n_steps) return cudaErrorInvalidValue;
      err = cudaStreamGetCaptureInfo(s, &st, nullptr, &graph, &deps, &nd);
      if (err != cudaSuccess) return err;
      cudaGraphNodeParams np = {};
      np.type = cudaGraphNodeTypeConditional;
      np.conditional.handle = cond[ph];
      np.conditional.type = cudaGraphCondTypeWhile;
      np.conditional.size = 1;
      cudaGraphNode_t node;
      err = cudaGraphAddNode(&node, graph, deps, nd, &np);
      if (err == cudaSuccess) {
        err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
      }
      if (err == cudaSuccess) {
        err = cudaStreamBeginCaptureToGraph(s2, np.conditional.phGraph_out[0], nullptr,
                                            nullptr, 0, cudaStreamCaptureModeThreadLocal);
      }
      if (err != cudaSuccess) return err;
      for (long long j = 1; j <= body && err == cudaSuccess; ++j) {
        const long long* b = g.steps + 3 * (i + j);
        err = b[0] == kWhile ? cudaErrorInvalidValue : record(b[0], (int)b[1], b[2], s2);
      }
      cudaGraph_t captured = nullptr;
      const cudaError_t end = cudaStreamEndCapture(s2, &captured);
      if (err == cudaSuccess) err = end;
      i += body;
    }
    return err;
  }
};

// ------------------------------------------------- power_method_jit
//
// core.power.power_method_jit on the card: one graph of an init kernel and
// a WHILE node whose body is the caller's captured chunk of sweeps (a
// child graph: v_prev = v, then check_every sweeps of v) and
// pm_residual_kernel, which sets the condition. The counterpart of the
// reference's lax.while_loop: no host read until the caller's.

// k = 0, delta = inf, condition = 0 < max_iter (inf > tol)
__global__ void pm_init_kernel(long long* k, double* delta, long long max_iter,
                               cudaGraphConditionalHandle cond) {
  *k = 0;
  *delta = INFINITY;
  cudaGraphSetConditional(cond, max_iter > 0 ? 1 : 0);
}

constexpr int PM_THREADS = 1024;

// delta = max over columns of sum_i |v - v_prev| (each difference in T,
// the sum in f64 in a fixed order, rounded once to T), k += check_every,
// condition = k < max_iter && delta > tol; one CTA
template <typename T>
__global__ void __launch_bounds__(PM_THREADS)
pm_residual_kernel(const T* __restrict__ v, const T* __restrict__ v_prev,
                   long long n, int V, long long* k, double* delta,
                   long long check_every, long long max_iter, double tol,
                   cudaGraphConditionalHandle cond) {
  using A = typename Num<T>::Acc;
  __shared__ double red[PM_THREADS / 32];
  const int t = threadIdx.x;
  double worst = 0.0;
  for (int c = 0; c < V; ++c) {
    double s = 0.0;
    for (long long i = t; i < n; i += PM_THREADS) {
      const A d = rnd<T>(Num<T>::to_acc(v[i * V + c]) - Num<T>::to_acc(v_prev[i * V + c]));
      s += fabs((double)d);
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (t % 32 == 0) red[t / 32] = s;
    __syncthreads();
    if (t == 0) {
      double tot = 0.0;
      for (int w = 0; w < PM_THREADS / 32; ++w) tot += red[w];
      const double col = (double)rnd<T>((A)tot);
      worst = (c == 0 || col > worst || col != col) ? col : worst;
    }
    __syncthreads();
  }
  if (t == 0) {
    const long long kk = *k + check_every;
    *k = kk;
    *delta = worst;
    cudaGraphSetConditional(cond, (kk < max_iter && worst > tol) ? 1 : 0);
  }
}

template <typename T>
cudaError_t pm_residual_node(cudaGraphNode_t* node, cudaGraph_t body,
                             const cudaGraphNode_t* dep, const void* v,
                             const void* v_prev, long long n, int V,
                             long long* k, double* delta, long long check_every,
                             long long max_iter, double tol,
                             cudaGraphConditionalHandle cond) {
  const T* vp = static_cast<const T*>(v);
  const T* pp = static_cast<const T*>(v_prev);
  void* params[] = {&vp, &pp, &n, &V, &k, &delta, &check_every, &max_iter, &tol, &cond};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(pm_residual_kernel<T>);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(PM_THREADS);
  kp.kernelParams = params;
  return cudaGraphAddKernelNode(node, body, dep, 1, &kp);
}

}  // namespace

extern "C" {

// y = (A @ (x * cin)) * mask for the columns [col0, col0 + v) of the
// row-major (n_pad, ld) x / y / mask; cin is (n_pad, 1) or (n_pad, ld);
// mask and active may be null. vt is v rounded up to 1, 2, 4, 8 or 16.
// ws holds nblocks * bs * vt values of x's dtype; cnt (n_brows * bs /
// min(bs, 32),) int32 is 0 on entry and on exit.
int bsr_spmm_launch(int dtype, int bs, int vt, const void* blocks,
                    const int* idx, const int* row_ptr, int nblocks,
                    int n_brows, const void* x, const void* cin, int cin_cols,
                    const void* mask, void* y, int ld, int col0, int v,
                    void* ws, int* cnt, const int* active, void* stream) {
  if (vt != vt_of(v)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = k1_group(dtype, bs, blocks, idx, row_ptr, nblocks, n_brows, x,
                     cin, cin_cols, mask, y, ld, col0, v, ws, cnt, active,
                     nullptr, s, true);
  if (err != cudaSuccess) return err;
  return k1_group(dtype, bs, blocks, idx, row_ptr, nblocks, n_brows, x, cin,
                  cin_cols, mask, y, ld, col0, v, ws, cnt, active, nullptr, s,
                  false);
}

// K1's link form: y = A @ (x * cin) over the link list (ptr, cols) of an
// n-row 0/1 operator; x and y row-major (n, v), cin (n, 1) or (n, v);
// lanes (1, 2, 4, ..., 32) a row, the n_long rows of long_rows (more than
// KL_ROUNDS * lanes links each) a CTA each.
int links_spmm_launch(int dtype, const int* ptr, const int* cols,
                      const int* long_rows, int n_long, int n, int lanes,
                      const void* x, const void* cin, int cin_cols, void* y,
                      int v, void* stream) {
  if (n < 0 || n_long < 0 || v < 1 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || (cin_cols != 1 && cin_cols != v)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF64: return launch_links<double>(ptr, cols, long_rows, n_long, n, lanes, x, cin, cin_cols, y, v, s);
    case kF32: return launch_links<float>(ptr, cols, long_rows, n_long, n, lanes, x, cin, cin_cols, y, v, s);
    case kBF16: return launch_links<__nv_bfloat16>(ptr, cols, long_rows, n_long, n, lanes, x, cin, cin_cols, y, v, s);
    default: return cudaErrorInvalidValue;
  }
}

// one sweep's epilogue (mode 0, predicated on ctl[0]) or the certificate
// (mode 1: delta gets the residual, a is normalized, ctl is not read) as
// its two launches; cnt is 0 on entry and on exit; part (3, nslices, V) f64
// and cand_v/cand_i (nslices, V, rank_k) are workspace
int sweep_epilogue_launch(int dtype, const void* hr, void* h, void* a, int n,
                          int V, int rows, int nslices, int rank_k, int mode,
                          double tol, long long max_iter, long long stable,
                          int* ctl, int* cnt, int* conv,
                          int* stop, int* stab, int* top, double* delta,
                          double* part, double* cand_v, int* cand_i,
                          void* stream) {
  EpArgs p{};
  p.hr = hr;
  p.h = h;
  p.a = a;
  p.ctl = ctl;
  p.cnt = cnt;
  p.conv = conv;
  p.stop = stop;
  p.stab = stab;
  p.top = top;
  p.delta = delta;
  p.part = part;
  p.cand_v = cand_v;
  p.cand_i = cand_i;
  p.n = n;
  p.V = V;
  p.rows = rows;
  p.nslices = nslices;
  p.rank_k = rank_k;
  p.mode = mode;
  p.tol = tol;
  p.max_iter = max_iter;
  p.stable = stable;
  return launch_epilogue(dtype, p, static_cast<cudaStream_t>(stream));
}

long long k2_args_size() { return (long long)sizeof(K2Args); }

// capture and instantiate the K2 graph of *args, a K2Args (its buffers
// must outlive the graph's launch); *exec gets the executable graph, or null
// on an error
int k2_graph_build(const void* k2_args, void** exec) {
  *exec = nullptr;
  const K2Args* args = static_cast<const K2Args*>(k2_args);
  K2Builder b{*args};
  cudaError_t err = cudaSuccess;
  for (int ph = 0; ph < 2 && err == cudaSuccess; ++ph) {
    if (args->phase[ph].h == nullptr) continue;
    for (int which = 0; which < 2 && err == cudaSuccess; ++which) {
      err = b.spmm(ph, which, nullptr, true);
    }
  }
  if (err != cudaSuccess) return err;
  cudaStream_t s = nullptr, s2 = nullptr;
  err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (err == cudaSuccess) err = cudaStreamCreateWithFlags(&s2, cudaStreamNonBlocking);
  cudaGraph_t graph = nullptr;
  if (err == cudaSuccess) {
    err = cudaStreamBeginCapture(s, cudaStreamCaptureModeThreadLocal);
    if (err == cudaSuccess) {
      err = b.capture(s, s2);
      cudaStreamCaptureStatus st;
      if (cudaStreamIsCapturing(s2, &st) == cudaSuccess && st != cudaStreamCaptureStatusNone) {
        cudaGraph_t body = nullptr;
        cudaStreamEndCapture(s2, &body);
      }
      const cudaError_t end = cudaStreamEndCapture(s, &graph);
      if (err == cudaSuccess) err = end;
    }
  }
  if (err == cudaSuccess) {
    cudaGraphExec_t ge = nullptr;
    err = cudaGraphInstantiate(&ge, graph, 0);
    if (err == cudaSuccess) *exec = ge;
  }
  if (graph != nullptr) cudaGraphDestroy(graph);
  if (s2 != nullptr) cudaStreamDestroy(s2);
  if (s != nullptr) cudaStreamDestroy(s);
  if (err == cudaSuccess) err = cudaGetLastError();
  return err;
}

int k2_graph_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                         static_cast<cudaStream_t>(stream));
}

int k2_graph_destroy(void* exec) {
  return cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}

// the executable graph of power_method_jit: init, then WHILE (condition)
// { sweep_graph (a child graph: the caller's captured chunk of sweeps);
// pm_residual_kernel }. v / v_prev are row-major (n, V) of dtype; k and
// delta are device scalars the graph writes; *exec gets the executable
// graph (launch with k2_graph_launch, free with k2_graph_destroy), or
// null on an error
int pm_graph_build(void* sweep_graph, int dtype, const void* v,
                   const void* v_prev, long long n, int V, long long* k,
                   double* delta, long long check_every, long long max_iter,
                   double tol, void** exec) {
  *exec = nullptr;
  if (n <= 0 || V <= 0 || check_every <= 0) return cudaErrorInvalidValue;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle cond = 0;
  err = cudaGraphConditionalHandleCreate(&cond, graph, 0, 0);
  cudaGraphNode_t init = nullptr, loop = nullptr, child = nullptr, res = nullptr;
  if (err == cudaSuccess) {
    void* params[] = {&k, &delta, &max_iter, &cond};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(pm_init_kernel);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = params;
    err = cudaGraphAddKernelNode(&init, graph, nullptr, 0, &kp);
  }
  cudaGraphNodeParams np = {};
  if (err == cudaSuccess) {
    np.type = cudaGraphNodeTypeConditional;
    np.conditional.handle = cond;
    np.conditional.type = cudaGraphCondTypeWhile;
    np.conditional.size = 1;
    err = cudaGraphAddNode(&loop, graph, &init, 1, &np);
  }
  if (err == cudaSuccess) {
    err = cudaGraphAddChildGraphNode(&child, np.conditional.phGraph_out[0], nullptr, 0,
                                     static_cast<cudaGraph_t>(sweep_graph));
  }
  if (err == cudaSuccess) {
    cudaGraph_t body = np.conditional.phGraph_out[0];
    switch (dtype) {
      case kF64:
        err = pm_residual_node<double>(&res, body, &child, v, v_prev, n, V, k, delta,
                                       check_every, max_iter, tol, cond);
        break;
      case kF32:
        err = pm_residual_node<float>(&res, body, &child, v, v_prev, n, V, k, delta,
                                      check_every, max_iter, tol, cond);
        break;
      case kBF16:
        err = pm_residual_node<__nv_bfloat16>(&res, body, &child, v, v_prev, n, V, k,
                                              delta, check_every, max_iter, tol, cond);
        break;
      default: err = cudaErrorInvalidValue;
    }
  }
  if (err == cudaSuccess) {
    cudaGraphExec_t ge = nullptr;
    err = cudaGraphInstantiate(&ge, graph, 0);
    if (err == cudaSuccess) *exec = ge;
  }
  cudaGraphDestroy(graph);
  if (err == cudaSuccess) err = cudaGetLastError();
  return err;
}

}  // extern "C"
