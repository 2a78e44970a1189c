// Hand-written Hopper (sm_90a) kernels of the port's accelerated-HITS sweep.
//
// bsr_spmm (K1) replaces the Pallas TPU kernel _bsr_kernel
// (src/repro/kernels/bsr_spmm.py, launched by _bsr_scaled_matvec):
//     y = (A_bsr @ (x * cin)) * mask
// over the nonzero (BS x BS) blocks of A, sorted by block row.
//
// sweep_epilogue replaces the per-sweep body of the TPU loop
// bsr_converge_cols (same file): per column, L1-normalize the new hub
// vector (eps 1e-30), take the residual against the old one, apply the
// optional top-k rank-stability rule, and update conv / the sweep count /
// the device stop flag, so the host reads that flag once per chunk of
// sweeps instead of once per sweep.
//
// What bounds them on the H100: K1 reads every stored block once per call
// (an f64 main-path operator is ~43 MB against 50 MB of L2), so it is
// memory bound; x * cin is tiny by comparison. The TPU walked a block
// row's blocks in grid order. A port that gives one CTA a block row (the
// first version) keeps one tile in flight per SM and is bound by latency
// and by its densest block row: the blocking permutation packs the graph's
// hubs into a few block rows. The epilogue touches O(n_pad * V) values and
// is launch/latency bound.
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
// * Every kernel takes an optional device flag `active`; with *active == 0
//   every CTA returns at once, so sweeps enqueued after the loop stopped
//   change nothing and leave the counters at 0.
//
// Plain C interface (loaded with ctypes); every launcher launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

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
                int* __restrict__ cnt, const int* __restrict__ active) {
  using S = K1Shape<T, BS, VT>;
  using A = typename S::A;
  constexpr int RB = S::RB, G = S::G, JG = S::JG, EC = S::EC, RC = S::RC;
  constexpr int SLICES = BS / RB;
  if (active != nullptr && *active == 0) return;

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

template <typename T, int BS, int VT>
cudaError_t launch_k1(const void* blocks, const int* idx, const int* row_ptr,
                      int nblocks, int n_brows, const void* x, const void* cin,
                      int cin_cols, const void* mask, void* y, int ld,
                      int col0, int v, void* ws, int* cnt, const int* active,
                      cudaStream_t stream) {
  using S = K1Shape<T, BS, VT>;
  auto kern = bsr_spmm_kernel<T, BS, VT>;
  if (S::smem + 1024 > 48 * 1024) {  // the static is_last flag counts too
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(nblocks > 0 ? nblocks : 1, BS / S::RB);
  kern<<<grid, K1_THREADS, S::smem, stream>>>(
      static_cast<const T*>(blocks), idx, row_ptr, nblocks, n_brows,
      static_cast<const T*>(x), static_cast<const T*>(cin), cin_cols,
      static_cast<const T*>(mask), static_cast<T*>(y), ld, col0, v,
      static_cast<T*>(ws), cnt, active);
  return cudaGetLastError();
}

#define K1_ARGS blocks, idx, row_ptr, nblocks, n_brows, x, cin, cin_cols, mask, y, ld, col0, v, ws, cnt, active, s
#define K1_PARAMS                                                               \
  const void *blocks, const int *idx, const int *row_ptr, int nblocks,          \
      int n_brows, const void *x, const void *cin, int cin_cols,                \
      const void *mask, void *y, int ld, int col0, int v, void *ws, int *cnt,  \
      const int *active, cudaStream_t s

template <typename T, int BS>
cudaError_t k1_by_vt(int vt, K1_PARAMS) {
  switch (vt) {
    case 1: return launch_k1<T, BS, 1>(K1_ARGS);
    case 2: return launch_k1<T, BS, 2>(K1_ARGS);
    case 4: return launch_k1<T, BS, 4>(K1_ARGS);
    case 8: return launch_k1<T, BS, 8>(K1_ARGS);
    case 16: return launch_k1<T, BS, 16>(K1_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t k1_by_bs(int bs, int vt, K1_PARAMS) {
  switch (bs) {
    case 16: return k1_by_vt<T, 16>(vt, K1_ARGS);
    case 32: return k1_by_vt<T, 32>(vt, K1_ARGS);
    case 64: return k1_by_vt<T, 64>(vt, K1_ARGS);
    case 128: return k1_by_vt<T, 128>(vt, K1_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------- sweep epilogue

constexpr int EP_THREADS = 256;
constexpr int EP_WARPS = EP_THREADS / 32;

// deterministic block sum (fixed shuffle tree, then warp 0 over the warps);
// every thread gets the total
template <typename A>
__device__ A block_sum(A v, A* sh) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  __syncthreads();  // sh may still be read from a previous call
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < EP_WARPS ? sh[lane] : A(0);
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) sh[0] = v;
  }
  __syncthreads();
  return sh[0];
}

// (value, index) ordered by value descending, then index ascending: the
// order lax.top_k returns, lowest index first among equal values
template <typename A>
__device__ __forceinline__ bool before(A v, int i, A bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <typename A>
__device__ void block_argmax(A& v, int& i, A* shv, int* shi) {
  for (int off = 16; off > 0; off >>= 1) {
    const A ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (before(ov, oi, v, i)) { v = ov; i = oi; }
  }
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  __syncthreads();
  if (lane == 0) { shv[wid] = v; shi[wid] = i; }
  __syncthreads();
  if (wid == 0) {
    v = lane < EP_WARPS ? shv[lane] : -INFINITY;
    i = lane < EP_WARPS ? shi[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      const A ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (before(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) { shv[0] = v; shi[0] = i; }
  }
  __syncthreads();
  v = shv[0];
  i = shi[0];
}

// mode 0 (sweep): one CTA per column j; hr is the new masked hub vector
// before normalization, h the current one (updated in place), a the
// authority of this sweep. The last CTA to finish updates conv, the sweep
// count ctl[1] and the stop flag ctl[0] (ctl[2] counts finished CTAs).
// mode 1 (certificate): delta[j] = |normalize(hr) - h|_1 and a is
// L1-normalized in place; h, conv and ctl are untouched.
template <typename T>
__global__ void __launch_bounds__(EP_THREADS)
sweep_epilogue_kernel(const T* __restrict__ hr, T* __restrict__ h,
                      T* __restrict__ a, int n, int V, double tol,
                      int rank_k, int stable_sweeps, int* __restrict__ top,
                      int* __restrict__ stab, int* __restrict__ stop,
                      int* __restrict__ conv, double* __restrict__ delta,
                      int* __restrict__ ctl, int max_iter, int mode) {
  using A = typename Num<T>::Acc;
  if (mode == 0 && ctl[0] == 0) return;
  __shared__ double sh[EP_WARPS];
  __shared__ A shv[EP_WARPS];
  __shared__ int shi[EP_WARPS];
  __shared__ bool is_last;
  const int j = blockIdx.x;
  const int t = threadIdx.x;
  const A eps = rnd<T>(A(1e-30));

  // ||h'||_1: kept in f64, then rounded through the accumulator type to T
  // (jnp.sum's f32 accumulation for bf16), so its value does not depend on
  // the order of the sum
  double s = 0.0;
  for (int i = t; i < n; i += EP_THREADS) s += fabs((double)Num<T>::to_acc(hr[(long)i * V + j]));
  s = block_sum(s, sh);
  const A den = rnd<T>(rnd<T>((A)s) + eps);

  double d = 0.0;
  for (int i = t; i < n; i += EP_THREADS) {
    const long e = (long)i * V + j;
    const A hn = rnd<T>(Num<T>::to_acc(hr[e]) / den);
    d += fabs((double)rnd<T>(hn - Num<T>::to_acc(h[e])));
    if (mode == 0) h[e] = Num<T>::from_acc(hn);
  }
  d = block_sum(d, sh);
  const A dT = rnd<T>((A)d);

  if (mode == 1) {
    double sa = 0.0;
    for (int i = t; i < n; i += EP_THREADS) sa += fabs((double)Num<T>::to_acc(a[(long)i * V + j]));
    sa = block_sum(sa, sh);
    const A dena = rnd<T>(rnd<T>((A)sa) + eps);
    for (int i = t; i < n; i += EP_THREADS) {
      const long e = (long)i * V + j;
      a[e] = Num<T>::from_acc(Num<T>::to_acc(a[e]) / dena);
    }
    if (t == 0) delta[j] = (double)dT;
    return;
  }

  bool stp = (double)dT <= tol;
  if (rank_k > 0) {
    // k rounds of arg-max, each over the entries ordered strictly after
    // the previous pick: the top-k indices of the unnormalized a
    bool same = true;
    A pv = INFINITY;
    int pi = -1;
    for (int q = 0; q < rank_k; ++q) {
      A bv = -INFINITY;
      int bi = INT_MAX;
      for (int i = t; i < n; i += EP_THREADS) {
        const A v = Num<T>::to_acc(a[(long)i * V + j]);
        const bool after = v < pv || (v == pv && i > pi);
        if (after && before(v, i, bv, bi)) { bv = v; bi = i; }
      }
      block_argmax(bv, bi, shv, shi);
      if (t == 0) {
        same = same && top[j * rank_k + q] == bi;
        top[j * rank_k + q] = bi;
      }
      pv = bv;
      pi = bi;
    }
    if (t == 0) {
      const int sb = same ? stab[j] + 1 : 0;
      stab[j] = sb;
      stp = stp || sb >= stable_sweeps;
    }
  }
  if (t == 0) {
    stop[j] = stp ? 1 : 0;
    delta[j] = (double)dT;
    __threadfence();
    is_last = atomicAdd(&ctl[2], 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (is_last && t == 0) {
    __threadfence();
    volatile int* vstop = stop;
    volatile int* vconv = conv;
    const int k1 = ctl[1] + 1;
    bool any_running = false;
    for (int c = 0; c < V; ++c) {
      int cv = vconv[c];
      if (cv < 0 && vstop[c]) {
        cv = k1;
        vconv[c] = k1;
      }
      any_running = any_running || cv < 0;
    }
    ctl[1] = k1;
    ctl[2] = 0;
    ctl[0] = (k1 < max_iter && any_running) ? 1 : 0;
  }
}

template <typename T>
cudaError_t launch_ep(const void* hr, void* h, void* a, int n, int V,
                      double tol, int rank_k, int stable_sweeps, int* top,
                      int* stab, int* stop, int* conv, double* delta,
                      int* ctl, int max_iter, int mode, cudaStream_t stream) {
  sweep_epilogue_kernel<T><<<V, EP_THREADS, 0, stream>>>(
      static_cast<const T*>(hr), static_cast<T*>(h), static_cast<T*>(a), n,
      V, tol, rank_k, stable_sweeps, top, stab, stop, conv, delta, ctl,
      max_iter, mode);
  return cudaGetLastError();
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
  if (nblocks < 0 || n_brows <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF64: return k1_by_bs<double>(bs, vt, K1_ARGS);
    case kF32: return k1_by_bs<float>(bs, vt, K1_ARGS);
    case kBF16: return k1_by_bs<__nv_bfloat16>(bs, vt, K1_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

int sweep_epilogue_launch(int dtype, const void* hr, void* h, void* a, int n,
                          int V, double tol, int rank_k, int stable_sweeps,
                          int* top, int* stab, int* stop, int* conv,
                          double* delta, int* ctl, int max_iter, int mode,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF64: return launch_ep<double>(hr, h, a, n, V, tol, rank_k, stable_sweeps, top, stab, stop, conv, delta, ctl, max_iter, mode, s);
    case kF32: return launch_ep<float>(hr, h, a, n, V, tol, rank_k, stable_sweeps, top, stab, stop, conv, delta, ctl, max_iter, mode, s);
    case kBF16: return launch_ep<__nv_bfloat16>(hr, h, a, n, V, tol, rank_k, stable_sweeps, top, stab, stop, conv, delta, ctl, max_iter, mode, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
