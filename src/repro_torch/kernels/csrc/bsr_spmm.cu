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
// memory bound; x * cin is tiny by comparison and is re-read from L2 by
// the CTAs of a block row. The epilogue touches O(n_pad * V) values and is
// launch/latency bound.
//
// Design (a simple, exact first version):
// * The TPU grid walked the nonzero blocks in order and revisited the
//   output tile in VMEM. Here every CTA owns RB output rows of one block
//   row and walks that row's blocks (row_ptr) in idx order itself, so
//   each output element is written exactly once, with no atomics, and the
//   sum over a row's blocks runs in the same order on every run.
// * Per block, the CTA stages (x * cin) of the block's columns and its
//   RB x BS slice of the block in shared memory; 128 threads split each
//   row's dot product into G partial sums that are added in a fixed order.
// * Rounding follows the Pallas kernel, not the f32 oracle: x * cin is
//   rounded to x's dtype, the block product accumulates in f64 (f64) or
//   f32 (f32, bf16), and each block's product is rounded to y's dtype and
//   added into y in y's dtype (a bf16 running sum in the ladder's bulk
//   phase). The f32 accumulator's value is the f32 rounding of a sum kept
//   in f64 (products of f32 or bf16 values are exact in f64), so it does
//   not depend on the order of the sum: the plain torch version computes
//   the same bits. No tensor cores, so no TF32.
// * Every kernel takes an optional device flag `active`; with *active == 0
//   it returns at once, so sweeps enqueued after the loop stopped change
//   nothing.
//
// Plain C interface (loaded with ctypes); every launcher launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

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
  static constexpr int TS = BS + 1;              // padded tile row stride
  static constexpr size_t smem = sizeof(double) * G * RB * VT +
                                 sizeof(A) * BS * VT + sizeof(T) * RB * TS;
};

template <typename T, int BS, int VT>
__global__ void __launch_bounds__(K1_THREADS)
bsr_spmm_kernel(const T* __restrict__ blocks, const int* __restrict__ idx,
                const int* __restrict__ row_ptr, const T* __restrict__ x,
                const T* __restrict__ cin, int cin_cols,
                const T* __restrict__ mask, T* __restrict__ y, int ld,
                int col0, int v, const int* __restrict__ active) {
  using S = K1Shape<T, BS, VT>;
  using A = typename S::A;
  constexpr int RB = S::RB, G = S::G, JG = S::JG, TS = S::TS;
  if (active != nullptr && *active == 0) return;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* red = reinterpret_cast<double*>(smem_raw);  // [G][RB][VT]
  A* xs = reinterpret_cast<A*>(red + G * RB * VT);     // [BS][VT]
  T* tile = reinterpret_cast<T*>(xs + BS * VT);        // [RB][TS]

  const int brow = blockIdx.x;
  const int row0 = blockIdx.y * RB;  // first tile row of this CTA
  const int t = threadIdx.x;
  const int r = t % RB, g = t / RB;

  A yv[VT];  // running output of row r (kept by the threads of group 0)
#pragma unroll
  for (int c = 0; c < VT; ++c) yv[c] = A(0);

  const int kb = row_ptr[brow], ke = row_ptr[brow + 1];
  for (int kk = kb; kk < ke; ++kk) {
    const long bc = idx[2 * kk + 1];
    __syncthreads();  // the previous block's readers are done
    for (int e = t; e < BS * VT; e += K1_THREADS) {
      const int j = e / VT, c = e % VT;
      A val = A(0);
      if (c < v) {
        const long row = bc * BS + j;
        const A xv = Num<T>::to_acc(x[row * ld + col0 + c]);
        const A cv = Num<T>::to_acc(
            cin[cin_cols == 1 ? row : row * ld + col0 + c]);
        val = rnd<T>(xv * cv);  // x * cin in x's dtype
      }
      xs[e] = val;
    }
    const T* blk = blocks + (long)kk * BS * BS + (long)row0 * BS;
    for (int e = t; e < RB * BS; e += K1_THREADS) {
      tile[(e / BS) * TS + (e % BS)] = blk[e];
    }
    __syncthreads();

    double part[VT];
#pragma unroll
    for (int c = 0; c < VT; ++c) part[c] = 0.0;
#pragma unroll 4
    for (int jj = 0; jj < JG; ++jj) {
      const int j = g * JG + jj;
      const double bv = (double)Num<T>::to_acc(tile[r * TS + j]);
#pragma unroll
      for (int c = 0; c < VT; ++c) part[c] = fma(bv, (double)xs[j * VT + c], part[c]);
    }
#pragma unroll
    for (int c = 0; c < VT; ++c) red[(g * RB + r) * VT + c] = part[c];
    __syncthreads();
    if (g == 0) {
#pragma unroll
      for (int c = 0; c < VT; ++c) {
        double s = red[r * VT + c];
        for (int q = 1; q < G; ++q) s += red[(q * RB + r) * VT + c];
        // the accumulator's value, rounded to y's dtype, adds in y's dtype
        yv[c] = rnd<T>(yv[c] + rnd<T>((A)s));
      }
    }
  }
  if (g == 0) {
    const long row = (long)brow * BS + row0 + r;
#pragma unroll
    for (int c = 0; c < VT; ++c) {
      if (c < v) {
        A out = yv[c];
        if (mask != nullptr) {
          out = rnd<T>(out * Num<T>::to_acc(mask[row * ld + col0 + c]));
        }
        y[row * ld + col0 + c] = Num<T>::from_acc(out);
      }
    }
  }
}

template <typename T, int BS, int VT>
cudaError_t launch_k1(const void* blocks, const int* idx, const int* row_ptr,
                      int n_brows, const void* x, const void* cin,
                      int cin_cols, const void* mask, void* y, int ld,
                      int col0, int v, const int* active,
                      cudaStream_t stream) {
  using S = K1Shape<T, BS, VT>;
  auto kern = bsr_spmm_kernel<T, BS, VT>;
  if (S::smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(n_brows, BS / S::RB);
  kern<<<grid, K1_THREADS, S::smem, stream>>>(
      static_cast<const T*>(blocks), idx, row_ptr, static_cast<const T*>(x),
      static_cast<const T*>(cin), cin_cols, static_cast<const T*>(mask),
      static_cast<T*>(y), ld, col0, v, active);
  return cudaGetLastError();
}

template <typename T, int BS>
cudaError_t k1_by_vt(int vt, const void* blocks, const int* idx,
                     const int* row_ptr, int n_brows, const void* x,
                     const void* cin, int cin_cols, const void* mask, void* y,
                     int ld, int col0, int v, const int* active,
                     cudaStream_t s) {
  switch (vt) {
    case 1: return launch_k1<T, BS, 1>(blocks, idx, row_ptr, n_brows, x, cin, cin_cols, mask, y, ld, col0, v, active, s);
    case 2: return launch_k1<T, BS, 2>(blocks, idx, row_ptr, n_brows, x, cin, cin_cols, mask, y, ld, col0, v, active, s);
    case 4: return launch_k1<T, BS, 4>(blocks, idx, row_ptr, n_brows, x, cin, cin_cols, mask, y, ld, col0, v, active, s);
    case 8: return launch_k1<T, BS, 8>(blocks, idx, row_ptr, n_brows, x, cin, cin_cols, mask, y, ld, col0, v, active, s);
    case 16: return launch_k1<T, BS, 16>(blocks, idx, row_ptr, n_brows, x, cin, cin_cols, mask, y, ld, col0, v, active, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t k1_by_bs(int bs, int vt, const void* blocks, const int* idx,
                     const int* row_ptr, int n_brows, const void* x,
                     const void* cin, int cin_cols, const void* mask, void* y,
                     int ld, int col0, int v, const int* active,
                     cudaStream_t s) {
  switch (bs) {
    case 16: return k1_by_vt<T, 16>(vt, blocks, idx, row_ptr, n_brows, x, cin, cin_cols, mask, y, ld, col0, v, active, s);
    case 32: return k1_by_vt<T, 32>(vt, blocks, idx, row_ptr, n_brows, x, cin, cin_cols, mask, y, ld, col0, v, active, s);
    case 64: return k1_by_vt<T, 64>(vt, blocks, idx, row_ptr, n_brows, x, cin, cin_cols, mask, y, ld, col0, v, active, s);
    case 128: return k1_by_vt<T, 128>(vt, blocks, idx, row_ptr, n_brows, x, cin, cin_cols, mask, y, ld, col0, v, active, s);
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
int bsr_spmm_launch(int dtype, int bs, int vt, const void* blocks,
                    const int* idx, const int* row_ptr, int n_brows,
                    const void* x, const void* cin, int cin_cols,
                    const void* mask, void* y, int ld, int col0, int v,
                    const int* active, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF64: return k1_by_bs<double>(bs, vt, blocks, idx, row_ptr, n_brows, x, cin, cin_cols, mask, y, ld, col0, v, active, s);
    case kF32: return k1_by_bs<float>(bs, vt, blocks, idx, row_ptr, n_brows, x, cin, cin_cols, mask, y, ld, col0, v, active, s);
    case kBF16: return k1_by_bs<__nv_bfloat16>(bs, vt, blocks, idx, row_ptr, n_brows, x, cin, cin_cols, mask, y, ld, col0, v, active, s);
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
