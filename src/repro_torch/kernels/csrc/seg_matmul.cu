// Hand-written Hopper (sm_90a) kernel of the port's tiled segment-sum.
//
// seg_matmul (K3) replaces the Pallas TPU kernel _seg_kernel
// (src/repro/kernels/seg_matmul.py, launched by seg_matmul): the scatter
// half of message passing. Messages already gathered per edge sit in
// tiles of tile_e slots; every tile belongs to one destination block of bs
// rows (blkid, sorted), and each slot carries its row within that block
// (off) and a 0/1 padding mask (valid). Per block,
//     y[row] = sum over the block's tiles, in tile order, of
//              round_y(round_acc(sum over the tile's slots s with
//                                off[s] == row of msgs[s] * valid[s]))
// added into y in y's dtype, which is what the TPU kernel's
// `y += dot(onehot, msgs).astype(y.dtype)` computes.
//
// What bounds it on the H100: every message is read once and every output
// row written once, so it is memory bound; the per-tile sort below is a
// few hundred shared-memory operations per thread.
//
// Design (a simple, exact first version):
// * The TPU built a (bs x tile_e) one-hot and multiplied it on the MXU.
//   Here one CTA owns one destination block and a chunk of at most FC
//   columns, walks that block's tiles (tile_ptr, from blkid) in order, and
//   keeps the block's running output in shared memory: every output
//   element is written exactly once, blocks without tiles write zeros, and
//   there are no atomics on floats.
// * The slots of a block are in the edges' input order, not sorted by row.
//   Per tile the CTA sorts the slot indices by row in shared memory, a
//   stable counting sort (a slot's rank among the earlier slots of its
//   row, integer counts per row, prefix sums), so each row's messages are
//   then summed in slot order by one thread per (row, column): the same
//   order on every run, and the order the plain torch version sums in.
// * Rounding: each message is cast to the accumulator dtype and multiplied
//   by its valid weight there; the tile's sum per row is kept in f64 and
//   rounded once to the accumulator dtype, then to y's dtype (f64 -> bf16
//   through f32, as torch casts), and added into y in y's dtype.
//
// Plain C interface (loaded with ctypes); the launcher launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum DType { kF64 = 0, kF32 = 1, kBF16 = 2 };

constexpr int K3_THREADS = 256;
constexpr int K3_FC = 32;  // widest column chunk of one CTA

// Y: the register type of the running output (bf16 values kept in f32)
template <typename T> struct Out;
template <> struct Out<double> {
  using Y = double;
  __device__ static double rnd(double v) { return v; }
  __device__ static double from_f64(double v) { return v; }
  __device__ static double store(double v) { return v; }
};
template <> struct Out<float> {
  using Y = float;
  __device__ static float rnd(float v) { return v; }
  __device__ static float from_f64(double v) { return __double2float_rn(v); }
  __device__ static float store(float v) { return v; }
};
template <> struct Out<__nv_bfloat16> {
  using Y = float;
  __device__ static float rnd(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
  __device__ static float from_f64(double v) { return rnd(__double2float_rn(v)); }
  __device__ static __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
};

// a message cast to the accumulator dtype A
template <typename A> __device__ A to_acc(double v);
template <> __device__ double to_acc<double>(double v) { return v; }
template <> __device__ float to_acc<float>(double v) { return __double2float_rn(v); }
template <typename A> __device__ A to_acc(float v) { return (A)v; }
template <typename A> __device__ A to_acc(__nv_bfloat16 v) { return (A)__bfloat162float(v); }

// products never contracted into an FMA with the following sum
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }

// the tile's f64 sum rounded to A, then to y's precision
template <typename T, typename A>
__device__ __forceinline__ typename Out<T>::Y contribution(double s) {
  if constexpr (sizeof(A) == sizeof(double)) {
    return Out<T>::from_f64(s);
  } else {
    const float a = __double2float_rn(s);
    if constexpr (sizeof(T) == sizeof(double)) {
      return (double)a;
    } else {
      return Out<T>::rnd(a);
    }
  }
}

size_t k3_smem(int bs, int tile_e, int fc, size_t ybytes) {
  return ybytes * (size_t)bs * fc + sizeof(int) * (4 * (size_t)tile_e + 2 * (size_t)bs);
}

template <typename T, typename A>
__global__ void __launch_bounds__(K3_THREADS)
seg_matmul_kernel(const int* __restrict__ tile_ptr, const T* __restrict__ msgs,
                  const int* __restrict__ off, const int* __restrict__ valid,
                  T* __restrict__ y, int bs, int tile_e, int F, int fc) {
  using Y = typename Out<T>::Y;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Y* ys = reinterpret_cast<Y*>(smem_raw);        // [bs][fc] running output
  int* key = reinterpret_cast<int*>(ys + bs * fc);  // [tile_e] row, -1: skip
  int* wgt = key + tile_e;                       // [tile_e] valid weight
  int* rank = wgt + tile_e;                      // [tile_e] rank in its row
  int* order = rank + tile_e;                    // [tile_e] slots by row
  int* cnt = order + tile_e;                     // [bs] slots per row
  int* start = cnt + bs;                         // [bs] first of a row

  const int b = blockIdx.x;
  const int col0 = blockIdx.y * fc;
  const int fcv = min(fc, F - col0);  // columns of this chunk
  const int t = threadIdx.x;
  const int nrg = K3_THREADS / fc;    // row groups
  const int c = t % fc, rg = t / fc;
  // thread (rg, c) owns rows rg, rg + nrg, ... of column c: it alone
  // initializes, updates and writes them
  const bool owner = rg < nrg && c < fcv;
  if (owner) {
    for (int r = rg; r < bs; r += nrg) ys[r * fc + c] = Y(0);
  }

  const int k0 = tile_ptr[b], k1 = tile_ptr[b + 1];
  for (int k = k0; k < k1; ++k) {
    const long base = (long)k * tile_e;
    __syncthreads();  // the previous tile's readers are done
    for (int s = t; s < tile_e; s += K3_THREADS) {
      const int o = off[base + s], w = valid[base + s];
      key[s] = (w != 0 && o >= 0 && o < bs) ? o : -1;
      wgt[s] = w;
    }
    for (int r = t; r < bs; r += K3_THREADS) cnt[r] = 0;
    __syncthreads();
    for (int s = t; s < tile_e; s += K3_THREADS) {
      const int kk = key[s];
      if (kk >= 0) {
        int rk = 0;
        for (int q = 0; q < s; ++q) rk += key[q] == kk;
        rank[s] = rk;
        atomicAdd(&cnt[kk], 1);  // an integer count: the same every run
      }
    }
    __syncthreads();
    if (t == 0) {
      int acc = 0;
      for (int r = 0; r < bs; ++r) {
        start[r] = acc;
        acc += cnt[r];
      }
    }
    __syncthreads();
    for (int s = t; s < tile_e; s += K3_THREADS) {
      const int kk = key[s];
      if (kk >= 0) order[start[kk] + rank[s]] = s;
    }
    __syncthreads();
    if (owner) {
      for (int r = rg; r < bs; r += nrg) {
        double sum = 0.0;
        const int i0 = start[r], i1 = i0 + cnt[r];
        for (int i = i0; i < i1; ++i) {
          const int s = order[i];
          const A v = mul_rn(to_acc<A>(msgs[(base + s) * F + col0 + c]), (A)wgt[s]);
          sum += (double)v;
        }
        // a row without slots would add a zero: y never changes by it
        if (i1 > i0) {
          Y& yv = ys[r * fc + c];
          yv = Out<T>::rnd(yv + contribution<T, A>(sum));
        }
      }
    }
  }
  if (owner) {
    for (int r = rg; r < bs; r += nrg) {
      y[((long)b * bs + r) * F + col0 + c] = Out<T>::store(ys[r * fc + c]);
    }
  }
}

template <typename T, typename A>
cudaError_t launch_k3(int bs, int tile_e, int F, int n_blocks,
                      const int* tile_ptr, const void* msgs, const int* off,
                      const int* valid, void* y, cudaStream_t stream) {
  const int fc = F < K3_FC ? F : K3_FC;
  const size_t smem = k3_smem(bs, tile_e, fc, sizeof(typename Out<T>::Y));
  auto kern = seg_matmul_kernel<T, A>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(n_blocks, (F + fc - 1) / fc);
  kern<<<grid, K3_THREADS, smem, stream>>>(
      tile_ptr, static_cast<const T*>(msgs), off, valid, static_cast<T*>(y),
      bs, tile_e, F, fc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t k3_by_acc(int accum, int bs, int tile_e, int F, int n_blocks,
                      const int* tile_ptr, const void* msgs, const int* off,
                      const int* valid, void* y, cudaStream_t s) {
  switch (accum) {
    case kF64: return launch_k3<T, double>(bs, tile_e, F, n_blocks, tile_ptr, msgs, off, valid, y, s);
    case kF32: return launch_k3<T, float>(bs, tile_e, F, n_blocks, tile_ptr, msgs, off, valid, y, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// y (n_blocks * bs, F) row-major in msgs' dtype; msgs (n_tiles * tile_e,
// F) row-major; off/valid (n_tiles * tile_e,) int32; tile_ptr
// (n_blocks + 1,) int32: block b owns tiles tile_ptr[b]:tile_ptr[b+1].
// accum is kF64 or kF32.
int seg_matmul_launch(int dtype, int accum, int bs, int tile_e, int F,
                      int n_blocks, const int* tile_ptr, const void* msgs,
                      const int* off, const int* valid, void* y,
                      void* stream) {
  if (bs <= 0 || tile_e <= 0 || F <= 0 || n_blocks < 0) return cudaErrorInvalidValue;
  if (n_blocks == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF64: return k3_by_acc<double>(accum, bs, tile_e, F, n_blocks, tile_ptr, msgs, off, valid, y, s);
    case kF32: return k3_by_acc<float>(accum, bs, tile_e, F, n_blocks, tile_ptr, msgs, off, valid, y, s);
    case kBF16: return k3_by_acc<__nv_bfloat16>(accum, bs, tile_e, F, n_blocks, tile_ptr, msgs, off, valid, y, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
