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
// added into y in y's dtype, starting from +0, which is what the TPU
// kernel's `y += dot(onehot, msgs).astype(y.dtype)` computes.
//
// What bounds it on the H100: every message is read once and every output
// row written once, so the function is memory bound. The TPU walked a
// block's tiles in grid order; a port that gives one CTA a whole block
// (the first version) is bound instead by its heaviest block, whose tiles
// it handles one after another with the card nearly idle.
//
// Design: parallel over tiles, then an in-order fold.
// * One CTA per (tile, chunk of at most K3_FC columns), so a heavy block
//   costs what a light one does per tile. The CTA stages the tile's off
//   and valid and its (tile_e x fc) message slab in shared memory with
//   cp.async 16-byte copies (plain coalesced loads where the slab is not
//   16-byte aligned); the rank below runs while the slab is in flight.
// * The slots of a block keep the edges' input order. The CTA sorts the
//   tile's slots by row, stably, in parallel: __match_any_sync gives each
//   slot its peers of the same row in its warp's 32 slots and its rank
//   among them; per-(segment, row) counts are scanned over the segments,
//   and the row totals over the rows (one warp), which gives every slot
//   its place. Each row is then summed in slot order in f64 from shared
//   memory by one thread per (row, column): the order the plain version
//   sums in.
// * The tile's contribution (its f64 row sums rounded once to the
//   accumulator dtype, then to y's dtype, f64 -> bf16 through f32 as torch
//   casts) goes to the workspace ws (n_tiles, bs, F) in y's dtype. A row
//   without slots writes +0: the plain version adds the tile's whole
//   (bs, F) contribution too, and since y starts at +0 and x + y is -0
//   only when both are -0, y is never -0, so adding +0 leaves it as it is.
// * The last CTA to finish a (block, chunk) folds: after __threadfence
//   and an atomicAdd on the counter cnt[block * n_chunks + chunk], the CTA
//   that sees count == n_tiles_of_block - 1 adds the block's contributions
//   in tile order into +0, rounding each add to y's dtype, writes y once
//   and resets the counter to 0. No CTA waits for another. A block of one
//   tile writes y directly and touches no counter. Each contribution is
//   rounded on its own before the in-order add, so the parallel schedule
//   changes no bit: kernel and plain agree in every dtype.
// * Blocks that own no tile come out zero: the CTA of a block's first
//   tile zero-fills the blocks between the previous tile's block and its
//   own, and the CTA of the last tile the blocks after its own.
// * No float atomics. Padded slots (valid 0) and offsets outside the
//   block are skipped; messages must be finite (see seg_matmul.py).
//
// Plain C interface (loaded with ctypes); the launcher launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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
  __device__ static double load_cg(const double* p) { return __ldcg(p); }
};
template <> struct Out<float> {
  using Y = float;
  __device__ static float rnd(float v) { return v; }
  __device__ static float from_f64(double v) { return __double2float_rn(v); }
  __device__ static float store(float v) { return v; }
  __device__ static float load_cg(const float* p) { return __ldcg(p); }
};
template <> struct Out<__nv_bfloat16> {
  using Y = float;
  __device__ static float rnd(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
  __device__ static float from_f64(double v) { return rnd(__double2float_rn(v)); }
  __device__ static __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
  __device__ static float load_cg(const __nv_bfloat16* p) {
    const unsigned short bits = __ldcg(reinterpret_cast<const unsigned short*>(p));
    return __bfloat162float(__ushort_as_bfloat16(bits));
  }
};

// a stored value widened to Out<T>::Y
__device__ __forceinline__ double to_y(double v) { return v; }
__device__ __forceinline__ float to_y(float v) { return v; }
__device__ __forceinline__ float to_y(__nv_bfloat16 v) { return __bfloat162float(v); }

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n"); }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// n ints from src to dst: 16-byte cp.async where src allows it, else plain
// 4-byte loads
__device__ void stage_ints(int* dst, const int* src, int n) {
  if (aligned16(src) && n % 4 == 0) {
    for (int e = threadIdx.x; e < n / 4; e += K3_THREADS) cp_async16(dst + 4 * e, src + 4 * e);
  } else {
    for (int e = threadIdx.x; e < n; e += K3_THREADS) dst[e] = src[e];
  }
}

// acc[u] += the u-th value of a 16-byte piece of the workspace, in y's dtype
template <typename T, int EC>
__device__ __forceinline__ void add_piece(typename Out<T>::Y* acc, uint4 raw) {
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int u = 0; u < EC; ++u) acc[u] = Out<T>::rnd(acc[u] + (typename Out<T>::Y)to_y(v[u]));
}

__host__ __device__ inline int k3_segments(int tile_e) { return (tile_e + 31) / 32; }

// shared memory: the (tile_e x fc) slab, then off/valid/rank/order
// (tile_e or n_seg*32 each), cnt (n_seg x bs), tot and start (bs each)
__host__ __device__ inline size_t k3_smem(int bs, int tile_e, int fc, size_t tbytes) {
  const size_t slab = (tbytes * (size_t)tile_e * fc + 15) / 16 * 16;
  const size_t nseg = (size_t)k3_segments(tile_e);
  return slab + sizeof(int) * (2 * (size_t)tile_e + 2 * nseg * 32 + nseg * bs + 2 * (size_t)bs);
}

template <typename T, typename A>
__global__ void __launch_bounds__(K3_THREADS)
seg_matmul_kernel(const int* __restrict__ blkid, const int* __restrict__ tile_ptr,
                  const T* __restrict__ msgs, const int* __restrict__ off,
                  const int* __restrict__ valid, T* __restrict__ y,
                  T* __restrict__ ws, int* __restrict__ cnt_blk, int n_tiles,
                  int n_blocks, int bs, int tile_e, int F, int fc) {
  using Y = typename Out<T>::Y;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nseg = k3_segments(tile_e);
  T* slab = reinterpret_cast<T*>(smem_raw);  // [tile_e][fc]
  int* key = reinterpret_cast<int*>(smem_raw + (sizeof(T) * (size_t)tile_e * fc + 15) / 16 * 16);
  int* wgt = key + tile_e;     // [tile_e] valid weight
  int* rank = wgt + tile_e;    // [nseg*32] rank among its warp peers
  int* order = rank + nseg * 32;  // [nseg*32] slots by (row, slot)
  int* cnt = order + nseg * 32;   // [nseg][bs] slots per (segment, row)
  int* tot = cnt + nseg * bs;     // [bs] slots per row
  int* start = tot + bs;          // [bs] first place of a row
  __shared__ bool is_last;

  const int k = blockIdx.x;
  const int chunk = blockIdx.y, n_chunks = gridDim.y;
  const int col0 = chunk * fc;
  const int fcv = min(fc, F - col0);  // columns of this chunk
  const int t = threadIdx.x, lane = t % 32;
  const long base = (long)k * tile_e;
  const int b = blkid[k];
  const int k0 = tile_ptr[b], nt = tile_ptr[b + 1] - k0;

  // ---- stage off and valid (group 0), then the message slab (group 1)
  stage_ints(key, off + base, tile_e);
  stage_ints(wgt, valid + base, tile_e);
  cp_async_commit();
  const T* src = msgs + base * F + col0;
  const size_t tb = sizeof(T);
  if (fcv == F && aligned16(src) && (tb * tile_e * F) % 16 == 0) {
    // the chunk is the whole row: the slab is one contiguous run
    const int nv = (int)(tb * tile_e * F / 16);
    for (int e = t; e < nv; e += K3_THREADS) {
      cp_async16(reinterpret_cast<unsigned char*>(slab) + 16 * (size_t)e,
                 reinterpret_cast<const unsigned char*>(src) + 16 * (size_t)e);
    }
  } else if (aligned16(src) && (tb * F) % 16 == 0 && (tb * fcv) % 16 == 0 &&
             (tb * fc) % 16 == 0) {
    const int nv = (int)(tb * fcv / 16);  // 16-byte pieces per slot row
    for (int e = t; e < tile_e * nv; e += K3_THREADS) {
      const int s = e / nv, q = e % nv;
      cp_async16(reinterpret_cast<unsigned char*>(slab + (size_t)s * fc) + 16 * q,
                 reinterpret_cast<const unsigned char*>(src + (long)s * F) + 16 * q);
    }
  } else {
    for (int e = t; e < tile_e * fcv; e += K3_THREADS) {
      const int s = e / fcv, c = e % fcv;
      slab[s * fc + c] = src[(long)s * F + c];
    }
  }
  cp_async_commit();
  for (int e = t; e < nseg * bs; e += K3_THREADS) cnt[e] = 0;
  asm volatile("cp.async.wait_group 1;\n");  // off and valid have landed
  __syncthreads();

  // ---- stable rank of every slot by row, in parallel
  for (int s = t; s < nseg * 32; s += K3_THREADS) {  // whole warps
    int kk = -1;
    if (s < tile_e) {
      const int o = key[s], w = wgt[s];
      kk = (w != 0 && o >= 0 && o < bs) ? o : -1;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, kk);
    const unsigned lower = peers & ((1u << lane) - 1u);
    rank[s] = kk >= 0 ? __popc(lower) : -1;
    if (kk >= 0 && lower == 0u) cnt[(s / 32) * bs + kk] = __popc(peers);
    if (s < tile_e) key[s] = kk;
  }
  __syncthreads();
  // per row: exclusive scan of the segment counts, and the row's total
  for (int r = t; r < bs; r += K3_THREADS) {
    int acc = 0;
    for (int g = 0; g < nseg; ++g) {
      const int c = cnt[g * bs + r];
      cnt[g * bs + r] = acc;
      acc += c;
    }
    tot[r] = acc;
  }
  __syncthreads();
  // exclusive scan of the row totals by warp 0: lane l owns rows
  // [l*per, (l+1)*per)
  if (t < 32) {
    const int per = (bs + 31) / 32;
    const int r0 = min(bs, lane * per), r1 = min(bs, r0 + per);
    int local = 0;
    for (int r = r0; r < r1; ++r) local += tot[r];
    int incl = local;
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += o;
    }
    int acc = incl - local;
    for (int r = r0; r < r1; ++r) {
      start[r] = acc;
      acc += tot[r];
    }
  }
  __syncthreads();
  for (int s = t; s < tile_e; s += K3_THREADS) {
    const int kk = key[s];
    if (kk >= 0) order[start[kk] + cnt[(s / 32) * bs + kk] + rank[s]] = s;
  }
  cp_async_wait_all();  // the slab has landed
  __syncthreads();

  // ---- per (row, column): the tile's sum in slot order, rounded
  const int nrg = K3_THREADS / fc;  // row groups
  const int c = t % fc, rg = t / fc;
  // thread (rg, c) owns rows rg, rg + nrg, ... of column c
  const bool owner = rg < nrg && c < fcv;
  if (owner) {
    for (int r = rg; r < bs; r += nrg) {
      double sum = 0.0;
      const int i0 = start[r], i1 = i0 + tot[r];
      for (int i = i0; i < i1; ++i) {
        const int s = order[i];
        sum += (double)mul_rn(to_acc<A>(slab[s * fc + c]), (A)wgt[s]);
      }
      const Y contrib = contribution<T, A>(sum);
      const long yo = ((long)b * bs + r) * F + col0 + c;
      if (nt == 1) {
        y[yo] = Out<T>::store(Out<T>::rnd(Y(0) + contrib));
      } else {
        ws[((long)k * bs + r) * F + col0 + c] = Out<T>::store(contrib);
      }
    }
    // blocks without tiles: zeros, written by the first tile after them
    // (and the last tile for the blocks after it)
    const int gap0 = (k - k0 == 0) ? (k > 0 ? blkid[k - 1] + 1 : 0) : b;
    const int gap1 = (k == n_tiles - 1) ? n_blocks : 0;
    for (int bb = gap0; bb < b; ++bb) {
      for (int r = rg; r < bs; r += nrg) y[((long)bb * bs + r) * F + col0 + c] = Out<T>::store(Y(0));
    }
    for (int bb = b + 1; bb < gap1; ++bb) {
      for (int r = rg; r < bs; r += nrg) y[((long)bb * bs + r) * F + col0 + c] = Out<T>::store(Y(0));
    }
  }
  if (nt == 1) return;

  // ---- the last CTA of (block, chunk) adds the tiles in order
  __threadfence();
  __syncthreads();
  int* counter = cnt_blk + (long)b * n_chunks + chunk;
  if (t == 0) is_last = atomicAdd(counter, 1) == nt - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const long step = (long)bs * F;  // from one tile's contribution to the next
  constexpr int EC = 16 / (int)sizeof(T);  // values in 16 bytes
  if ((tb * F) % 16 == 0 && (tb * col0) % 16 == 0 && fcv % EC == 0 && aligned16(ws)) {
    // 16 bytes a load, eight tiles in flight, each value added in order
    const int pieces = fcv / EC;
    for (int e = t; e < bs * pieces; e += K3_THREADS) {
      const int r = e / pieces, c0 = (e % pieces) * EC;
      const T* wp = ws + ((long)k0 * bs + r) * F + col0 + c0;
      Y acc[EC];
#pragma unroll
      for (int u = 0; u < EC; ++u) acc[u] = Y(0);
      int q = 0;
      for (; q + 8 <= nt; q += 8) {
        uint4 raw[8];
#pragma unroll
        for (int w = 0; w < 8; ++w) raw[w] = __ldcg(reinterpret_cast<const uint4*>(wp + (q + w) * step));
#pragma unroll
        for (int w = 0; w < 8; ++w) add_piece<T, EC>(acc, raw[w]);
      }
      for (; q < nt; ++q) add_piece<T, EC>(acc, __ldcg(reinterpret_cast<const uint4*>(wp + q * step)));
      T* yp = y + ((long)b * bs + r) * F + col0 + c0;
#pragma unroll
      for (int u = 0; u < EC; ++u) yp[u] = Out<T>::store(acc[u]);
    }
  } else if (owner) {
    for (int r = rg; r < bs; r += nrg) {
      const T* wp = ws + ((long)k0 * bs + r) * F + col0 + c;
      Y acc = Y(0);
      int q = 0;
      for (; q + 8 <= nt; q += 8) {  // eight loads in flight, adds in order
        Y c8[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) c8[u] = Out<T>::load_cg(wp + (q + u) * step);
#pragma unroll
        for (int u = 0; u < 8; ++u) acc = Out<T>::rnd(acc + c8[u]);
      }
      for (; q < nt; ++q) acc = Out<T>::rnd(acc + Out<T>::load_cg(wp + q * step));
      y[((long)b * bs + r) * F + col0 + c] = Out<T>::store(acc);
    }
  }
  if (t == 0) *counter = 0;
}

template <typename T, typename A>
cudaError_t launch_k3(int bs, int tile_e, int F, int n_tiles, int n_blocks,
                      const int* blkid, const int* tile_ptr, const void* msgs,
                      const int* off, const int* valid, void* y, void* ws,
                      int* cnt, cudaStream_t stream) {
  const int fc = F < K3_FC ? F : K3_FC;
  const size_t smem = k3_smem(bs, tile_e, fc, sizeof(T));
  auto kern = seg_matmul_kernel<T, A>;
  if (smem + 1024 > 48 * 1024) {  // the static is_last flag counts too
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(n_tiles, (F + fc - 1) / fc);
  kern<<<grid, K3_THREADS, smem, stream>>>(
      blkid, tile_ptr, static_cast<const T*>(msgs), off, valid,
      static_cast<T*>(y), static_cast<T*>(ws), cnt, n_tiles, n_blocks, bs,
      tile_e, F, fc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t k3_by_acc(int accum, int bs, int tile_e, int F, int n_tiles,
                      int n_blocks, const int* blkid, const int* tile_ptr,
                      const void* msgs, const int* off, const int* valid,
                      void* y, void* ws, int* cnt, cudaStream_t s) {
  switch (accum) {
    case kF64: return launch_k3<T, double>(bs, tile_e, F, n_tiles, n_blocks, blkid, tile_ptr, msgs, off, valid, y, ws, cnt, s);
    case kF32: return launch_k3<T, float>(bs, tile_e, F, n_tiles, n_blocks, blkid, tile_ptr, msgs, off, valid, y, ws, cnt, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// y (n_blocks * bs, F) row-major in msgs' dtype; msgs (n_tiles * tile_e,
// F) row-major; blkid (n_tiles,) sorted and off/valid (n_tiles * tile_e,)
// int32; tile_ptr (n_blocks + 1,) int32: block b owns tiles
// tile_ptr[b]:tile_ptr[b+1]. ws holds n_tiles * bs * F values of msgs'
// dtype; cnt (n_blocks * ceil(F / 32),) int32 is 0 on entry and on exit.
// accum is kF64 or kF32.
int seg_matmul_launch(int dtype, int accum, int bs, int tile_e, int F,
                      int n_tiles, int n_blocks, const int* blkid,
                      const int* tile_ptr, const void* msgs, const int* off,
                      const int* valid, void* y, void* ws, int* cnt,
                      void* stream) {
  if (bs <= 0 || tile_e <= 0 || F <= 0 || n_blocks < 0 || n_tiles < 0) return cudaErrorInvalidValue;
  if (n_blocks == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles == 0) {  // every block is empty: +0 is all-zero bits
    return cudaMemsetAsync(y, 0, (size_t)n_blocks * bs * F *
                           (dtype == kF64 ? 8 : dtype == kF32 ? 4 : 2), s);
  }
  switch (dtype) {
    case kF64: return k3_by_acc<double>(accum, bs, tile_e, F, n_tiles, n_blocks, blkid, tile_ptr, msgs, off, valid, y, ws, cnt, s);
    case kF32: return k3_by_acc<float>(accum, bs, tile_e, F, n_tiles, n_blocks, blkid, tile_ptr, msgs, off, valid, y, ws, cnt, s);
    case kBF16: return k3_by_acc<__nv_bfloat16>(accum, bs, tile_e, F, n_tiles, n_blocks, blkid, tile_ptr, msgs, off, valid, y, ws, cnt, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
