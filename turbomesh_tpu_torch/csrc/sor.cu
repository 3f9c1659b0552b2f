// Red-black SOR sweeps of the frozen Winslow system for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _rb_sor_kernel of
// turbomesh_tpu/ops/sor.py:74 (math in _half_sweep, :31-71), launched by
// red_black_sor (:96). Contract: red_black_sor(use_pallas=False). One
// block of N x M points; base, cf and x are (N, M, 2) C-contiguous arrays
// of T (float or double), interleaved (x, y), the mask (N, M) bytes
// (torch.bool). Red points have (i + j) even, black points odd; a point
// of the sweep's color inside the mask gets
//
//   x <- x + (-omega / diag_safe) * res(x),   diag_safe = diag ?: 1,
//
// with res the 9-point Winslow stencil whose coefficients come from the
// frozen `base` and `cf`, in the order of sor.py:43-70. Every other point
// is copied through unchanged.
//
// Where it would go wrong, and what this kernel does about it:
//  - Not Gauss-Seidel within a color. The cross terms h * up(rt(z)) etc.
//    (sor.py:63-64) reach the diagonal neighbours, which have the SAME
//    color ((i +- 1) + (j +- 1) keeps the parity). The reference forms res
//    from the whole field before any update, i.e. a Jacobi update over one
//    color; an in-place update would race. Each half-sweep forms every new
//    value in registers, then a barrier, then the stores, then a barrier;
//    each launch reads one device buffer and writes the other.
//  - Circular shifts. jnp.roll wraps at the edges (sor.py:38-41), so the
//    neighbours of row 0 are in row N - 1 and those of column 0 in column
//    M - 1. Every index is taken modulo N and M (any negative one too: the
//    grown tile of a small block wraps around it more than once), and the
//    color of a point comes from its wrapped indices, never from its place
//    in the tile: with N or M odd, row -1 is row N - 1 of the other parity.
//  - nvcc contracts a * b + c to FMA, so the result is not bitwise the
//    reference's; it is held to 1e-12 (f64) and 1e-5 (f32, against the
//    plain version in f64) of max |plain| in chip_smoke.py.
//
// Design: temporal blocking in shared memory. The TPU kernel kept the
// whole block in VMEM and ran every sweep inside one pallas_call; a CTA's
// 227 KB cannot hold a 256 x 256 field, so each CTA keeps a tile and a
// halo. A first launch forms the frozen coefficients (diag, c_ip, c_im,
// c_jp, c_jm, h, scale; scale 0 outside the mask) of every point once a
// call. Each tile launch then owns an inner tile of ti x tj points, copies
// x and the coefficients of the tile grown by `steps` on every side
// (indices modulo N and M) into shared memory with cp.async, all copies in
// flight at once, and runs `steps` colored half-sweeps there. The 9-point
// stencil reaches one point in every direction, so after half-sweep k
// only the tile grown by steps - k is still exact, and half-sweep k
// updates just that region; the last leaves the inner tile exact, and
// only it is written back. A call of `sweeps` sweeps is 1 + ceil(2 *
// sweeps / s) launches, each tile launch of at most s half-sweeps and
// starting on the color that follows the last one's (2 * sweeps launches
// of one half-sweep each before: 100 against 8 or 14 for 50 sweeps).
// The alternative, a thread-block cluster holding the whole block in
// distributed shared memory for a single launch, would run on 16 of the
// 132 SMs, stop at 16 x 227 KB (a 256 x 256 f64 field with its
// coefficients takes 4.7 MB) and need this design beside it for larger
// blocks; the tiles run any block on every SM with one kernel.
//
// Shared memory a CTA, per point of the grown tile: x and y and the seven
// coefficients, 36 B in f32 and 72 B in f64, and a parity byte a row and a
// column; 216 KB in f64 at the larger grown tile of ops/sor.py
// sor_schedule, 48 x 64 points: 16 x 32 tiles and s = 16 where the block
// has few tiles (a 256 x 256 block: 128 CTAs), 32 x 48 (made even
// across the block: 32 x 42 at the scale-4 block 881 x 161, 112 CTAs) and
// s = 8 where it has enough for three quarters of the SMs.
//
// Bound. The function reads base, cf, x0 (6 values a point) and the mask,
// and writes x (2 values): at the scale-4 block (881 x 161 = 141,841
// points, f32) 4.7 MB, 1.4 us at 3.35 TB/s. Its arithmetic is 33 flops a
// masked point for the coefficients, once a call, and 38 a masked point
// and sweep for the x and y updates: 1,933 a point for 50 sweeps, 0.27
// GFLOP over the block's 139,761 masked points, 4.0 us at 67 TFLOP/s in
// f32 (chip_smoke.py computes the bound of each call from its inputs).
// This kernel does more work than that: the halo's updates again in the
// neighbouring tiles, 3.0 updates for each one kept at 16 x 32 and s =
// 16, 1.4 at 32 x 42 and s = 8. What limits it is the shared-memory
// traffic of those updates: a warp (a row, a lane a column pair, one
// member of each pair of the half-sweep's color) reads nine (x, y) pairs,
// seven coefficients and its row's parity and writes one pair, 28
// wavefronts of 128 B for 32 points in f32 and 55 in f64, where an SM
// moves one wavefront a cycle; then the two barriers of each half-sweep,
// each launch's copy of the grown tile, and the launches.

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// a modulo n in [0, n), for any int a (the grown tile of a small block
// reaches below -n)
__device__ __forceinline__ int wrap(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

constexpr int kCoefs = 7;  // diag, c_ip, c_im, c_jp, c_jm, h, scale
// a CTA is 32 x rows threads: lane x holds the column pair (2x, 2x + 1) of
// the grown tile (so W <= 64), and each thread at most this many rows
constexpr int kRowsPerThread = 4;

// cp.async of `Bytes` (4, 8 or 16) from device to shared memory
template <int Bytes>
__device__ __forceinline__ void copy_async(void* shared, const void* global) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(global), "n"(Bytes));
}

__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The frozen coefficients of every point, once a call, into kCoefs planes
// of N * M values; scale is 0 outside the mask, where no point moves.
template <typename T>
__global__ void rb_sor_coef_kernel(const T* __restrict__ base,
                                   const T* __restrict__ cf,
                                   const unsigned char* __restrict__ mask,
                                   T* __restrict__ coef, int N, int M,
                                   T omega) {
  using T2 = typename Pair<T>::type;
  const long n = (long)N * M;
  const long k = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int i = (int)(k / M);
  const int j = (int)(k - (long)i * M);
  const T2* base2 = reinterpret_cast<const T2*>(base);
  const long up = (long)(i + 1 == N ? 0 : i + 1) * M;
  const long dn = (long)(i == 0 ? N - 1 : i - 1) * M;
  const long row = (long)i * M;
  const int rt = j + 1 == M ? 0 : j + 1;
  const int lt = j == 0 ? M - 1 : j - 1;
  const T2 bu = base2[up + j], bd = base2[dn + j];
  const T2 br = base2[row + rt], bl = base2[row + lt];
  const T2 f = reinterpret_cast<const T2*>(cf)[k];
  const T half = T(0.5);
  const T x_xi_x = half * (bu.x - bd.x);
  const T x_xi_y = half * (bu.y - bd.y);
  const T x_eta_x = half * (br.x - bl.x);
  const T x_eta_y = half * (br.y - bl.y);
  const T g11 = x_xi_x * x_xi_x + x_xi_y * x_xi_y;
  const T g22 = x_eta_x * x_eta_x + x_eta_y * x_eta_y;
  const T g12 = x_xi_x * x_eta_x + x_xi_y * x_eta_y;
  const T diag = T(-2.0) * (g11 + g22);
  coef[k] = diag;
  coef[n + k] = g22 * (T(1) + half * f.x);
  coef[2 * n + k] = g22 * (T(1) - half * f.x);
  coef[3 * n + k] = g11 * (T(1) + half * f.y);
  coef[4 * n + k] = g11 * (T(1) - half * f.y);
  coef[5 * n + k] = half * g12;
  coef[6 * n + k] = mask[k] ? (-omega) / (diag == T(0) ? T(1) : diag) : T(0);
}

// One launch: `steps` colored half-sweeps, the first of color `parity0`,
// of the ti x tj tile (blockIdx.y, blockIdx.x), from src to dst.
//
// Shared memory holds the grown tile (H x W points, W even) split by
// column parity: point (r, c) sits in half e = c & 1 at index r * P +
// c / 2 (P = W / 2), so the points of one color in a row, every other
// column, are consecutive words and a warp (one row, one lane a column
// pair) reads them without bank conflicts. The color of (r, c) is the
// parity of its wrapped row plus that of its wrapped column.
template <typename T>
__global__ void __launch_bounds__(512)
    rb_sor_tile_kernel(const T* __restrict__ coef_g, const T* __restrict__ src,
                       T* __restrict__ dst, int N, int M, int ti, int tj,
                       int steps, int parity0) {
  using T2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = ti + 2 * steps, W = tj + 2 * steps;
  const int P = W / 2, HP = H * P, HW = 2 * HP;
  T2* xs = reinterpret_cast<T2*>(smem);     // x, y: [2][HP]
  T* coef = reinterpret_cast<T*>(xs + HW);  // [kCoefs][2][HP]
  // the parities of the wrapped columns and rows: [W], W even, then [H]
  unsigned char* col_par = reinterpret_cast<unsigned char*>(coef + kCoefs * HW);
  unsigned char* row_par = col_par + W;

  const T2* src2 = reinterpret_cast<const T2*>(src);
  const long n = (long)N * M;
  const int i0 = blockIdx.y * ti - steps;  // global row of local row 0
  const int j0 = blockIdx.x * tj - steps;

  // the grown tile's x and coefficients, all copies in flight at once
  for (int r = threadIdx.y; r < H; r += blockDim.y) {
    const long row = (long)wrap(i0 + r, N) * M;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = threadIdx.x + 32 * cc;
      if (c >= W) break;
      const long k = row + wrap(j0 + c, M);
      const int at = (c & 1) * HP + r * P + (c >> 1);
      copy_async<sizeof(T2)>(xs + at, src2 + k);
#pragma unroll
      for (int q = 0; q < kCoefs; ++q)
        copy_async<sizeof(T)>(coef + q * HW + at, coef_g + q * n + k);
    }
  }
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < H) row_par[tid] = (unsigned char)(wrap(i0 + tid, N) & 1);
  if (tid < W) col_par[tid] = (unsigned char)(wrap(j0 + tid, M) & 1);
  copy_async_wait_all();
  __syncthreads();

  // half-sweep k updates the tile grown by steps - k (local rows and
  // columns [k, H - k) and [k, W - k)), whose neighbours are still exact.
  // Jacobi within the color: every new value goes to registers first and
  // into shared memory only after all of them are formed.
  const int pc = threadIdx.x;  // column pair of this lane
  const uchar2 cpar = pc < P ? reinterpret_cast<const uchar2*>(col_par)[pc]
                             : make_uchar2(2, 2);
  for (int k = 1; k <= steps; ++k) {
    const int col = (parity0 + k - 1) & 1;
    T2 next[kRowsPerThread][2];
    bool moved[kRowsPerThread][2];
#pragma unroll
    for (int it = 0; it < kRowsPerThread; ++it) {
      const int r = k + threadIdx.y + it * blockDim.y;
      moved[it][0] = moved[it][1] = false;
      if (r >= H - k || pc >= P) continue;
      const int rpar = row_par[r];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * pc + e;
        if ((rpar ^ (e ? cpar.y : cpar.x)) != col || c < k || c >= W - k)
          continue;
        const int at = e * HP + r * P + pc;
        const T scale = coef[6 * HW + at];
        if (scale == T(0)) continue;  // outside the mask
        // (r, c + 1) and (r, c - 1) lie in the other half
        const int ar = (1 - e) * HP + r * P + pc + e;
        const int al = ar - 1;
        const T2 z = xs[at], u = xs[at + P], d = xs[at - P];
        const T2 rt = xs[ar], lt = xs[al];
        const T2 urt = xs[ar + P], ult = xs[al + P];
        const T2 drt = xs[ar - P], dlt = xs[al - P];
        const T diag = coef[at], cip = coef[HW + at], cim = coef[2 * HW + at];
        const T cjp = coef[3 * HW + at], cjm = coef[4 * HW + at];
        const T h = coef[5 * HW + at];
        const T rx = diag * z.x + cip * u.x + cim * d.x + cjp * rt.x +
                     cjm * lt.x - h * urt.x + h * ult.x + h * drt.x -
                     h * dlt.x;
        const T ry = diag * z.y + cip * u.y + cim * d.y + cjp * rt.y +
                     cjm * lt.y - h * urt.y + h * ult.y + h * drt.y -
                     h * dlt.y;
        next[it][e].x = z.x + scale * rx;
        next[it][e].y = z.y + scale * ry;
        moved[it][e] = true;
      }
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < kRowsPerThread; ++it) {
      const int r = k + threadIdx.y + it * blockDim.y;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (moved[it][e]) xs[e * HP + r * P + pc] = next[it][e];
    }
    __syncthreads();
  }

  // the inner tile, where it lies inside the block
  T2* dst2 = reinterpret_cast<T2*>(dst);
  for (int r = steps + threadIdx.y; r < steps + ti; r += blockDim.y) {
    const int gi = i0 + r;
    if (gi >= N) break;
    for (int c = steps + threadIdx.x; c < steps + tj; c += blockDim.x) {
      const int gj = j0 + c;
      if (gj >= M) break;
      dst2[(long)gi * M + gj] = xs[(c & 1) * HP + r * P + (c >> 1)];
    }
  }
}

// shared memory of a launch of `steps` half-sweeps on ti x tj tiles: per
// point of the grown tile x and y and the coefficients, and the parities
// of its rows and columns
template <typename T>
size_t smem_bytes(int ti, int tj, int steps) {
  const size_t h = ti + 2 * steps, w = tj + 2 * steps;
  return h * w * (2 + kCoefs) * sizeof(T) + h + w;
}

template <typename T>
int red_black_sor(const T* base, const T* cf, const unsigned char* mask,
                  const T* x0, T* coef, T* tmp, T* out, int N, int M,
                  double omega, int sweeps, int ti, int tj, int s, int rows,
                  int device, void* stream) {
  turbomesh::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (N <= 0 || M <= 0 || sweeps <= 0) return (int)cudaGetLastError();
  // the layout's limits: W = tj + 2 s even and at most 64 (a lane a
  // column pair), H = ti + 2 s at most kRowsPerThread rows a thread
  if (ti <= 0 || tj <= 0 || s <= 0 || rows <= 0 || 32 * rows > 512 ||
      tj % 2 != 0 || tj + 2 * s > 64 || ti + 2 * s > kRowsPerThread * rows)
    return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory only once the kernel allows it
  static size_t allowed = 48 * 1024;
  const size_t need = smem_bytes<T>(ti, tj, s);
  if (need > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        rb_sor_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)need);
    if (err != cudaSuccess) return (int)err;
    allowed = need;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long n = (long)N * M;
  rb_sor_coef_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      base, cf, mask, coef, N, M, (T)omega);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((M + tj - 1) / tj), (unsigned)((N + ti - 1) / ti));
  const dim3 block(32, (unsigned)rows);
  const long total = 2L * sweeps;
  const long launches = (total + s - 1) / s;
  // x0 -> ... -> out: launch l writes `out` when launches - 1 - l is even,
  // `tmp` otherwise, so the last one writes `out`
  const T* from = x0;
  for (long l = 0; l < launches; ++l) {
    const int steps = (int)(total - l * s < s ? total - l * s : s);
    T* to = (launches - 1 - l) % 2 == 0 ? out : tmp;
    rb_sor_tile_kernel<T><<<grid, block, smem_bytes<T>(ti, tj, steps), st>>>(
        coef, from, to, N, M, ti, tj, steps, (int)((l * s) & 1));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    from = to;
  }
  return 0;
}

}  // namespace

// Entry points red_black_sor_f32 / _f64 of the extension module sor:
// the coefficient launch, then ceil(2 * sweeps / s) launches of ti x tj
// tiles (CTAs of 32 x rows threads) on `stream` on `device`, the result
// in `out`; `coef` (7 * N * M values) and `tmp` (the shape of x0) are
// caller-allocated scratch (`tmp` unused by a single tile launch).
// They return the first failed launch's cudaError (0 = success).
static PyMethodDef methods[] = {
    turbomesh::method<red_black_sor<float>>("red_black_sor_f32"),
    turbomesh::method<red_black_sor<double>>("red_black_sor_f64"),
    {nullptr, nullptr, 0, nullptr}};

TURBOMESH_MODULE(sor, methods)
