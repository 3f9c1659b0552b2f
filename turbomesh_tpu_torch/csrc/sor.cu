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
// with res the 9-point Winslow stencil whose metrics come from `base` on
// the fly, exactly in the order of sor.py:43-70. Every other point is
// copied through unchanged.
//
// Where it would go wrong, and what this kernel does about it:
//  - Not Gauss-Seidel within a color. The cross terms h * up(rt(z)) etc.
//    (sor.py:63-64) reach the diagonal neighbours, which have the SAME
//    color ((i +- 1) + (j +- 1) keeps the parity). The reference forms res
//    from the whole field before any update, i.e. a Jacobi update over one
//    color; an in-place kernel would race and give another answer. Each
//    launch reads one buffer and writes the other (ping-pong).
//  - Circular shifts. jnp.roll wraps at the edges (sor.py:38-41), so the
//    neighbours of row 0 are in row N - 1 and those of column 0 in column
//    M - 1. Indices are taken modulo N and M, which keeps the result right
//    for any mask, including one that touches the edges.
//  - nvcc contracts a * b + c to FMA, so the result is not bitwise the
//    reference's; it is held to 1e-12 (f64) and 1e-5 (f32, against the
//    plain version in f64) of max |plain| in chip_smoke.py.
//
// Design: one thread per point, one launch per colored half-sweep (2 *
// sweeps launches per call, issued from the entry point below).
//
// Bound. The function reads base, cf, x0 (6 values a point) and the mask,
// and writes x (2 values): at the scale-4 block (881 x 161 = 141,841
// points, f32) 4.7 MB, 1.4 us at 3.35 TB/s. Its arithmetic is 33 flops a
// masked point for the coefficients, which the frozen base and cf fix once
// a call, and 38 a masked point and sweep for the x and y updates: 1,933
// a point for 50 sweeps, 0.27 GFLOP over the block's 139,761 masked
// points, 4.0 us at 67 TFLOP/s in f32 (chip_smoke.py computes the bound of
// each call from its inputs). This kernel recomputes the coefficients in
// every half-sweep (71 flops a point and sweep), as the reference does.
// This design instead moves about 9 planes of 4 B a point per half-sweep
// (the 8 planes above and the mask, neighbours from cache): 5.1 MB, 1.5
// us per half-sweep at the scale-4 block and 2.4 MB, 0.7 us at the bench's
// 256 x 256, so a 50-sweep call is bounded near 150 us and 70 us. Both
// are below what 100 launches cost (a few us each), so the simple design
// is launch-bound. One launch for all sweeps (a grid-wide sync between
// half-sweeps, or the block kept in shared memory / L2) is later work.

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

template <typename T>
__global__ void rb_sor_half_sweep_kernel(const T* __restrict__ base,
                                         const T* __restrict__ cf,
                                         const unsigned char* __restrict__ mask,
                                         const T* __restrict__ xin,
                                         T* __restrict__ xout, int N, int M,
                                         int parity, T omega) {
  const long n = (long)N * M;
  const long k = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int i = (int)(k / M);
  const int j = (int)(k - (long)i * M);
  if (!mask[k] || ((i + j) & 1) != parity) {
    xout[2 * k] = xin[2 * k];
    xout[2 * k + 1] = xin[2 * k + 1];
    return;
  }
  // neighbour indices modulo N and M (the circular shifts of the
  // reference): up = i + 1, dn = i - 1, rt = j + 1, lt = j - 1
  const long up = (long)(i + 1 == N ? 0 : i + 1) * M;
  const long dn = (long)(i == 0 ? N - 1 : i - 1) * M;
  const long row = (long)i * M;
  const int rt = j + 1 == M ? 0 : j + 1;
  const int lt = j == 0 ? M - 1 : j - 1;

  const T half = T(0.5);
  const T x_xi_x = half * (base[2 * (up + j)] - base[2 * (dn + j)]);
  const T x_xi_y = half * (base[2 * (up + j) + 1] - base[2 * (dn + j) + 1]);
  const T x_eta_x = half * (base[2 * (row + rt)] - base[2 * (row + lt)]);
  const T x_eta_y =
      half * (base[2 * (row + rt) + 1] - base[2 * (row + lt) + 1]);
  const T g11 = x_xi_x * x_xi_x + x_xi_y * x_xi_y;
  const T g22 = x_eta_x * x_eta_x + x_eta_y * x_eta_y;
  const T g12 = x_xi_x * x_eta_x + x_xi_y * x_eta_y;

  const T cfp = cf[2 * k];
  const T cfq = cf[2 * k + 1];
  const T diag = T(-2.0) * (g11 + g22);
  const T c_ip = g22 * (T(1) + half * cfp);
  const T c_im = g22 * (T(1) - half * cfp);
  const T c_jp = g11 * (T(1) + half * cfq);
  const T c_jm = g11 * (T(1) - half * cfq);
  const T h = half * g12;
  const T diag_safe = diag == T(0) ? T(1) : diag;
  const T scale = (-omega) / diag_safe;

#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const T z = xin[2 * k + c];
    const T res = diag * z + c_ip * xin[2 * (up + j) + c] +
                  c_im * xin[2 * (dn + j) + c] +
                  c_jp * xin[2 * (row + rt) + c] +
                  c_jm * xin[2 * (row + lt) + c] -
                  h * xin[2 * (up + rt) + c] + h * xin[2 * (up + lt) + c] +
                  h * xin[2 * (dn + rt) + c] - h * xin[2 * (dn + lt) + c];
    xout[2 * k + c] = z + scale * res;
  }
}

template <typename T>
int red_black_sor(const T* base, const T* cf, const unsigned char* mask,
                  const T* x0, T* tmp, T* out, int N, int M, double omega,
                  int sweeps, int device, void* stream) {
  turbomesh::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const long n = (long)N * M;
  const int threads = 256;
  const long blocks = (n + threads - 1) / threads;
  if (blocks == 0 || sweeps <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // x0 -> tmp (red), then tmp -> out (black), out -> tmp (red), ...: the
  // last (black) half-sweep always writes `out`
  const T* src = x0;
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int parity = 0; parity < 2; ++parity) {
      T* dst = parity == 0 ? tmp : out;
      rb_sor_half_sweep_kernel<T><<<(unsigned)blocks, threads, 0, s>>>(
          base, cf, mask, src, dst, N, M, parity, (T)omega);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      src = dst;
    }
  }
  return 0;
}

}  // namespace

// Entry points red_black_sor_f32 / _f64 of the extension module sor: 2 *
// sweeps launches on `stream` on `device`, the result in `out`; `tmp` is
// caller-allocated scratch of the same shape. They return the first failed
// launch's cudaError (0 = success).
static PyMethodDef methods[] = {
    turbomesh::method<red_black_sor<float>>("red_black_sor_f32"),
    turbomesh::method<red_black_sor<double>>("red_black_sor_f64"),
    {nullptr, nullptr, 0, nullptr}};

TURBOMESH_MODULE(sor, methods)
