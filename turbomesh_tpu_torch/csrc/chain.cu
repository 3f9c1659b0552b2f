// Connection-chain tridiagonal solve of the interface preconditioner, K-I,
// for Hopper (sm_90a).
//
// One call solves every connection chain of the plan's segment table by
// Thomas elimination and writes the solution into the chains' rows of the
// f32 correction field:
//
//   for each chain s, points k < L with valid[s, k]:  j = seg[s, k]
//     T_s = tridiag(ch_l[j], ch_d[j], ch_u[j])      (identity where invalid)
//     x_s = T_s^-1 vflat[c_row[j]]                  (x and y components)
//     z[c_row[j]] = cur + (x - cur),  cur = z[c_row[j]] on entry
//
// It replaces no Pallas kernel. It is the counterpart of the JAX package's
// lax.scan Thomas (turbomesh_tpu/smoothing/krylov.py:333) as the interface
// solve uses it (turbomesh_tpu/smoothing/device.py:1072), which the port
// had unrolled into ~1,600 eager torch kernels a call (ops/chain.py
// chain_solve_ref, the plain version).
//
// What bounds it. A T106 call reads 21 x 149 table entries, 809 rows of
// coefficients and right-hand sides and writes 809 rows: about 40 KB, so
// 0.01 us at 3.35 TB/s. What bounds it in practice is latency: a chain of
// 149 points is a recurrence of 149 dependent steps, each a multiply, a
// subtract and an IEEE division. The design therefore aims at one launch
// and no host work per step, not at bandwidth.
//
// Design: one CTA per chain. Its threads gather the chain's coefficients
// and right-hand side into shared memory (identity rows dl = du = 0,
// d = 1, rhs = 0 where the table is padded) and find n, one past its last
// valid point. Thread 0 runs the elimination over the n points, cp and the
// dp of x and y overwriting du and the rhs, then the back substitution;
// the threads scatter the solution.
// The padded tail past n is not eliminated: a division with a zero
// dividend takes the IEEE division's slow path, and eliminating the whole
// padded row took 73.7-74.4 us a T106 call against 29.8 us without the
// tail (an H100), its slowest CTA a chain of 9 points. Its effect is exact
// without it: while cp and dp end finite, the tail solves to x = +0 and
// the last point reads dp - cp * 0, as the plain version computes it;
// otherwise the tail is NaN, and so is that point. What bounds the call
// then is the longest chain's n dependent steps of a multiply, a subtract
// and a division.
//
// Bit for bit: every operation rounds as the eager torch kernel it stands
// for does (__fmul_rn, __fsub_rn, __fadd_rn, __fdiv_rn: no FMA
// contraction), and an exact zero denominator becomes 1 as in
// krylov._nonzero. That holds where a value is not finite too: CUDA's
// arithmetic returns one canonical NaN, in this kernel as in the plain
// version's. tests/test_torch_chain.py holds the kernel to the plain
// version's bits on the same CUDA tensors.
//
// Shared memory: five floats a table column; a table longer than the
// device's opt-in limit allows makes the entry point return
// cudaErrorInvalidValue, on which the wrapper raises.

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kFloatsPerPoint = 5;
constexpr size_t kDefaultShared = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
chain_thomas_kernel(const float* __restrict__ ch_l,
                    const float* __restrict__ ch_d,
                    const float* __restrict__ ch_u,
                    const long long* __restrict__ seg,
                    const unsigned char* __restrict__ valid,
                    const long long* __restrict__ c_row,
                    const float* __restrict__ vflat, float* __restrict__ z,
                    int L) {
  extern __shared__ float sh[];
  __shared__ int s_n;
  float* s_dl = sh;
  float* s_d = s_dl + L;
  float* s_du = s_d + L;   // then cp
  float* s_rx = s_du + L;  // then dp, then x
  float* s_ry = s_rx + L;
  const long base = (long)blockIdx.x * L;

  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  int last = 0;
  for (int k = threadIdx.x; k < L; k += blockDim.x) {
    if (valid[base + k]) {
      const long long j = seg[base + k];
      const long long r = c_row[j];
      s_dl[k] = ch_l[j];
      s_d[k] = ch_d[j];
      s_du[k] = ch_u[j];
      s_rx[k] = vflat[2 * r];
      s_ry[k] = vflat[2 * r + 1];
      last = k + 1;
    } else {
      s_dl[k] = 0.0f;
      s_d[k] = 1.0f;
      s_du[k] = 0.0f;
      s_rx[k] = 0.0f;
      s_ry[k] = 0.0f;
    }
  }
  if (last) atomicMax(&s_n, last);
  __syncthreads();

  // thread 0: the elimination, the padded tail, the back substitution
  const int n = s_n;
  if (threadIdx.x == 0 && n > 0) {
    float cp = 0.0f, px = 0.0f, py = 0.0f;
    for (int k = 0; k < n; ++k) {
      const float dl = s_dl[k];
      float denom = __fsub_rn(s_d[k], __fmul_rn(dl, cp));
      if (denom == 0.0f) denom = 1.0f;
      cp = __fdiv_rn(s_du[k], denom);
      px = __fdiv_rn(__fsub_rn(s_rx[k], __fmul_rn(dl, px)), denom);
      py = __fdiv_rn(__fsub_rn(s_ry[k], __fmul_rn(dl, py)), denom);
      s_du[k] = cp;
      s_rx[k] = px;
      s_ry[k] = py;
    }
    if (n < L) {
      // the tail's x: +0 while cp and the component's dp end finite, NaN
      // otherwise; the last point reads it as the plain version does
      const float nan = __int_as_float(0x7fffffff);
      const bool cp_ok = isfinite(cp);
      px = __fsub_rn(px, __fmul_rn(cp, cp_ok && isfinite(px) ? 0.0f : nan));
      py = __fsub_rn(py, __fmul_rn(cp, cp_ok && isfinite(py) ? 0.0f : nan));
      s_rx[n - 1] = px;
      s_ry[n - 1] = py;
    }
    for (int k = n - 2; k >= 0; --k) {
      const float c = s_du[k];
      px = __fsub_rn(s_rx[k], __fmul_rn(c, px));
      py = __fsub_rn(s_ry[k], __fmul_rn(c, py));
      s_rx[k] = px;
      s_ry[k] = py;
    }
  }
  __syncthreads();

  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    if (valid[base + k]) {
      const long long r = c_row[seg[base + k]];
      const float cx = z[2 * r], cy = z[2 * r + 1];
      z[2 * r] = __fadd_rn(cx, __fsub_rn(s_rx[k], cx));
      z[2 * r + 1] = __fadd_rn(cy, __fsub_rn(s_ry[k], cy));
    }
  }
}

}  // namespace

// Entry point chain_solve of the extension module chain. `z` holds the
// correction field (P, 2) f32 on entry and is updated in place at the
// chains' rows; the table (seg, valid) is (S, L), row-major. Launches on
// `stream` on `device` and returns cudaGetLastError() of the launch
// (0 = success), or cudaErrorInvalidValue when a column of five floats a
// point does not fit the device's shared memory.
static int chain_solve(const float* ch_l, const float* ch_d,
                       const float* ch_u, const long long* seg,
                       const unsigned char* valid, const long long* c_row,
                       const float* vflat, float* z, int S, int L, int device,
                       void* stream) {
  turbomesh::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (S <= 0 || L <= 0) return 0;
  const size_t shmem = sizeof(float) * kFloatsPerPoint * (size_t)L;
  if (shmem > kDefaultShared) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, chain_thomas_kernel);
    if (err != cudaSuccess) return (int)err;
    if (shmem + attr.sharedSizeBytes > (size_t)optin)
      return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(chain_thomas_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  chain_thomas_kernel<<<(unsigned)S, kThreads, shmem,
                        static_cast<cudaStream_t>(stream)>>>(
      ch_l, ch_d, ch_u, seg, valid, c_row, vflat, z, L);
  return (int)cudaGetLastError();
}

static PyMethodDef methods[] = {
    turbomesh::method<chain_solve>("chain_solve"),
    {nullptr, nullptr, 0, nullptr}};

TURBOMESH_MODULE(chain, methods)
