// Build-and-launch probe for Hopper (sm_90a): out = in + 1.
//
// Replaces the probe kernel `k` of turbomesh_tpu/ops/zebra.py:297 (inside
// pallas_service_ok, :287-309), which o_ref[:] = i_ref[:] + 1.0 on one
// (8, 128) f32 tile. On the TPU it gated the Pallas kernels off when the
// remote compile service failed. Here it gates nothing: it shows that nvcc
// builds for this card and that a kernel launches and writes its output;
// a failure raises in the wrapper (ops/probe.py).
//
// Bound: 8 KiB in and out at 3.35 TB/s, a few nanoseconds; any real call
// is launch latency, and on the host the wrapper's path: ops/_build.py
// launch passes the device ordinal and PyTorch's current stream straight
// to this entry point, which switches device only when it must
// (launch.cuh). One thread per element, grid-stride loop.

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

__global__ void probe_kernel(const float* __restrict__ in,
                             float* __restrict__ out, long n) {
  for (long k = blockIdx.x * (long)blockDim.x + threadIdx.x; k < n;
       k += (long)gridDim.x * blockDim.x) {
    out[k] = in[k] + 1.0f;
  }
}

}  // namespace

// Entry point probe_add_one of the extension module probe. Launches on
// `stream` on `device` and returns cudaGetLastError() of the launch (0 =
// success).
static int probe_add_one(const float* in, float* out, long n, int device,
                         void* stream) {
  turbomesh::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const int threads = 128;
  long blocks = (n + threads - 1) / threads;
  if (blocks > 1024) blocks = 1024;
  if (blocks > 0) {
    probe_kernel<<<(unsigned)blocks, threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(in, out, n);
  }
  return (int)cudaGetLastError();
}

static PyMethodDef methods[] = {
    turbomesh::method<probe_add_one>("probe_add_one"),
    {nullptr, nullptr, 0, nullptr}};

TURBOMESH_MODULE(probe, methods)
