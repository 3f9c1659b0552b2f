// The V-cycle's correction glue on the zebra planes, K-G, for Hopper
// (sm_90a).
//
// One call glues one level's correction field and writes it as the two
// ghost-framed f32 planes (B, Ng, Mg) that the zebra kernel K-A reads
// (Ng = N + 2, Mg = M + 2), every point exactly once:
//
//   out[p] = value(p)                          p a plain point
//   out[d] = cw_e * value(src_e)               d = dst_e, a copy entry
//   out[d] = sum_k jw_lk * value(member_lk)    d = dst_l, a junction master
//
// value() reads the call's input, never its output, so the entries see
// the field before any of them writes (multigrid.MapGlue.correction's
// "values read the pre-scatter field"). The input is either a
// (B, N, M, 2) field z, framed by a ghost ring of zeros (the first
// half-sweep of a smooth: value(p) = z at interior p, 0 on the ring), or
// the two framed planes that K-A wrote (every later half-sweep: value(p)
// = the plane's value where p lies on the smooth mask, else 0, as the
// V-cycle's torch.where did between the half-sweeps; the ring of K-A's
// planes is never read).
//
// The per-point byte table `code` says which point is which: kOff (off
// the smooth mask: a ghost, or an interior point the V-cycle does not
// smooth), kOn (on the mask), kDest (written by one entry: never on the
// mask, and every destination is one entry's; ops/glue.py check_tables
// holds both when the tables are built). The entries are `copy` (E rows
// of dst, src; weights `cw` (E, 2)) and `junction` (L rows of dst and K
// members; weights `jw` (L, K)), all indices into the framed points.
// With no table (code null, no entries) the field form only frames z:
// the V-cycle frames its right-hand side so.
//
// It ports no Pallas kernel: the JAX package leaves the glue to XLA
// (turbomesh_tpu/smoothing/multigrid.py _glue_correction and the
// reshaping around the zebra passes of _smooth_glued_pallas). It was
// added because the port issued this glue and the reshaping around K-A
// as about 15 small torch kernels a half-sweep (pad, gathers, multiplies,
// a sum, two cats, index_copy, two plane copies, a stack, a where), 48
// half-sweeps a T106 V-cycle inside the preconditioner's CUDA graph; on
// the H100 they outweighed K-A.
//
// What bounds it: bytes and latency. A T106 level-0 call (8 x 223 x 43 =
// 76,712 framed points, 1,906 copy entries, 12 junctions) reads the code
// byte of every point and the input (8 B) of the 23,707 points on the
// mask, and writes 8 B a point: 0.91 MB with the entries, 0.27 us at
// 3.35 TB/s, below a launch's latency. The design is one
// launch with one thread a framed point (neighbouring threads on
// neighbouring addresses) followed by one thread an entry; no shared
// memory, no atomics. A thread of a destination writes nothing, so no
// two threads write one address. Glue and K-A stay two launches: the
// entries read partner blocks' values that K-A has just written, a
// dependency across the whole grid.
//
// Bit for bit: the copies are copies, a copy entry one f32 multiply
// (__fmul_rn: 0 * v keeps the sign of v as the torch multiply does), a
// junction master the f32 products summed in the order of torch's CUDA
// reduction of the (L, K, 2) products over K (Reduce.cuh: one thread an
// output, four accumulators, member k into accumulator k mod 4 from 0,
// then combined in turn), with no FMA contraction. The mask is a select,
// not a multiply (a multiply would turn -x * 0 into -0).
//
// The second entry point writes the V-cycle's masked (B, N, M, 2) field
// from K-A's last planes: out = mask ? plane : 0 at the interior points.

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
// the per-point codes of ops/glue.py (OFF = 0)
constexpr unsigned char kOn = 1, kDest = 2;
// torch's CUDA reduction keeps this many accumulators a thread (Reduce.cuh
// vt0)
constexpr int kSumLanes = 4;

struct Args {
  const float* __restrict__ z;    // field form: (B, N, M, 2); else null
  const float* __restrict__ inx;  // planes form: (B, Ng, Mg) each
  const float* __restrict__ iny;
  const unsigned char* __restrict__ code;  // (B * Ng * Mg,) or null
  const int* __restrict__ copy;            // (E, 2): dst, src
  const float* __restrict__ cw;            // (E, 2)
  const int* __restrict__ junction;        // (L, 1 + K): dst, members
  const float* __restrict__ jw;            // (L, K)
  float* __restrict__ outx;
  float* __restrict__ outy;
  int B, Ng, Mg, E, L, K;
};

struct XY {
  float x, y;
};

// The value of framed point q as the glue reads it (x, y).
template <bool FIELD>
__device__ __forceinline__ XY value(const Args& a, long long q) {
  if constexpr (FIELD) {
    const int j = (int)(q % a.Mg);
    const long long r = q / a.Mg;
    const int i = (int)(r % a.Ng);
    const long long b = r / a.Ng;
    if (i < 1 || i > a.Ng - 2 || j < 1 || j > a.Mg - 2) return {0.0f, 0.0f};
    const long long f =
        2 * ((b * (a.Ng - 2) + (i - 1)) * (long long)(a.Mg - 2) + (j - 1));
    return {a.z[f], a.z[f + 1]};
  } else {
    if (a.code[q] != kOn) return {0.0f, 0.0f};
    return {a.inx[q], a.iny[q]};
  }
}

template <bool FIELD>
__global__ void __launch_bounds__(kThreads) glue_kernel(const Args a) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long P = (long long)a.B * a.Ng * a.Mg;
  if (t < P) {  // a framed point
    if (a.code != nullptr && a.code[t] == kDest) return;
    const XY v = value<FIELD>(a, t);
    a.outx[t] = v.x;
    a.outy[t] = v.y;
    return;
  }
  long long e = t - P;
  if (e < a.E) {  // a copy entry
    const XY v = value<FIELD>(a, a.copy[2 * e + 1]);
    const long long d = a.copy[2 * e];
    a.outx[d] = __fmul_rn(a.cw[2 * e], v.x);
    a.outy[d] = __fmul_rn(a.cw[2 * e + 1], v.y);
    return;
  }
  e -= a.E;
  if (e >= a.L) return;
  // a junction master: the weighted sum of its members
  const int* row = a.junction + e * (1 + a.K);
  const float* w = a.jw + e * a.K;
  float lane_x[kSumLanes], lane_y[kSumLanes];
#pragma unroll
  for (int l = 0; l < kSumLanes; ++l) lane_x[l] = lane_y[l] = 0.0f;
  for (int k = 0; k < a.K; ++k) {
    const XY v = value<FIELD>(a, row[1 + k]);
    const int l = k % kSumLanes;
    lane_x[l] = __fadd_rn(lane_x[l], __fmul_rn(w[k], v.x));
    lane_y[l] = __fadd_rn(lane_y[l], __fmul_rn(w[k], v.y));
  }
  float sx = lane_x[0], sy = lane_y[0];
#pragma unroll
  for (int l = 1; l < kSumLanes; ++l) {
    sx = __fadd_rn(sx, lane_x[l]);
    sy = __fadd_rn(sy, lane_y[l]);
  }
  a.outx[row[0]] = sx;
  a.outy[row[0]] = sy;
}

__global__ void __launch_bounds__(kThreads)
    unframe_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const unsigned char* __restrict__ mask,
                   float* __restrict__ out, int B, int N, int M) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * N * M) return;
  const int j = (int)(t % M);
  const long long r = t / M;
  const int i = (int)(r % N);
  const long long b = r / N;
  const long long q = (b * (N + 2) + i + 1) * (long long)(M + 2) + j + 1;
  const bool on = mask[t] != 0;
  out[2 * t] = on ? x[q] : 0.0f;
  out[2 * t + 1] = on ? y[q] : 0.0f;
}

unsigned blocks(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

}  // namespace

// Entry point glue_planes of the extension module glue. `out` holds the
// two output planes (2, B, Ng, Mg). `z` nonzero selects the field form
// (`inx`, `iny` unused), else the planes form; `code` 0 with E = L = 0
// frames z. Launches on `stream` on `device` and returns
// cudaGetLastError() of the launch (0 = success).
static int glue_planes(const float* z, const float* inx, const float* iny,
                       const unsigned char* code, const int* copy,
                       const float* cw, const int* junction, const float* jw,
                       float* out, int B, int Ng, int Mg, int E, int L, int K,
                       int device, void* stream) {
  turbomesh::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const long long P = (long long)B * Ng * Mg;
  if (P <= 0) return 0;
  const Args a{z, inx, iny, code, copy, cw, junction, jw, out, out + P,
               B, Ng, Mg, E, L, K};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks(P + E + L);
  if (z != nullptr)
    glue_kernel<true><<<grid, kThreads, 0, st>>>(a);
  else
    glue_kernel<false><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// Entry point unframe_planes: out (B, N, M, 2) = mask ? (x, y) : 0 at the
// interior of the framed planes x, y (B, N + 2, M + 2); mask (B, N, M)
// bytes.
static int unframe_planes(const float* x, const float* y,
                          const unsigned char* mask, float* out, int B,
                          int N, int M, int device, void* stream) {
  turbomesh::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const long long n = (long long)B * N * M;
  if (n <= 0) return 0;
  unframe_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, mask, out, B, N, M);
  return (int)cudaGetLastError();
}

static PyMethodDef methods[] = {
    turbomesh::method<glue_planes>("glue_planes"),
    turbomesh::method<unframe_planes>("unframe_planes"),
    {nullptr, nullptr, 0, nullptr}};

TURBOMESH_MODULE(glue, methods)
