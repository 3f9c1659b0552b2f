// The linear Winslow operator of one Picard step, K-W, for Hopper (sm_90a).
//
// One call applies the affine equation map of DeviceSmoother._apply to a
// flat field v (P = B * N * M padded points, two components) and writes
// every row of the result:
//
//   out[p] = scale[p] * free[p] * row_p(S(v))     (scale optional)
//
// S(v) is the slave substitution, read through the per-point source table
// `src` (src[q] = q, or -(k + 1) for the k-th slave, which reads
// v[sl_master[k]] + w * sl_off[k]); row_p is the row the per-point table
// `row` names (its low 3 bits the kind, bits 3 and 4 the free x and y
// components, bits 5 and up the index into the kind's per-row tables):
// the interior 9-point Winslow stencil with the metrics frozen at the base
// (f32: the f64-differenced metrics G, (B, N-2, M-2, 3); f64: formed here
// from the base coordinates), a connection middle row (the c_* tables,
// the metrics cG, the periodic shift w * c_pi), a junction row (l_stencil,
// l_weight, w * l_rhs), a sliding row (y - y of s_nb), or none (0).
// w = 1 gives the affine map F(v), w = 0 the linear map A v.
//
// It ports no Pallas kernel: the JAX package leaves this map to XLA
// (turbomesh_tpu/smoothing/device.py _apply). It was added because the
// port issued it as 109-126 eager torch kernels a call, about 25 times a
// FGMRES iteration in f64 and 63 times in f32 inside the preconditioner's
// CUDA graph; on the H100 those gathers and small elementwise kernels
// outweighed the line-relaxation kernel K-A.
//
// What bounds it: bytes. A T106 call (72,488 padded points) reads the two
// tables (8 B a point), the field, the control function, the base (f64:
// 16 B) or the metrics (f32: 12 B), the optional scale, and writes the
// result: 88 B a point in f64 with the scale, 44 in f32, 6.4 / 3.2 MB, so
// 1.9 / 1.0 us at 3.35 TB/s, below a launch's latency. The design is one
// launch with one thread a padded point, each writing its point's two
// components and nothing else, its nine neighbours read through the source
// table (neighbouring threads read neighbouring addresses, so the L1 and
// L2 serve most of the reuse); no shared memory, no atomics.
//
// Bit for bit: every operation rounds as the eager torch kernel it stands
// for (__fmul_rn, __dadd_rn, ...: no FMA contraction), in the eager
// expression's order, so interior, connection and sliding rows equal the
// plain version's on the card. A junction row's sum runs in the order of
// torch's CUDA reduction (four accumulators over the stencil, k mod 4,
// combined in turn); a reduction configured otherwise rounds differently
// there, which the tests bound by 1e-14 (f64) and 1e-6 (f32) relative.

#include <cuda_runtime.h>

#include <type_traits>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kInterior = 1, kConnection = 2, kJunction = 3, kSliding = 4;
constexpr int kKindMask = 7, kFreeX = 8, kFreeY = 16, kIndexShift = 5;
// torch's CUDA reduction keeps this many accumulators a thread (Reduce.cuh
// vt0)
constexpr int kSumLanes = 4;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

template <typename T>
struct Args {
  const int* row;          // (P,) kind | free bits | index << kIndexShift
  const int* src;          // (P,) q, or -(k + 1) for the k-th slave
  const T* v;              // (P, 2)
  const T* cf;             // (P, 2) control function, storage frame
  const double* base;      // (P, 2) f64 frozen coordinates (f64 only)
  const float* G;          // (B, N-2, M-2, 3) f32 metrics (f32 only)
  const T* cG;             // (C, 3) connection metrics
  const T* scale;          // (P, 2) row scale, or null
  const long long* c_g0m;  // (C,) each: the connection rows' neighbours
  const long long* c_g0p;
  const long long* c_in0;
  const long long* c_in1;
  const long long* c_d0m;
  const long long* c_d0p;
  const long long* c_d1m;
  const long long* c_d1p;
  const T* c_pi;                 // (C, 2)
  const unsigned char* c_swap;   // (C,) bool
  const long long* l_stencil;    // (L, K)
  const T* l_weight;             // (L, K)
  const T* l_rhs;                // (L, 2)
  const long long* s_nb;         // (S,)
  const long long* sl_master;    // (Q,)
  const T* sl_off;               // (Q, 2)
  T w;                           // with_offsets
  T* out;                        // (P, 2)
  long long P;
  int N, M, K;
};

template <typename T>
struct Pair {
  T x, y;
};

// Point q of the slave-substituted field.
template <typename T>
__device__ __forceinline__ Pair<T> load(const Args<T>& a, long long q) {
  const int s = a.src[q];
  if (s >= 0) return {a.v[2 * (long long)s], a.v[2 * (long long)s + 1]};
  const long long k = -1 - (long long)s;
  const long long m = a.sl_master[k];
  return {add(a.v[2 * m], mul(a.w, a.sl_off[2 * k])),
          add(a.v[2 * m + 1], mul(a.w, a.sl_off[2 * k + 1]))};
}

// Component c of a pair.
template <typename T>
__device__ __forceinline__ T at(const Pair<T>& u, int c) {
  return c ? u.y : u.x;
}

template <typename T>
__device__ __forceinline__ Pair<T> base_at(const Args<T>& a, long long q) {
  return {(T)a.base[2 * q], (T)a.base[2 * q + 1]};
}

// The interior row of point p = (b, i, j): _interior_apply's expression.
template <typename T>
__device__ Pair<T> interior_row(const Args<T>& a, long long p) {
  const long long M = a.M;
  T g11, g12, g22;
  if constexpr (std::is_same_v<T, float>) {
    const long long NM = (long long)a.N * M;
    const long long b = p / NM, r = p - b * NM;
    const long long i = r / M, j = r - i * M;
    const long long g = ((b * (a.N - 2) + i - 1) * (M - 2) + j - 1) * 3;
    g11 = a.G[g];
    g12 = a.G[g + 1];
    g22 = a.G[g + 2];
  } else {
    // _metrics at the frozen base: i along N (stride M), j along M
    const Pair<T> im = base_at(a, p - M), ip = base_at(a, p + M);
    const Pair<T> jm = base_at(a, p - 1), jp = base_at(a, p + 1);
    const T x_xi = mul(T(0.5), sub(ip.x, im.x));
    const T x_eta = mul(T(0.5), sub(jp.x, jm.x));
    const T y_xi = mul(T(0.5), sub(ip.y, im.y));
    const T y_eta = mul(T(0.5), sub(jp.y, jm.y));
    g22 = add(mul(x_eta, x_eta), mul(y_eta, y_eta));
    g12 = add(mul(x_xi, x_eta), mul(y_xi, y_eta));
    g11 = add(mul(x_xi, x_xi), mul(y_xi, y_xi));
  }
  const T P = a.cf[2 * p], Q = a.cf[2 * p + 1];
  const T hP = mul(T(0.5), P), hQ = mul(T(0.5), Q);
  const T c_ij = sub(mul(T(-2), g22), mul(T(2), g11));
  const T c_ip = mul(g22, add(T(1), hP));
  const T c_im = mul(g22, sub(T(1), hP));
  const T c_jp = mul(g11, add(T(1), hQ));
  const T c_jm = mul(g11, sub(T(1), hQ));
  const T h = mul(T(0.5), g12);
  const Pair<T> vc = load(a, p);
  const Pair<T> v_ip = load(a, p + M), v_im = load(a, p - M);
  const Pair<T> v_jp = load(a, p + 1), v_jm = load(a, p - 1);
  const Pair<T> v_pp = load(a, p + M + 1), v_pm = load(a, p + M - 1);
  const Pair<T> v_mp = load(a, p - M + 1), v_mm = load(a, p - M - 1);
  const auto component = [&](int c) {
    T acc = mul(c_ij, at(vc, c));
    acc = add(acc, mul(c_ip, at(v_ip, c)));
    acc = add(acc, mul(c_im, at(v_im, c)));
    acc = add(acc, mul(c_jp, at(v_jp, c)));
    acc = add(acc, mul(c_jm, at(v_jm, c)));
    acc = sub(acc, mul(h, at(v_pp, c)));
    acc = add(acc, mul(h, at(v_pm, c)));
    acc = add(acc, mul(h, at(v_mp, c)));
    return sub(acc, mul(h, at(v_mm, c)));
  };
  return {component(0), component(1)};
}

// Connection middle row k at point p (smooth.zig:994-1105's layout).
template <typename T>
__device__ Pair<T> connection_row(const Args<T>& a, long long p, long long k) {
  const T g11 = a.cG[3 * k], g12 = a.cG[3 * k + 1], g22 = a.cG[3 * k + 2];
  const bool swap = a.c_swap[k] != 0;
  const T P = swap ? a.cf[2 * p + 1] : a.cf[2 * p];
  const T Q = swap ? a.cf[2 * p] : a.cf[2 * p + 1];
  const T c_ij = sub(mul(T(-2), g22), mul(T(2), g11));
  const T c_ip1 = mul(g22, add(T(1), mul(T(0.5), P)));
  const T c_im1 = mul(g22, sub(T(1), mul(T(0.5), P)));
  const T c_jp1 = mul(g11, add(T(1), mul(T(0.5), Q)));
  const T c_jm1 = mul(g11, sub(T(1), mul(T(0.5), Q)));
  const T c_pp = mul(T(-0.5), g12), c_pm = mul(T(0.5), g12);
  const T c_mp = c_pm, c_mm = c_pp;
  const Pair<T> vc = load(a, p);
  const Pair<T> g0p = load(a, a.c_g0p[k]), g0m = load(a, a.c_g0m[k]);
  const Pair<T> in0 = load(a, a.c_in0[k]), in1 = load(a, a.c_in1[k]);
  const Pair<T> d0m = load(a, a.c_d0m[k]), d0p = load(a, a.c_d0p[k]);
  const Pair<T> d1m = load(a, a.c_d1m[k]), d1p = load(a, a.c_d1p[k]);
  const auto component = [&](int c) {
    const T pi = mul(a.w, a.c_pi[2 * k + c]);
    T acc = mul(c_ij, at(vc, c));
    acc = add(acc, mul(c_ip1, at(g0p, c)));
    acc = add(acc, mul(c_im1, at(g0m, c)));
    acc = add(acc, mul(c_jm1, at(in0, c)));
    acc = add(acc, mul(c_jp1, sub(at(in1, c), pi)));
    acc = add(acc, mul(c_mm, at(d0m, c)));
    acc = add(acc, mul(c_pm, at(d0p, c)));
    acc = add(acc, mul(c_mp, sub(at(d1m, c), pi)));
    return add(acc, mul(c_pp, sub(at(d1p, c), pi)));
  };
  return {component(0), component(1)};
}

// Junction row k: sum over the stencil of weight * value, minus w * rhs.
template <typename T>
__device__ Pair<T> junction_row(const Args<T>& a, long long k) {
  T lane_x[kSumLanes], lane_y[kSumLanes];
#pragma unroll
  for (int l = 0; l < kSumLanes; ++l) lane_x[l] = lane_y[l] = T(0);
  const long long* st = a.l_stencil + k * a.K;
  const T* wt = a.l_weight + k * a.K;
  for (int e = 0; e < a.K; ++e) {
    const Pair<T> u = load(a, st[e]);
    const T wgt = wt[e];
    const int l = e % kSumLanes;
    lane_x[l] = add(lane_x[l], mul(wgt, u.x));
    lane_y[l] = add(lane_y[l], mul(wgt, u.y));
  }
  T sx = lane_x[0], sy = lane_y[0];
#pragma unroll
  for (int l = 1; l < kSumLanes; ++l) {
    sx = add(sx, lane_x[l]);
    sy = add(sy, lane_y[l]);
  }
  return {sub(sx, mul(a.w, a.l_rhs[2 * k])),
          sub(sy, mul(a.w, a.l_rhs[2 * k + 1]))};
}

template <typename T>
__global__ void __launch_bounds__(kThreads) winslow_kernel(const Args<T> a) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.P) return;
  const int code = a.row[p];
  const long long k = code >> kIndexShift;
  Pair<T> r = {T(0), T(0)};
  switch (code & kKindMask) {
    case kInterior:
      r = interior_row(a, p);
      break;
    case kConnection:
      r = connection_row(a, p, k);
      break;
    case kJunction:
      r = junction_row(a, k);
      break;
    case kSliding:
      r.y = sub(load(a, p).y, load(a, a.s_nb[k]).y);
      break;
    default:
      break;
  }
  T ox = (code & kFreeX) ? r.x : T(0);
  T oy = (code & kFreeY) ? r.y : T(0);
  if (a.scale != nullptr) {
    ox = mul(a.scale[2 * p], ox);
    oy = mul(a.scale[2 * p + 1], oy);
  }
  a.out[2 * p] = ox;
  a.out[2 * p + 1] = oy;
}

template <typename T>
int launch_winslow(const Args<T>& a, int device, void* stream) {
  turbomesh::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (a.P <= 0) return 0;
  const unsigned blocks = (unsigned)((a.P + kThreads - 1) / kThreads);
  winslow_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Entry points winslow_f32 and winslow_f64 of the extension module
// winslow: the field, control function, metrics, scale and output of one
// call, then the mesh's tables (ops/winslow.py WinslowTables keeps their
// pointers), then with_offsets, the sizes, the device and the stream.
// Each launches on `stream` on `device` and returns cudaGetLastError() of
// the launch (0 = success). f32 reads the metrics G (base unused); f64
// forms them from base (G unused). scale may be 0 (none).
static int winslow_f32(const float* v, const float* cf, const float* G,
                       const float* cG, const float* scale, float* out,
                       const int* row, const int* src,
                       const long long* c_g0m, const long long* c_g0p,
                       const long long* c_in0, const long long* c_in1,
                       const long long* c_d0m, const long long* c_d0p,
                       const long long* c_d1m, const long long* c_d1p,
                       const float* c_pi, const unsigned char* c_swap,
                       const long long* l_stencil, const float* l_weight,
                       const float* l_rhs, const long long* s_nb,
                       const long long* sl_master, const float* sl_off,
                       double w, long long P, int N, int M, int K,
                       int device, void* stream) {
  const Args<float> a{row,   src,   v,     cf,    nullptr, G,     cG,
                      scale, c_g0m, c_g0p, c_in0, c_in1,   c_d0m, c_d0p,
                      c_d1m, c_d1p, c_pi,  c_swap, l_stencil, l_weight,
                      l_rhs, s_nb,  sl_master, sl_off, (float)w, out,
                      P,     N,     M,     K};
  return launch_winslow(a, device, stream);
}

static int winslow_f64(const double* v, const double* cf, const double* base,
                       const double* cG, const double* scale, double* out,
                       const int* row, const int* src,
                       const long long* c_g0m, const long long* c_g0p,
                       const long long* c_in0, const long long* c_in1,
                       const long long* c_d0m, const long long* c_d0p,
                       const long long* c_d1m, const long long* c_d1p,
                       const double* c_pi, const unsigned char* c_swap,
                       const long long* l_stencil, const double* l_weight,
                       const double* l_rhs, const long long* s_nb,
                       const long long* sl_master, const double* sl_off,
                       double w, long long P, int N, int M, int K,
                       int device, void* stream) {
  const Args<double> a{row,   src,   v,     cf,    base,  nullptr, cG,
                       scale, c_g0m, c_g0p, c_in0, c_in1, c_d0m,   c_d0p,
                       c_d1m, c_d1p, c_pi,  c_swap, l_stencil, l_weight,
                       l_rhs, s_nb,  sl_master, sl_off, w, out,
                       P,     N,     M,     K};
  return launch_winslow(a, device, stream);
}

static PyMethodDef methods[] = {
    turbomesh::method<winslow_f32>("winslow_f32"),
    turbomesh::method<winslow_f64>("winslow_f64"),
    {nullptr, nullptr, 0, nullptr}};

TURBOMESH_MODULE(winslow, methods)
