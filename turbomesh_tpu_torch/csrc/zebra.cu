// Zebra line-relaxation half-sweep for Hopper (sm_90a).
//
// One call performs one colored half-sweep of zebra line relaxation on a
// stack of B ghost-framed f32 planes (B, Ng, Mg), all C-contiguous:
//
//   res = msk * (r - A z)            (9-point glued Winslow stencil, x and y)
//   sol = T^-1 res                   (tridiagonal dl/d/du along `axis`)
//   out = z + sel * sol
//
// Replaces the four Pallas TPU decompositions of the same computation in
// turbomesh_tpu/ops/zebra.py: _zebra_kernel (:127, with _zebra_math :85
// and _pcr1/_pcr2 :36-82), _thomas_zebra_kernel (:138), and the "split"
// pair _residual_kernel (:232) + _pcr_kernel (:274). Their common
// contract is zebra_pass(..., use_pallas=False).
//
// What bounds it. The function reads 13 planes and writes 2: 60 bytes a
// point, 69 MB and 21 us at 3.35 TB/s on the scale-4 level-0 planes
// (8, 883, 163). A line solve is a recurrence, so one thread per line
// leaves the card idle: axis 0 there is only B x Mg = 1,304 threads, each
// walking 883 points with ~20 dependent loads a step, and axis 1 has 7,064
// threads whose loads sit Mg apart.
//
// Design: a partitioned line solve (the Thomas/PCR hybrid of batched
// tridiagonal GPU solvers; arXiv 2509.03933), on B x lines x K threads.
//  1. Each line of n points is cut into K chunks [k n / K, (k + 1) n / K).
//     One thread per chunk forms the masked residual of its points on the
//     fly from the 3x3 neighbourhood of z and the metrics of bx/by (f32).
//  2. The same thread runs a modified forward and backward elimination that
//     writes each point of its chunk as x_t = px_t - ap_t x_s - cp_t x_e in
//     terms of the chunk's end values x_s, x_e (x and y share ap, cp), and
//     leaves two rows of a reduced tridiagonal system (unit diagonal) per
//     chunk in shared memory. ap, cp, px, py go to four scratch planes
//     (L2-resident until step 4 reads them back).
//  3. One thread per line solves the 2K-unknown reduced system by Thomas
//     in shared memory (at most 64 steps).
//  4. Every thread back-substitutes its chunk and writes z + sel * sol.
// Steps 2-4 run in f64; inputs, residual and outputs stay f32. In f32 the
// partitioned elimination loses digits on the weakly dominant wall-normal
// lines: x_t = px_t - ap_t x_s - cp_t x_e cancels where the end values
// reach far into the chunk, and at scale-4 level 0, axis 1, it sits
// 1.0e-5 to 2.3e-5 from the f64 plain version for every K from 2 to 32
// (the f32 Thomas 6.7e-6, the bar 1e-5); a step of f32 refinement does not
// help, the reduced system in f64 alone does not either. With f64
// recurrences it sits at 1.5e-7 (tests/test_torch_zebra.py emulates this
// arithmetic). For the same reason the reduced system is solved by Thomas
// and not by warp-shuffle PCR: the f32 PCR of the plain version is 2.0e-5
// off there. The f64 work is a few operations a point, far below the
// card's f64 rate. What bounds the kernel now is latency: on an H100 at
// the scale-4 level-0 planes it takes 6.7x (axis 0: 88 CTAs of 512
// threads for 132 SMs) and 3x (axis 1) the 21 us that the bytes need
// (PERF.md), each thread walking its chunk's dependent steps.
// K = ops/zebra.py zebra_chunks(n): one chunk per 8 points, at most 32;
// below 16 points K = 1 and the line runs the f32 Thomas kernel (one
// thread per line). Zero denominators become 1 in every elimination, as
// in the reference (zebra.py:197,206, krylov.py:345-346).
// Identity rows (dl = du = 0, d = 1) need no case: their ap, cp, px are 0,
// so they decouple chains wherever they fall, a chunk's ends included.
//
// Layouts. Axis 0 (lines along i, one per column j, stride Mg): a CTA is
// 16 adjacent columns x K chunks, so a warp loads two row segments of 16
// contiguous floats (two full 32-byte sectors each), and the reduced
// system in f64 fits 32 KB of shared memory. Axis 1 (lines along j,
// stride 1): one warp per line, lanes = chunks of consecutive points (8
// lines a CTA). Chunks of consecutive points rather than a tile staged
// through shared memory: a chunk of ~8 points is one or two 32-byte
// sectors that the lane walks from L1, and the passes need no block-wide
// barrier between tiles.
// Lines whose sel is 0 at every point (the other color, and the padding
// outside a block) copy z through without the elimination: z + 0 * sol is
// z for every finite sol. Where msk == 0 the residual is exactly 0 and no
// neighbour is read; neighbour indices are clamped at the ghost frame, so
// no out-of-range read can reach a result.

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kMaxChunks = 32;   // ops/zebra.py MAX_CHUNKS
constexpr int kColsAxis0 = 16;   // columns (lines) of a CTA along axis 0
constexpr int kLinesAxis1 = 8;   // lines (warps) of a CTA along axis 1
constexpr int kThomasThreads = 128;

struct Planes {
  const float* __restrict__ bx;
  const float* __restrict__ by;
  const float* __restrict__ cfp;
  const float* __restrict__ cfq;
  const float* __restrict__ dl;
  const float* __restrict__ d;
  const float* __restrict__ du;
  const float* __restrict__ msk;
  const float* __restrict__ sel;
  const float* __restrict__ rx;
  const float* __restrict__ ry;
  const float* __restrict__ zx;
  const float* __restrict__ zy;
};

__device__ __forceinline__ float nonzero(float v) { return v == 0.0f ? 1.0f : v; }
__device__ __forceinline__ double nonzero(double v) { return v == 0.0 ? 1.0 : v; }

// Masked residual msk * (r - A z) at plane point (i, j), x and y.
// `p` is the offset of the plane (b * Ng * Mg).
__device__ __forceinline__ void residual(const Planes& s, long p, int i,
                                         int j, int Ng, int Mg, float m,
                                         float* resx, float* resy) {
  const int ip = min(i + 1, Ng - 1), im = max(i - 1, 0);
  const int jp = min(j + 1, Mg - 1), jm = max(j - 1, 0);
  const long c = p + (long)i * Mg + j;
  const long n_ip = p + (long)ip * Mg + j, n_im = p + (long)im * Mg + j;
  const long n_jp = p + (long)i * Mg + jp, n_jm = p + (long)i * Mg + jm;
  const long n_pp = p + (long)ip * Mg + jp, n_pm = p + (long)ip * Mg + jm;
  const long n_mp = p + (long)im * Mg + jp, n_mm = p + (long)im * Mg + jm;

  const float x_xi = 0.5f * (s.bx[n_ip] - s.bx[n_im]);
  const float y_xi = 0.5f * (s.by[n_ip] - s.by[n_im]);
  const float x_eta = 0.5f * (s.bx[n_jp] - s.bx[n_jm]);
  const float y_eta = 0.5f * (s.by[n_jp] - s.by[n_jm]);
  const float g11 = x_xi * x_xi + y_xi * y_xi;
  const float g22 = x_eta * x_eta + y_eta * y_eta;
  const float g12 = x_xi * x_eta + y_xi * y_eta;

  const float P = s.cfp[c], Q = s.cfq[c];
  const float diag = -2.0f * (g11 + g22);
  const float c_ip = g22 * (1.0f + 0.5f * P);
  const float c_im = g22 * (1.0f - 0.5f * P);
  const float c_jp = g11 * (1.0f + 0.5f * Q);
  const float c_jm = g11 * (1.0f - 0.5f * Q);
  const float h = 0.5f * g12;

  const float ax = diag * s.zx[c] + c_ip * s.zx[n_ip] + c_im * s.zx[n_im] +
                   c_jp * s.zx[n_jp] + c_jm * s.zx[n_jm] - h * s.zx[n_pp] +
                   h * s.zx[n_pm] + h * s.zx[n_mp] - h * s.zx[n_mm];
  const float ay = diag * s.zy[c] + c_ip * s.zy[n_ip] + c_im * s.zy[n_im] +
                   c_jp * s.zy[n_jp] + c_jm * s.zy[n_jm] - h * s.zy[n_pp] +
                   h * s.zy[n_pm] + h * s.zy[n_mp] - h * s.zy[n_mm];
  *resx = m * (s.rx[c] - ax);
  *resy = m * (s.ry[c] - ay);
}

// One line of the plane stack: point t sits at first + t * stride and at
// plane indices (i, j) = (t, l) for axis 0, (l, t) for axis 1.
template <int AXIS>
struct Line {
  long p;      // plane offset b * Ng * Mg
  long first;  // offset of point 0
  int l;       // column (axis 0) or row (axis 1) within the plane
  int n;       // points on the line

  __device__ Line(int b, int l_, int Ng, int Mg)
      : p((long)b * Ng * Mg),
        first(p + (AXIS == 0 ? (long)l_ : (long)l_ * Mg)),
        l(l_),
        n(AXIS == 0 ? Ng : Mg) {}

  __device__ long at(int t, int Mg) const {
    return first + (AXIS == 0 ? (long)t * Mg : (long)t);
  }

  // masked residual of x and y at point t (exactly 0 where msk == 0)
  __device__ void res(const Planes& s, int t, long idx, int Ng, int Mg,
                      float* rx, float* ry) const {
    *rx = 0.0f;
    *ry = 0.0f;
    const float m = s.msk[idx];
    if (m != 0.0f)
      residual(s, p, AXIS == 0 ? t : l, AXIS == 0 ? l : t, Ng, Mg, m, rx, ry);
  }
};

// K = 1: Thomas along the whole line, one thread per line (lines of fewer
// than 16 points). cp is the normalized super-diagonal scratch plane; the
// forward-swept right-hand sides are parked in the output planes.
template <int AXIS>
__global__ void zebra_thomas_kernel(Planes s, float* __restrict__ outx,
                                    float* __restrict__ outy,
                                    float* __restrict__ cp, int B, int Ng,
                                    int Mg) {
  const int lines = AXIS == 0 ? Mg : Ng;
  const long t_id = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t_id >= (long)B * lines) return;
  const Line<AXIS> ln((int)(t_id / lines), (int)(t_id % lines), Ng, Mg);
  const int n = ln.n;

  bool active = false;
  for (int t = 0; t < n; ++t) active |= s.sel[ln.at(t, Mg)] != 0.0f;
  if (!active) {
    for (int t = 0; t < n; ++t) {
      const long idx = ln.at(t, Mg);
      outx[idx] = s.zx[idx];
      outy[idx] = s.zy[idx];
    }
    return;
  }

  float c_prev = 0.0f, px_prev = 0.0f, py_prev = 0.0f;
  for (int t = 0; t < n; ++t) {
    const long idx = ln.at(t, Mg);
    float resx, resy;
    ln.res(s, t, idx, Ng, Mg, &resx, &resy);
    const float a = t == 0 ? 0.0f : s.dl[idx];
    const float den = nonzero(s.d[idx] - a * c_prev);
    const float c = s.du[idx] / den;
    const float px = (resx - a * px_prev) / den;
    const float py = (resy - a * py_prev) / den;
    cp[idx] = c;
    outx[idx] = px;
    outy[idx] = py;
    c_prev = c;
    px_prev = px;
    py_prev = py;
  }

  float xn = px_prev, yn = py_prev;
  {
    const long idx = ln.at(n - 1, Mg);
    const float sl = s.sel[idx];
    outx[idx] = s.zx[idx] + sl * xn;
    outy[idx] = s.zy[idx] + sl * yn;
  }
  for (int t = n - 2; t >= 0; --t) {
    const long idx = ln.at(t, Mg);
    const float c = cp[idx];
    const float x = outx[idx] - c * xn;
    const float y = outy[idx] - c * yn;
    const float sl = s.sel[idx];
    outx[idx] = s.zx[idx] + sl * x;
    outy[idx] = s.zy[idx] + sl * y;
    xn = x;
    yn = y;
  }
}

// K >= 2: the partitioned solve (steps 1-4 of the note above), its
// recurrences and the reduced system in f64.
// AXIS 0: block (kColsAxis0, K), threadIdx.x = column within the CTA,
//         threadIdx.y = chunk; grid (ceil(Mg / kColsAxis0), B).
// AXIS 1: block (32, kLinesAxis1), threadIdx.x = chunk, threadIdx.y = line
//         within the CTA; grid ceil(B * Ng / kLinesAxis1).
// Scratch: four f64 planes (ap, cp, px, py). Dynamic shared memory: the
// reduced system, 4 x [2K][LPC] doubles (A, C, RX, RY), row-major with
// the line fastest.
template <int AXIS>
__global__ void zebra_partitioned_kernel(Planes s, float* __restrict__ outx,
                                         float* __restrict__ outy,
                                         double* __restrict__ sa,
                                         double* __restrict__ sc,
                                         double* __restrict__ spx,
                                         double* __restrict__ spy, int B,
                                         int Ng, int Mg, int K) {
  constexpr int LPC = AXIS == 0 ? kColsAxis0 : kLinesAxis1;
  extern __shared__ double sh[];
  __shared__ int line_active[LPC];

  const int q = AXIS == 0 ? threadIdx.x : threadIdx.y;  // line within CTA
  const int k = AXIS == 0 ? threadIdx.y : threadIdx.x;  // chunk
  int b, l;
  bool valid;
  if (AXIS == 0) {
    b = blockIdx.y;
    l = blockIdx.x * LPC + q;
    valid = l < Mg;
  } else {
    const long line = (long)blockIdx.x * LPC + q;
    valid = line < (long)B * Ng;
    b = valid ? (int)(line / Ng) : 0;
    l = valid ? (int)(line % Ng) : 0;
  }
  valid = valid && k < K;
  const Line<AXIS> ln(b, l, Ng, Mg);
  const int n = ln.n;
  const int s0 = (int)((long)k * n / K);
  const int L = (int)((long)(k + 1) * n / K) - s0;  // >= 2 (K <= n / 2)

  const int rows = 2 * K;
  double* A = sh;
  double* C = A + rows * LPC;
  double* RX = C + rows * LPC;
  double* RY = RX + rows * LPC;
  const int r0 = (2 * k) * LPC + q;      // the chunk's start row
  const int r1 = (2 * k + 1) * LPC + q;  // its end row

  if (k == 0) line_active[q] = 0;
  __syncthreads();
  if (valid) {
    bool mine = false;
    for (int t = 0; t < L; ++t) mine |= s.sel[ln.at(s0 + t, Mg)] != 0.0f;
    if (mine) line_active[q] = 1;
  }
  __syncthreads();
  const bool solve = valid && line_active[q] != 0;

  if (valid && !solve) {
    for (int t = 0; t < L; ++t) {
      const long idx = ln.at(s0 + t, Mg);
      outx[idx] = s.zx[idx];
      outy[idx] = s.zy[idx];
    }
  }

  if (solve) {
    // forward: row t -> ap_t x_s + x_t + cp_t x_{t+1} = px_t (row 0 keeps
    // its coupling ap_0 to the previous chunk's end)
    double ap_p = 0.0, cp_p = 0.0, px_p = 0.0, py_p = 0.0;
    for (int t = 0; t < L; ++t) {
      const int g = s0 + t;
      const long idx = ln.at(g, Mg);
      float resx, resy;
      ln.res(s, g, idx, Ng, Mg, &resx, &resy);
      const double a = g == 0 ? 0.0 : (double)s.dl[idx];
      const double c = g == n - 1 ? 0.0 : (double)s.du[idx];
      double ap, px, py, r;
      if (t < 2) {
        r = 1.0 / nonzero((double)s.d[idx]);
        ap = a * r;
        px = resx * r;
        py = resy * r;
      } else {
        r = 1.0 / nonzero((double)s.d[idx] - a * cp_p);
        ap = -(a * ap_p) * r;
        px = (resx - a * px_p) * r;
        py = (resy - a * py_p) * r;
      }
      const double cpv = c * r;
      sa[idx] = ap;
      sc[idx] = cpv;
      spx[idx] = px;
      spy[idx] = py;
      ap_p = ap;
      cp_p = cpv;
      px_p = px;
      py_p = py;
    }
    // the end row: ap x_s + x_e + cp x_{next chunk's start} = px
    A[r1] = ap_p;
    C[r1] = cp_p;
    RX[r1] = px_p;
    RY[r1] = py_p;

    // backward: rows L-3 .. 1 -> ap_t x_s + x_t + cp_t x_e = px_t
    const long i0 = ln.at(s0, Mg);
    double ap0 = sa[i0], cp0 = sc[i0], px0 = spx[i0], py0 = spy[i0];
    if (L >= 3) {
      long idx = ln.at(s0 + L - 2, Mg);
      double apn = sa[idx], cpn = sc[idx], pxn = spx[idx], pyn = spy[idx];
      for (int t = L - 3; t >= 1; --t) {
        idx = ln.at(s0 + t, Mg);
        const double cpt = sc[idx];
        const double px = spx[idx] - cpt * pxn;
        const double py = spy[idx] - cpt * pyn;
        const double ap = sa[idx] - cpt * apn;
        const double cpv = -(cpt * cpn);
        sa[idx] = ap;
        sc[idx] = cpv;
        spx[idx] = px;
        spy[idx] = py;
        apn = ap;
        cpn = cpv;
        pxn = px;
        pyn = py;
      }
      // the start row, with row 1 substituted:
      // ap x_{previous chunk's end} + x_s + cp x_e = px
      const double r = 1.0 / nonzero(1.0 - cp0 * apn);
      px0 = (px0 - cp0 * pxn) * r;
      py0 = (py0 - cp0 * pyn) * r;
      ap0 = ap0 * r;
      cp0 = -(cp0 * cpn) * r;
    }
    A[r0] = ap0;
    C[r0] = cp0;
    RX[r0] = px0;
    RY[r0] = py0;
  }
  __syncthreads();

  // the reduced system of the line, by Thomas (in place: C <- c'', R <- x)
  if (solve && k == 0) {
    double cpp = 0.0, dx = 0.0, dy = 0.0;
    for (int r = 0; r < rows; ++r) {
      const int o = r * LPC + q;
      const double a = A[o];
      const double rd = 1.0 / nonzero(1.0 - a * cpp);
      cpp = C[o] * rd;
      dx = (RX[o] - a * dx) * rd;
      dy = (RY[o] - a * dy) * rd;
      C[o] = cpp;
      RX[o] = dx;
      RY[o] = dy;
    }
    for (int r = rows - 2; r >= 0; --r) {
      const int o = r * LPC + q;
      dx = RX[o] - C[o] * dx;
      dy = RY[o] - C[o] * dy;
      RX[o] = dx;
      RY[o] = dy;
    }
  }
  __syncthreads();

  if (solve) {
    const double xs = RX[r0], ys = RY[r0], xe = RX[r1], ye = RY[r1];
    for (int t = 0; t < L; ++t) {
      const long idx = ln.at(s0 + t, Mg);
      double x, y;
      if (t == 0) {
        x = xs;
        y = ys;
      } else if (t == L - 1) {
        x = xe;
        y = ye;
      } else {
        const double ap = sa[idx], cpv = sc[idx];
        x = spx[idx] - ap * xs - cpv * xe;
        y = spy[idx] - ap * ys - cpv * ye;
      }
      const float sl = s.sel[idx];
      outx[idx] = s.zx[idx] + sl * (float)x;
      outy[idx] = s.zy[idx] + sl * (float)y;
    }
  }
}

template <int AXIS>
void launch(const Planes& s, float* outx, float* outy, double* scratch,
            int B, int Ng, int Mg, int K, cudaStream_t stream) {
  const long plane = (long)B * Ng * Mg;
  if (K == 1) {
    const long total = (long)B * (AXIS == 0 ? Mg : Ng);
    const long blocks = (total + kThomasThreads - 1) / kThomasThreads;
    zebra_thomas_kernel<AXIS><<<(unsigned)blocks, kThomasThreads, 0, stream>>>(
        s, outx, outy, reinterpret_cast<float*>(scratch), B, Ng, Mg);
    return;
  }
  double* sa = scratch;
  double* sc = sa + plane;
  double* spx = sc + plane;
  double* spy = spx + plane;
  const int lpc = AXIS == 0 ? kColsAxis0 : kLinesAxis1;
  const size_t shmem = sizeof(double) * 4 * 2 * K * lpc;
  if (AXIS == 0) {
    const dim3 grid((Mg + kColsAxis0 - 1) / kColsAxis0, B),
        block(kColsAxis0, K);
    zebra_partitioned_kernel<0><<<grid, block, shmem, stream>>>(
        s, outx, outy, sa, sc, spx, spy, B, Ng, Mg, K);
  } else {
    const long lines = (long)B * Ng;
    const dim3 grid((unsigned)((lines + kLinesAxis1 - 1) / kLinesAxis1)),
        block(kWarp, kLinesAxis1);
    zebra_partitioned_kernel<1><<<grid, block, shmem, stream>>>(
        s, outx, outy, sa, sc, spx, spy, B, Ng, Mg, K);
  }
}

}  // namespace

// Entry point zebra_half_sweep of the extension module zebra. `out` holds ten f32 planes of
// the stack's shape: outx, outy, then the scratch (four f64 planes). `chunks` is
// K (ops/zebra.py zebra_chunks); it is held to [1, min(32, n / 2)]. Launches
// on `stream` on `device` and returns cudaGetLastError() of the launch
// (0 = success).
static int zebra_half_sweep(const float* bx, const float* by,
                            const float* cfp, const float* cfq,
                            const float* dl, const float* d, const float* du,
                            const float* msk, const float* sel,
                            const float* rx, const float* ry, const float* zx,
                            const float* zy, float* out, int B, int Ng,
                            int Mg, int axis, int chunks, int device,
                            void* stream) {
  turbomesh::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (B <= 0 || Ng <= 0 || Mg <= 0) return 0;
  Planes s{bx, by, cfp, cfq, dl, d, du, msk, sel, rx, ry, zx, zy};
  const long plane = (long)B * Ng * Mg;
  const int n = axis == 0 ? Ng : Mg;
  int K = chunks < kMaxChunks ? chunks : kMaxChunks;
  if (K > n / 2) K = n / 2;
  if (K < 1) K = 1;
  float* outx = out;
  float* outy = out + plane;
  // 8-byte aligned: `out` comes from PyTorch's allocator
  double* scratch = reinterpret_cast<double*>(out + 2 * plane);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (axis == 0)
    launch<0>(s, outx, outy, scratch, B, Ng, Mg, K, st);
  else
    launch<1>(s, outx, outy, scratch, B, Ng, Mg, K, st);
  return (int)cudaGetLastError();
}

static PyMethodDef methods[] = {
    turbomesh::method<zebra_half_sweep>("zebra_half_sweep"),
    {nullptr, nullptr, 0, nullptr}};

TURBOMESH_MODULE(zebra, methods)
