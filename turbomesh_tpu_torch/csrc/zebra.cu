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
// Design: one thread per line, over B x lines. Both line directions are
// handled by strides (no transposes, no P/Q swap): axis 0 lines run along
// i (stride Mg, one line per column j), axis 1 lines along j (stride 1,
// one line per row i). The forward Thomas sweep forms the residual of
// each line point on the fly from the 3x3 neighbourhood of z and the
// metrics of bx/by, and solves x and y in the same pass with shared
// diagonals. The normalized super-diagonal c' goes to the scratch plane
// `cp` (allocated by the caller); the forward-swept right-hand sides are
// parked in the output planes and overwritten by z + sel * sol during the
// back substitution. Zero denominators become 1, as in the reference
// (zebra.py:197,206, krylov.py:345-346). Where msk == 0 the residual is
// exactly 0 and no neighbour is read; neighbour indices are clamped at the
// ghost frame, so no out-of-range read can reach a result.
//
// Bound: device memory. Per point and half-sweep the kernel reads about
// 18 f32 values (13 planes, with neighbour reads mostly from cache) and
// writes/re-reads about 5 (outx, outy, cp in the forward sweep, read back
// and rewritten in the back substitution): ~20 f32 reads and writes per
// point, ~80 bytes. For axis 0 neighbouring threads touch neighbouring
// columns, so loads coalesce. For axis 1 the threads of a warp sit Mg
// elements apart, so each load is a separate transaction: uncoalesced,
// left to a later change (a tiled transpose through shared memory, or a
// warp per line with a parallel tridiagonal solve). Parallelism is only
// B x lines threads, each sequential over its line.

#include <cuda_runtime.h>

namespace {

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

__global__ void zebra_half_sweep_kernel(Planes s, float* __restrict__ outx,
                                        float* __restrict__ outy,
                                        float* __restrict__ cp, int B, int Ng,
                                        int Mg, int axis) {
  const int lines = axis == 0 ? Mg : Ng;  // lines per plane
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)B * lines) return;
  const int b = (int)(t / lines);
  const int l = (int)(t % lines);
  const long p = (long)b * Ng * Mg;
  const int n = axis == 0 ? Ng : Mg;       // points per line
  const long stride = axis == 0 ? Mg : 1;
  const long first = p + (axis == 0 ? (long)l : (long)l * Mg);

  // forward sweep: residual on the fly, elimination for x and y
  float c_prev = 0.0f, px_prev = 0.0f, py_prev = 0.0f;
  for (int k = 0; k < n; ++k) {
    const long idx = first + k * stride;
    const int i = axis == 0 ? k : l;
    const int j = axis == 0 ? l : k;
    float resx = 0.0f, resy = 0.0f;
    const float m = s.msk[idx];
    if (m != 0.0f) residual(s, p, i, j, Ng, Mg, m, &resx, &resy);
    const float a = k == 0 ? 0.0f : s.dl[idx];
    float den = s.d[idx] - a * c_prev;
    if (den == 0.0f) den = 1.0f;
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

  // back substitution, writing z + sel * sol in place of the swept rhs
  float xn = px_prev, yn = py_prev;
  {
    const long idx = first + (long)(n - 1) * stride;
    const float sl = s.sel[idx];
    outx[idx] = s.zx[idx] + sl * xn;
    outy[idx] = s.zy[idx] + sl * yn;
  }
  for (int k = n - 2; k >= 0; --k) {
    const long idx = first + k * stride;
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

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns cudaGetLastError() of the launch (0 = success).
extern "C" int zebra_half_sweep(const float* bx, const float* by,
                                const float* cfp, const float* cfq,
                                const float* dl, const float* d,
                                const float* du, const float* msk,
                                const float* sel, const float* rx,
                                const float* ry, const float* zx,
                                const float* zy, float* outx, float* outy,
                                float* cp, int B, int Ng, int Mg, int axis,
                                void* stream) {
  Planes s{bx, by, cfp, cfq, dl, d, du, msk, sel, rx, ry, zx, zy};
  const long total = (long)B * (axis == 0 ? Mg : Ng);
  const int threads = 128;
  const long blocks = (total + threads - 1) / threads;
  if (blocks > 0) {
    zebra_half_sweep_kernel<<<(unsigned)blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        s, outx, outy, cp, B, Ng, Mg, axis);
  }
  return (int)cudaGetLastError();
}
