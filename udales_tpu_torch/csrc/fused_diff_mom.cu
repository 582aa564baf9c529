// SGS momentum diffusion du, dv, dw in one pass (modsubgrid.f90:672-997).
//
// Replaces the TPU Pallas kernel `fused_diff_mom`
// (udales_tpu/ops/pallas_stencil.py:191, pallas_call at :344).  It computes
// exactly what the plain sweeps udales_tpu_torch/ops/subgrid.py diff_u,
// diff_v and diff_w compute, with the same formulas in the same order.
//
// Inputs are the h=1 ghosted fields of ops/boundary.py, all C-contiguous
// with z fastest:
//   u, v, ekm  (nx+2, ny+2, nz+2)   cell arrays with one k ghost each side
//   w          (nx+2, ny+2, nz+1)   face array, no k ghost
// Outputs: du, dv (nx, ny, nz) and dw (nx, ny, nz+1) with faces 0 and nz
// written as zero.  Vertical metrics arrive as device vectors:
//   dzf_g (nz+2), dzhiq (nz+1), dzhi (nz+1), dzfi_g (nz+2); dzfi[k] is
//   read as dzfi_g[k+1], which holds the same value.
//
// What bounds it on the H100: bytes.  Per grid point it reads about four
// input fields (u, v, w, ekm) and writes three, some 28 bytes in float32
// against roughly 150 flops, far below the card's ~20 flop/byte balance
// point, so it is memory-bound at 3.35 TB/s.  The simple design: one
// thread per output point (i, j, k), k fastest across consecutive threads
// so every neighbour load of a warp is one coalesced z-run; the 27-point
// neighbourhood is re-read from L1/L2 rather than tiled in shared memory.
// Each point is written exactly once (du, dv and dw of the same (i, j, k)
// by the same thread), so the kernel needs no synchronisation.  The TPU
// kernel's z-roll with its k = 0 / nz-1 epilogue and its nz % 128 gate
// were lane-layout workarounds and are not carried over: every z row is
// computed straight from the ghosted inputs.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void fused_diff_mom_kernel(
    const T* __restrict__ u, const T* __restrict__ v,
    const T* __restrict__ w, const T* __restrict__ ekm,
    const T* __restrict__ dzf_g, const T* __restrict__ dzhiq,
    const T* __restrict__ dzhi, const T* __restrict__ dzfi_g,
    T* __restrict__ du, T* __restrict__ dv, T* __restrict__ dw,
    int nx, int ny, int nz, T dxi, T dyi, T dx2i, T dy2i) {
  const int nf = nz + 1;  // k runs over the nz+1 faces; cells use k < nz
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)nx * ny * nf;
  if (idx >= total) return;
  const int k = (int)(idx % nf);
  const int j = (int)((idx / nf) % ny);
  const int i = (int)(idx / ((long long)nf * ny));

  // cell arrays: G[1+i+di, 1+j+dj, 1+k+dk]; face array: W[1+i+di, 1+j+dj, k+dk]
  const long long cy = nz + 2, cx = (long long)(ny + 2) * cy;
  const long long wy = nz + 1, wx = (long long)(ny + 2) * wy;
  const long long c0 = (1 + i) * cx + (1 + j) * cy + (1 + k);
  const long long w0 = (1 + i) * wx + (1 + j) * wy + k;
#define C(A, di, dj, dk) A[c0 + (di) * cx + (dj) * cy + (dk)]
#define W(di, dj, dk) w[w0 + (di) * wx + (dj) * wy + (dk)]

  if (k < nz) {
    const T dzf_km = dzf_g[k], dzf_k = dzf_g[k + 1], dzf_kp = dzf_g[k + 2];
    const T dzhiq_k = dzhiq[k], dzhiq_kp = dzhiq[k + 1];
    const T dzhi_k = dzhi[k], dzhi_kp = dzhi[k + 1];
    const T dzfi_k = dzfi_g[k + 1];
    const T ekm_c = C(ekm, 0, 0, 0);
    const long long o = ((long long)i * ny + j) * nz + k;

    // ---- diff_u (modsubgrid.f90:672-775) ----
    {
      const T ekm_im = C(ekm, -1, 0, 0);
      const T emom = (dzf_km * (ekm_c + ekm_im)
                      + dzf_k * (C(ekm, 0, 0, -1) + C(ekm, -1, 0, -1))) * dzhiq_k;
      const T emop = (dzf_kp * (ekm_c + ekm_im)
                      + dzf_k * (C(ekm, 0, 0, 1) + C(ekm, -1, 0, 1))) * dzhiq_kp;
      const T empo = T(0.25) * (ekm_c + C(ekm, 0, 1, 0) + C(ekm, -1, 0, 0)
                                + C(ekm, -1, 1, 0));
      const T emmo = T(0.25) * (ekm_c + C(ekm, 0, -1, 0) + C(ekm, -1, -1, 0)
                                + C(ekm, -1, 0, 0));
      const T uc = C(u, 0, 0, 0);
      const T t_x = (ekm_c * (C(u, 1, 0, 0) - uc)
                     - ekm_im * (uc - C(u, -1, 0, 0))) * T(2.0) * dx2i;
      const T t_y = (empo * ((C(u, 0, 1, 0) - uc) * dyi
                             + (C(v, 0, 1, 0) - C(v, -1, 1, 0)) * dxi)
                     - emmo * ((uc - C(u, 0, -1, 0)) * dyi
                               + (C(v, 0, 0, 0) - C(v, -1, 0, 0)) * dxi)) * dyi;
      const T t_z = (emop * ((C(u, 0, 0, 1) - uc) * dzhi_kp
                             + (W(0, 0, 1) - W(-1, 0, 1)) * dxi)
                     - emom * ((uc - C(u, 0, 0, -1)) * dzhi_k
                               + (W(0, 0, 0) - W(-1, 0, 0)) * dxi)) * dzfi_k;
      du[o] = t_x + t_y + t_z;
    }
    // ---- diff_v (modsubgrid.f90:778-886) ----
    {
      const T ekm_jm = C(ekm, 0, -1, 0);
      const T eomm = (dzf_km * (ekm_c + ekm_jm)
                      + dzf_k * (C(ekm, 0, 0, -1) + C(ekm, 0, -1, -1))) * dzhiq_k;
      const T eomp = (dzf_kp * (ekm_c + ekm_jm)
                      + dzf_k * (C(ekm, 0, 0, 1) + C(ekm, 0, -1, 1))) * dzhiq_kp;
      const T emmo = T(0.25) * (ekm_c + ekm_jm + C(ekm, -1, -1, 0)
                                + C(ekm, -1, 0, 0));
      const T epmo = T(0.25) * (ekm_c + ekm_jm + C(ekm, 1, -1, 0)
                                + C(ekm, 1, 0, 0));
      const T vc = C(v, 0, 0, 0);
      const T t_x = (epmo * ((C(v, 1, 0, 0) - vc) * dxi
                             + (C(u, 1, 0, 0) - C(u, 1, -1, 0)) * dyi)
                     - emmo * ((vc - C(v, -1, 0, 0)) * dxi
                               + (C(u, 0, 0, 0) - C(u, 0, -1, 0)) * dyi)) * dxi;
      const T t_y = (ekm_c * (C(v, 0, 1, 0) - vc)
                     - ekm_jm * (vc - C(v, 0, -1, 0))) * T(2.0) * dy2i;
      const T t_z = (eomp * ((C(v, 0, 0, 1) - vc) * dzhi_kp
                             + (W(0, 0, 1) - W(0, -1, 1)) * dyi)
                     - eomm * ((vc - C(v, 0, 0, -1)) * dzhi_k
                               + (W(0, 0, 0) - W(0, -1, 0)) * dyi)) * dzfi_k;
      dv[o] = t_x + t_y + t_z;
    }
  }

  // ---- diff_w (modsubgrid.f90:890-997) at face kf = k ----
  // cell "above" the face is cell kf (C offset dk = 0), "below" is kf-1
  // (dk = -1); faces 0 and nz are impermeable and get zero.
  const long long ow = ((long long)i * ny + j) * nf + k;
  if (k == 0 || k == nz) {
    dw[ow] = T(0);
    return;
  }
  {
    const T dzf_km = dzf_g[k], dzf_k = dzf_g[k + 1];
    const T dzhiq_k = dzhiq[k], dzhi_k = dzhi[k];
    const T dzfi_k = dzfi_g[k + 1], dzfi_km = dzfi_g[k];
    const T ea = C(ekm, 0, 0, 0), eb = C(ekm, 0, 0, -1);
    const T emom = (dzf_km * (ea + C(ekm, -1, 0, 0))
                    + dzf_k * (eb + C(ekm, -1, 0, -1))) * dzhiq_k;
    const T eomm = (dzf_km * (ea + C(ekm, 0, -1, 0))
                    + dzf_k * (eb + C(ekm, 0, -1, -1))) * dzhiq_k;
    const T eopm = (dzf_km * (ea + C(ekm, 0, 1, 0))
                    + dzf_k * (eb + C(ekm, 0, 1, -1))) * dzhiq_k;
    const T epom = (dzf_km * (ea + C(ekm, 1, 0, 0))
                    + dzf_k * (eb + C(ekm, 1, 0, -1))) * dzhiq_k;
    const T wc = W(0, 0, 0);
    const T t_x = (epom * ((W(1, 0, 0) - wc) * dxi
                           + (C(u, 1, 0, 0) - C(u, 1, 0, -1)) * dzhi_k)
                   - emom * ((wc - W(-1, 0, 0)) * dxi
                             + (C(u, 0, 0, 0) - C(u, 0, 0, -1)) * dzhi_k)) * dxi;
    const T t_y = (eopm * ((W(0, 1, 0) - wc) * dyi
                           + (C(v, 0, 1, 0) - C(v, 0, 1, -1)) * dzhi_k)
                   - eomm * ((wc - W(0, -1, 0)) * dyi
                             + (C(v, 0, 0, 0) - C(v, 0, 0, -1)) * dzhi_k)) * dyi;
    const T t_z = (ea * (W(0, 0, 1) - wc) * dzfi_k
                   - eb * (wc - W(0, 0, -1)) * dzfi_km) * T(2.0) * dzhi_k;
    dw[ow] = t_x + t_y + t_z;
  }
#undef C
#undef W
}

template <typename T>
int launch(const void* u, const void* v, const void* w, const void* ekm,
           const void* dzf_g, const void* dzhiq, const void* dzhi,
           const void* dzfi_g, void* du, void* dv, void* dw,
           int nx, int ny, int nz, double dxi, double dyi, double dx2i,
           double dy2i, void* stream) {
  const long long total = (long long)nx * ny * (nz + 1);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  fused_diff_mom_kernel<T><<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
      (const T*)u, (const T*)v, (const T*)w, (const T*)ekm,
      (const T*)dzf_g, (const T*)dzhiq, (const T*)dzhi, (const T*)dzfi_g,
      (T*)du, (T*)dv, (T*)dw, nx, ny, nz, (T)dxi, (T)dyi, (T)dx2i,
      (T)dy2i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_diff_mom_f32(
    const void* u, const void* v, const void* w, const void* ekm,
    const void* dzf_g, const void* dzhiq, const void* dzhi,
    const void* dzfi_g, void* du, void* dv, void* dw, int nx, int ny, int nz,
    double dxi, double dyi, double dx2i, double dy2i, void* stream) {
  return launch<float>(u, v, w, ekm, dzf_g, dzhiq, dzhi, dzfi_g, du, dv, dw,
                       nx, ny, nz, dxi, dyi, dx2i, dy2i, stream);
}

extern "C" int fused_diff_mom_f64(
    const void* u, const void* v, const void* w, const void* ekm,
    const void* dzf_g, const void* dzhiq, const void* dzhi,
    const void* dzfi_g, void* du, void* dv, void* dw, int nx, int ny, int nz,
    double dxi, double dyi, double dx2i, double dy2i, void* stream) {
  return launch<double>(u, v, w, ekm, dzf_g, dzhiq, dzhi, dzfi_g, du, dv, dw,
                        nx, ny, nz, dxi, dyi, dx2i, dy2i, stream);
}
