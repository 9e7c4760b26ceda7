// pic_ref: compiled reference-semantics PIC kernels (CPU baseline + oracle).
//
// Implements, with the exact discrete semantics of the reference
// (/root/reference/src/env/{interpolate,solve,integration,util}.py, studied
// not copied):
//   * CIC charge deposition with n0*L/N/dx normalization
//   * periodic FD Poisson solve: Thomas tridiagonal elimination with a
//     Sherman-Morrison rank-1 correction (gamma parameter)
//   * central-difference gradient E = -G phi (banded, applied directly)
//   * CIC field gather
//   * Yoshida 4th-order kick/drift step (3 field evaluations)
//   * open-loop rollout with per-step field energy
//
// Purpose: (a) independent cross-validation oracle for the JAX kernels;
// (b) an honest compiled CPU baseline for bench.py — the reference's hot
// kernels are Numba-compiled (LLVM), so a -O3 C++ loop is the right
// apples-to-apples single-core baseline.
//
// Exposed with a C ABI for ctypes. Build: `make -C native`.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Workspace {
  int n_mesh;
  double dx, length;
  // Thomas factorization scratch
  std::vector<double> diag, rhs, q, dens, phi, e_mesh;
};

// Periodic FD Laplacian solve via Thomas + Sherman-Morrison, pinning handled
// exactly as the reference's gamma trick (solve.py:28-53 semantics): the
// resulting phi differs from the minimum-norm solution by a constant, which
// the gradient annihilates.
void solve_phi(Workspace& w, const double* rho, double gamma) {
  const int m = w.n_mesh;
  const double inv_dx2 = 1.0 / (w.dx * w.dx);
  const double a_diag = -2.0 * inv_dx2;  // main diagonal
  const double a_off = 1.0 * inv_dx2;    // off diagonals + periodic corners

  // Modified system: A' = A - gamma e0 e0^T - (corner products)/gamma ...
  // A'[0][0] = a_diag - gamma ; A'[m-1][m-1] = a_diag - a_off*a_off/gamma
  // then x = A'^{-1} b, q = A'^{-1} u with u = gamma e0 + a_off e_{m-1},
  // v = e0 + (a_off/gamma) e_{m-1};  x -= q (v.x)/(1 + v.q)
  auto thomas = [&](std::vector<double>& d, std::vector<double>& b) {
    // in-place Thomas with constant off-diagonals a_off
    for (int i = 1; i < m; ++i) {
      const double f = a_off / d[i - 1];
      d[i] -= f * a_off;
      b[i] -= f * b[i - 1];
    }
    b[m - 1] /= d[m - 1];
    for (int i = m - 2; i >= 0; --i) {
      b[i] = (b[i] - a_off * b[i + 1]) / d[i];
    }
  };

  w.diag.assign(m, a_diag);
  w.diag[0] = a_diag - gamma;
  w.diag[m - 1] = a_diag - a_off * a_off / gamma;

  w.rhs.assign(rho, rho + m);
  std::vector<double> d2 = w.diag;
  thomas(w.diag, w.rhs);  // rhs := x

  w.q.assign(m, 0.0);
  w.q[0] = gamma;
  w.q[m - 1] = a_off;
  thomas(d2, w.q);  // q := A'^{-1} u

  const double vx = w.rhs[0] + (a_off / gamma) * w.rhs[m - 1];
  const double vq = w.q[0] + (a_off / gamma) * w.q[m - 1];
  const double s = vx / (1.0 + vq);
  for (int i = 0; i < m; ++i) w.phi[i] = w.rhs[i] - s * w.q[i];
}

void deposit_cic(Workspace& w, const double* x, int64_t n, double n0) {
  const int m = w.n_mesh;
  std::fill(w.dens.begin(), w.dens.end(), 0.0);
  const double inv_dx = 1.0 / w.dx;
  for (int64_t p = 0; p < n; ++p) {
    double xp = std::fmod(x[p], w.length);
    if (xp < 0) xp += w.length;
    const double pos = xp * inv_dx;
    int il = (int)std::floor(pos);
    const double fr = pos - il;
    il %= m;
    const int ir = (il + 1) % m;
    w.dens[il] += 1.0 - fr;
    w.dens[ir] += fr;
  }
  const double norm = n0 * w.length / (double)n * inv_dx;
  for (int i = 0; i < m; ++i) w.dens[i] = w.dens[i] * norm - n0;
}

void e_from_phi(Workspace& w) {
  const int m = w.n_mesh;
  const double c = -1.0 / (2.0 * w.dx);
  for (int i = 0; i < m; ++i) {
    const double right = w.phi[(i + 1) % m];
    const double left = w.phi[(i - 1 + m) % m];
    w.e_mesh[i] = c * (right - left);
  }
}

void compute_field(Workspace& w, const double* x, int64_t n, double n0, double gamma,
                   const double* e_external) {
  deposit_cic(w, x, n, n0);
  solve_phi(w, w.dens.data(), gamma);
  e_from_phi(w);
  if (e_external) {
    for (int i = 0; i < w.n_mesh; ++i) w.e_mesh[i] += e_external[i];
  }
}

void gather_accel(const Workspace& w, const double* x, int64_t n, double* accel) {
  const int m = w.n_mesh;
  const double inv_dx = 1.0 / w.dx;
  for (int64_t p = 0; p < n; ++p) {
    double xp = std::fmod(x[p], w.length);
    if (xp < 0) xp += w.length;
    const double pos = xp * inv_dx;
    int il = (int)std::floor(pos);
    const double fr = pos - il;
    il %= m;
    const int ir = (il + 1) % m;
    accel[p] = -((1.0 - fr) * w.e_mesh[il] + fr * w.e_mesh[ir]);
  }
}

}  // namespace

extern "C" {

// One Yoshida-4 step in place; returns field energy PE = 0.5 sum(E^2) dx * N/L
// of the post-step self-consistent field.
double pic_ref_step(double* x, double* v, int64_t n, int n_mesh, double length,
                    double dt, double n0, double gamma, const double* e_external) {
  Workspace w;
  w.n_mesh = n_mesh;
  w.length = length;
  w.dx = length / n_mesh;
  w.diag.resize(n_mesh);
  w.rhs.resize(n_mesh);
  w.q.resize(n_mesh);
  w.dens.resize(n_mesh);
  w.phi.resize(n_mesh);
  w.e_mesh.resize(n_mesh);

  const double cbrt2 = std::cbrt(2.0);
  const double w0 = -cbrt2 / (2.0 - cbrt2);
  const double w1 = 1.0 / (2.0 - cbrt2);
  const double cs[4] = {0.5 * w1, 0.5 * (w0 + w1), 0.5 * (w0 + w1), 0.5 * w1};
  const double ds[3] = {w1, w0, w1};

  std::vector<double> accel(n);

  for (int64_t p = 0; p < n; ++p) x[p] += cs[0] * dt * v[p];
  for (int s = 0; s < 3; ++s) {
    compute_field(w, x, n, n0, gamma, e_external);
    gather_accel(w, x, n, accel.data());
    for (int64_t p = 0; p < n; ++p) {
      v[p] += ds[s] * dt * accel[p];
      x[p] += cs[s + 1] * dt * v[p];
    }
  }
  for (int64_t p = 0; p < n; ++p) {
    x[p] = std::fmod(x[p], length);
    if (x[p] < 0) x[p] += length;
  }

  compute_field(w, x, n, n0, gamma, nullptr);
  double pe = 0.0;
  for (int i = 0; i < n_mesh; ++i) pe += w.e_mesh[i] * w.e_mesh[i];
  return 0.5 * pe * w.dx * (double)n / length;
}

// Open-loop rollout of n_steps; writes PE after each step into pe_out.
void pic_ref_rollout(double* x, double* v, int64_t n, int n_mesh, double length,
                     double dt, double n0, double gamma, int n_steps, double* pe_out) {
  for (int t = 0; t < n_steps; ++t) {
    pe_out[t] = pic_ref_step(x, v, n, n_mesh, length, dt, n0, gamma, nullptr);
  }
}

// Standalone field solve: density rho (already n-n0) -> E mesh.
void pic_ref_solve_e(const double* rho, int n_mesh, double length, double gamma,
                     double* e_out) {
  Workspace w;
  w.n_mesh = n_mesh;
  w.length = length;
  w.dx = length / n_mesh;
  w.diag.resize(n_mesh);
  w.rhs.resize(n_mesh);
  w.q.resize(n_mesh);
  w.dens.resize(n_mesh);
  w.phi.resize(n_mesh);
  w.e_mesh.resize(n_mesh);
  solve_phi(w, rho, gamma);
  e_from_phi(w);
  std::memcpy(e_out, w.e_mesh.data(), sizeof(double) * n_mesh);
}

}  // extern "C"
