// General-CSR ILU(0) + GMRES(restart) host kernels for the DoF-ordering
// parity mode (cell-RCM + finite-element fill pattern), the role PETSc's
// C KSP/PC kernels play for the reference (pc_type=ilu with DMPlex
// numbering, reference solvers/parameters.py:27). The default device path
// is the structured envelope ILU in perphil_tpu/ops/ilu.py; this kernel
// exists so the ordering-faithful factorization — inherently sequential in
// an unstructured row order — runs at native speed on the host.
//
// Semantics mirror perphil_tpu/ops/ordering.py::host_ilu0 / host_gmres
// (themselves PETSc KSPGMRES/KSPConvergedDefault-faithful): left
// preconditioning, classical Gram-Schmidt (one fused pass), preconditioned
// residual norm, tol = max(rtol*||M^-1 r0||, atol).
//
// Every kernel is templated on the CSR index type and exported for both
// int64 (the original ABI) and int32 (PETSc's default PetscInt — 33% less
// index traffic in the memory-bound SpMV/trisolve, the main single-core
// cost at the reference's largest sizes).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// y = A x  (CSR)
template <typename I>
void spmv(int64_t n, const I* indptr, const I* indices, const double* data,
          const double* x, double* y) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    double s = 0.0;
    for (I k = indptr[i]; k < indptr[i + 1]; ++k) s += data[k] * x[indices[k]];
    y[i] = s;
  }
}

double dot(int64_t n, const double* a, const double* b) {
  double s = 0.0;
#pragma omp parallel for reduction(+ : s) schedule(static)
  for (int64_t i = 0; i < n; ++i) s += a[i] * b[i];
  return s;
}

double nrm2(int64_t n, const double* a) { return std::sqrt(dot(n, a, a)); }

// z = U^-1 L^-1 r over the combined factor F (unit lower implied, diag[] is
// the index of the diagonal entry in each row).
template <typename I>
void ilu_apply(int64_t n, const I* indptr, const I* indices,
               const double* data, const I* diag, const double* r, double* z,
               double* y) {
  for (int64_t i = 0; i < n; ++i) {
    double s = r[i];
    for (I k = indptr[i]; k < diag[i]; ++k) s -= data[k] * y[indices[k]];
    y[i] = s;
  }
  for (int64_t i = n - 1; i >= 0; --i) {
    double s = y[i];
    for (I k = diag[i] + 1; k < indptr[i + 1]; ++k)
      s -= data[k] * z[indices[k]];
    z[i] = s / data[diag[i]];
  }
}

// In-place IKJ ILU(0) on the stored CSR pattern (explicit zeros kept, like
// PETSc aij). indices must be sorted within each row. diag_out[i] receives
// the data-index of the diagonal entry of row i. Returns 0, or 1 on a
// zero/missing pivot.
template <typename I>
int64_t ilu0_factorize_csr(int64_t n, const I* indptr, const I* indices,
                           double* data, I* diag_out) {
  // column -> position scratch for the current row
  std::vector<I> pos(n, I(-1));
  for (int64_t i = 0; i < n; ++i) {
    diag_out[i] = I(-1);
    for (I k = indptr[i]; k < indptr[i + 1]; ++k)
      if (indices[k] == I(i)) {
        diag_out[i] = k;
        break;
      }
    if (diag_out[i] < 0) return 1;
  }
  for (int64_t i = 0; i < n; ++i) {
    const I s = indptr[i], e = indptr[i + 1];
    for (I k = s; k < e; ++k) pos[indices[k]] = k;
    for (I kk = s; kk < diag_out[i]; ++kk) {
      const I kcol = indices[kk];
      const double piv = data[diag_out[kcol]];
      if (piv == 0.0) {
        for (I k = s; k < e; ++k) pos[indices[k]] = I(-1);
        return 1;
      }
      const double f = data[kk] / piv;
      data[kk] = f;
      for (I uk = diag_out[kcol] + 1; uk < indptr[kcol + 1]; ++uk) {
        const I p = pos[indices[uk]];
        if (p >= 0) data[p] -= f * data[uk];
      }
    }
    for (I k = s; k < e; ++k) pos[indices[k]] = I(-1);
  }
  return 0;
}

// Left-preconditioned GMRES(restart) on A x = b from x = 0, PC = ILU(0)
// factors F (pass f_indptr == nullptr for unpreconditioned). Writes the
// solution into x (length n), returns the iteration count. *rnorm_out
// receives the final preconditioned residual norm. hist (may be null,
// length >= max_it + 1) receives the preconditioned residual norm
// trajectory: hist[0] = ||M^-1 r0||, hist[k] = recurrence norm after
// iteration k — the numbers KSPMonitorResidual would print.
template <typename I>
int64_t gmres_ilu_csr(int64_t n, const I* a_indptr, const I* a_indices,
                      const double* a_data, const I* f_indptr,
                      const I* f_indices, const double* f_data,
                      const I* f_diag, const double* b, double rtol,
                      double atol, int64_t restart, int64_t max_it, double* x,
                      double* rnorm_out, double* hist) {
  const bool pc = f_indptr != nullptr;
  std::vector<double> r(n), w(n), tmp(n), ytmp(n);
  std::vector<double> V((restart + 1) * n);
  std::vector<double> H((restart + 1) * restart, 0.0);
  std::vector<double> cs(restart), sn(restart), g(restart + 1);
  std::vector<double> h(restart + 1), yy(restart);
  std::memset(x, 0, n * sizeof(double));

  auto precond = [&](const double* in, double* out) {
    if (pc)
      ilu_apply(n, f_indptr, f_indices, f_data, f_diag, in, out, ytmp.data());
    else
      std::memcpy(out, in, n * sizeof(double));
  };

  // r = M^-1 (b - A x) with x = 0
  precond(b, r.data());
  const double rnorm0 = nrm2(n, r.data());
  const double tol = std::fmax(rtol * rnorm0, atol);
  double rnorm = rnorm0;
  int64_t its = 0;
  if (hist) hist[0] = rnorm0;

  while (its < max_it) {
    spmv(n, a_indptr, a_indices, a_data, x, tmp.data());
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) tmp[i] = b[i] - tmp[i];
    precond(tmp.data(), r.data());
    const double beta = nrm2(n, r.data());
    if (beta <= tol) {
      rnorm = beta;
      break;
    }
    std::fill(H.begin(), H.end(), 0.0);
    std::fill(g.begin(), g.end(), 0.0);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) V[i] = r[i] / beta;
    g[0] = beta;
    int64_t k = 0;
    while (k < restart && its < max_it) {
      spmv(n, a_indptr, a_indices, a_data, &V[k * n], tmp.data());
      precond(tmp.data(), w.data());
      // classical Gram-Schmidt, one pass (PETSc KSPGMRESClassicalGramSchmidt)
      // — all k+1 dots fused into a single sweep over the basis (PETSc's
      // VecMDot): w is read once instead of k+1 times. Each h[i] still
      // accumulates in ascending-j order, so single-thread results are
      // bit-identical to separate dots.
      for (int64_t i = 0; i <= k; ++i) h[i] = 0.0;
      {
        double* hh = h.data();
#pragma omp parallel for reduction(+ : hh[ : k + 1]) schedule(static)
        for (int64_t j = 0; j < n; ++j) {
          const double wj = w[j];
          for (int64_t i = 0; i <= k; ++i) hh[i] += V[i * n + j] * wj;
        }
      }
#pragma omp parallel for schedule(static)
      for (int64_t j = 0; j < n; ++j) {
        double s = w[j];
        for (int64_t i = 0; i <= k; ++i) s -= V[i * n + j] * h[i];
        w[j] = s;
      }
      const double hk1 = nrm2(n, w.data());
      for (int64_t i = 0; i <= k; ++i) H[i * restart + k] = h[i];
      // Givens rotations
      for (int64_t i = 0; i < k; ++i) {
        const double t =
            cs[i] * H[i * restart + k] + sn[i] * H[(i + 1) * restart + k];
        H[(i + 1) * restart + k] =
            -sn[i] * H[i * restart + k] + cs[i] * H[(i + 1) * restart + k];
        H[i * restart + k] = t;
      }
      const double d = std::hypot(H[k * restart + k], hk1);
      cs[k] = H[k * restart + k] / d;
      sn[k] = hk1 / d;
      H[k * restart + k] = d;
      g[k + 1] = -sn[k] * g[k];
      g[k] = cs[k] * g[k];
      if (hk1 > 0.0) {
#pragma omp parallel for schedule(static)
        for (int64_t i = 0; i < n; ++i) V[(k + 1) * n + i] = w[i] / hk1;
      }
      ++k;
      ++its;
      rnorm = std::fabs(g[k]);
      if (hist) hist[its] = rnorm;
      if (rnorm <= tol) break;
    }
    // back-substitute y = H[:k,:k]^-1 g[:k]; x += V[:k]^T y
    for (int64_t i = k - 1; i >= 0; --i) {
      double s = g[i];
      for (int64_t j = i + 1; j < k; ++j) s -= H[i * restart + j] * yy[j];
      yy[i] = s / H[i * restart + i];
    }
#pragma omp parallel for schedule(static)
    for (int64_t j = 0; j < n; ++j) {
      double s = x[j];
      for (int64_t i = 0; i < k; ++i) s += V[i * n + j] * yy[i];
      x[j] = s;
    }
    if (rnorm <= tol) break;
  }
  *rnorm_out = rnorm;
  return its;
}

// Sequential pointwise Gauss-Seidel sweeps on A x = b starting from x
// (updated in place), with SNESConvergedDefault-style stopping:
// ||b - A x|| <= max(rtol * ||b - A x0||, atol), or the step test
// ||x - x_prev|| < stol * ||x|| (PETSc snes_stol). Returns the sweep
// count. The role of SNES 'ngs' on one rank (lexicographic order); the
// numpy fallback is ops/ordering.py::host_gs_sweeps.
template <typename I>
int64_t gs_sweeps_csr(int64_t n, const I* indptr, const I* indices,
                      const double* data, const double* b, double* x,
                      double rtol, double atol, double stol, int64_t max_it) {
  std::vector<double> diag(n), r(n), prev(n);
  for (int64_t i = 0; i < n; ++i) {
    diag[i] = 0.0;
    for (I k = indptr[i]; k < indptr[i + 1]; ++k)
      if (indices[k] == I(i)) {
        diag[i] = data[k];
        break;
      }
  }
  spmv(n, indptr, indices, data, x, r.data());
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) r[i] = b[i] - r[i];
  const double f0 = nrm2(n, r.data());
  const double tol = std::max(rtol * f0, atol);
  int64_t sweeps = 0;
  double fn = f0;
  while (fn > tol && sweeps < max_it) {
    std::memcpy(prev.data(), x, sizeof(double) * n);
    for (int64_t i = 0; i < n; ++i) {
      double s = b[i];
      for (I k = indptr[i]; k < indptr[i + 1]; ++k) {
        const I j = indices[k];
        if (j != I(i)) s -= data[k] * x[j];
      }
      x[i] = s / diag[i];
    }
    ++sweeps;
    spmv(n, indptr, indices, data, x, r.data());
    double fs = 0.0, ds = 0.0, xs = 0.0;
#pragma omp parallel for reduction(+ : fs, ds, xs) schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      const double ri = b[i] - r[i];
      fs += ri * ri;
      const double di = x[i] - prev[i];
      ds += di * di;
      xs += x[i] * x[i];
    }
    fn = std::sqrt(fs);
    if (std::sqrt(ds) < stol * std::sqrt(xs)) break;
  }
  return sweeps;
}

}  // namespace

extern "C" {

int64_t csr_ilu0_factorize(int64_t n, const int64_t* indptr,
                           const int64_t* indices, double* data,
                           int64_t* diag_out) {
  return ilu0_factorize_csr(n, indptr, indices, data, diag_out);
}

int64_t csr_ilu0_factorize_i32(int64_t n, const int32_t* indptr,
                               const int32_t* indices, double* data,
                               int32_t* diag_out) {
  return ilu0_factorize_csr(n, indptr, indices, data, diag_out);
}

int64_t csr_gmres_ilu(int64_t n, const int64_t* a_indptr,
                      const int64_t* a_indices, const double* a_data,
                      const int64_t* f_indptr, const int64_t* f_indices,
                      const double* f_data, const int64_t* f_diag,
                      const double* b, double rtol, double atol,
                      int64_t restart, int64_t max_it, double* x,
                      double* rnorm_out, double* hist) {
  return gmres_ilu_csr(n, a_indptr, a_indices, a_data, f_indptr, f_indices,
                       f_data, f_diag, b, rtol, atol, restart, max_it, x,
                       rnorm_out, hist);
}

int64_t csr_gmres_ilu_i32(int64_t n, const int32_t* a_indptr,
                          const int32_t* a_indices, const double* a_data,
                          const int32_t* f_indptr, const int32_t* f_indices,
                          const double* f_data, const int32_t* f_diag,
                          const double* b, double rtol, double atol,
                          int64_t restart, int64_t max_it, double* x,
                          double* rnorm_out, double* hist) {
  return gmres_ilu_csr(n, a_indptr, a_indices, a_data, f_indptr, f_indices,
                       f_data, f_diag, b, rtol, atol, restart, max_it, x,
                       rnorm_out, hist);
}

int64_t csr_gs_sweeps(int64_t n, const int64_t* indptr,
                      const int64_t* indices, const double* data,
                      const double* b, double* x, double rtol, double atol,
                      double stol, int64_t max_it) {
  return gs_sweeps_csr(n, indptr, indices, data, b, x, rtol, atol, stol,
                       max_it);
}

int64_t csr_gs_sweeps_i32(int64_t n, const int32_t* indptr,
                          const int32_t* indices, const double* data,
                          const double* b, double* x, double rtol,
                          double atol, double stol, int64_t max_it) {
  return gs_sweeps_csr(n, indptr, indices, data, b, x, rtol, atol, stol,
                       max_it);
}

}  // extern "C"
