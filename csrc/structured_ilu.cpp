// Native ILU(0) factorization over structured (fixed-offset-list) matrices.
//
// Plays the role PETSc's C factorization kernels play for the reference
// (PCSetUp for pc_type=ilu, reference solvers/parameters.py:27): the
// factorization is inherently sequential in row order, so it runs on the
// host; triangular solves and GS sweeps run on the device via
// parallel-prefix trees or wavefront lax.scan (perphil_tpu/ops/ilu.py). This C++ path replaces the
// level-vectorized numpy fallback with a single IKJ sweep (natural order),
// bit-identical results, ~an order of magnitude faster at large N.
//
// Storage contract (matches ops/ilu.py::StructuredSystem):
//   vals  : (nrows, noffs) row-major doubles, factor written in place
//           (L strictly-lower with unit diagonal implied; U on/above)
//   deltas: (noffs,) global flat column offsets (col = row + delta)
//   valid : (nrows, noffs) uint8 structural-pattern mask
//   lower_order: indices of strictly-lower offsets, ascending column order
//   mmap  : (noffs, noffs) mmap[k*noffs+j] = offset index t in the pivot
//           row with delta_t == delta_j - delta_k, or -1
//   uppers: flattened per-k lists of j with delta_j > delta_k and
//           mmap[k][j] >= 0; uppers_ptr delimits them (CSR-style)

#include <cstdint>

extern "C" {

void ilu0_factorize(
    double* vals,
    const int64_t* deltas,
    const uint8_t* valid,
    int64_t nrows,
    int64_t noffs,
    const int64_t* lower_order,
    int64_t nlower,
    const int64_t* mmap,
    const int64_t* uppers,
    const int64_t* uppers_ptr,
    int64_t center)
{
    for (int64_t r = 0; r < nrows; ++r) {
        double* row = vals + r * noffs;
        const uint8_t* vrow = valid + r * noffs;
        for (int64_t ki = 0; ki < nlower; ++ki) {
            const int64_t k = lower_order[ki];
            const double a = row[k];
            if (a == 0.0) continue;
            const int64_t pr = r + deltas[k];
            if (pr < 0 || pr >= nrows) continue;
            const double* prow = vals + pr * noffs;
            const double piv = prow[center];
            if (piv == 0.0) continue;
            const double f = a / piv;
            row[k] = f;
            const int64_t* mrow = mmap + k * noffs;
            for (int64_t ui = uppers_ptr[ki]; ui < uppers_ptr[ki + 1]; ++ui) {
                const int64_t j = uppers[ui];
                if (!vrow[j]) continue;  // no fill outside the pattern
                row[j] -= f * prow[mrow[j]];
            }
        }
    }
}

}  // extern "C"
