// The per-snarl binary table, filter and chi-squared statistic on one
// thread, shared by binary_tables.cu (K3) and perm_binary.cu (K15).
//
// The operations are those of stoat_tpu/pipeline/binary.py
// _binary_from_path_counts (:98-146) with stoat_tpu/stats/chi2.py
// chi2_2x2_stat (:32) and chi2_2xn_stat (:89), in the same order, on
// float64.  Built with -fmad=false, each multiply and add is rounded as the
// plain PyTorch version (pipeline/binary.py binary_tables_plain) rounds it,
// so both kernels give that version's bits for the same counts.

#pragma once

#include <cmath>
#include <cstdint>

namespace stoat {

struct BinaryTable {
  double a, b, c, d;  // g0 / g1 of the first two kept columns, 0 if missing
  double stat, df;
  int k;              // kept columns
  bool filtered, invalid, zexp;
};

// column(j, x0, x1) sets column j's control and case counts (0 on padding)
// and returns whether the column is a real path.  It is called twice per
// column when the table is 2 x N.
template <typename Column>
__device__ inline BinaryTable binary_table(Column column, int64_t Pmax,
                                           double min_individuals,
                                           double min_haplotypes,
                                           double maf_threshold) {
  BinaryTable t;
  double total_sum = 0.0;
  double row0 = 0.0;  // 2xN row sums over kept columns
  double row1 = 0.0;
  double total_kept = 0.0;
  int k = 0;
  int maf_count = 0;
  double a = 0.0, b = 0.0, c = 0.0, d = 0.0;
  for (int64_t j = 0; j < Pmax; ++j) {
    double x0, x1;
    const bool real = column(j, x0, x1);
    const double col = x0 + x1;
    total_sum += col;
    if (!real || col == 0.0) continue;
    const double freq1 = x1 / col;
    const double other = 1.0 - freq1;
    const double maf = freq1 < other ? freq1 : other;
    if (maf > maf_threshold) ++maf_count;
    if (k == 0) {
      a = x0;
      c = x1;
    } else if (k == 1) {
      b = x0;
      d = x1;
    }
    ++k;
    row0 += x0;
    row1 += x1;
    total_kept += col;
  }
  t.filtered = floor(total_sum / 2.0) < min_individuals ||
               total_sum < min_haplotypes || k < 2 || maf_count < 2;
  t.k = k;
  t.a = a;
  t.b = b;
  t.c = c;
  t.d = d;

  if (k == 2) {
    // chi2.py:46-72
    const double r1 = a + b;
    const double r2 = c + d;
    const double c1 = a + c;
    const double c2 = b + d;
    const double total = r1 + r2;
    const bool invalid = r1 == 0.0 || r2 == 0.0 || c1 == 0.0 || c2 == 0.0;
    const double safe_total = invalid ? 1.0 : total;
    double ea = r1 * c1 / safe_total;
    double eb = r1 * c2 / safe_total;
    double ec = c1 * r2 / safe_total;
    double ed = c2 * r2 / safe_total;
    const bool zexp = ea == 0.0 || eb == 0.0 || ec == 0.0 || ed == 0.0;
    if (zexp) {
      ea = 1.0;
      eb = 1.0;
      ec = 1.0;
      ed = 1.0;
    }
    const double da = a - ea;
    const double db = b - eb;
    const double dc = c - ec;
    const double dd = d - ed;
    t.stat = da * da / ea + db * db / eb + dc * dc / ec + dd * dd / ed;
    t.df = 1.0;
    t.invalid = invalid;
    t.zexp = zexp;
    return t;
  }

  // chi2.py:95-118 over the kept columns; a column that is not kept adds
  // 0.0 + 0.0 in the JAX sum, which leaves every partial sum unchanged.
  const bool invalid = total_kept == 0.0 || row0 == 0.0 || row1 == 0.0;
  const double safe_total = total_kept == 0.0 ? 1.0 : total_kept;
  double stat = 0.0;
  for (int64_t j = 0; j < Pmax; ++j) {
    double x0, x1;
    if (!column(j, x0, x1)) continue;
    const double col = x0 + x1;
    if (col == 0.0) continue;
    double e0 = row0 * col / safe_total;
    double e1 = row1 * col / safe_total;
    if (!(e0 > 0.0)) e0 = 1.0;
    if (!(e1 > 0.0)) e1 = 1.0;
    const double d0 = x0 - e0;
    const double d1 = x1 - e1;
    stat += d0 * d0 / e0 + d1 * d1 / e1;
  }
  t.stat = stat;
  t.df = double(k - 1 > 1 ? k - 1 : 1);
  t.invalid = invalid;
  t.zexp = false;
  return t;
}

}  // namespace stoat
