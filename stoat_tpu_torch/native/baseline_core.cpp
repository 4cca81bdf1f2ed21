// Single-core C++ baseline: the reference's per-snarl scalar analysis loop.
//
// This is the benchmark stand-in for single-core `stoat` (whose vendored
// dependency stack is not buildable here): the same algorithmic shape as
// the reference stoat's src/ — per-snarl identify_path bit scans
// (snarl_analyzer.cpp:315-356), binary contingency tables + chi²/Fisher
// (binary_table.cpp, stats_test.cpp:178-380), and the quantitative dosage
// table + identical-column merge + OLS (quantitative_table.cpp,
// snarl_analyzer.cpp:541-684, stats_test.cpp:383-506) — dependency-free
// C++17 (own incomplete gamma/beta in place of Boost, Gaussian elimination
// in place of Eigen).
//
// Built at first use by stoat_tpu_torch/native/baseline.py (g++ with the
// flags of the port's other cores, keyed by source, flags and host CPU).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <unordered_map>
#include <vector>

namespace {

// ---------------- special functions (Numerical-Recipes style) ----------

static double gammln(double x) { return std::lgamma(x); }

static double gser(double a, double x) {
    double ap = a, sum = 1.0 / a, del = sum;
    for (int n = 0; n < 500; ++n) {
        ap += 1.0;
        del *= x / ap;
        sum += del;
        if (std::fabs(del) < std::fabs(sum) * 1e-15) break;
    }
    return sum * std::exp(-x + a * std::log(x) - gammln(a));
}

static double gcf(double a, double x) {
    const double FPMIN = 1e-300;
    double b = x + 1.0 - a, c = 1.0 / FPMIN, d = 1.0 / b, h = d;
    for (int i = 1; i <= 500; ++i) {
        double an = -double(i) * (double(i) - a);
        b += 2.0;
        d = an * d + b;
        if (std::fabs(d) < FPMIN) d = FPMIN;
        c = b + an / c;
        if (std::fabs(c) < FPMIN) c = FPMIN;
        d = 1.0 / d;
        double del = d * c;
        h *= del;
        if (std::fabs(del - 1.0) < 1e-15) break;
    }
    return std::exp(-x + a * std::log(x) - gammln(a)) * h;
}

// regularized upper incomplete gamma Q(a, x) — chi2 sf = Q(df/2, x/2)
static double gammq(double a, double x) {
    if (x < 0.0 || a <= 0.0) return 1.0;
    if (x == 0.0) return 1.0;
    if (x < a + 1.0) return 1.0 - gser(a, x);
    return gcf(a, x);
}

static double betacf(double a, double b, double x) {
    const double FPMIN = 1e-300;
    double qab = a + b, qap = a + 1.0, qam = a - 1.0;
    double c = 1.0, d = 1.0 - qab * x / qap;
    if (std::fabs(d) < FPMIN) d = FPMIN;
    d = 1.0 / d;
    double h = d;
    for (int m = 1; m <= 300; ++m) {
        int m2 = 2 * m;
        double aa = m * (b - m) * x / ((qam + m2) * (a + m2));
        d = 1.0 + aa * d;
        if (std::fabs(d) < FPMIN) d = FPMIN;
        c = 1.0 + aa / c;
        if (std::fabs(c) < FPMIN) c = FPMIN;
        d = 1.0 / d;
        h *= d * c;
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2));
        d = 1.0 + aa * d;
        if (std::fabs(d) < FPMIN) d = FPMIN;
        c = 1.0 + aa / c;
        if (std::fabs(c) < FPMIN) c = FPMIN;
        d = 1.0 / d;
        double del = d * c;
        h *= del;
        if (std::fabs(del - 1.0) < 1e-15) break;
    }
    return h;
}

static double betai(double a, double b, double x) {
    if (x <= 0.0) return 0.0;
    if (x >= 1.0) return 1.0;
    double bt = std::exp(gammln(a + b) - gammln(a) - gammln(b) +
                         a * std::log(x) + b * std::log(1.0 - x));
    if (x < (a + 1.0) / (a + b + 2.0))
        return bt * betacf(a, b, x) / a;
    return 1.0 - bt * betacf(b, a, 1.0 - x) / b;
}

// two-sided Student-t p-value
static double t_sf2(double t_abs, double df) {
    return betai(df / 2.0, 0.5, df / (df + t_abs * t_abs));
}

// ---------------- Fisher exact (PLINK scan, stats_test.cpp:264-360) ----

constexpr double kEps2 = 9.094947017729282e-13;
constexpr double kBias = 1.0339757656912846e-25;

static double fisher_exact(long m11, long m12, long m21, long m22) {
    if ((m11 | m12) == 0 || (m21 | m22) == 0 || (m11 | m21) == 0 ||
        (m12 | m22) == 0)
        return -1.0;  // NA
    if (m12 > m21) std::swap(m12, m21);
    if (m11 > m22) std::swap(m11, m22);
    if ((double)m11 * m22 > (double)m12 * m21) {
        std::swap(m11, m12);
        std::swap(m21, m22);
    }
    double tprob = (1 - kEps2) * kBias;
    double cur_prob = tprob, cprob = 0;
    double c11 = m11, c12 = m12, c21 = m21, c22 = m22;
    while (c12 > 0.5) {
        c11 += 1;
        c22 += 1;
        cur_prob *= (c12 * c21) / (c11 * c22);
        c12 -= 1;
        c21 -= 1;
        if (cur_prob > 1.797693134862315708e308) return 0.0;
        if (cur_prob < kBias) {
            tprob += cur_prob;
            break;
        }
        cprob += cur_prob;
    }
    if (cprob == 0) return 1.0;
    while (c12 > 0.5) {
        c11 += 1;
        c22 += 1;
        cur_prob *= (c12 * c21) / (c11 * c22);
        c12 -= 1;
        c21 -= 1;
        double pre = tprob;
        tprob += cur_prob;
        if (tprob <= pre) break;
    }
    if (m11) {
        c11 = m11;
        c12 = m12;
        c21 = m21;
        c22 = m22;
        cur_prob = (1 - kEps2) * kBias;
        do {
            c12 += 1;
            c21 += 1;
            cur_prob *= (c11 * c22) / (c12 * c21);
            c11 -= 1;
            c22 -= 1;
            double pre = tprob;
            tprob += cur_prob;
            if (tprob <= pre) return pre / (cprob + pre);
        } while (c11 > 0.5);
    }
    return tprob / (cprob + tprob);
}

// ---------------- small dense solve (Gaussian elimination) -------------

static bool invert(std::vector<double>& A, int n) {
    std::vector<double> I(n * n, 0.0);
    for (int i = 0; i < n; ++i) I[i * n + i] = 1.0;
    for (int col = 0; col < n; ++col) {
        int piv = col;
        for (int r = col + 1; r < n; ++r)
            if (std::fabs(A[r * n + col]) > std::fabs(A[piv * n + col]))
                piv = r;
        if (std::fabs(A[piv * n + col]) < 1e-300) return false;
        if (piv != col) {
            for (int k = 0; k < n; ++k) {
                std::swap(A[piv * n + k], A[col * n + k]);
                std::swap(I[piv * n + k], I[col * n + k]);
            }
        }
        double inv = 1.0 / A[col * n + col];
        for (int k = 0; k < n; ++k) {
            A[col * n + k] *= inv;
            I[col * n + k] *= inv;
        }
        for (int r = 0; r < n; ++r) {
            if (r == col) continue;
            double f = A[r * n + col];
            if (f == 0.0) continue;
            for (int k = 0; k < n; ++k) {
                A[r * n + k] -= f * A[col * n + k];
                I[r * n + k] -= f * I[col * n + k];
            }
        }
    }
    A = std::move(I);
    return true;
}

}  // namespace

extern "C" {

// Run the reference-style scalar per-snarl loop over a packed workload.
//
// matrix: [n_rows, n_cols] uint8 edge×haplotype
// path_row_offsets: [n_paths+1] into path_rows (edge rows per path)
// snarl_offsets: [n_snarls+1] into the flat path axis
// pheno_bin: [n_samples] 0/1; pheno_q: [n_samples]
// Returns the number of snarls fully analyzed (binary + quantitative each).
long stoat_baseline_run(const uint8_t* matrix, long n_rows, long n_cols,
                        const int32_t* path_rows,
                        const int64_t* path_row_offsets,
                        const int64_t* snarl_offsets, long n_snarls,
                        const uint8_t* pheno_bin, const double* pheno_q,
                        long n_samples, long min_ind, long min_hap,
                        double maf_threshold, double* sink) {
    long analyzed = 0;
    double acc = 0.0;
    std::vector<long> carriers;
    for (long s = 0; s < n_snarls; ++s) {
        long p0 = snarl_offsets[s], p1 = snarl_offsets[s + 1];
        long n_paths = p1 - p0;
        if (n_paths < 2) continue;

        // identify_path per path: haplotype columns with every edge set
        std::vector<std::vector<long>> hits(n_paths);
        for (long p = 0; p < n_paths; ++p) {
            long r0 = path_row_offsets[p0 + p], r1 = path_row_offsets[p0 + p + 1];
            for (long col = 0; col < n_cols; ++col) {
                bool all = true;
                for (long ri = r0; ri < r1; ++ri) {
                    if (!matrix[long(path_rows[ri]) * n_cols + col]) {
                        all = false;
                        break;
                    }
                }
                if (all) hits[p].push_back(col);
            }
        }

        // ---- binary ------------------------------------------------
        {
            std::vector<long> g0(n_paths, 0), g1(n_paths, 0);
            long total = 0;
            for (long p = 0; p < n_paths; ++p) {
                for (long col : hits[p]) {
                    if (pheno_bin[col / 2]) ++g1[p];
                    else ++g0[p];
                    ++total;
                }
            }
            std::vector<long> k0, k1;
            for (long p = 0; p < n_paths; ++p)
                if (g0[p] + g1[p]) {
                    k0.push_back(g0[p]);
                    k1.push_back(g1[p]);
                }
            if (total / 2 >= min_ind && total >= min_hap &&
                long(k0.size()) >= 2) {
                int above = 0;
                for (size_t i = 0; i < k0.size(); ++i) {
                    double cs = double(k0[i] + k1[i]);
                    double f1 = double(k1[i]) / cs;
                    double maf = std::min(f1, 1.0 - f1);
                    if (maf > maf_threshold) ++above;
                }
                if (above >= 2) {
                    // chi2
                    double r0s = 0, r1s = 0, tot = 0;
                    for (size_t i = 0; i < k0.size(); ++i) {
                        r0s += k0[i];
                        r1s += k1[i];
                    }
                    tot = r0s + r1s;
                    double stat = 0;
                    bool ok = r0s > 0 && r1s > 0;
                    for (size_t i = 0; i < k0.size() && ok; ++i) {
                        double cs = double(k0[i] + k1[i]);
                        if (cs == 0) { ok = false; break; }
                        double e0 = r0s * cs / tot, e1 = r1s * cs / tot;
                        stat += (k0[i] - e0) * (k0[i] - e0) / e0;
                        stat += (k1[i] - e1) * (k1[i] - e1) / e1;
                    }
                    if (ok) acc += gammq((double(k0.size()) - 1) / 2.0,
                                         stat / 2.0);
                    if (k0.size() == 2)
                        acc += fisher_exact(k0[0], k0[1], k1[0], k1[1]);
                    ++analyzed;
                }
            }
        }

        // ---- quantitative -------------------------------------------
        {
            // dosage per sample over non-empty paths
            std::vector<long> kept;
            for (long p = 0; p < n_paths; ++p)
                if (!hits[p].empty()) kept.push_back(p);
            if (kept.size() < 2) continue;
            long K = long(kept.size());
            std::vector<double> dos(n_samples * K, 0.0);
            std::vector<char> used(n_samples, 0);
            for (long ki = 0; ki < K; ++ki)
                for (long col : hits[kept[ki]]) {
                    dos[(col / 2) * K + ki] += 1.0;
                    used[col / 2] = 1;
                }
            long n_used = 0;
            for (long i = 0; i < n_samples; ++i) n_used += used[i];
            if (n_used < min_ind) continue;
            // normalize rows
            std::vector<double> norm;
            std::vector<double> y;
            norm.reserve(n_used * K);
            for (long i = 0; i < n_samples; ++i) {
                if (!used[i]) continue;
                double rs = 0;
                for (long ki = 0; ki < K; ++ki) rs += dos[i * K + ki];
                for (long ki = 0; ki < K; ++ki) {
                    double v = dos[i * K + ki];
                    norm.push_back(v > 0 ? v / rs : 0.0);
                }
                y.push_back(pheno_q[i]);
            }
            double total = 0;
            std::vector<double> colsum(K, 0.0);
            for (long r = 0; r < n_used; ++r)
                for (long ki = 0; ki < K; ++ki) {
                    colsum[ki] += norm[r * K + ki];
                    total += norm[r * K + ki];
                }
            if (total < min_hap) continue;
            int above = 0;
            for (long ki = 0; ki < K; ++ki) {
                double f = colsum[ki] / total;
                if (std::min(f, 1.0 - f) > maf_threshold) ++above;
            }
            if (above < 2) continue;
            // merge identical columns (>=3)
            std::vector<std::vector<double>> cols(K);
            for (long ki = 0; ki < K; ++ki) {
                cols[ki].resize(n_used);
                for (long r = 0; r < n_used; ++r)
                    cols[ki][r] = norm[r * K + ki];
            }
            std::vector<std::vector<double>> merged_cols;
            if (K >= 3) {
                std::vector<char> merged(K, 0);
                for (long i = 0; i < K; ++i) {
                    if (merged[i]) continue;
                    std::vector<double> col = cols[i];
                    for (long j = i + 1; j < K; ++j) {
                        if (merged[j]) continue;
                        if (cols[j] == cols[i]) {
                            for (long r = 0; r < n_used; ++r)
                                col[r] += cols[j][r];
                            merged[j] = 1;
                        }
                    }
                    merged_cols.push_back(std::move(col));
                }
            } else {
                merged_cols = cols;
            }
            if (merged_cols.size() < 2) continue;
            merged_cols.pop_back();  // remove last column
            long V = long(merged_cols.size());
            long P = 1 + V;
            // X^T X, X^T y
            std::vector<double> XtX(P * P, 0.0), Xty(P, 0.0);
            for (long r = 0; r < n_used; ++r) {
                std::vector<double> row(P);
                row[0] = 1.0;
                for (long v = 0; v < V; ++v) row[1 + v] = merged_cols[v][r];
                for (long a = 0; a < P; ++a) {
                    Xty[a] += row[a] * y[r];
                    for (long b = 0; b < P; ++b)
                        XtX[a * P + b] += row[a] * row[b];
                }
            }
            std::vector<double> inv = XtX;
            if (!invert(inv, int(P))) continue;
            std::vector<double> beta(P, 0.0);
            for (long a = 0; a < P; ++a)
                for (long b = 0; b < P; ++b)
                    beta[a] += inv[a * P + b] * Xty[b];
            double rss = 0, ymean = 0;
            for (long r = 0; r < n_used; ++r) ymean += y[r];
            ymean /= double(n_used);
            for (long r = 0; r < n_used; ++r) {
                double pred = beta[0];
                for (long v = 0; v < V; ++v)
                    pred += beta[1 + v] * merged_cols[v][r];
                double e = y[r] - pred;
                rss += e * e;
            }
            long df_res = std::max(n_used - P + 1, 1L);
            double mse = rss / double(df_res);
            double se1 = std::sqrt(inv[1 * P + 1] * mse);
            double t1 = beta[1] / se1;
            double pval = std::isfinite(t1)
                ? t_sf2(std::fabs(t1), double(df_res)) : 1.0;
            acc += pval;
            ++analyzed;
        }
    }
    if (sink) *sink = acc;
    return analyzed;
}


// Graph-mode single-core baseline: the reference's per-snarl walk-set
// partitioning (PathPartitioner::get_walk_sets, partitioner.cpp:36-268 —
// refine sample sets by the ordered multiset of outgoing edges each path
// takes from the snarl's start bound) followed by the chi2 test over the
// per-partition case/control counts (graph_path_association_finder.cpp:
// 119-156).  Scalar C++17, one core, with a node→steps index built once
// like handlegraph's step index.
//
// steps: flat (node_id<<1 | is_reverse) per path step
// offsets: [n_paths+1] into steps
// start_handles: per snarl (node_id<<1 | orientation) of the start bound
// pheno: [n_paths] 1 = case path
// Returns snarls partitioned+tested; accumulates p-values into *sink so
// the work cannot be optimized away.
long stoat_baseline_graph(const uint64_t* steps, const int64_t* offsets,
                          long n_paths, const uint64_t* start_handles,
                          long n_snarls, const uint8_t* pheno,
                          double* sink) {
    // node id -> [(path, step index)] (the reference gets this from
    // handlegraph's for_each_step_on_handle index)
    std::unordered_map<uint64_t, std::vector<std::pair<int32_t, int32_t>>>
        node_steps;
    node_steps.reserve(size_t(n_paths) * 4);
    for (long p = 0; p < n_paths; ++p)
        for (int64_t i = offsets[p]; i < offsets[p + 1]; ++i)
            node_steps[steps[i] >> 1].push_back(
                {int32_t(p), int32_t(i - offsets[p])});

    double acc = 0.0;
    long tested = 0;
    for (long s = 0; s < n_snarls; ++s) {
        uint64_t h = start_handles[s];
        uint64_t node = h >> 1;
        uint64_t orient = h & 1;
        auto it = node_steps.find(node);
        if (it == node_steps.end()) continue;

        // ordered outgoing-edge list per path (sorted by step position)
        std::map<int32_t, std::vector<std::pair<int32_t, uint64_t>>>
            per_path;
        for (const auto& ps : it->second) {
            int32_t p = ps.first, si = ps.second;
            int64_t base = offsets[p];
            uint64_t st = steps[base + si];
            bool go_fwd = (st & 1) == orient;
            int64_t j = go_fwd ? si + 1 : si - 1;
            if (j < 0 || base + j >= offsets[p + 1]) continue;
            per_path[p].push_back({si, steps[base + j]});
        }
        // group by the ordered edge tuple (walk-set refinement)
        std::map<std::vector<uint64_t>, std::vector<int32_t>> groups;
        for (auto& pp : per_path) {
            std::sort(pp.second.begin(), pp.second.end());
            std::vector<uint64_t> key;
            key.reserve(pp.second.size());
            for (const auto& e : pp.second) key.push_back(e.second);
            groups[key].push_back(pp.first);
        }
        if (groups.size() < 2) continue;

        // chi2 2xN over per-partition case/control counts
        std::vector<long> g0, g1;
        for (const auto& g : groups) {
            long c0 = 0, c1 = 0;
            for (int32_t p : g.second) {
                if (pheno[p]) ++c1;
                else ++c0;
            }
            g0.push_back(c0);
            g1.push_back(c1);
        }
        double r0s = 0, r1s = 0;
        for (size_t i = 0; i < g0.size(); ++i) {
            r0s += g0[i];
            r1s += g1[i];
        }
        double tot = r0s + r1s;
        if (r0s > 0 && r1s > 0 && tot > 0) {
            double stat = 0;
            bool ok = true;
            for (size_t i = 0; i < g0.size() && ok; ++i) {
                double cs = double(g0[i] + g1[i]);
                if (cs == 0) { ok = false; break; }
                double e0 = r0s * cs / tot, e1 = r1s * cs / tot;
                stat += (g0[i] - e0) * (g0[i] - e0) / e0;
                stat += (g1[i] - e1) * (g1[i] - e1) / e1;
            }
            if (ok) acc += gammq((double(g0.size()) - 1) / 2.0, stat / 2.0);
            if (g0.size() == 2)
                acc += fisher_exact(g0[0], g0[1], g1[0], g1[1]);
        }
        ++tested;
    }
    *sink = acc;
    return tested;
}


}  // extern "C"
