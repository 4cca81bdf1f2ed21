"""perm_ols (K16a, csrc/perm_ols.cu): the OLS t statistic of every
permuted phenotype row against every snarl's design, the inverse once a
snarl.  A call's work: X [S, N, P] float64 and its used mask read, ncols,
the [K, N] phenotype rows read, t and df [K, S] written (the bytes of
chip_smoke.py kernel_work's perm_ols branch, lines 4957-4962 at the
commit that added this benchmark); the operations the normal equations
need, X^T X once a snarl (S N P (P + 1)) and per row and snarl X^T y
(2 N P) and the used rows' sum of squares y^T y (2 N).  chip_smoke.py
counts a residual pass besides (K S N (4 P + 3)), which this form does
not need.
"""

KERNELS = ("perm_ols_inverse", "perm_ols_main", "perm_ols")


def work(call):
    S, N, P, K = call["S"], call["N"], call["P"], call["K"]
    nbytes = S * N * (P * 8 + 1) + S * 4 + K * N * 8 + 2 * K * S * 8
    flops = S * N * P * (P + 1) + K * S * N * (2 * P + 2)
    return nbytes, flops
