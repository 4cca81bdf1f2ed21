"""score_perm (K16c, csrc/score_test.cu): the covariate-adjusted score
statistic T = U^T V^-1 U with U = D^T (used * e_k) of every permuted
residual row against every snarl.  A call's work, a frozen copy of
chip_smoke.py kernel_work's score_perm branch (lines 4978-4983 at the
commit that added this benchmark): D [S, N, PT] float64 and the used
mask read, V^-1 [S, PT, PT] read, the [K, N] residual rows read, T [K, S]
written; per row and snarl U (2 N PT) and the quadratic form
(2 PT^2 + 2 PT).
"""

KERNELS = ("score_perm",)


def work(call):
    S, N, PT, K = call["S"], call["N"], call["PT"], call["K"]
    nbytes = (S * N * (PT * 8 + 1) + S * PT * PT * 8 + K * N * 8
              + K * S * 8)
    flops = K * S * (2 * N * PT + 2 * PT * PT + 2 * PT)
    return nbytes, flops
