"""Kernel K16c, csrc/score_test.cu score_perm: its roofline bound over its
device time in the traced window, % (gwasbench/roofline/score_perm.py)."""

from gwasbench.roofline import share


def read(ctx):
    return share(ctx, "score_perm")
