"""Kernel K16a, csrc/perm_ols.cu: its roofline bound over its device time
in the traced window, % (gwasbench/roofline/perm_ols.py)."""

from gwasbench.roofline import share


def read(ctx):
    return share(ctx, "perm_ols")
