"""Tiny cells for the CPU tests: 60 samples x 300 snarls on 2
chromosomes, 20 permutations, the program's plain versions on the CPU."""

from gwasbench import harness

CELLS = ("kgp3_quant_perm10k", "kgp3_casecontrol_perm10k")
TINY = {"n_samples": 60, "n_snarls": 300, "permutations": 20}
SEED = 2**31 + 77


def tiny_cell(name):
    return harness.load_cell(name, overrides=TINY)


def run_tiny(name, seconds=0.2, trace=False, seed=SEED):
    return harness.run_cell(tiny_cell(name), seed, seconds, trace,
                            device_name="cpu", log=lambda line: None)
