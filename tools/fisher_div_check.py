#!/usr/bin/env python3
"""Hold the Fisher scan's division (csrc/fisher_device.cuh fisher_div, the
fast path of nvcc's float64 division written out) to nvcc's own '/' on
the card, bit for bit.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/fisher_div_check.py [--n 100000000] [--seed 0]

It builds a small test library from the header (into the git-ignored
build/stoat_tpu_torch/, with the port's nvcc flags), draws ``--n`` pairs
(a, b) on the card in four families (the scan's own ratios: products of
two counts below 10^4 over products of two counts below 10^4; uniform
mantissas at exponents -600..600; a at the ends of fisher_div's range,
2^+-250; b a power of two and a one of b's neighbours), and counts,
for each family, the pairs that fisher_div takes (its range test), and
the taken pairs whose quotient differs from a / b in any bit.  It prints
one line per family and exits non-zero on any difference, or when there
is no card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
#include "fisher_device.cuh"

__global__ void fisher_div_check_kernel(const double* a, const double* b,
                                        int64_t n,
                                        unsigned long long* counts) {
  unsigned long long taken = 0, differ = 0;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x) {
    bool ok;
    const double q = stoat::fisher_div(a[i], b[i], ok);
    const double want = a[i] / b[i];
    if (ok) {
      ++taken;
      differ += __double_as_longlong(q) != __double_as_longlong(want);
    }
  }
  atomicAdd(&counts[0], taken);
  atomicAdd(&counts[1], differ);
}

extern "C" int fisher_div_check(const void* a, const void* b, int64_t n,
                                void* counts, void* stream) {
  fisher_div_check_kernel<<<264, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(a), static_cast<const double*>(b), n,
      static_cast<unsigned long long*>(counts));
  return int(cudaGetLastError());
}
"""


def families(torch, n, gen, device):
    """(name, a, b) of the four families, n/4 pairs each."""
    m = n // 4
    f64 = dict(dtype=torch.float64, device=device)

    def counts(hi):
        return torch.randint(0, hi, (m,), generator=gen, device=device,
                             dtype=torch.int64).to(torch.float64)
    yield "scan ratios", counts(10 ** 4) * counts(10 ** 4), \
        (counts(10 ** 4) + 1.0) * (counts(10 ** 4) + 1.0)

    def wide(lo, hi):
        mant = 1.0 + torch.rand(m, generator=gen, **f64)
        exp = torch.randint(lo, hi + 1, (m,), generator=gen, device=device)
        return torch.ldexp(mant, exp)
    yield "exponents -600..600", wide(-600, 600), wide(-600, 600)
    yield "range ends", wide(-253, -247) * (2.0 ** 500) ** torch.randint(
        0, 2, (m,), generator=gen, device=device), wide(-3, 3)
    b = torch.ldexp(torch.ones(m, **f64),
                    torch.randint(-400, 400, (m,), generator=gen,
                                  device=device))
    step = torch.randint(-4, 5, (m,), generator=gen, device=device)
    a = torch.nextafter(b, torch.where(step >= 0, b * 2, b * 0.5))
    yield "powers of two", a, b


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("fisher_div_check: no CUDA device is available\n")
        return 1
    sys.path.insert(0, HERE)
    from stoat_tpu_torch.kernels import build
    out_dir = build.BUILD_DIR / "check"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "fisher_div_check.cu"
    src.write_text(SOURCE)
    lib_path = out_dir / "libfisher_div_check.so"
    res = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                          str(build.CSRC_DIR), "-o", str(lib_path), str(src)],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        sys.stderr.write(res.stderr)
        return 1
    fn = ctypes.CDLL(str(lib_path)).fisher_div_check
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] + \
        [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    bad = 0
    for name, a, b in families(torch, args.n, gen, device):
        a, b = a.contiguous(), b.contiguous()
        counts = torch.zeros(2, dtype=torch.int64, device=device)
        err = fn(a.data_ptr(), b.data_ptr(), a.numel(), counts.data_ptr(),
                 torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            sys.stderr.write(f"fisher_div_check: launch error {err}\n")
            return 1
        taken, differ = counts.tolist()
        bad += differ
        print(f"fisher_div {name}: {a.numel()} pairs, {taken} in range, "
              f"{differ} differ from a / b", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
