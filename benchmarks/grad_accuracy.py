#!/usr/bin/env python
"""Accuracy of the float32 mixture paths against the float64 dense oracle, on
an NVIDIA GPU (float64 runs on the card, so this is one phase).

    python benchmarks/grad_accuracy.py            # shapes (a)-(d) of bench.py
    python benchmarks/grad_accuracy.py --shape b

For each shape and each path (fused kernels, blockwise XLA) prints the max abs
error of every output field and of the gradients of a fixed linear functional
w.r.t. means, conics (symmetrised) and values, each over the reference's max
abs value, beside its tolerance.  Exits non-zero on a GPU-less machine or when
the fused path is outside its tolerance.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import bench
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--shape", choices=sorted(bench.SHAPES), action="append")
    args = p.parse_args()

    from pigs_tpu.utils.runtime import card_line, require_gpu
    require_gpu()
    print(f"card: {card_line()}")
    bad = []
    for name in args.shape or sorted(bench.SHAPES):
        for impl in ("pallas", "xla"):
            acc = bench.accuracy(name, impl=impl)
            print(f"shape ({name}) impl={impl}: " + "  ".join(
                f"{k} {e:.2e}/{tol:.0e}" for k, (e, tol) in acc.items()))
            if impl == "pallas":
                bad += [(name, k) for k, (e, tol) in acc.items() if e > tol]
    if bad:
        sys.exit(f"outside tolerance: {bad}")


if __name__ == "__main__":
    main()
