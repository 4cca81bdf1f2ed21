"""Run one cell of the benchmark once, on the card of this machine.

    python3 gwasbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints the numbers it compared, each with
its limit, as the last lines of standard error, and one JSON object as
the last line of standard output.  Exits non-zero, with no result, when
no CUDA card is visible, when fewer cards than the cell needs are, or
when a module of JAX or of the JAX package is loaded once the window has
closed.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gwasbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
