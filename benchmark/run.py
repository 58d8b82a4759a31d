"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program
(drone_image_stitch_cpp_tpu_torch) and a CUDA card; see
mosaicbench/harness.py.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mosaicbench.harness import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main())
