"""The least time of the lookup argument's table work (lookup_yardstick.py:
the cell's padded table rows x challenge rounds x batch at 40 int32
instructions a row, or its bytes where they bind) over the device ms a
forward of the leaf span "plonk: lookup argument", in %. The cell is the one
the run's --workload names, read from BENCHMARK.json as run.py reads it."""

import sys

from lookup_yardstick import cell_common, least_seconds
from traced_report import device_ms


def read(obs):
    ms = device_ms("plonk: lookup argument")
    common = cell_common(sys.argv[1:])
    if not ms or common is None or not common["luts"]:
        return None
    return 100.0 * least_seconds(common, obs["batch"]) * 1e3 / ms
