"""The benchmark of the PyTorch and CUDA port (`moegan_tpu_torch`) on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json: sets up from the seed, measures for
`--seconds`, checks what the timed path produced against the plain
reference, and prints one JSON line (`correct`, `attempted`, `failed`,
`metrics`, `device`, with `--trace 1` also `breakdown`, then `compared`).
Without a card it exits with 2 and prints no result.
"""

import os
import sys
import time


def _since_process_start() -> float:
    """Seconds since this process started (0 where /proc does not say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = time.perf_counter() - _since_process_start()

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from perfbench.harness.runner import main

    sys.exit(main(sys.argv[1:], T0))
