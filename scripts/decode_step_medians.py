"""Wall time of each serve's decode-only steps in ``chip_smoke.py`` logs.

``chip_smoke.py`` logs one ``<serve> step decode: wall_ms=...`` line for
every decode-only step of every serve.  This prints, for each log given and
each serve, the steps' count and the median, smallest and largest wall time
in ms, so that runs of two trees in one call can be set side by side:

    python3 scripts/decode_step_medians.py parent.log final.log final2.log
"""
from __future__ import annotations

import re
import statistics
import sys

STEP = re.compile(r"^(.*?) step decode: wall_ms=([0-9.]+)")


def medians(lines):
    """{serve: (steps, median, min, max)} over the decode-only step lines."""
    walls = {}
    for line in lines:
        m = STEP.match(line)
        if m:
            walls.setdefault(m.group(1), []).append(float(m.group(2)))
    return {serve: (len(w), statistics.median(w), min(w), max(w)) for serve, w in walls.items()}


def main(paths) -> None:
    for path in paths:
        with open(path) as f:
            for serve, (n, med, lo, hi) in medians(f).items():
                print(f"{path}\t{serve}\tsteps {n}\tmedian {med:.2f}\tmin {lo:.2f}\tmax {hi:.2f}")


if __name__ == "__main__":
    main(sys.argv[1:])
