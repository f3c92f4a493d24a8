"""``readings.py`` for the cells whose faults live in ``faults_qlayer``:

    python3 perfbench/readings_qlayer.py --workload qkan-layer-16x16-d7 \
        --seconds <s> --seeds <n> [<n> ...] [--fault <name>]

The same readings, one JSON line a seed, with ``faults_qlayer.FAULTS``
beside ``faults.FAULTS`` for ``--fault``.  The benchmark's own runs never
run this.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import readings  # noqa: E402  (sets one host thread)

if __name__ == "__main__":
    from perfbench import faults, faults_qlayer

    faults.FAULTS.update(faults_qlayer.FAULTS)
    sys.exit(readings.main())
