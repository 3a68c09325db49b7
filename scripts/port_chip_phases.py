"""Run some phases of chip_smoke.py on the card, after its build phase:

    python scripts/port_chip_phases.py patchtst timesnet backbone_cli

Each name is a `phase_<name>` function of chip_smoke.py that takes no
argument, the card's nvidia-smi line (`smi`) or a scratch directory
(`tmp`); they run in the order given, each under a 600 s limit. It prints
the card's name and power limit first, as chip_smoke.py does. For trying
a slice's new phases without the whole script; chip_smoke.py stays the
check that every path runs.
"""

from __future__ import annotations

import inspect
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main(names) -> None:
    smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    work = tempfile.mkdtemp(prefix="chip_phases_")
    try:
        for name in names:
            fn = getattr(chip_smoke, f"phase_{name}")
            args = {"smi": smi, "tmp": work}
            params = list(inspect.signature(fn).parameters)
            with chip_smoke.time_limit(600, f"phase {name}"):
                fn(*(args[p] for p in params))
            print(f"[phases] {name}: done", flush=True)
    finally:
        for proc in list(chip_smoke.CHILDREN):
            chip_smoke.stop_server(proc)
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main(sys.argv[1:])
