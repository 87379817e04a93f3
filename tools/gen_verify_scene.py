"""Write the verification scene: a dual-CMOS PAN pair with a 200-column
overlap, both sensors' 4-band MSS, RRC tables and an AOS downlink of
CMOS1 (raw tiles, CRC-corrupt frames, one missing image frame).

    python tools/gen_verify_scene.py OUT_DIR [--lines 8192]

The construction is chip_smoke.py's (make_scene / write_inputs); the
ground truth is saved beside the inputs as scene.npy / scene2.npy.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", help="output directory (created)")
    ap.add_argument("--lines", type=int, default=8192,
                    help="PAN lines (a multiple of 1024, > 7168)")
    args = ap.parse_args()
    sc = chip_smoke.make_scene(args.lines)
    paths = chip_smoke.write_inputs(sc, args.out, with_downlink=True)
    np.save(os.path.join(args.out, "scene.npy"), sc["scene"])
    np.save(os.path.join(args.out, "scene2.npy"), sc["scene2"])
    for key, path in paths.items():
        print(f"{key}: {path}")


if __name__ == "__main__":
    main()
