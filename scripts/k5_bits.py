#!/usr/bin/env python3
"""K5's bf16 bits at the four preset widths, for comparing two commits on
one NVIDIA GPU:

    python3 scripts/k5_bits.py [--package-root DIR]

Prints the card's name and power limit, then one JSON object: for each
shape, row count and GELU form of `chip_smoke.P21_BITS_SHAPES`, the
truncated sha256 of K5's forward output and its seven cotangents
(`chip_smoke.k5_digests`). With --package-root the port's package is
imported from DIR (a `git archive` of another commit, which builds its own
kernels there), else from this checkout. Phase 21 of chip_smoke.py holds
this checkout's digests to those it printed for the commit before the
widths were opened (`P21_PARENT_DIGESTS`). Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package-root", type=Path, default=REPO)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import chip_smoke  # imports no part of the port at module level

    sys.path.insert(0, str(args.package_root.resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    import probpose_pytorch_tpu_torch

    print(chip_smoke.card_line(), flush=True)
    print(json.dumps(dict(package=str(Path(probpose_pytorch_tpu_torch.__file__).parent),
                          digests=chip_smoke.k5_digests(torch))), flush=True)


if __name__ == "__main__":
    main()
