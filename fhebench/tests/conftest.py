"""Tests of the benchmark itself (``python -m pytest fhebench/tests``): CPU only,
except those marked ``gpu``, which skip without a card."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
