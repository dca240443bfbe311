"""The benchmark's CPU tests: ``python -m pytest benchmark/tests`` from the
root of the checkout. Tests marked ``cuda`` decide inside the test whether
there is a card."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (BENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)
