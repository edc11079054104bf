"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from
the root of the repo (CPU); the tests marked ``gpu`` run where torch sees
a CUDA card and skip elsewhere."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
