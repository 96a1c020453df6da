"""The benchmark's own tests run on the CPU at tiny sizes; the one that
needs a card carries the ``gpu`` marker and skips without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
