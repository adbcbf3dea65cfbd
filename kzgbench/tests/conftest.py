"""The benchmark's CPU tests: ``python -m pytest kzgbench/tests``.  They
import neither ``jax`` nor the JAX package; the card's one test is marked
``cuda`` and decides inside itself whether there is a card."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
