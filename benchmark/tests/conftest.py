"""The benchmark's CPU tests: run from the checkout's root with
`python -m pytest benchmark/tests -q`. The card-only test is marked
`cuda` and skips here, deciding inside the test."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
