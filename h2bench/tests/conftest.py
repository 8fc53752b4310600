"""Put the checkout and its ``src`` on the path of the benchmark's tests
(``python -m pytest h2bench/tests`` from the root of a checkout)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
