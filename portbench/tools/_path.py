"""Put the checkout's ``src`` and ``portbench`` on ``sys.path`` (the
tools run as scripts from the root of the checkout)."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (HERE.parents[1] / "src", HERE.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
