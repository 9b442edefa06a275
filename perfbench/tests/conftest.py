"""The benchmark's tests import ``perfbench`` and the port from the
checkout: its root and ``src`` go on the path."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for path in (ROOT, ROOT / "src"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))
