"""The benchmark's CPU tests: run from the repository's root with
``python -m pytest portbench/tests -q``.  The repository's root is put on
the path, so that ``portbench`` and the program beside it import."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
