"""step_ms_clean (metrics/step_ms_clean.py) in the cells that report tokens_per_s.restart."""

import os

from harness.spec import load_reader

read = load_reader(os.path.join(os.path.dirname(os.path.abspath(__file__)), "step_ms_clean.py"))
