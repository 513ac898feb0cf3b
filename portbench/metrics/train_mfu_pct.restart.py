"""train_mfu_pct (metrics/train_mfu_pct.py) in the cells that report tokens_per_s.restart."""

import os

from harness.spec import load_reader

read = load_reader(os.path.join(os.path.dirname(os.path.abspath(__file__)), "train_mfu_pct.py"))
