"""flash_bwd_roofline (metrics/flash_bwd_roofline.py) in the cells that report tokens_per_s.restart."""

import os

from harness.spec import load_reader

read = load_reader(os.path.join(os.path.dirname(os.path.abspath(__file__)), "flash_bwd_roofline.py"))
