"""``python -m torchsnapshot_tpu_torch.telemetry <events.jsonl>``."""

import sys

from .stats import main

if __name__ == "__main__":
    sys.exit(main())
