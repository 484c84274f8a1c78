"""``python -m distributed_ba3c_tpu_torch --task train|play|eval ...`` (cli.py)."""

import sys

from distributed_ba3c_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
