"""``python -m pygrid_tpu_torch.infra`` → the deploy CLI (reference installs
it as the ``pygrid`` console script, ``apps/infrastructure/cli/setup.py:8-11``).
The deploy API server is ``python -m pygrid_tpu_torch.infra.api``."""

import sys

from pygrid_tpu_torch.infra.cli import main

if __name__ == "__main__":
    sys.exit(main())
