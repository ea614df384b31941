"""``python -m pygrid_tpu_torch.analysis`` — the gridlint CLI."""

import sys

from pygrid_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
