"""``python -m repro_torch.analysis`` — see repro_torch.analysis.runner."""

import sys

from repro_torch.analysis.runner import main

if __name__ == "__main__":
    sys.exit(main())
