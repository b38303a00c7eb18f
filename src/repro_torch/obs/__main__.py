"""``python -m repro_torch.obs`` — see :mod:`repro_torch.obs.cli`."""

import sys

from .cli import main

sys.exit(main())
