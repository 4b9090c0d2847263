"""``python -m cfrk_tpu_torch`` — see cfrk_tpu_torch.cli."""

import sys

from .cli import main

sys.exit(main())
