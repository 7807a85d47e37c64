"""``python -m sparktorch_tpu_torch.lint`` entry point."""

import sys

from sparktorch_tpu_torch.lint.cli import main

sys.exit(main())
