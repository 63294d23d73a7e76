"""``python -m lightgbm_tpu_torch config=train.conf [key=value ...]``."""
import sys

from .cli import main

sys.exit(main())
