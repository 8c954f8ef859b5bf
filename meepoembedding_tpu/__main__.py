"""`python -m meepoembedding_tpu <cmd>` (SURVEY.md C20, L7)."""

import sys

from meepoembedding_tpu.cli import main

sys.exit(main())
