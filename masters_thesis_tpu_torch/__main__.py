import sys

from masters_thesis_tpu_torch.cli import main

sys.exit(main())
