import sys

from salmon_tpu_torch.cli import main

sys.exit(main())
