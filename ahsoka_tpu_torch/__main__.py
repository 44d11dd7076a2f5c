import sys

from ahsoka_tpu_torch.cli.main import main

sys.exit(main())
