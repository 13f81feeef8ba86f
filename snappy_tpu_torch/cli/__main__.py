import sys

from snappy_tpu_torch.cli.main import main

sys.exit(main())
