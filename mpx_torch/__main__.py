import sys

from mpx_torch.cli import main

sys.exit(main())
