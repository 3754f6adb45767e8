import sys

from fermi_tpu_torch.cli.main import main

sys.exit(main())
