# Copied from quickstep_tpu/__main__.py; only the package name in imports differs.
from quickstep_tpu_torch.cli.repl import main
import sys

sys.exit(main())
