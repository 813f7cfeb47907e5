"""``python -m apex_example_tpu_torch.serve``: the serving CLI (cli.py)."""

import sys

from apex_example_tpu_torch.serve.cli import main

if __name__ == "__main__":
    sys.exit(main())
